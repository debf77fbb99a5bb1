"""A run with the timed path broken underneath must come out not correct:
the harness is driven on the CPU at a tiny size (its look for a card
skipped), once for each fault a served cell can have."""

import json

import pytest

from kvbench.tests.helpers import copy_with_tiny_cells, rehearse

FAULTS = {
    # the decode step returns its state unchanged: the first step's logits
    # again, with no token appended
    "state_unchanged": """
from repro_torch.core.engine import KVSwapEngine
real = KVSwapEngine.decode_step
first = {}
def decode_step(self, ids):
    if "out" not in first:
        first["out"] = real(self, ids)
    return first["out"].clone()
KVSwapEngine.decode_step = decode_step
""",
    # half of the batch left out: its rows keep the logits of their previous step
    "half_batch_left_out": """
from repro_torch.core.engine import KVSwapEngine
real = KVSwapEngine.decode_step
last = {}
def decode_step(self, ids):
    out = real(self, ids)
    half = self.batch // 2
    if "out" in last:
        out[half:] = last["out"][half:]
    last["out"] = out.clone()
    return out
KVSwapEngine.decode_step = decode_step
""",
    # a served token altered where it is produced (the session's sampler)
    "token_altered": """
import numpy as np
import repro_torch.serving.api as api
real = api.make_row_sampler
def make_row_sampler(params=None):
    sample = real(params)
    n = [0]
    def altered(logits):
        n[0] += 1
        tok = np.asarray(sample(logits))
        return (tok + 1) % logits.shape[-1] if n[0] == 4 else tok
    return altered
api.make_row_sampler = make_row_sampler
""",
}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return copy_with_tiny_cells(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["tiny-moe", "tiny-dense"])
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_fault_is_not_correct(copy, cell, fault):
    script = (FAULTS.get(fault, "") + "import json\nfrom kvbench.run import run_cell\n"
              f"print(json.dumps(run_cell({cell!r}, 77, 0.5, False, device='cpu')))\n")
    proc = rehearse(copy, script)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    checks = out["checks"]
    assert out["correct"] is (fault is None), checks
    over = [k for k, c in checks.items() if "limit" in c and c["value"] > c["limit"]]
    assert bool(over) is (fault is not None), checks
