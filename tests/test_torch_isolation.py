"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``,
``chip_smoke.py`` or the card-only tests, and no entry point falls back to
the CPU unasked."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'bad': bad, 'n': sum(m.startswith('repro_torch') for m in sys.modules)}))\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert result["n"] > 30          # every module of the port was imported


def test_no_source_imports_jax_or_reference():
    # the card-only tests run where JAX is not installed
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 30
    offenders = [str(f.relative_to(ROOT)) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []


class TestNoCpuUnasked:
    @pytest.fixture(autouse=True)
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_resolve(self):
        from repro_torch.device import resolve

        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve("cuda")
        assert resolve("cpu") == torch.device("cpu")

    def test_entry_points_raise(self, tiny_cfg):
        import dataclasses

        from repro_torch.bridge import adapter_from_numpy, params_from_numpy
        from repro_torch.core.engine import EngineConfig, KVSwapEngine
        from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params
        from repro_torch.serving import ServeSession

        cfg = ModelConfig(**dataclasses.asdict(tiny_cfg))
        params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        model = TransformerAdapter(cfg)
        calib = np.random.default_rng(0).standard_normal((64, 2, 16)).astype(np.float32)
        ecfg = EngineConfig(group_size=4, n_select=4, rank=8, reuse_capacity=4, max_seq=64)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KVSwapEngine(model, params, ecfg, batch=1, calib_k=calib)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeSession(model, params, ecfg, slots=1, calib_k=calib)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(cfg, generator=torch.Generator())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_numpy({"w": np.zeros(2)})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            adapter_from_numpy(np.zeros((32, 8), np.float32), 2, 16)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or on a host without CUDA, the smoke run exits
    nonzero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (lone, ROOT / "chip_smoke.py"):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=script.parent, timeout=120,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
