"""What decides ``correct``: the served tokens and the logits they were
chosen from, against the plain reference.

Once the window has closed and the program's state is freed, the
reference (``kvbench/reference/<family>.py``) runs over each compared
request's prompt and served tokens, on the benchmark's own weights, with an
adapter it fits itself.  It follows the program's discrete choices (the
groups each decode step selected, the experts each token was routed to)
and checks them apart: each must be a top-``M`` (top-``k``) choice under the
reference's own numbers up to a slack.  The number compared at each served
position is the larger of the gap by which the served token's logit lies
below the reference's best and the largest deviation of the program's
logits from the reference's, both over the reference's largest magnitude
there: greedy decoding serves the program's best, so a sound program reads
rounding.  The gap alone rarely moves under a precision one step lower (it
needs an argmax to flip), the deviation always does.

The control (``control=True``, never in the benchmark's own runs) is the
same reference in the precision below the configuration's, TF32 matrix
products for fp32 with TF32 off, put in the program's place: its own
choices, its logits and the tokens it puts first, judged alike.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from kvbench import workload


@contextlib.contextmanager
def tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sample(requests: list[dict], seed: int, most: int) -> list[dict]:
    """The requests to compare: the one with the most served tokens, and
    others drawn from the seed, ``most`` in all."""
    served = [r for r in requests if len(r["served"])]
    if len(served) <= most:
        return served
    served.sort(key=lambda r: -len(r["served"]))
    rng = np.random.default_rng([seed % 2**63, 2])
    rest = rng.choice(len(served) - 1, most - 1, replace=False) + 1
    return [served[0]] + [served[i] for i in sorted(rest)]


def compare(w: dict, cfg: dict, requests: list[dict], seed: int, device, *,
            control: bool = False, most: int = 8) -> dict:
    """``requests``: ``{"prompt", "served", "logits", "selections", "routes",
    "missing"}`` (numpy; the logits each served token was chosen from, ``[n,
    V]``; the program's group selection at each decode
    position, one ``[Td, n_groups]`` mask a layer; its experts at every
    position, one ``[T, k]`` a layer, or ``None`` for a dense model; how many
    of these choices were not observed).  Returns the largest relative
    logit error (:func:`judge`), the largest slack of the selections and of
    the routes, the tokens compared and the choices missing; with
    ``control``, the control's numbers."""
    ref = importlib.import_module(f"kvbench.reference.{cfg['model']}")
    engine = cfg["engine"]
    calib = torch.as_tensor(workload.calibration(seed, cfg["vocab_size"], engine["calib_tokens"]),
                            device=device)
    out = {"error": 0.0, "slack": 0.0, "routing_slack": 0.0, "tokens": 0, "requests": 0,
           "missing": 0}
    if control:
        out.update(control_error=0.0, control_slack=0.0, control_routing_slack=0.0)

    def judge(tokens, n_prompt, served, logits, selections, routes, key):
        """The fp32 reference following ``selections`` and ``routes``: at
        each served position the larger of the gap of ``served`` below its
        best and the largest deviation of ``logits`` (those the tokens were
        chosen from) from its own, both over its largest magnitude there;
        and the choices' slacks."""
        stats: dict = {}
        with tf32(False):
            ref_logits = ref.served_logits(w, cfg, engine, adapter, tokens, n_prompt,
                                           follow=selections, routes=routes, stats=stats)
        scale = ref_logits.abs().amax(dim=-1).clamp_min(1e-30)
        gap = ref_logits.max(dim=-1).values - ref_logits.gather(1, served[:, None])[:, 0]
        dev = (logits.to(ref_logits.device) - ref_logits).abs().amax(dim=-1)
        err = (torch.maximum(gap, dev) / scale).max()
        for name, value in (("error", float(err)), ("slack", stats.get("slack", 0.0)),
                            ("routing_slack", stats.get("routing_slack", 0.0))):
            out[key + name] = max(out[key + name], value)

    with torch.no_grad():
        with tf32(False):
            adapter = ref.fit_adapter(w, cfg, calib, engine["rank"])
        if control:
            with tf32(True):
                adapter_lo = ref.fit_adapter(w, cfg, calib, engine["rank"])
        for r in sample(requests, seed, most):
            served = torch.as_tensor(r["served"], device=device)
            tokens = torch.cat([torch.as_tensor(r["prompt"], device=device), served[:-1]])
            n_prompt = len(r["prompt"])
            out["tokens"] += int(served.numel())
            out["requests"] += 1
            if r["missing"]:
                out["missing"] += r["missing"]
                continue
            judge(tokens, n_prompt, served, torch.as_tensor(r["logits"]), r["selections"],
                  r["routes"], "")
            if control:
                # the reference in TF32 in the program's place: its own
                # choices and its first-ranked tokens, judged alike
                picked: list = []
                routed: list = []
                with tf32(True):
                    lo = ref.served_logits(w, cfg, engine, adapter_lo, tokens, n_prompt,
                                           record=picked, record_routes=routed)
                judge(tokens, n_prompt, lo.argmax(dim=-1), lo, picked, routed or None, "control_")
                del lo
    return out
