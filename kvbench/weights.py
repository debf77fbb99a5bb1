"""The benchmark's weights: drawn from the seed on the device, in one call.

A configuration's family lists its leaves as ``(path, shape, std)``; every
random leaf is a view of one buffer filled by a single ``normal_`` from a
``torch.Generator`` on the run's device, then scaled in place (``std
None`` is a norm scale of ones).  Both the program and the plain
reference read these tensors; neither makes its own.
"""

from __future__ import annotations

import math

import torch


def make(leaves: list[tuple[str, tuple, float | None]], seed: int, device) -> dict:
    """``{path: tensor}`` for every leaf, fp32 on ``device``."""
    sizes = [math.prod(shape) for _, shape, std in leaves if std is not None]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    buf.normal_(generator=torch.Generator(device=device).manual_seed(seed))
    out, at = {}, 0
    for path, shape, std in leaves:
        if std is None:
            out[path] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        out[path] = buf[at:at + n].view(shape).mul_(std)
        at += n
    return out


def nested(flat: dict) -> dict:
    """``{"layers.3.wq": t, "embed": t}`` → ``{"layers": [..., {"wq": t}], "embed": t}``."""
    out: dict = {}
    for path, t in flat.items():
        parts = path.split(".")
        if parts[0] == "layers":
            layers = out.setdefault("layers", [])
            i = int(parts[1])
            while len(layers) <= i:
                layers.append({})
            layers[i][parts[2]] = t
        else:
            out[path] = t
    return out


def nbytes(flat: dict) -> int:
    return sum(t.numel() * t.element_size() for t in flat.values())
