"""Device meshes over ``torch.distributed``.

Functions, not module-level constants, so importing never touches the
process group.  Single pod: 16×16 = 256 devices (data × model).  Multi-pod:
2×16×16 = 512 (pod × data × model).  Every mesh spans the whole world of
the default process group, which the caller initialises
(``torch.distributed.init_process_group`` with its own address, world size
and rank); a shape whose size is not the world's raises.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.device import resolve


def make_mesh_auto(shape, axes, *, device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes``.  Its device
    type is ``cuda`` when the process group's backend is NCCL, else
    ``device``'s (``None`` = the CUDA card, as every entry point)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} devices, the world "
                         f"has {world}")
    dev_type = "cuda" if dist.get_backend() == "nccl" else resolve(device).type
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_auto(shape, axes, device=device)


def make_smoke_mesh(n_devices: int | None = None, *, device=None):
    """A ``(1, n)`` mesh over ``("data", "model")``; ``n`` defaults to the world."""
    n = n_devices or dist.get_world_size()
    return make_mesh_auto((1, n), ("data", "model"), device=device)
