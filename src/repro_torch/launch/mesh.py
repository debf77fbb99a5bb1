"""Device meshes over ``torch.distributed``.

Functions, not module-level constants, so importing never touches the
process group.  Single pod: 16×16 = 256 devices (data × model).  Multi-pod:
2×16×16 = 512 (pod × data × model).  Every mesh spans the whole world of
the default process group, which the caller initialises
(``torch.distributed.init_process_group`` with its own address, world size
and rank); a shape whose size is not the world's raises.

:func:`fake_world` is the other way in: a default group of the ``fake``
backend, one rank of a world of any size with no peers and no traffic
(each collective returns a tensor of the right shape), so the production
meshes can be built in one process for the dry run
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import contextlib
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


class FakeStore(dist.Store):
    """A store that holds nothing: the ``fake`` backend never rendezvouses
    (the stand-in for ``torch.testing._internal.distributed.fake_pg``'s)."""


def _register_fake_backend() -> None:
    """Register the ``fake`` backend (``FakeProcessGroup``) with
    ``torch.distributed`` where this torch has not yet: importing torch's
    own test module registers it, and where that module is missing the
    same registration is made here."""
    if "FAKE" in getattr(dist.Backend, "_plugins", {}):
        return
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers it)
    except ImportError:
        from torch._C._distributed_c10d import FakeProcessGroup

        def create(opts, backend_opts):
            if hasattr(FakeProcessGroup, "_create_internal"):
                return FakeProcessGroup._create_internal(opts.group_rank, opts.group_size,
                                                         backend_opts)
            return FakeProcessGroup(opts.group_rank, opts.group_size)

        dist.Backend.register_backend("fake", create, extended_api=True,
                                      devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_world(world: int):
    """A default process group of the ``fake`` backend at rank 0 of
    ``world`` ranks, for the ``with`` block; destroyed on the way out,
    whatever happens inside.  Raises if a default group is already up."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    _register_fake_backend()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_fake_production_mesh(*, multi_pod: bool = False):
    """:func:`make_production_mesh` over the CPU in a :func:`fake_world` of
    256 (16×16) or 512 (2×16×16) ranks."""
    return make_production_mesh(multi_pod=multi_pod, device="cpu")
