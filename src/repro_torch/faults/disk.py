"""FaultyDisk: the injection shim over :class:`~repro.core.offload.KVDiskStore`.

A transparent proxy — every attribute the engine, managers, warm tier or
tests touch (``n_groups``, ``accountant``, ``warm = ...``, ``spec``,
``free_row``…) delegates to the wrapped store — that intercepts exactly
the read/write surface the :class:`~repro.faults.plan.FaultPlan` models:

* ``read_run`` consults the plan first: persistent
  :class:`~repro.faults.errors.MediaError` for grown bad extents,
  transient read/torn errors per the armed burst, and flash-GC stalls
  charged to the accountant as modeled stall seconds (so they land in
  the same ``io_seconds`` every report reads) before the real read runs.
  A fetch vets each row's planned runs through it (``vet_runs``, under
  the disk tier's retry ladder) before placing the groups, so those reads
  are charged there and ``charge_runs`` has nothing left to charge.
* the write surface (``write_prefill``/``write_prefill_row``/
  ``append_group``/``append_group_row``) runs the real write first, then
  lets the plan remap/grow bad extents over what was just written —
  faults are born where real ones are, at write time.

The wrapper is what ``KVSwapEngine(..., faults=plan)`` installs as
``self.store``; with ``faults=None`` the engine keeps the bare store and
this module never loads (the bit-identity contract of the unfaulted
stack is untouched by construction).
"""

from __future__ import annotations

from repro_torch.faults.plan import FaultPlan

__all__ = ["FaultyDisk"]

_OWN = frozenset({"inner", "plan", "_disk_name"})


class FaultyDisk:
    """Fault-injecting proxy around a ``KVDiskStore``."""

    def __init__(self, inner, plan: FaultPlan):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "plan", plan)
        spec = getattr(getattr(inner, "accountant", None), "spec", None)
        object.__setattr__(self, "_disk_name", getattr(spec, "name", "nvme"))

    # -- transparent proxying ---------------------------------------------
    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        # writes like ``store.warm = tier`` must reach the real store (its
        # own methods read ``self.warm``), so only wrapper-private names
        # stay on the proxy
        if name in _OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    # -- faulted read surface ---------------------------------------------
    def read_run(self, layer: int, batch_idx: int, start: int, count: int):
        stall = self.plan.on_read(layer, batch_idx, start, count,
                                  disk=self._disk_name)
        if stall and self.inner.accountant is not None:
            self.inner.accountant.charge_stall(stall)
        return self.inner.read_run(layer, batch_idx, start, count)

    def vet_runs(self, layer: int, batch_idx: int, gids, scheduler, read) -> None:
        """Read each planned run of ``gids`` through ``read`` (the disk
        tier's retry ladder over :meth:`read_run`) before the fetch places
        them: faulted, stalled and charged run by run, in the order a read a
        run charges them.  The bytes the fetch places come from its gather."""
        for run in scheduler.plan(gids.tolist()):
            read(batch_idx, run)

    def charge_runs(self, counts) -> None:
        """Nothing: :meth:`vet_runs` charged each run as it read it."""

    # -- faulted write surface --------------------------------------------
    def write_prefill(self, layer: int, k, v):
        ng = self.inner.write_prefill(layer, k, v)
        for bi in range(self.inner.batch):
            self.plan.on_write(layer, bi, 0, ng)
        return ng

    def write_prefill_row(self, layer: int, batch_idx: int, k, v):
        ng = self.inner.write_prefill_row(layer, batch_idx, k, v)
        self.plan.on_write(layer, batch_idx, 0, ng)
        return ng

    def append_group(self, layer: int, k_group, v_group):
        self.inner.append_group(layer, k_group, v_group)
        for bi in range(self.inner.batch):
            gi = int(self.inner.n_groups[layer, bi]) - 1
            self.plan.on_write(layer, bi, gi, 1)

    def append_group_row(self, layer: int, batch_idx: int, k_group, v_group):
        self.inner.append_group_row(layer, batch_idx, k_group, v_group)
        gi = int(self.inner.n_groups[layer, batch_idx]) - 1
        self.plan.on_write(layer, batch_idx, gi, 1)

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
