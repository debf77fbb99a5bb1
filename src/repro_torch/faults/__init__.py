"""Storage fault injection + the typed faults the recovery machinery speaks.

See docs/robustness.md for the failure-domain map.  The package has two
faces:

* **Injection** — :class:`FaultSpec`/:class:`FaultPlan` (seeded,
  deterministic, schedule-independent decisions) and :class:`FaultyDisk`
  (the shim ``KVSwapEngine(..., faults=plan)`` installs over its
  ``KVDiskStore``).  Production code never depends on these.
* **Recovery vocabulary** — the :mod:`~repro_torch.faults.errors` taxonomy and
  :mod:`~repro_torch.faults.retry` policy, which the real stack (manager,
  engine, prefix cache, serving session) imports whether or not any
  faults are being injected.
"""

from repro_torch.faults.disk import FaultyDisk
from repro_torch.faults.errors import (CorruptBlockError, FetchFailed,
                                 InjectedCrash, ManifestCorrupt, MediaError,
                                 PersistentFault, RetriesExhausted,
                                 StorageFault, TornReadError, TransientFault,
                                 TransientReadError)
from repro_torch.faults.plan import FaultPlan, FaultSpec, FaultStats
from repro_torch.faults.retry import RetryPolicy, call_with_retries

__all__ = [
    "CorruptBlockError",
    "FaultPlan",
    "FaultSpec",
    "FaultStats",
    "FaultyDisk",
    "FetchFailed",
    "InjectedCrash",
    "ManifestCorrupt",
    "MediaError",
    "PersistentFault",
    "RetriesExhausted",
    "RetryPolicy",
    "StorageFault",
    "TornReadError",
    "TransientFault",
    "TransientReadError",
    "call_with_retries",
]
