"""The typed storage faults and the bounded retry policy the disk tier speaks.

Fault *injection* (``FaultPlan``/``FaultyDisk`` in the reference) is not
ported yet: ``KVSwapEngine(faults=...)`` raises ``NotImplementedError``.
"""

from repro_torch.faults.errors import (CorruptBlockError, FetchFailed,
                                       InjectedCrash, ManifestCorrupt,
                                       MediaError, PersistentFault,
                                       RetriesExhausted, StorageFault,
                                       TornReadError, TransientFault,
                                       TransientReadError)
from repro_torch.faults.retry import RetryPolicy, call_with_retries

__all__ = [
    "CorruptBlockError",
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
