"""Asynchronous disk-I/O subsystem for the KVSwap runtime (§3.3–§3.4).

- :mod:`repro.io.scheduler` — sort/coalesce group reads into sequential runs;
- :mod:`repro.io.prefetch` — background worker pool + double buffer that
  overlap layer *i+1*'s group preloading with layer *i*'s compute.
"""

from repro_torch.io.prefetch import (DoubleBuffer, PrefetchQueueFull, PrefetchResult,
                               PrefetchWorker)
from repro_torch.io.scheduler import ReadRun, ReadScheduler

__all__ = [
    "DoubleBuffer",
    "PrefetchQueueFull",
    "PrefetchResult",
    "PrefetchWorker",
    "ReadRun",
    "ReadScheduler",
]
