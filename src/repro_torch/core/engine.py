"""KVSwap engine in PyTorch: prefill → disk, overlap-pipelined sparse decode (§3.4).

The port of :mod:`repro.core.engine` for dense attention models and for
hybrids whose recurrent-state layers (Mamba2) sit between attention
layers (Zamba2): only the attention ("kv") layers own disk-backed KV, the
state layers carry their state in :attr:`KVSwapEngine.states`.  Host-side
orchestration (disk store, reuse and rolling buffers, mapping tables, the
prefetch worker, the modeled I/O and compute clocks) is the reference's,
copied; the device side is PyTorch on the run's device, with the decode
path's two hand-written CUDA kernels behind
:mod:`repro_torch.kernels.ops`.

Execution modes, as in the reference:

* ``async_io`` — group reads for layer *i+1* run on background
  :class:`~repro_torch.io.PrefetchWorker` threads (host only: no CUDA call
  is ever made on a worker) while layer *i* computes; tokens are
  bit-identical to the synchronous mode;
* ``device_resident`` — the selected-KV working set stays on the device
  between steps: each layer's reuse buffer has a device mirror updated in
  place with only the fetch misses, the context is gathered on the device
  by slot, and fresh K/V stay in a device rolling tail until their group
  completes (one download per ``G`` steps).  ``False`` is the host-gather
  control path with bit-identical tokens.

Per-slot request lifecycle (continuous batching) follows the reference:
:meth:`KVSwapEngine.admit_row` prefills one prompt into a free slot
(restoring a cached prefix when a :class:`~repro_torch.cache.PrefixCache`
is handed in), :meth:`KVSwapEngine.retire_row` frees it, and inactive rows
select no groups, read nothing and charge no modeled time.

A model whose KV layers cache latent records (MLA, ``model.kv_planes ==
1``) keeps one record a token in the store, the reuse buffers and their
mirrors, the slabs and the tails; each layer's gathered records are
decompressed on the device (``model.expand_context``) before its block.
The prefix cache, the warm tier and ``publish`` take K/V pairs and refuse
such a model.

Orthogonally, as in the reference: ``warm_budget_bytes > 0`` puts a
host-RAM warm tier (:mod:`repro_torch.tiers`) between the reuse buffers
and the disk, ``faults=`` wraps the disk store in the fault-injecting
:class:`~repro_torch.faults.FaultyDisk`, and :meth:`KVSwapEngine.publish` /
:meth:`KVSwapEngine.prefill_cached` move prompt KV through a persistent
prefix cache.  Warm prefill (restored prefix KV plus a chunked suffix
prefill) computes cold prefill's operations row for row; see
:meth:`KVSwapEngine.prefill_cached` for when their bits agree.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.cache.blocks import chain_blocks
from repro_torch.core import hardware
from repro_torch.core.adapter import ModelAdapter
from repro_torch.core.lowrank import LowRankAdapter, compress_k, fit_adapter
from repro_torch.core.manager import KVCacheManager
from repro_torch.core.offload import DISKS, DiskSpec, IOAccountant, KVDiskStore
from repro_torch.core.predictor import PredictorConfig
from repro_torch.core.reuse_buffer import ReuseBuffer
from repro_torch.core.rolling_buffer import RollingBuffer
from repro_torch.core.upload import SlabRing
from repro_torch.device import resolve
from repro_torch.faults.errors import CorruptBlockError, StorageFault
from repro_torch.faults.retry import RetryPolicy
from repro_torch.io import DoubleBuffer, PrefetchWorker, ReadRun, ReadScheduler
from repro_torch.kernels.fused_predict import fused_predict
from repro_torch.obs import NULL_OBS, PrefetchQualityMeter
from repro_torch.utils import stats as stats_util


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Runtime parameters — the tuple the offline tuner (§3.5) produces.

    Knob-by-knob (see ``docs/tuning.md`` for how the tuner picks them):

    * ``group_size`` (**G**) — tokens per KV group, the unit of disk layout,
      prediction, and transfer.  Larger G → bigger sequential reads (better
      effective bandwidth, Fig. 2) but coarser selection.
    * ``n_select`` (**M**) — groups preloaded per layer per decode step; the
      attention budget is ``M·G`` tokens.
    * ``rank`` (**r**) — low-rank adapter width for the compressed K cache;
      compression ratio σ = ``H_k·d / r``.  Higher r → better prediction
      recall, more resident metadata memory.
    * ``reuse_capacity`` (**C**) — reuse-buffer slots (groups) per layer per
      sequence; adjacent steps share 75–81 % of critical groups (Fig. 8), so
      C converts memory into skipped disk reads.
    * ``max_seq`` — KV capacity in tokens (bounds the memmap file).
    * ``disk`` — which :class:`DiskSpec` prices modeled I/O
      ("nvme"/"ufs"/"emmc").
    * ``warm_budget_bytes`` — host-RAM byte budget for the quantized warm
      tier (:mod:`repro_torch.tiers`) between the reuse buffer and disk: groups
      evicted from the reuse buffer are kept as per-group-scaled int8 under
      a global LRU budget and served back at memcpy+dequantize cost instead
      of a disk re-read.  0 (default) disables the tier entirely — tokens
      and ``StepStats`` are then byte-identical to an engine without it.
    * ``predict_from`` — "prev" scores layer *i* from layer *i−1*'s input
      (cross-layer similarity, §3.3), which is what makes prefetch
      overlappable; "self" predicts from the layer's own input (exact timing
      of InfiniGen-style online prediction, no overlap possible).
    * ``kv_bits`` — 16 stores the raw dtype on disk; 8 stores per-group
      scaled int8 (§7 "low-bit KV"), shrinking every group read.
    * ``device_resident`` — keep the selected-KV working set on device
      between steps (reuse-mirror delta uploads + device rolling buffer +
      fused prediction); ``False`` is the host-gather control path with
      bit-identical tokens.  Note C (``reuse_capacity``) then also bounds
      device memory: ``2·C·G·H_kv·d·itemsize`` bytes per KV layer.
    * ``async_io`` — run group preloading on the background worker
      (:mod:`repro_torch.io`); bit-identical tokens, overlapped wall-clock.
    * ``io_threads`` — prefetch worker threads (async mode only).
    * ``coalesce_gap`` — largest unrequested-group gap the
      :class:`ReadScheduler` reads through to keep a request sequential;
      0 merges only strictly adjacent groups.
    """

    group_size: int = 4            # G
    n_select: int = 100            # M (selected groups per layer per step)
    rank: int = 64                 # r  (σ = H_k·d / r)
    reuse_capacity: int = 160      # C (groups per layer per sequence)
    max_seq: int = 4096            # KV capacity (tokens)
    disk: str = "nvme"
    warm_budget_bytes: int = 0     # host-RAM warm tier budget (0 = disabled)
    predict_from: str = "prev"     # "prev" (paper, overlappable) | "self"
    kv_bits: int = 16              # 16 = raw dtype on disk; 8 = int8 (§7)
    device_resident: bool = True   # device-side working set, delta uploads
    dtype: str = "float32"
    compute: str = "jetson-orin-agx"  # timing model for simulated throughput
    async_io: bool = False         # background prefetch pipeline (repro_torch.io)
    io_threads: int = 2            # PrefetchWorker pool size
    coalesce_gap: int = 0          # ReadScheduler gap coalescing (groups)
    # bounded retry-with-backoff for disk reads (docs/robustness.md):
    # io_max_attempts total attempts per coalesced run, exponential modeled
    # backoff from io_backoff_s between them (charged as accountant stall
    # time, never slept).  1 attempt = fail on first error.
    io_max_attempts: int = 3
    io_backoff_s: float = 0.002

    @property
    def disk_spec(self) -> DiskSpec:
        return DISKS[self.disk]

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)


@dataclasses.dataclass
class StepStats:
    """Per-decode-step accounting.

    ``io/compute/pipelined_seconds`` are *modeled* (DiskSpec + ComputeSpec)
    and identical between sync and async modes; ``wall_seconds`` and
    ``io_wait_seconds`` are *measured* on the host, so async mode shows the
    read time actually hidden under compute (``io_wait < io_seconds``-ish).
    """

    io_seconds: float = 0.0          # modeled fetch-serve time (disk + warm tier)
    compute_seconds: float = 0.0     # modeled compute time, summed over layers
    pipelined_seconds: float = 0.0   # modeled layer-pipelined step latency
    io_bytes: int = 0                # cumulative disk bytes read since engine start
    io_requests: int = 0             # cumulative read requests since start
    warm_bytes: int = 0              # warm-tier-served bytes this step (disk units)
    wall_seconds: float = 0.0        # measured wall time of this step
    io_wait_seconds: float = 0.0     # measured wall time blocked on fetches
    h2d_bytes: int = 0               # host→device KV payload bytes this step
    active_rows: int = 0             # rows decoded this step (continuous batching)
    # prefetch quality (repro_torch.obs.quality): pooled integer counts over this
    # step's (layer, row) selections, scored as 1-step lookahead against the
    # previous step's selections.  Ratios of sums aggregate correctly across
    # steps, so the counts are stored and the ratios derived.
    pred_shared_groups: int = 0      # |prev ∩ cur| summed over (layer, row)
    pred_prev_groups: int = 0        # |prev| summed over (layer, row)
    pred_cur_groups: int = 0         # |cur| summed over (layer, row)
    stale_groups: int = 0            # reuse-resident but unselected this step
    resident_groups: int = 0         # reuse-resident at selection time

    @property
    def overlap_saved_seconds(self) -> float:
        """Modeled time the pipeline hides: serial − pipelined."""
        return max(0.0, self.io_seconds + self.compute_seconds - self.pipelined_seconds)

    @property
    def pred_precision(self) -> float:
        """Of last step's selection, the fraction re-selected this step —
        what a 1-step lookahead prefetcher's precision would have been."""
        return self.pred_shared_groups / self.pred_prev_groups \
            if self.pred_prev_groups else 0.0

    @property
    def pred_recall(self) -> float:
        """Of this step's selection, the fraction last step's selection
        already covered — a lookahead prefetcher's recall."""
        return self.pred_shared_groups / self.pred_cur_groups \
            if self.pred_cur_groups else 0.0

    @property
    def stale_group_rate(self) -> float:
        """Of the groups resident in the reuse buffers at selection time,
        the fraction this step did not select (reclaimable dead weight)."""
        return self.stale_groups / self.resident_groups \
            if self.resident_groups else 0.0


def summarize_steps(steps: Sequence[StepStats]) -> dict:
    """Mean per-step modeled + measured overlap over a window of steps.

    Shared by :meth:`KVSwapEngine.overlap_report` (whole-engine view) and the
    serving session, which summarizes only its own flush window of a
    persistent engine's ``step_log``.

    ``step_seconds_p50/p95/p99`` are tail percentiles of the modeled
    per-step latency (``pipelined_seconds``) over the window — means hide
    exactly the straggler steps (reuse-buffer cold starts, C<M overflow
    rounds) that break per-token SLOs, so the serving harness and the
    engine report the same tail statistic from the same helper
    (:func:`repro_torch.utils.stats.percentile`).
    """
    if not steps:
        return {}
    n = len(steps)
    mean = lambda f: sum(f(s) for s in steps) / n
    tails = stats_util.percentiles([s.pipelined_seconds for s in steps])
    # prefetch quality pooled over the window: ratios of summed counts, not
    # means of per-step ratios (sparse steps would otherwise be overweighted)
    shared = sum(s.pred_shared_groups for s in steps)
    prev = sum(s.pred_prev_groups for s in steps)
    cur = sum(s.pred_cur_groups for s in steps)
    stale = sum(s.stale_groups for s in steps)
    resident = sum(s.resident_groups for s in steps)
    return {
        "io_seconds": mean(lambda s: s.io_seconds),
        "compute_seconds": mean(lambda s: s.compute_seconds),
        "pipelined_seconds": mean(lambda s: s.pipelined_seconds),
        "overlap_saved_seconds": mean(lambda s: s.overlap_saved_seconds),
        "wall_seconds": mean(lambda s: s.wall_seconds),
        "io_wait_seconds": mean(lambda s: s.io_wait_seconds),
        "h2d_bytes": mean(lambda s: s.h2d_bytes),
        "active_rows": mean(lambda s: s.active_rows),
        "warm_bytes": mean(lambda s: s.warm_bytes),
        "pred_precision": shared / prev if prev else 0.0,
        "pred_recall": shared / cur if cur else 0.0,
        "stale_group_rate": stale / resident if resident else 0.0,
        **{f"step_seconds_{k}": v for k, v in tails.items()},
    }


class PublishResult(int):
    """Return of :meth:`KVSwapEngine.publish`: behaves as the plain block
    count (``+=`` accounting in the serving layer keeps working), but also
    carries ``heads`` — per published row, the deepest resident block id of
    that row's hash chain (``None`` when nothing of the row's chain is
    resident, e.g. a prompt shorter than one block)."""

    def __new__(cls, published: int, heads: dict[int, str | None] | None = None):
        self = super().__new__(cls, published)
        self.heads = heads or {}
        return self


class KVSwapEngine:
    """Serve one batch of sequences with the KVSwap runtime on ``device``
    (``None`` = the CUDA card; raises on a host without one)."""

    def __init__(
        self,
        model: ModelAdapter,
        params,
        cfg: EngineConfig,
        *,
        batch: int,
        adapter: LowRankAdapter | None = None,
        calib_k: np.ndarray | None = None,
        obs=None,
        faults=None,
        device=None,
    ):
        self.device = resolve(device)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.obs = obs if obs is not None else NULL_OBS
        if adapter is None:
            if calib_k is None:
                raise ValueError("need a fitted LowRankAdapter or calibration K")
            adapter = fit_adapter(calib_k, rank=cfg.rank, device=self.device)
        if adapter.rank != cfg.rank:
            raise ValueError(f"adapter rank {adapter.rank} != cfg.rank {cfg.rank}")
        if adapter.a.device != self.device:
            raise ValueError(f"adapter lives on {adapter.a.device}, engine on {self.device}")
        self.adapter = adapter
        self._per_head_a = adapter.per_head  # [H_k, d, r]
        self._dtype = torch.from_numpy(np.zeros(0, cfg.np_dtype)).dtype
        # 2: K and V a token; 1: one latent record (MLA), V derived from it
        self.kv_planes = getattr(model, "kv_planes", 2)
        limit = getattr(model, "max_positions", None)
        if limit is not None and cfg.max_seq > limit:
            raise ValueError(f"max_seq {cfg.max_seq} exceeds the {limit} positions the "
                             "model defines")
        if self.kv_planes == 1 and cfg.warm_budget_bytes > 0:
            raise ValueError("the warm tier keeps K/V pairs; latent records have none")

        g = cfg.group_size
        self.max_groups = (cfg.max_seq + g - 1) // g
        self.cap_tokens = self.max_groups * g
        # hybrid support: only "kv" layers own disk-backed KV state; j below
        # indexes the KV layers, `layer` the model's blocks
        self.layer_kinds = tuple(getattr(model, "layer_kinds", ("kv",) * model.n_layers))
        self.kv_layers = [i for i, k in enumerate(self.layer_kinds) if k == "kv"]
        self._kv_index = {layer: j for j, layer in enumerate(self.kv_layers)}
        n_kv_layers = len(self.kv_layers)
        self.accountant = IOAccountant(cfg.disk_spec)
        if self.obs.enabled:
            # mirror every I/O charge into the registry inside the
            # accountant's lock (registry totals stay equal to snapshot())
            self.accountant.bind_metrics(self.obs.registry)
            reg = self.obs.registry
            self._m_steps = reg.counter(
                "kvswap_engine_decode_steps_total", "decode steps executed")
            self._m_tokens = reg.counter(
                "kvswap_engine_decode_tokens_total",
                "tokens decoded (active rows per step)")
            self._m_admissions = reg.counter(
                "kvswap_engine_admissions_total",
                "prefills + per-slot admissions")
            self._m_prefill_tokens = reg.counter(
                "kvswap_engine_prefill_tokens_total",
                "prompt tokens computed by prefill (cached tokens excluded)")
            self._m_hist_pipe = reg.histogram(
                "kvswap_step_pipelined_seconds",
                "modeled layer-pipelined decode-step latency")
            self._m_hist_wall = reg.histogram(
                "kvswap_step_wall_seconds", "measured decode-step wall time")
            self._m_expanded = reg.counter(
                "kvswap_latent_records_expanded_total",
                "latent records decompressed into heads on the device (MLA decode)")
        # the modeled clock prices the paper's device (Jetson Orin AGX by
        # default), as the reference does, so StepStats compare one to one
        self.compute_spec = hardware.COMPUTES.get(cfg.compute, hardware.TPU_V5E)
        self.store = KVDiskStore(
            n_layers=n_kv_layers, batch=batch, max_groups=self.max_groups,
            group_size=g, n_kv_heads=model.n_kv_heads, head_dim=model.head_dim,
            dtype=cfg.np_dtype, accountant=self.accountant,
            quant_bits=8 if cfg.kv_bits == 8 else 0, planes=self.kv_planes,
        )
        # fault injection: with a FaultPlan attached the disk tier is wrapped
        # in the FaultyDisk shim; faults=None keeps the bare store, and the
        # injection modules are never loaded
        self.faults = faults
        if faults is not None:
            from repro_torch.faults import FaultyDisk

            self.store = FaultyDisk(self.store, faults)
        self.reuse = [
            ReuseBuffer(batch=batch, capacity=cfg.reuse_capacity, group_size=g,
                        n_kv_heads=model.n_kv_heads, head_dim=model.head_dim,
                        dtype=cfg.np_dtype, planes=self.kv_planes)
            for _ in range(n_kv_layers)
        ]
        self.rolling = [
            RollingBuffer(batch=batch, group_size=g, n_kv_heads=model.n_kv_heads,
                          head_dim=model.head_dim, dtype=cfg.np_dtype, planes=self.kv_planes)
            for _ in range(n_kv_layers)
        ]
        self.scheduler = ReadScheduler(max_gap=cfg.coalesce_gap)
        # host-RAM warm tier (victim cache) between reuse buffers and disk:
        # one tier for the whole engine (warm_budget_bytes is a global
        # budget across layers and rows); None when disabled, so the
        # disabled path is the code without a tier
        self.warm = None
        if cfg.warm_budget_bytes > 0:
            from repro_torch.tiers import WarmTier

            self.warm = WarmTier(budget_bytes=cfg.warm_budget_bytes,
                                 compute=self.compute_spec,
                                 accountant=self.accountant, obs=self.obs)
            self.store.warm = self.warm
        self._retry = RetryPolicy(max_attempts=cfg.io_max_attempts,
                                  backoff_base_s=cfg.io_backoff_s)
        self.device_resident = bool(cfg.device_resident
                                    and hasattr(model, "gather_context"))
        # the device-resident path's upload slabs, one a live table: the
        # double buffer's two and one whose copy may be pending (async), or
        # one (sync); each holds the most one layer's fetch can serve
        self.slabs = None
        if self.device_resident:
            self.slabs = SlabRing(
                3 if cfg.async_io else 1, batch=batch, n_select=cfg.n_select,
                group_shape=(g, self.kv_planes, model.n_kv_heads, model.head_dim),
                dtype=cfg.np_dtype, device=self.device, obs=self.obs)
        self.managers = [
            KVCacheManager(store=self.store, reuse=self.reuse[j], rolling=self.rolling[j],
                           layer=j, scheduler=self.scheduler, warm=self.warm,
                           obs=self.obs, retry=self._retry, slabs=self.slabs)
            for j in range(n_kv_layers)
        ]
        self.prefetcher: PrefetchWorker | None = None
        if cfg.async_io:
            self.prefetcher = PrefetchWorker(
                self._fetch_table, n_threads=cfg.io_threads,
                max_pending=max(4, 2 * max(n_kv_layers, 1)),
                accountant=self.accountant,
                obs=self.obs,
            )
        self.quality = PrefetchQualityMeter()
        # recurrent state of the non-KV (Mamba2) layers, keyed by model layer
        self.states: dict[int, dict] = {}
        # preallocated compressed K cache, one per KV layer: [B, cap_tokens, r]
        self.k_lr = [
            torch.zeros((batch, self.cap_tokens, cfg.rank), dtype=torch.float32,
                        device=self.device)
            for _ in range(n_kv_layers)
        ]
        self.row_active = np.zeros(batch, dtype=bool)
        self.row_seq = np.zeros(batch, dtype=np.int64)    # tokens seen (incl. tail)
        self.row_valid = np.zeros(batch, dtype=np.int64)  # tokens in k_lr (n_groups·G)
        self.n_select = cfg.n_select
        self.pred_cfg = PredictorConfig(
            group_size=g, n_select=cfg.n_select,
            n_heads=model.n_heads, n_kv_heads=model.n_kv_heads,
        )
        self.dims = (hardware.LatentDims if self.kv_planes == 1 else hardware.ModelDims)(
            d_model=model.d_model, n_heads=model.n_heads, n_kv_heads=model.n_kv_heads,
            head_dim=model.head_dim, d_ff=getattr(model, "d_ff", 4 * model.d_model),
        )
        self.step_log: list[StepStats] = []
        self.prefill_report: dict = {}
        self.admit_log: list[dict] = []   # one report per admit_row/prefill
        self._prompt_np: np.ndarray | None = None
        # device rolling tail per layer: [B, G, H_kv, d] fp32, written in
        # place by decode; per-row validity comes from RollingBuffer.fills
        self._tail_k: list[torch.Tensor | None] = [None] * n_kv_layers
        self._tail_v: list[torch.Tensor | None] = [None] * n_kv_layers
        self._dev_ready = False
        self._h2d_step = 0
        self._step_active = np.zeros(batch, dtype=bool)
        self._obs_at = {"step": 0}    # the args of the current step's phase spans
        # an observer of decode: ``layer_hook(layer, x, pos, table)`` is
        # called as each KV layer's attention starts, with its input, the
        # rows' positions and the layer's MappingTable (this step's selection)
        self.layer_hook = None

    # -- per-row lifecycle views ----------------------------------------
    @property
    def seq_len(self) -> int:
        """Longest row's token count — the lockstep view (uniform batches)."""
        return int(self.row_seq.max(initial=0))

    @property
    def valid_tokens(self) -> int:
        """Longest row's compressed-cache watermark (lockstep view)."""
        return int(self.row_valid.max(initial=0))

    def _fetch_table(self, j: int, ids: np.ndarray, mask: np.ndarray):
        """The prefetch worker's unit of work: host-only group resolution."""
        return self.managers[j].fetch(ids, mask)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """Download a device tensor as the engine's storage dtype."""
        return t.to(self._dtype).cpu().numpy()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Upload a host array (restored prefix K or V) to the device."""
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    def metadata_bytes(self) -> dict:
        """In-memory footprint of KVSwap state (the paper's Fig. 3a metric).
        ``k_lr_logical`` counts the valid compressed keys of every row in
        every KV layer (a hybrid's state layers own none)."""
        klr = int(self.row_valid.sum()) * self.cfg.rank * 4
        klr_alloc = sum(k.numel() * 4 for k in self.k_lr)
        reuse = sum(r.nbytes for r in self.reuse)
        rolling = sum(r.nbytes for r in self.rolling)
        out = {
            "k_lr_logical": klr * len(self.kv_layers),
            "k_lr_alloc": klr_alloc,
            "reuse_buffer": reuse,
            "rolling_buffer": rolling,
            "total": klr_alloc + reuse + rolling,
        }
        if self.warm is not None:
            # warm tier: int8 slab payload + modeled index overhead, both
            # charged against warm_budget_bytes
            out["warm_tier"] = self.warm.nbytes
            out["warm_tier_index"] = self.warm.index_nbytes
            out["warm_budget_bytes"] = self.warm.budget_bytes
            out["total"] += out["warm_tier"] + out["warm_tier_index"]
        if any(r.device is not None for r in self.reuse):
            # the device mirrors double C's footprint; reported apart, as
            # they bound device memory
            out["device_mirror"] = sum(r.device.nbytes for r in self.reuse
                                       if r.device is not None)
        return out

    # ------------------------------------------------------------------
    def _modeled_prefill_compute(self, n_new: int, n_ctx0: int,
                                 batch: int | None = None) -> float:
        """Modeled compute seconds to prefill ``n_new`` tokens."""
        return self.model.n_layers * hardware.prefill_layer_time(
            self.compute_spec, self.dims, n_new=n_new, n_ctx0=n_ctx0,
            batch=self.batch if batch is None else batch)

    def _admission_report(self, *, s: int, n_cached: int, tr, wall: float,
                          wall_t0_ns: int, row: int | None = None) -> None:
        """Modeled + measured accounting of one admission (cold or warm).

        ``modeled_seconds`` charges restore reads, store writes and (chunked)
        compute sequentially; ``modeled_cold_seconds`` prices the same prompt
        with no cached tokens, so callers can report the saving."""
        batch = None if row is None else 1
        compute = self._modeled_prefill_compute(s - n_cached, n_cached, batch=batch)
        cold = self._modeled_prefill_compute(s, 0, batch=batch)
        rep = {
            "prompt_tokens": s,
            "cached_tokens": n_cached,
            "computed_tokens": s - n_cached,
            "restore_seconds": tr.read_seconds,
            "write_seconds": tr.write_seconds,
            "compute_seconds": compute,
            "modeled_seconds": tr.read_seconds + tr.write_seconds + compute,
            "modeled_cold_seconds": cold + tr.write_seconds,
            "wall_seconds": wall,
        }
        if row is not None:
            rep["row"] = row
        self.prefill_report = rep
        self.admit_log.append(dict(rep))
        self._obs_admission("prefill" if row is None else "admit_row", rep, wall_t0_ns)

    def _obs_admission(self, name: str, rep: dict, wall_t0_ns: int) -> None:
        """Admission span on both clocks (the wall one from the
        admission's first reading) + admission counters."""
        obs = self.obs
        if not obs.enabled:
            return
        t0, _ = obs.advance_model(rep["modeled_seconds"])
        obs.tracer.add(
            name, "engine-step", cat="admission",
            wall_t0_ns=wall_t0_ns, wall_t1_ns=obs.tracer.now_ns(),
            model_t0=t0, model_dur=rep["modeled_seconds"],
            args={k: rep[k] for k in ("prompt_tokens", "cached_tokens", "row")
                  if k in rep})
        self._m_admissions.inc()
        self._m_prefill_tokens.inc(rep["computed_tokens"])

    def _spill_prefill_layer(self, j: int, k_np: np.ndarray, v_np: np.ndarray,
                             k_dev: torch.Tensor, s: int, row: int | None) -> None:
        """Per-layer prefill spill shared by the cold and warm paths, batched
        and per slot: write the full groups to disk, seed the rolling tail,
        write the compressed keys into ``k_lr``.  One body so the paths cannot
        drift (warm prefill's bit-identity contract depends on them
        matching).  ``k_np/v_np [B, S, H_kv, d]`` host, ``k_dev`` the same K
        on the device; ``row=None`` spills every row, else slot ``row``
        (``B == 1``)."""
        g = self.cfg.group_size
        ng = s // g
        if row is None:
            self.store.write_prefill(j, k_np, v_np)
            if s - ng * g:
                self.rolling[j].seed(k_np[:, ng * g:], v_np[:, ng * g:])
            if ng:
                self.k_lr[j][:, :ng * g] = compress_k(k_dev[:, :ng * g].float(), self.adapter)
            return
        self.store.write_prefill_row(j, row, k_np[0], v_np[0])
        if s - ng * g:
            self.rolling[j].seed_row(row, k_np[0, ng * g:], v_np[0, ng * g:])
        if ng:
            self.k_lr[j][row, :ng * g] = compress_k(k_dev[0, :ng * g].float(), self.adapter)
        if self._dev_ready:
            # seed the device rolling tail's row from the host tail
            self._tail_k[j][row] = torch.from_numpy(self.rolling[j].k[row]).to(
                self.device, torch.float32)
            if self.kv_planes == 2:
                self._tail_v[j][row] = torch.from_numpy(self.rolling[j].v[row]).to(
                    self.device, torch.float32)

    def _prefill_layers(self, tokens_np: np.ndarray, s: int, n_cached: int = 0,
                        k_pre: np.ndarray | None = None, v_pre: np.ndarray | None = None,
                        row: int | None = None) -> torch.Tensor:
        """Run tokens ``[n_cached, s)`` of ``tokens_np [B, S]`` through every
        block and spill each KV layer; returns the last hidden state ``[B, S -
        n_cached, D]``.  With ``n_cached`` the blocks attend over the restored
        prefix ``k_pre/v_pre [n_kv, B, n_cached, H_kv, d]`` (chunked prefill:
        the same score rows as the cold forward, op by op)."""
        b = tokens_np.shape[0]
        positions = torch.arange(n_cached, s, device=self.device)[None, :].repeat(b, 1)
        x = self.model.embed(self.params,
                             torch.as_tensor(tokens_np[:, n_cached:], device=self.device))
        for layer in range(self.model.n_layers):
            if self.layer_kinds[layer] == "state":
                x, self.states[layer] = self.model.prefill_state_block(
                    self.params, layer, x, positions)
                continue
            j = self._kv_index[layer]
            if n_cached:
                kp, vp = self._upload(k_pre[j]), self._upload(v_pre[j])
                x, k_suf, v_suf = self.model.prefill_block_with_ctx(
                    self.params, layer, x, positions, kp, vp)
                k_dev = torch.cat([kp, k_suf], dim=1)
                k_np = np.concatenate([k_pre[j], self._host(k_suf)], axis=1)
                v_np = np.concatenate([v_pre[j], self._host(v_suf)], axis=1)
            else:
                x, k_dev, v = self.model.prefill_block(self.params, layer, x, positions)
                k_np = self._host(k_dev)
                v_np = k_np if self.kv_planes == 1 else self._host(v)
            self._spill_prefill_layer(j, k_np, v_np, k_dev, s, row)
        return x

    def _open_cache(self, cache) -> None:
        """Bind ``cache`` to this engine's geometry, accountant and obs."""
        if self.kv_planes == 1:
            raise ValueError("the prefix cache keeps K/V pairs; a model of latent "
                             "records (MLA) has none to restore or publish")
        cache.open(n_layers=len(self.kv_layers), group_size=self.cfg.group_size,
                   n_kv_heads=self.model.n_kv_heads, head_dim=self.model.head_dim,
                   dtype=self.cfg.np_dtype)
        cache.use_accountant(self.accountant)
        cache.use_obs(self.obs)

    def prefill(self, tokens: np.ndarray) -> torch.Tensor:
        """Run full-attention prefill of every row, spill KV to disk layer by
        layer, build the compressed K cache.  Returns last-position logits
        ``[B, V]`` on the device."""
        w0 = self.obs.tracer.now_ns() if self.obs.enabled else 0
        t0 = time.perf_counter()
        self._reset_device_state()   # mirrors rebuilt at first decode
        tokens_np = np.asarray(tokens)
        b, s = tokens_np.shape
        if b != self.batch:
            raise ValueError(f"batch mismatch {b} != {self.batch}")
        self._prompt_np = tokens_np
        for bi in range(self.batch):   # lockstep admission of every slot
            self._free_row(bi)
        with self.accountant.track() as tr:
            x = self._prefill_layers(tokens_np, s)
        self._activate_all(s)
        logits = self.model.logits(self.params, x[:, -1])
        self._admission_report(s=s, n_cached=0, tr=tr, wall=time.perf_counter() - t0,
                               wall_t0_ns=w0)
        return logits

    def _activate_all(self, s: int) -> None:
        g = self.cfg.group_size
        self.row_valid[:] = (s // g) * g
        self.row_seq[:] = s
        self.row_active[:] = True

    # -- persistent prefix cache (repro_torch.cache) ---------------------
    def prefill_cached(self, tokens: np.ndarray, cache) -> torch.Tensor:
        """Prefill through the cross-request prefix cache.

        Longest-prefix match the prompt against ``cache``
        (:class:`repro_torch.cache.PrefixCache`), restore the matched blocks'
        KV groups straight into this engine's disk store, and run **only the
        uncached suffix** through the model (chunked prefill over restored
        prefix KV).  At least one token is always recomputed so the call
        still returns last-position logits.

        Bit-identity: the cache stores KV in the raw engine dtype, and the
        chunked suffix computes the same score rows as the full forward, so
        logits (and every decode step after) equal :meth:`prefill`'s on the
        same prompt wherever each operation gives a row the same bits
        whatever the number of rows and keys beside it.  On the CPU that
        holds for a suffix of two tokens or more over a prefix published
        from a prompt of the same length (one row takes the matrix-vector
        route, and attention over more keys sums in another order); the
        card's fp32 GEMMs pick their kernel by shape, so there warm logits
        agree with cold ones within 1e-4 (``PERF.md``).  Lossy stored KV
        (``kv_bits=8``, a ``dtype`` narrower than the compute dtype) makes it
        approximately equal.

        The batch prefills in lockstep, so the usable split is the *common*
        cached prefix (minimum over rows).  Hybrid models fall back to cold
        prefill: recurrent state lives outside the KV cache.
        """
        w0 = self.obs.tracer.now_ns() if self.obs.enabled else 0
        t0 = time.perf_counter()
        tokens_np = np.asarray(tokens)
        b, s = tokens_np.shape
        if b != self.batch:
            raise ValueError(f"batch mismatch {b} != {self.batch}")
        if (any(kind != "kv" for kind in self.layer_kinds)
                or not hasattr(self.model, "prefill_block_with_ctx")):
            return self.prefill(tokens_np)
        bt = cache.cfg.block_tokens
        self._open_cache(cache)

        def common_chains():
            chains = [cache.match(tokens_np[bi], max_tokens=s - 1) for bi in range(b)]
            n = min(sum(m.n_tokens for m in ch) for ch in chains)
            return n, [ch[:n // bt] for ch in chains]

        n_cached, chains = common_chains()
        if n_cached == 0:
            return self.prefill(tokens_np)
        self._reset_device_state()   # mirrors rebuilt at first decode
        for bi in range(self.batch):   # lockstep admission of every slot
            self._free_row(bi)
        with self.accountant.track() as tr:
            # identical rows resolve to the same chain: read each unique chain
            # once.  A checksum mismatch quarantines the bad block (and its
            # descendants) inside read_chain; re-match against the now-shorter
            # cache and retry: warm prefill degrades to a longer suffix, never
            # to wrong KV.
            while True:
                uniq = {ch[-1].block_id: ch for ch in chains}
                for ch in uniq.values():
                    cache.pin(ch)
                try:
                    data = {key: cache.read_chain(ch) for key, ch in uniq.items()}
                    break
                except CorruptBlockError:
                    n_cached, chains = common_chains()
                    if n_cached == 0:
                        return self.prefill(tokens_np)
                finally:
                    for ch in uniq.values():
                        cache.unpin(ch)
            nkv, hkv, hd = len(self.kv_layers), self.model.n_kv_heads, self.model.head_dim
            k_pre = np.empty((nkv, b, n_cached, hkv, hd), dtype=self.cfg.np_dtype)
            v_pre = np.empty_like(k_pre)
            for bi, ch in enumerate(chains):
                k_pre[:, bi], v_pre[:, bi] = data[ch[-1].block_id]
            x = self._prefill_layers(tokens_np, s, n_cached, k_pre, v_pre)
        self._activate_all(s)
        self._prompt_np = tokens_np
        logits = self.model.logits(self.params, x[:, -1])
        self._admission_report(s=s, n_cached=n_cached, tr=tr,
                               wall=time.perf_counter() - t0, wall_t0_ns=w0)
        return logits

    def _restore_prefix(self, cache, tokens_np: np.ndarray, s: int):
        """Longest *verified* cached prefix of one prompt: match → pin →
        read_chain, re-matching after a :class:`CorruptBlockError`
        (``read_chain`` quarantined the bad block and its descendants, so
        every retry sees a strictly shorter chain and the loop terminates).
        Returns ``(n_cached, k_pre, v_pre)`` — ``(0, None, None)`` when
        nothing restorable is left."""
        while True:
            chain = cache.match(tokens_np, max_tokens=s - 1)
            n_cached = sum(m.n_tokens for m in chain)
            if not n_cached:
                return 0, None, None
            cache.pin(chain)
            try:
                k_pre, v_pre = cache.read_chain(chain)  # [nkv, n_cached, hkv, d]
                return n_cached, k_pre, v_pre
            except CorruptBlockError:
                continue
            finally:
                cache.unpin(chain)

    # -- per-slot request lifecycle (continuous batching) ----------------
    def admit_row(self, bi: int, tokens: np.ndarray, cache=None) -> torch.Tensor:
        """Prefill one prompt into free slot ``bi`` while other slots keep
        decoding; returns the slot's last-position logits ``[V]``.

        The prompt runs as a batch-1 forward, its KV spills into row ``bi``
        of the disk store, the rolling tail seeds row ``bi`` and the
        compressed K cache gets the row's groups; no other row's state is
        touched.  With a :class:`~repro_torch.cache.PrefixCache` the longest
        cached prefix is restored from the cache instead of recomputed
        (chunked suffix prefill, the bit-identity contract of
        :meth:`prefill_cached`).  ``prefill_report`` records the admission's
        modeled seconds.
        """
        if self.row_active[bi]:
            raise RuntimeError(f"slot {bi} is busy; retire it first")
        if any(kind != "kv" for kind in self.layer_kinds):
            raise ValueError("admit_row requires attention-only models "
                             "(recurrent state has no per-row lifecycle)")
        tokens_np = np.asarray(tokens).reshape(-1).astype(np.int64)
        s = int(tokens_np.shape[0])
        if s < 1:
            raise ValueError("empty prompt")
        if s > self.cap_tokens:
            raise RuntimeError("prompt exceeds KV capacity; raise cfg.max_seq")
        w0 = self.obs.tracer.now_ns() if self.obs.enabled else 0
        t0 = time.perf_counter()
        self._free_row(bi)
        n_cached = 0
        k_pre = v_pre = None
        try:
            with self.accountant.track() as tr:
                if cache is not None and hasattr(self.model, "prefill_block_with_ctx"):
                    self._open_cache(cache)
                    n_cached, k_pre, v_pre = self._restore_prefix(cache, tokens_np, s)
                    if n_cached:
                        k_pre, v_pre = k_pre[:, None], v_pre[:, None]
                x = self._prefill_layers(tokens_np[None], s, n_cached, k_pre, v_pre, row=bi)
        except StorageFault:
            # failure atomicity: a half-admitted slot must not look decodeable
            self._free_row(bi)
            self.row_active[bi] = False
            raise
        self.row_seq[bi] = s
        self.row_valid[bi] = (s // self.cfg.group_size) * self.cfg.group_size
        self.row_active[bi] = True
        logits = self.model.logits(self.params, x[:, -1])[0]
        self._admission_report(s=s, n_cached=n_cached, tr=tr,
                               wall=time.perf_counter() - t0, wall_t0_ns=w0, row=bi)
        return logits

    def retire_row(self, bi: int) -> None:
        """End slot ``bi``'s request and free its reuse slots, rolling tail,
        disk extents and compressed-cache watermark."""
        self.row_active[bi] = False
        self._free_row(bi)

    def deactivate_row(self, bi: int) -> None:
        """Mask slot ``bi`` out of decoding without freeing its state."""
        self.row_active[bi] = False

    def reactivate_row(self, bi: int) -> None:
        """Undo :meth:`deactivate_row` on a slot holding a live request."""
        if self.row_seq[bi] == 0:
            raise RuntimeError(f"slot {bi} holds no request; admit one first")
        self.row_active[bi] = True

    def set_n_select(self, n: int) -> int:
        """Set the runtime critical-group budget, clamped to
        ``[1, cfg.n_select]`` (the degradation ladder's knob)."""
        self.n_select = max(1, min(int(n), self.cfg.n_select))
        return self.n_select

    def _free_row(self, bi: int) -> None:
        for mgr in self.managers:
            mgr.free_row(bi)
        self.store.free_row(bi)
        self.quality.clear_row(bi)
        self.row_seq[bi] = 0
        self.row_valid[bi] = 0

    def publish(self, cache, tokens: np.ndarray | Sequence[np.ndarray] | None = None,
                rows: Sequence[int] | None = None,
                save: bool = True) -> PublishResult:
        """Publish this request's KV into ``cache`` (end-of-request hook).

        ``tokens`` is the per-row served token history (prompt + every token
        fed to :meth:`decode_step`); it defaults to the prefill prompt, which
        is always safe — prompt KV was written by full-attention prefill, so
        later warm prefills restore exactly what a cold one would compute.
        Passing the full history also shares *generated* KV with follow-up
        turns (as decoded under sparse attention).

        Blocks are published root-first and deduplicated by content hash;
        returns a :class:`PublishResult` counting newly resident blocks.
        ``save=False`` defers the manifest write (the serving session saves
        once at drain instead of once per retirement).
        """
        if any(kind != "kv" for kind in self.layer_kinds):
            return PublishResult(0, {})
        if tokens is None:
            tokens = self._prompt_np
        if tokens is None:        # nothing prefilled yet → nothing to publish
            return PublishResult(0, {})
        g = self.cfg.group_size
        self._open_cache(cache)
        bt = cache.cfg.block_tokens
        nkv = len(self.kv_layers)
        hkv, hd = self.model.n_kv_heads, self.model.head_dim
        published = 0
        heads: dict[int, str | None] = {}
        bg = bt // g
        for bi in (rows if rows is not None else range(self.batch)):
            toks = np.asarray(tokens[bi]).reshape(-1)
            on_disk = int(self.store.n_groups[:, bi].min()) * g
            chain = chain_blocks(toks[:min(len(toks), on_disk)], bt)
            # resident blocks form rooted chains, so the missing blocks are
            # a contiguous suffix: touch the resident prefix, then read the
            # whole missing range as ONE sequential run per layer
            n_res = 0
            for blk in chain:
                if not cache.contains(blk.block_id):
                    break
                cache.touch(blk.block_id)
                n_res += 1
            missing = chain[n_res:]
            n_ok = n_res
            if missing:
                g0 = missing[0].index * bg
                ngr = len(missing) * bg
                k = np.empty((nkv, ngr, g, hkv, hd), dtype=self.cfg.np_dtype)
                v = np.empty_like(k)
                for j in range(nkv):
                    # retried like a decode fetch: a transient read error must
                    # not lose the chain at the finish line
                    k[j], v[j] = self.managers[j].read_run_with_retry(
                        bi, ReadRun(g0, ngr, tuple(range(g0, g0 + ngr))))
                for blk in missing:
                    off = blk.index * bg - g0
                    if not cache.put_block(blk, k[:, off:off + bg], v[:, off:off + bg]):
                        break   # budget exhausted by pinned blocks; keep the chain rooted
                    published += 1
                    n_ok += 1
            heads[int(bi)] = chain[n_ok - 1].block_id if n_ok else None
        if save:
            cache.save()
        return PublishResult(published, heads)

    # ------------------------------------------------------------------
    def decode_step(self, token_ids) -> torch.Tensor:
        """Decode one token per active row; returns logits ``[B, V]`` on the
        device (rows of inactive slots are garbage the caller ignores).

        ``token_ids`` is a ``[B]`` numpy array or tensor.  Sync and async
        modes, and the device-resident and host-gather paths, run the same
        numeric calls on the same inputs, so their tokens are bit-identical.
        """
        obs = self.obs
        on = obs.enabled
        if on:
            # the phase spans of this step: one lane a phase, the step's
            # index in their args (shared by every span of the step)
            tr = obs.tracer
            d0 = tr.now_ns()
            at = self._obs_at = {"step": len(self.step_log)}
        active = self.row_active.copy()
        n_active = int(active.sum())
        if n_active == 0:
            raise RuntimeError("no active rows (prefill or admit_row first)")
        if (self.row_seq[active] + 1 > self.cap_tokens).any():
            raise RuntimeError("KV capacity exceeded; raise cfg.max_seq")
        t0 = time.perf_counter()
        if self.device_resident:
            self._ensure_device_state()
        warm_bytes0 = self.accountant.warm_bytes
        self._h2d_step = 0
        self._step_active = active
        self.quality.begin_step()
        if on:
            t = tr.now_ns()
        b = self.batch
        if n_active == b:
            tok = torch.as_tensor(token_ids, device=self.device).reshape(b, 1)
        else:
            ids = token_ids.cpu().numpy() if torch.is_tensor(token_ids) else np.asarray(token_ids)
            tok = torch.as_tensor(np.where(active, ids.reshape(b), 0),
                                  device=self.device).reshape(b, 1)
        pos = torch.as_tensor(self.row_seq.astype(np.int32), device=self.device)
        x = self.model.embed(self.params, tok)[:, 0]
        valid = torch.as_tensor(self.row_valid.astype(np.int32), device=self.device)
        if on:
            tr.phase("embed", "embed", t, at)

        t_compute: list[float] = []
        t_io: list[float] = []
        flush_rows: list[tuple[int, int, torch.Tensor]] = []   # (layer, row, k_lr rows)
        try:
            if self.prefetcher is not None:
                x, io_wait = self._layers_async(x, pos, valid, t_compute, t_io, flush_rows)
            else:
                x, io_wait = self._layers_sync(x, pos, valid, t_compute, t_io, flush_rows)
        except BaseException:
            if self.slabs is not None:
                self.slabs.reclaim()   # the failed step's undelivered tables
            raise

        if on:
            t = tr.now_ns()
        for j, bi, rows in flush_rows:
            start = int(self.row_valid[bi])
            self.k_lr[j][bi, start:start + rows.shape[1]] = rows[0]
        for bi in {bi for _, bi, _ in flush_rows}:
            self.row_valid[bi] += self.cfg.group_size
        self.row_seq[active] += 1
        if on:
            t = tr.phase("flush", "flush", t, at)

        stats = StepStats()
        stats.io_seconds = sum(t_io)
        stats.compute_seconds = sum(t_compute)
        stats.pipelined_seconds = self._pipeline_latency(t_compute, t_io)
        snap = self.accountant.snapshot()
        stats.io_bytes = snap["read_bytes"]
        stats.io_requests = snap["read_requests"]
        stats.warm_bytes = snap["warm_bytes"] - warm_bytes0
        stats.io_wait_seconds = io_wait
        stats.h2d_bytes = self._h2d_step
        stats.active_rows = n_active
        qc = self.quality.finish_step()
        stats.pred_shared_groups = qc.shared_groups
        stats.pred_prev_groups = qc.prev_groups
        stats.pred_cur_groups = qc.cur_groups
        stats.stale_groups = qc.stale_groups
        stats.resident_groups = qc.resident_groups
        stats.wall_seconds = time.perf_counter() - t0
        self.step_log.append(stats)
        if on:
            t = tr.phase("stats", "stats", t, at)
        logits = self.model.logits(self.params, x)
        if on:
            tr.phase("logits", "logits", t, at)
            self._obs_step(stats, t_compute, t_io, d0)
        return logits

    def _obs_step(self, stats: StepStats, t_compute: Sequence[float],
                  t_io: Sequence[float], d0: int) -> None:
        """Decode-step spans on both clocks + per-step metrics: the wall
        span from ``d0``, the step's first reading, to now; the modeled
        lanes replay :meth:`_pipeline_latency`, so layer *i+1*'s I/O bar
        hides under layer *i*'s compute bar exactly as the model says."""
        obs = self.obs
        tr = obs.tracer
        t0, _ = obs.advance_model(stats.pipelined_seconds)
        tr.add("decode_step", "engine-step", cat="decode",
               wall_t0_ns=d0, wall_t1_ns=tr.now_ns(),
               model_t0=t0, model_dur=stats.pipelined_seconds,
               args={"step": self._obs_at["step"],
                     "active_rows": stats.active_rows,
                     "io_seconds": stats.io_seconds,
                     "compute_seconds": stats.compute_seconds,
                     "io_wait_seconds": stats.io_wait_seconds})
        L = len(t_compute)
        t = t0
        if t_io:
            if t_io[0] > 0:
                tr.add("io L0", "io", cat="io", model_t0=t, model_dur=t_io[0])
            t += t_io[0]
        for i in range(L):
            nxt = t_io[i + 1] if i + 1 < L else 0.0
            if t_compute[i] > 0:
                tr.add(f"compute L{i}", "compute", cat="compute",
                       model_t0=t, model_dur=t_compute[i])
            if nxt > 0:
                tr.add(f"io L{i + 1}", "io", cat="io", model_t0=t, model_dur=nxt)
            t += max(t_compute[i], nxt)
        self._m_steps.inc()
        self._m_tokens.inc(stats.active_rows)
        self._m_hist_pipe.observe(stats.pipelined_seconds)
        self._m_hist_wall.observe(stats.wall_seconds)

    def _reset_device_state(self) -> None:
        """Drop the device mirrors and tails (on re-prefill); the first
        decode step after rebuilds them from the fresh host state."""
        self._dev_ready = False
        for j in range(len(self.kv_layers)):
            self.reuse[j].device = None
            self._tail_k[j] = None
            self._tail_v[j] = None

    def _ensure_device_state(self) -> None:
        """Build the per-layer device mirrors at the first decode step: the
        reuse buffer's slot storage (usually empty) and the rolling tail the
        prefill seeded."""
        if self._dev_ready:
            return
        for j in range(len(self.kv_layers)):
            self.reuse[j].attach_device_mirror(self.device)
            # torch.tensor copies: the tail must never alias the host buffer
            self._tail_k[j] = torch.tensor(self.rolling[j].k, dtype=torch.float32,
                                           device=self.device)
            self._tail_v[j] = self._tail_k[j] if self.kv_planes == 1 else torch.tensor(
                self.rolling[j].v, dtype=torch.float32, device=self.device)
        self._dev_ready = True

    def layer_context(self, layer: int, bi: int) -> tuple[np.ndarray, np.ndarray, int]:
        """Row ``bi``'s K and V at model layer ``layer`` (a KV layer) before
        the decoding token's own, on the host as float32 ``[n, H_kv, d]``:
        the groups on disk, then the rolling tail; and the count of tokens
        on disk.  The disk is read without a charge to the accountant."""
        j, g = self._kv_index[layer], self.cfg.group_size
        n_disk = int(self.row_valid[bi]) // g * g
        k_disk, v_disk = self.store.peek_run(j, bi, 0, n_disk // g)
        fill = int(self.managers[j].rolling.fills[bi])
        if self.device_resident and self._dev_ready:
            k_tail, v_tail = (t[bi, :fill].cpu().numpy() for t in (self._tail_k[j], self._tail_v[j]))
        else:
            k_tail, v_tail = self.rolling[j].k[bi, :fill], self.rolling[j].v[bi, :fill]
        if n_disk + fill != int(self.row_seq[bi]):
            raise RuntimeError(f"row {bi}: {n_disk} tokens on disk + {fill} in the tail != "
                               f"{int(self.row_seq[bi])} seen")
        tail = k_disk.shape[-2:]
        k, v = (np.concatenate([a.reshape(n_disk, *tail), b]).astype(np.float32)
                for a, b in ((k_disk, k_tail), (v_disk, v_tail)))
        return k, v, n_disk

    # -- per-layer pieces shared by both modes --------------------------
    def _predict_for(self, layer: int, j: int, pred_src: torch.Tensor, pos: torch.Tensor,
                     valid: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """Score + select model layer ``layer``'s (KV layer ``j``'s) critical
        groups from ``pred_src``;
        the device ``(ids, mask)`` pair comes to the host in one transfer.
        Inactive rows are masked out on the host (they fetch nothing)."""
        obs = self.obs
        on = obs.enabled
        if on:
            tr, at = obs.tracer, self._obs_at
            t = tr.now_ns()
        q_pred = self.model.predict_query(self.params, layer, pred_src, pos)
        ids, mask = self._predict(j, q_pred, valid)
        pair = torch.cat([ids, mask.to(ids.dtype)], dim=1)
        if on:
            t = tr.phase("predict", f"predict L{layer}", t, at)
        pair = pair.cpu().numpy()
        if on:
            t = tr.phase("readback", f"readback L{layer}", t, at)
        m = ids.shape[1]
        ids, mask = pair[:, :m], pair[:, m:].astype(bool)
        masked = mask & self._step_active[:, None]
        self.quality.observe(layer, ids, masked, self.reuse[j])
        if on:
            tr.phase("quality", f"quality L{layer}", t, at)
        return ids, masked

    def _state_layer(self, layer: int, x: torch.Tensor, pos: torch.Tensor,
                     t_compute: list[float]) -> torch.Tensor:
        """One step of state layer ``layer``: no prediction, no fetch; the
        modeled clock charges a layer with no context."""
        x, self.states[layer] = self.model.decode_state_block(
            self.params, layer, x, pos, self.states[layer])
        t_compute.append(
            hardware.decode_layer_time(self.compute_spec, self.dims, n_ctx=0,
                                       batch=int(self._step_active.sum())))
        return x

    def _kv_layer(self, layer: int, j: int, x: torch.Tensor, pos: torch.Tensor, table,
                  t_compute: list[float], flush_rows: list) -> torch.Tensor:
        if self.layer_hook is not None:
            self.layer_hook(layer, x, pos, table)
        if self.device_resident:
            return self._kv_layer_device(layer, j, x, pos, table, t_compute, flush_rows)
        return self._kv_layer_host(layer, j, x, pos, table, t_compute, flush_rows)

    def _kv_layer_host(self, layer: int, j: int, x: torch.Tensor, pos: torch.Tensor,
                       table, t_compute: list[float], flush_rows: list) -> torch.Tensor:
        """Host-gather control path: host concat + full upload (phases
        ``upload``, ``block``, ``tail``: the new token's download and host
        append, ``spill``: the completed groups' compression)."""
        obs = self.obs
        on = obs.enabled
        if on:
            tr, at = obs.tracer, self._obs_at
            t = tr.now_ns()
        k_ctx, v_ctx, tok_mask, _ = self.managers[j].gather(table)
        k_dev = torch.from_numpy(k_ctx).to(self.device)
        v_dev = k_dev if self.kv_planes == 1 else torch.from_numpy(v_ctx).to(self.device)
        self._h2d_step += k_ctx.nbytes * self.kv_planes
        mask = torch.from_numpy(tok_mask).to(self.device)
        if on:
            t = tr.phase("upload", f"upload L{layer}", t, at)
        if self.kv_planes == 1:
            k_dev, v_dev = self._expand(layer, k_dev)
            if on:
                t = tr.phase("gather", f"expand L{layer}", t, at)
        x, k_new, v_new = self.model.decode_block(self.params, layer, x, pos, k_dev, v_dev,
                                                  mask)
        if on:
            t = tr.phase("block", f"block L{layer}", t, at)
        k_host = self._host(k_new)
        completed = self.managers[j].append_token_rows(
            k_host, k_host if self.kv_planes == 1 else self._host(v_new), self._step_active)
        if on:
            t = tr.phase("tail", f"tail L{layer}", t, at)
        for bi, k_g, _ in completed:
            # compress the completed group's keys exactly as stored on disk
            k_gj = torch.from_numpy(k_g[None]).to(self.device, torch.float32)
            self._h2d_step += k_gj.numel() * k_gj.element_size()
            flush_rows.append((j, bi, compress_k(k_gj, self.adapter)))
        if on:
            tr.phase("spill", f"spill L{layer}", t, at)
        self._charge_layer_compute(k_ctx.shape[1] + 1, t_compute)
        return x

    def _kv_layer_device(self, layer: int, j: int, x: torch.Tensor, pos: torch.Tensor,
                         table, t_compute: list[float], flush_rows: list) -> torch.Tensor:
        """Device-resident hot path: only fetch misses cross host→device.

        The fetch's upload slab reaches the device in one copy that also
        carries the table's addressing; the reuse mirror takes its groups in
        place, the context is gathered on the device by slot and the staged
        groups overwrite their rows; fresh ``k_new/v_new`` are written in
        place into the device rolling tail; a completed group is downloaded
        once to spill to disk and compressed from the device copy into
        ``k_lr``.
        """
        obs = self.obs
        on = obs.enabled
        if on:
            tr, at = obs.tracer, self._obs_at
            t = tr.now_ns()
        mgr = self.managers[j]
        up, h2d = mgr.sync_device(table)
        self._h2d_step += h2d
        if on:
            t = tr.phase("upload", f"upload L{layer}", t, at)
        mirror = self.reuse[j].device
        k_ctx, v_ctx, tok_mask = self.model.gather_context(
            mirror.k, mirror.v, up.slots, self._tail_k[j], self._tail_v[j], up.fill)
        if on:
            t = tr.phase("gather", f"gather L{layer}", t, at)
        # groups staged because the reuse buffer is pinned full (slots == -2)
        # overwrite their gathered rows in one index_put_ each of K and V
        if table.staged:
            up.put_staged(k_ctx, v_ctx)
            if on:
                t = tr.phase("upload", f"staged L{layer}", t, at)
        del up   # frees the copy's device buffer before the block allocates
        if self.kv_planes == 1:
            k_ctx, v_ctx = self._expand(layer, k_ctx)
            if on:
                t = tr.phase("gather", f"expand L{layer}", t, at)
        x, k_new, v_new = self.model.decode_block(
            self.params, layer, x, pos, k_ctx, v_ctx, tok_mask)
        if on:
            t = tr.phase("block", f"block L{layer}", t, at)
        # each active row's fresh token goes to its own tail position; rows
        # not decoding keep their tail contents
        act = np.flatnonzero(self._step_active)
        rows = torch.from_numpy(act).to(self.device)
        fidx = torch.from_numpy(mgr.rolling.fills[act]).to(self.device)
        self._tail_k[j][rows, fidx] = k_new[rows].float()
        if self.kv_planes == 2:
            self._tail_v[j][rows, fidx] = v_new[rows].float()
        if on:
            t = tr.phase("tail", f"tail L{layer}", t, at)
        for bi in mgr.rolling.advance_rows(self._step_active):
            # group complete: cast exactly as the host path stores it; one
            # download feeds the disk spill, k_lr compresses the device copy
            grp = torch.stack([self._tail_k[j][bi], self._tail_v[j][bi]][:self.kv_planes]
                              ).to(self._dtype)
            kv_np = grp.cpu().numpy()
            mgr.spill_group_row(bi, kv_np[0], kv_np[-1])
            flush_rows.append((j, bi, compress_k(grp[0][None].float(), self.adapter)))
        if on:
            tr.phase("spill", f"spill L{layer}", t, at)
        self._charge_layer_compute(k_ctx.shape[1] + 1, t_compute)
        return x

    def _expand(self, layer: int, rec_ctx: torch.Tensor):
        """An MLA layer's gathered records decompressed into its heads' K
        and V on the device (``model.expand_context``)."""
        if self.obs.enabled:
            self._m_expanded.inc(rec_ctx.shape[0] * rec_ctx.shape[1])
        return self.model.expand_context(self.params, layer, rec_ctx)

    def _charge_layer_compute(self, n_ctx: int, t_compute: list[float]) -> None:
        # only active rows charge modeled time (retired/empty slots are free)
        t_compute.append(
            hardware.decode_layer_time(
                self.compute_spec, self.dims, n_ctx=n_ctx,
                batch=int(self._step_active.sum()),
                rank=self.cfg.rank, n_lr_tokens=self.valid_tokens,
            )
        )

    # -- synchronous path ------------------------------------------------
    def _layers_sync(self, x, pos, valid, t_compute, t_io, flush_rows):
        """Predict + fetch inline, on the critical path."""
        io_wait = 0.0
        x_prev = x
        for layer in range(self.model.n_layers):
            if self.layer_kinds[layer] == "state":
                x_prev = x
                x = self._state_layer(layer, x, pos, t_compute)
                t_io.append(0.0)
                continue
            j = self._kv_index[layer]
            pred_src = x if (self.cfg.predict_from == "self" or layer == 0) else x_prev
            ids, mask = self._predict_for(layer, j, pred_src, pos, valid)
            on = self.obs.enabled
            if on:
                f0 = self.obs.tracer.now_ns()
            w0 = time.perf_counter()
            with self.accountant.track() as tr:
                table = self.managers[j].fetch(ids, mask)
            io_wait += time.perf_counter() - w0
            t_io.append(tr.read_seconds + tr.warm_seconds)
            if on:
                self.obs.tracer.add(
                    f"fetch L{layer}", "fetch", cat="fetch",
                    wall_t0_ns=f0, wall_t1_ns=self.obs.tracer.now_ns(),
                    args={"step": self._obs_at["step"],
                          "modeled_io_s": tr.read_seconds + tr.warm_seconds,
                          "read_bytes": tr.read_bytes,
                          "warm_bytes": tr.warm_bytes})
            x_prev = x
            x = self._kv_layer(layer, j, x, pos, table, t_compute, flush_rows)
        return x, io_wait

    # -- asynchronous pipeline (§3.3 / §3.4) ----------------------------
    def _layers_async(self, x, pos, valid, t_compute, t_io, flush_rows):
        """Issue layer *i+1*'s fetch as soon as its prediction source exists
        (``predict_from="prev"``: layer *i*'s input, in hand before layer *i*
        computes), so the host reads overlap the device compute.  The map
        is keyed by source layer: in a hybrid, a KV layer after a state
        layer is scored from that state layer's input."""
        issue_at: dict[int, list[int]] = {}
        for L in self.kv_layers:
            src = L if (self.cfg.predict_from == "self" or L == 0) else L - 1
            issue_at.setdefault(src, []).append(L)
        buf = DoubleBuffer(depth=2)
        io_wait = 0.0
        try:
            for layer in range(self.model.n_layers):
                # `x` is the input to `layer`: stage every KV layer whose
                # prediction source this is (the sync path's x_prev)
                for L in issue_at.get(layer, ()):
                    jj = self._kv_index[L]
                    ids, mask = self._predict_for(L, jj, x, pos, valid)
                    buf.stage(jj, self.prefetcher.submit(jj, ids, mask))
                if self.layer_kinds[layer] == "state":
                    x = self._state_layer(layer, x, pos, t_compute)
                    t_io.append(0.0)
                    continue
                j = self._kv_index[layer]
                on = self.obs.enabled
                if on:
                    f0 = self.obs.tracer.now_ns()
                w0 = time.perf_counter()
                res = buf.take(j)
                io_wait += time.perf_counter() - w0
                t_io.append(res.io_seconds)
                if on:
                    self.obs.tracer.add(
                        f"wait L{layer}", "wait", cat="wait",
                        wall_t0_ns=f0, wall_t1_ns=self.obs.tracer.now_ns(),
                        args={"step": self._obs_at["step"],
                              "modeled_io_s": res.io_seconds})
                x = self._kv_layer(layer, j, x, pos, res.table, t_compute, flush_rows)
        except BaseException:
            buf.drain()   # never leave staged futures behind on an error
            raise
        return x, io_wait

    def _predict(self, j: int, q_pred: torch.Tensor, valid: torch.Tensor):
        """Grouped critical-KV prediction against layer ``j``'s compressed K
        cache (kernel A on the card), returning device ``(ids, mask)``;
        ``valid [B]`` is each row's compressed-cache watermark."""
        return fused_predict(q_pred.float(), self._per_head_a, self.k_lr[j], valid,
                             group_size=self.cfg.group_size, n_select=self.n_select)

    @staticmethod
    def _pipeline_latency(t_compute: Sequence[float], t_io: Sequence[float]) -> float:
        """Layer-pipelined step latency: I/O for layer i+1 overlaps compute of
        layer i; layer 0's I/O is exposed (§3.3 'online prediction')."""
        L = len(t_compute)
        lat = t_io[0] if t_io else 0.0
        for i in range(L):
            nxt_io = t_io[i + 1] if i + 1 < L else 0.0
            lat += max(t_compute[i], nxt_io)
        return lat

    # ------------------------------------------------------------------
    def generate(self, prompt: np.ndarray, n_new: int, *, greedy: bool = True,
                 rng: np.random.Generator | None = None,
                 stop_ids: Sequence[int] = ()) -> np.ndarray:
        """Prefill + ``n_new`` decode steps.  Returns ``[B, n_new]`` tokens.

        Greedy ids stay on the device between steps and come to the host
        once at the end.  ``stop_ids``: a row that emits a stop token is
        deactivated on the spot (no further reads, no modeled time) and its
        remaining positions repeat the stop token; ``last_stop_mask``
        reports which rows stopped early.
        """
        from repro_torch.serving import sampling as _sampling

        logits = self.prefill(prompt)
        if greedy:
            sample = _sampling.greedy_device
        else:
            seed = 0 if rng is None else int(rng.integers(0, 2**31 - 1))
            sample = _sampling.make_sampler(seed=seed)
        stop_set = np.asarray(sorted({int(t) for t in stop_ids}), dtype=np.int64)
        stopped = np.zeros(self.batch, dtype=bool)
        self.last_stop_mask = stopped
        if not stop_set.size:   # fast path: greedy ids stay on the device
            out = []
            for _ in range(n_new):
                nxt = sample(logits)
                out.append(nxt)
                logits = self.decode_step(nxt)
            return torch.stack(out, dim=1).cpu().numpy() if greedy else np.stack(out, axis=1)
        stop_tok = np.zeros(self.batch, dtype=np.int64)
        toks: list[np.ndarray] = []
        for step in range(n_new):
            nxt = _sampling.greedy(logits) if greedy else sample(logits)
            nxt = nxt.astype(np.int64)
            nxt = np.where(stopped, stop_tok, nxt)         # frozen rows repeat
            newly = np.isin(nxt, stop_set) & ~stopped
            for bi in np.flatnonzero(newly):
                self.deactivate_row(bi)
            stop_tok = np.where(newly, nxt, stop_tok)
            stopped |= newly
            toks.append(nxt)
            if stopped.all():
                toks.extend([stop_tok.copy()] * (n_new - step - 1))
                break
            if step + 1 < n_new:
                logits = self.decode_step(nxt)
        self.last_stop_mask = stopped
        return np.stack(toks, axis=1)

    def reuse_ratio(self) -> float:
        hits = sum(r.stats.hits for r in self.reuse)
        miss = sum(r.stats.misses for r in self.reuse)
        return hits / max(hits + miss, 1)

    def simulated_throughput(self, skip: int = 1) -> float:
        """Tokens/s under the modeled Jetson+disk pipeline (batch tokens)."""
        steps = self.step_log[skip:] or self.step_log
        if not steps:
            return 0.0
        t = sum(s.pipelined_seconds for s in steps) / len(steps)
        return self.batch / t if t > 0 else 0.0

    def overlap_report(self, skip: int = 1) -> dict:
        """Mean per-step modeled + measured overlap (serving)."""
        return summarize_steps(self.step_log[skip:] or self.step_log)

    def close(self):
        if self.prefetcher is not None:
            self.prefetcher.close()
            self.prefetcher = None
        self.store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
