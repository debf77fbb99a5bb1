"""KVTier protocol conformance of the port's tiers: one harness, every tier.

The cases of ``tests/test_tiers_conformance.py``, run over the port's own
copies (:mod:`repro_torch.tiers`, :mod:`repro_torch.cache`,
:mod:`repro_torch.core.offload`), which import nothing of ``repro``.

The tier-chain refactor only works if every tier actually honors the
shared verbs — ``lookup`` is a side-effect-free resident check,
``admit``-then-``lookup``/``serve`` round-trips the payload,
``invalidate`` makes a rewrite win, and ``free_row`` clears the row's
byte accounting.  This suite runs the same scenario against
:class:`~repro_torch.tiers.WarmTier`, :class:`~repro_torch.tiers.DiskTier` and
:class:`~repro_torch.tiers.PrefixTier`, each over its real backing store —
no mocks, so a drift between a tier and its store fails here before it
can corrupt the fetch chain.

Tier-specific admission rules the harness honors:

* the disk tier is append-only (``gid`` must be the row watermark) and
  its rewrite path is truncate-then-reappend;
* the prefix tier stages group payloads and only publishes whole blocks
  (all layers x ``block_tokens`` worth), so the harness admits a full
  block's worth of groups across every layer;
* the warm tier is an exclusive victim cache: a served hit pops the
  entry (serve-after-serve misses) — the harness asserts the *first*
  serve, then re-admits.
"""

import numpy as np
import pytest

from repro_torch.cache import PrefixCache, PrefixCacheConfig
from repro_torch.core.offload import NVME, IOAccountant, KVDiskStore
from repro_torch.tiers import DiskTier, KVTier, PrefixTier, WarmTier

N_LAYERS, G, HKV, D = 2, 4, 2, 8
BLOCK_TOKENS = 8                       # 2 groups per block
BG = BLOCK_TOKENS // G
DTYPE = np.float32


def group_payload(rng, seed_shift=0):
    rng = np.random.default_rng(rng if isinstance(rng, int) else None)
    return rng.standard_normal((G, 2, HKV, D)).astype(DTYPE) + seed_shift


class _Harness:
    """One tier + the bookkeeping the parametrized tests share."""

    name = "base"
    exclusive_serve = False            # serve pops the entry (warm tier)
    lossy = False                      # int8 round trip (warm tier)
    authoritative = False              # serve_run must only see resident gids

    def assert_served(self, got, want):
        # lossy tiers round-trip within one int8 quantization step of the
        # group's max-scaled payload; everything else is exact
        atol = float(np.abs(want).max()) / 127.0 if self.lossy else 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)

    def make(self):
        raise NotImplementedError

    def close(self):
        pass

    def admit_row_groups(self, tier, row, payloads):
        """Admit ``{gid: kv}`` for every layer, per tier admission rules."""
        for layer in range(N_LAYERS):
            for gid in sorted(payloads):
                assert tier.admit(layer, row, gid, payloads[gid],
                                  scale=None, disk_nbytes=None)


class _WarmHarness(_Harness):
    name = "warm"
    exclusive_serve = True
    lossy = True

    def make(self):
        return WarmTier(budget_bytes=1 << 20, accountant=IOAccountant(NVME))

    def admit_row_groups(self, tier, row, payloads):
        for layer in range(N_LAYERS):
            for gid in sorted(payloads):
                assert tier.admit(layer, row, gid, payloads[gid],
                                  scale=None, disk_nbytes=payloads[gid].nbytes)


class _DiskHarness(_Harness):
    name = "disk"
    authoritative = True

    def make(self):
        self.store = KVDiskStore(n_layers=N_LAYERS, batch=2, max_groups=8,
                                 group_size=G, n_kv_heads=HKV, head_dim=D,
                                 dtype=DTYPE, accountant=IOAccountant(NVME))
        return DiskTier(store=self.store, layer=0)

    def close(self):
        self.store.close()


class _PrefixHarness(_Harness):
    name = "prefix"

    def make(self):
        self.cache = PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS))
        self.cache.open(n_layers=N_LAYERS, group_size=G, n_kv_heads=HKV,
                        head_dim=D, dtype=DTYPE)
        tier = PrefixTier(self.cache)
        self.tokens = np.arange(4 * BLOCK_TOKENS, dtype=np.int64)
        tier.bind_row(0, self.tokens)
        tier.bind_row(1, self.tokens[::-1].copy())
        return tier

    def close(self):
        self.cache.close()


HARNESSES = [_WarmHarness, _DiskHarness, _PrefixHarness]


@pytest.fixture(params=HARNESSES, ids=lambda h: h.name)
def harness(request):
    h = request.param()
    h.tier = h.make()
    yield h
    h.close()


def full_block(seed_shift=0.0):
    """gid -> payload for one whole block (the prefix tier's publish unit)."""
    rng = np.random.default_rng(7)
    return {gid: rng.standard_normal((G, 2, HKV, D)).astype(DTYPE)
            + seed_shift for gid in range(BG)}


class TestKVTierConformance:
    def test_is_a_kvtier(self, harness):
        assert isinstance(harness.tier, KVTier)
        assert harness.tier.name == harness.name

    def test_lookup_empty_is_miss_and_side_effect_free(self, harness):
        t = harness.tier
        assert t.lookup(0, 0, [0, 1, 2]) == []
        assert t.row_bytes(0) == 0

    def test_lookup_after_admit(self, harness):
        t = harness.tier
        payloads = full_block()
        harness.admit_row_groups(t, 0, payloads)
        gids = sorted(payloads)
        assert t.lookup(0, 0, gids + [17]) == gids
        # lookup is read-only: asking twice answers twice
        assert t.lookup(0, 0, gids) == gids
        # the other row is untouched
        if harness.name != "prefix":    # prefix rows share content identity
            assert t.lookup(0, 1, gids) == []

    def test_serve_round_trips_payload(self, harness):
        t = harness.tier
        payloads = full_block()
        harness.admit_row_groups(t, 0, payloads)
        for gid, want in payloads.items():
            got = t.serve(N_LAYERS - 1, 0, gid, DTYPE)
            assert got is not None and got.shape == (G, 2, HKV, D)
            harness.assert_served(got, want)
            if harness.exclusive_serve:     # victim cache: pop on hit
                assert t.serve(N_LAYERS - 1, 0, gid, DTYPE) is None
                assert t.admit(N_LAYERS - 1, 0, gid, want, scale=None,
                               disk_nbytes=want.nbytes)

    def test_serve_run_partitions_hits_and_residue(self, harness):
        t = harness.tier
        payloads = full_block()
        harness.admit_row_groups(t, 0, payloads)
        gids = sorted(payloads)
        if harness.authoritative:
            # the disk tier is the end of the chain: a group past the
            # watermark escalates (FetchFailed) rather than passing as
            # residue, so the chain walker only offers lookup-filtered
            # gids — mirror that here
            served, residue = t.serve_run(0, 0, gids, DTYPE)
            assert residue == []
        else:
            served, residue = t.serve_run(0, 0, gids + [29], DTYPE)
            assert residue == [29]
        assert [g for g, _ in served] == gids
        for gid, got in served:
            harness.assert_served(got, payloads[gid])

    def test_invalidate_then_rewrite_wins(self, harness):
        t = harness.tier
        old = full_block(0.0)
        harness.admit_row_groups(t, 0, old)
        for layer in range(N_LAYERS):
            for gid in sorted(old):
                t.invalidate(layer, 0, gid)
        assert t.lookup(0, 0, sorted(old)) == []
        new = full_block(1.0)
        harness.admit_row_groups(t, 0, new)
        got = t.serve(0, 0, 0, DTYPE)
        harness.assert_served(got, new[0])

    def test_free_row_clears_accounting(self, harness):
        t = harness.tier
        harness.admit_row_groups(t, 0, full_block())
        if harness.name != "prefix":
            # published prefix blocks are shared cache property, not row
            # bytes — the staged-bytes case is covered separately below
            assert t.row_bytes(0) > 0
        t.free_row(0)
        assert t.row_bytes(0) == 0
        assert t.lookup(0, 0, [0, 1]) == []


class TestPrefixTierSpecifics:
    """The content-addressed reconciliation the shared harness can't see."""

    @pytest.fixture()
    def ptier(self):
        h = _PrefixHarness()
        h.tier = h.make()
        yield h
        h.close()

    def test_partial_block_stays_staged(self, ptier):
        t, cache = ptier.tier, ptier.cache
        kv = group_payload(3)
        # one group of one layer: not publishable yet
        assert t.admit(0, 0, 0, kv)
        assert t.row_bytes(0) == kv.nbytes
        assert cache.resident_blocks() == 0
        # completing the block across layers + groups publishes and
        # drains the staging
        for layer in range(N_LAYERS):
            for gid in range(BG):
                if (layer, gid) != (0, 0):
                    assert t.admit(layer, 0, gid, kv)
        assert cache.resident_blocks() == 1
        assert t.row_bytes(0) == 0

    def test_rows_share_published_content(self, ptier):
        """Two rows bound to the same tokens see the same blocks — the
        disagg handoff's whole premise (prefill row publishes, decode row
        finds)."""
        t = ptier.tier
        t.bind_row(5, ptier.tokens)
        kv = group_payload(4)
        for layer in range(N_LAYERS):
            for gid in range(BG):
                assert t.admit(layer, 0, gid, kv)
        assert t.lookup(0, 5, [0, 1]) == [0, 1]
        got = t.serve(1, 5, 1, DTYPE)
        np.testing.assert_allclose(got, kv, rtol=0, atol=1e-6)

    def test_admit_declines_beyond_full_blocks(self, ptier):
        t = ptier.tier
        t.bind_row(7, np.arange(BLOCK_TOKENS + 3, dtype=np.int64))
        assert t.admit(0, 7, 0, group_payload(5))         # block 0: ok
        assert not t.admit(0, 7, BG, group_payload(5))    # tail: declined

    def test_unbound_row_misses_and_declines(self, ptier):
        t = ptier.tier
        assert t.lookup(0, 9, [0]) == []
        assert not t.admit(0, 9, 0, group_payload(6))
        assert t.serve(0, 9, 0, DTYPE) is None
