"""Data pipeline: synthetic LM streams and needle-retrieval tasks (numpy
only; the reference's module, copied, so that one seed gives the same
arrays in both packages).

No external datasets are available offline, so the pipeline provides:

* :class:`SyntheticLMStream` — an infinite, seeded, Markov-ish token stream
  with learnable structure (n-gram transitions + copy motifs) for the
  training examples; deterministic per (seed, step) so restarts resume
  exactly (checkpointable input pipeline).
* :class:`NeedleTask` — Needle-in-a-Haystack-style prompts (paper Fig. 9):
  a key token sequence is planted at a controlled depth inside filler; the
  quality benchmarks check whether the KVSwap predictor keeps the needle's
  KV entries among the selected groups.
* ``calib_k_cache`` — calibration K-cache sampler for the offline SVD
  (paper App. A.1 uses C4/WikiText samples; here: the model's own K outputs
  on synthetic text, which is what the adapter actually needs to span).
"""

from __future__ import annotations

import dataclasses

import numpy as np


class SyntheticLMStream:
    """Seeded synthetic token stream with low-order structure."""

    def __init__(self, vocab_size: int, *, seed: int = 0, order: int = 1,
                 copy_prob: float = 0.1):
        self.vocab = vocab_size
        self.seed = seed
        self.order = order
        self.copy_prob = copy_prob
        rng = np.random.default_rng(seed)
        # sparse transition preference: each context hash prefers a few tokens
        self._pref = rng.integers(0, vocab_size, size=(4096, 4))

    def batch(self, step: int, batch: int, seq_len: int) -> dict:
        """Deterministic batch for a given step: {tokens, targets}."""
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((batch, seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(1, seq_len + 1):
            if self.order <= 1:
                h = toks[:, t - 1].astype(np.int64) % 4096
            else:  # higher-order: mix the previous `order` tokens
                lo = max(0, t - self.order)
                h = np.zeros(batch, dtype=np.int64)
                for j in range(lo, t):
                    h = (h * 31 + toks[:, j]) % 4096
            choice = rng.integers(0, 4, size=batch)
            structured = self._pref[h, choice]
            random_tok = rng.integers(0, self.vocab, size=batch)
            use_struct = rng.random(batch) < 0.7
            toks[:, t] = np.where(use_struct, structured, random_tok)
            # occasional copy motif: repeat a token from 8 back
            if t > 8:
                copy = rng.random(batch) < self.copy_prob
                toks[:, t] = np.where(copy, toks[:, t - 8], toks[:, t])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class NeedleTask:
    """A planted-needle prompt and its bookkeeping."""

    tokens: np.ndarray      # [seq]
    needle_start: int
    needle_len: int
    query_start: int

    @property
    def needle_span(self) -> range:
        return range(self.needle_start, self.needle_start + self.needle_len)


def make_needle_prompt(vocab_size: int, seq_len: int, *, depth: float = 0.5,
                       needle_len: int = 8, seed: int = 0) -> NeedleTask:
    """Build a haystack with a needle at relative ``depth`` and a query that
    repeats the needle's prefix at the end (an induction-style retrieval
    pattern that a correct KV-selection must serve)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab_size, size=seq_len).astype(np.int32)
    start = int(depth * (seq_len - 2 * needle_len - 4))
    needle = rng.integers(0, vocab_size, size=needle_len).astype(np.int32)
    toks[start : start + needle_len] = needle
    qstart = seq_len - needle_len
    toks[qstart:] = needle  # query repeats the needle (induction head target)
    return NeedleTask(tokens=toks, needle_start=start, needle_len=needle_len,
                      query_start=qstart)


def calib_k_cache(model_forward_k, tokens: np.ndarray) -> np.ndarray:
    """Collect a calibration K cache by running the model's K projections
    over sample tokens.  ``model_forward_k(tokens) -> [B, S, H_k, d]`` (an
    array or a tensor on any device)."""
    k = model_forward_k(tokens)
    k = k.detach().cpu().numpy() if hasattr(k, "detach") else np.asarray(k)
    return k.reshape(-1, k.shape[-2], k.shape[-1])
