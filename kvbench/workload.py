"""The one traffic generator: it reads a mix's parameters
(``kvbench/traffic/<mix>.json``) and the seed, and nothing else.

``closed_loop_documents``: ``slots`` clients each keep one document
decoding; the documents come in groups of ``slots``, each group a
seed-drawn permutation of the lengths ``doc_tokens``, so every seed runs
the same set of sizes in another order.  Token ids are uniform over the
vocabulary.  Every document asks for ``decode_tokens`` greedy tokens.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

KINDS = ("closed_loop_documents",)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, stream])


def documents(mix: dict, seed: int, vocab: int) -> Iterator[np.ndarray]:
    """The mix's documents, in the order the clients take them."""
    if mix["kind"] not in KINDS:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}; known: {KINDS}")
    rng = _rng(seed, 0)
    lengths = np.asarray(mix["doc_tokens"])
    while True:
        for n in rng.permutation(np.resize(lengths, max(len(lengths), mix["slots"]))):
            yield rng.integers(0, vocab, int(n), dtype=np.int64)


def calibration(seed: int, vocab: int, n_tokens: int) -> np.ndarray:
    """The calibration prompt the low-rank adapter is fitted on."""
    return _rng(seed, 1).integers(0, vocab, n_tokens, dtype=np.int64)
