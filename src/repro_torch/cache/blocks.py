"""Hash-chained token blocks: the unit of cross-request KV sharing.

A *block* is ``block_tokens`` consecutive prompt tokens (a whole number of
KV groups, so a block maps to a contiguous group range in the disk layout).
Blocks are **content-addressed along the chain**::

    block_id = H(parent_id, block_tokens)

so a block's identity pins down the *entire prefix* up to and including it —
two requests share a cached block iff their prompts agree token-for-token up
to that point.  This is the LMCache / vLLM prefix-caching identity scheme,
applied to KVSwap's disk tier.

Lookup walks the chain from the root and stops at the first miss, which is
exactly longest-prefix match; eviction anywhere in a chain merely truncates
the reusable prefix (see :mod:`repro.cache.policy` for why whole suffixes
are evicted together).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

#: parent id of the first block of every chain.
ROOT_ID = "root"


def block_id(parent_id: str, tokens: np.ndarray) -> str:
    """Content hash chaining ``tokens`` onto ``parent_id``.

    Tokens are canonicalized to int64 bytes so the id is dtype-independent
    (the serving stack mixes int32 prompts with int64 sampled tokens).
    """
    h = hashlib.sha256()
    h.update(parent_id.encode("ascii"))
    h.update(np.ascontiguousarray(tokens, dtype=np.int64).tobytes())
    return h.hexdigest()[:32]


@dataclasses.dataclass(frozen=True)
class TokenBlock:
    """One link of a chain: identity + the tokens it covers."""

    block_id: str
    parent_id: str
    tokens: np.ndarray          # [block_tokens] int64
    index: int                  # position in the chain (0 = first block)

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])


def chain_blocks(tokens: np.ndarray, block_tokens: int) -> list[TokenBlock]:
    """Chunk a token sequence into its chain of full blocks.

    Only *full* blocks are chained — the tail ``len(tokens) % block_tokens``
    is never cached (mirroring the rolling buffer's treatment of partial
    groups).
    """
    if block_tokens <= 0:
        raise ValueError(f"block_tokens must be positive, got {block_tokens}")
    toks = np.ascontiguousarray(np.asarray(tokens).reshape(-1), dtype=np.int64)
    out: list[TokenBlock] = []
    parent = ROOT_ID
    for i in range(len(toks) // block_tokens):
        blk = toks[i * block_tokens : (i + 1) * block_tokens]
        bid = block_id(parent, blk)
        out.append(TokenBlock(block_id=bid, parent_id=parent, tokens=blk, index=i))
        parent = bid
    return out
