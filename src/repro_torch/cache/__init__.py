"""Content-addressed token blocks (the prefix cache's keys).

The prefix cache itself comes with a later slice of the port.
"""

from repro_torch.cache.blocks import ROOT_ID, TokenBlock, block_id, chain_blocks

__all__ = ["ROOT_ID", "TokenBlock", "block_id", "chain_blocks"]
