"""Small shared helpers (order statistics, byte sizes, tree sizes)."""

from repro_torch.utils.bytesize import GiB, KiB, MiB, fmt_bytes
from repro_torch.utils.stats import percentile, percentiles
from repro_torch.utils.treeops import tree_bytes, tree_count

__all__ = ["fmt_bytes", "GiB", "MiB", "KiB", "percentile", "percentiles",
           "tree_bytes", "tree_count"]
