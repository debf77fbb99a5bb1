"""``itl_p90_ms``, read per layer in the latent-attention cell, where its
spread over six seeds reaches half its end-to-end bound (PERF.md §6)."""

from kvbench.bench import reader

read = reader("itl_p90_ms")
