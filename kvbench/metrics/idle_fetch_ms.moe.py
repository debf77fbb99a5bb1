"""``idle_fetch_ms``, read per layer in a cell whose host loop drifts too far from
run to run for it to stand as an end-to-end metric there (PERF.md §2)."""

from kvbench.bench import reader

read = reader("idle_fetch_ms")
