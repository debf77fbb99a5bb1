"""Model configurations of this slice: Llama-3.1-8B and Qwen3-8B, each with
``config()`` (published widths) and ``smoke_config()`` (CPU-sized)."""
