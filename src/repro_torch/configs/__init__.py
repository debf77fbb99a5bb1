"""Model configurations of the port: Llama-3.1-8B, Qwen3-8B and Zamba2-1.2B,
each with ``config()`` (published widths) and ``smoke_config()``
(CPU-sized); :mod:`.registry` maps the reference's ``--arch`` names to them."""
