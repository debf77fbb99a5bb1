"""Model configurations of the port, each with ``config()`` (published
widths) and ``smoke_config()`` (CPU-sized): the dense Llama-3.1-8B,
Qwen3-8B, Qwen3-32B, StableLM-2-12B, Granite-8B and Chameleon-34B, the MoE
OLMoE-1B-7B and Llama-4-Maverick, and the hybrid Zamba2-1.2B;
:mod:`.registry` maps the reference's ``--arch`` names to them."""
