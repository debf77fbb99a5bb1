"""Hand-written CUDA kernels of the decode path (``csrc/*.cu``, ``sm_90a``),
their plain PyTorch versions and launch counts (:mod:`.ops`), and the
kernel-backed predictor (:mod:`.fused_predict`)."""
