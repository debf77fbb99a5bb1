"""Hand-written CUDA kernels (``csrc/*.cu``, ``sm_90a``): the decode path's
group scoring and flash-decode, and the Mamba2 prefill's SSD term;
their plain PyTorch versions and launch counts (:mod:`.ops`), and the
kernel-backed predictor (:mod:`.fused_predict`)."""
