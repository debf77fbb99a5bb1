"""KVSwap in PyTorch for one NVIDIA H100 (the port of :mod:`repro`).

The JAX package ``repro`` is the reference; this package imports nothing of
it (not even its numpy-only host modules — it keeps its own copies) and
never imports JAX.  The decode path's two TPU kernels are hand-written CUDA
kernels for ``sm_90a`` (:mod:`repro_torch.kernels`).

Entry points take ``device=None``, which means the CUDA card
(:func:`repro_torch.device.resolve`); pass ``device="cpu"`` to run on the
CPU, where every kernel uses its plain PyTorch version.
"""
