"""The port's one place that decides which device a run uses.

Every entry point (engine, serving session, ``init_params``, the weight
bridge) takes ``device=None`` and hands it to :func:`resolve`: ``None``
means the CUDA card, and a host without one raises instead of quietly
running on the CPU.  Tests ask for the CPU explicitly (``device="cpu"``).

Kernels choose by the tensor they are given, not by a flag: a CUDA tensor
launches the hand-written kernel, a CPU tensor takes its plain PyTorch
version (:mod:`repro_torch.kernels.ops`).
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else as given.

    Also turns TF32 off for matrix products and cuDNN, so fp32 results on
    the card compare with fp32 on the CPU (both flags are process-wide).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:   # "cuda" and "cuda:0" must compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
