"""Device resolution for the port's entry points.

Every entry point (``build_model``, ``DONN``, ``freeze``,
``InferenceEngine``, the serving CLI) runs on the CUDA card unless the
caller names another device.  Without a card, asking for the default
raises: nothing carries on silently on the CPU.  The CPU exists for the
tests, which pass ``device="cpu"`` and run the kernels' plain versions.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run its plain PyTorch path"
            )
        if dev.index is None:  # "cuda" and "cuda:0" name one card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
