"""PyTorch/CUDA port of nvse_tpu for NVIDIA Hopper (H100).

The JAX package `nvse_tpu` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of the host-side code
it needs. Every TPU kernel on a ported path is a hand-written CUDA
kernel under `csrc/`; plain tensor code is PyTorch.

Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve `device` for an entry point; never falls back to the CPU.

    A CUDA device without a visible GPU raises. Disables TF32 for
    matmuls and cuDNN: the JAX DSP runs its feature matmuls at HIGHEST
    precision (nvse_tpu/ops/spectral.py), and TF32 keeps only ~3
    decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA GPU is visible; "
                "pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
