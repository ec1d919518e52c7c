"""Model registry of the port.

`build_generator(h)` returns `(module, domain)` like the JAX package's
registry (nvse_tpu/models/__init__.py). The BSRNN family, GCRN (T-F
domain), ConvTasNet and HD-Demucs (time domain) are ported so far; any
other `model_name` raises and lists what is. BSRNN_24k is registered "tf"
as in the JAX package, but it takes a log-spectrum and trains only in the
joint domain (train/loop_joint.py).
"""
from __future__ import annotations

import torch

from .bsrnn import BSRNN, BSRNN_24k
from .convtasnet import ConvTasNet
from .gcrn import GCRN
from .hddemucas import HDDemucas

# name -> (factory, domain); names match the reference cfgs' model_name
_REGISTRY: dict = {
    "BSRNN": (BSRNN, "tf"),
    "BSRNN_24k": (BSRNN_24k, "tf"),
    "GCRN": (GCRN, "tf"),
    "ConvTasNet": (ConvTasNet, "time"),
    "HDDemucas": (HDDemucas, "time"),
}


def model_input_bins(h) -> int:
    """Feature rows the generator consumes: mel bins, or the one-sided
    spectrum for BSRNN_24k's log-spectrum input."""
    return h.n_fft // 2 + 1 if h.model_name == "BSRNN_24k" else h.num_mels


def build_generator(h, gen: torch.Generator | None = None):
    """Construct the generator named by h.model_name with random weights
    drawn from `gen` (default: a CPU generator seeded with h.seed)."""
    try:
        factory, domain = _REGISTRY[h.model_name]
    except KeyError:
        raise NotImplementedError(
            f"model {h.model_name!r} is not ported to PyTorch yet; "
            f"ported: {sorted(_REGISTRY)}") from None
    if gen is None:
        gen = torch.Generator().manual_seed(int(h.get("seed", 1234)))
    return factory(h, gen), domain
