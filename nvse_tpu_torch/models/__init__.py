"""Model registry of the port.

`build_generator(h)` returns `(module, domain)` like the JAX package's
registry (nvse_tpu/models/__init__.py): all ten of its generators, the BSRNN
family, GCRN and the conv T-F vocoders APNet, APNet2, FreeV and Vocos (T-F
domain), HiFiGAN, iSTFTNet, ConvTasNet and HD-Demucs (time domain); any
other `model_name` raises and lists them. BSRNN_24k is registered "tf"
as in the JAX package, but it takes a log-spectrum and trains only in the
joint domain (train/loop_joint.py).
"""
from __future__ import annotations

import torch

from .apnet import APNet, APNet2, FreeV
from .bsrnn import BSRNN, BSRNN_24k
from .convtasnet import ConvTasNet
from .gcrn import GCRN
from .hddemucas import HDDemucas
from .hifigan import HiFiGAN
from .istftnet import ISTFTNet
from .vocos import Vocos

# name -> (factory, domain); names match the reference cfgs' model_name
_REGISTRY: dict = {
    "APNet": (APNet, "tf"),
    "APNet2": (APNet2, "tf"),
    "FreeV": (FreeV, "tf"),
    "BSRNN": (BSRNN, "tf"),
    "BSRNN_24k": (BSRNN_24k, "tf"),
    "GCRN": (GCRN, "tf"),
    "HiFiGAN": (HiFiGAN, "time"),
    "iSTFTNet": (ISTFTNet, "time"),
    "ConvTasNet": (ConvTasNet, "time"),
    "HDDemucas": (HDDemucas, "time"),
    "Vocos": (Vocos, "tf"),
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
