"""CREPE pitch and periodicity on the card, fed by torchcrepe checkpoints.

Counterpart of nvse_tpu/metrics/crepe_jax.py. The reference scores
Periodicity / Pitch-RMSE / V-UV F1 with cargan + torchcrepe (reference
Metrics/evaluate.py:35-76): CREPE 'full' on 16 kHz audio at 10 ms hops,
pitch decoded from the 360 cent-bin posterior, periodicity the posterior
at the decoded bin. The network here is an nn.Module whose state_dict has
torchcrepe's names (conv{i}.weight (O, I, k, 1), conv{i}.bias,
conv{i}_BN.{weight, bias, running_mean, running_var}, classifier.*), so the
public `torchcrepe/assets/full.pth` (or tiny.pth) loads as it is
(`load_crepe`). Without a checkpoint, dsp.periodicity_metrics keeps its
YIN stand-in.

Architecture (torchcrepe/model.py): six blocks of [pad -> (k, 1) conv ->
ReLU -> BatchNorm (eval, eps _BN_EPS) -> MaxPool (2, 1)] over frames of 1024
samples, then Linear(in_features, 360) + sigmoid. 'full': channels
1024/128/128/128/256/512, first kernel 512 at stride 4 padded (254, 254),
the rest 64 at stride 1 padded (31, 32); in_features 2048. 'tiny':
channels / 8, in_features 256. The (k, 1) 2-D convs run as F.conv1d
(cuDNN on the card). Host framing, per-frame normalisation and the
weighted-argmax decoder are numpy, as in the JAX package.

Bin -> cents: cents(b) = 20 b + 1997.3794084376191, f = 10 * 2 ** (cents /
1200) (torchcrepe/convert.py).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

__all__ = ["Crepe", "load_crepe", "predict_f0_periodicity", "CENTS_OFFSET",
           "CENTS_PER_BIN", "PITCH_BINS"]

PITCH_BINS = 360
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191
WINDOW = 1024
SAMPLE_RATE = 16000
HOP = 160  # 10 ms
_BN_EPS = 0.0010000000474974513  # torchcrepe's batch_norm_fn eps
_PADS = [(254, 254)] + [(31, 32)] * 5
_STRIDES = [4] + [1] * 5


def _spec(model: str):
    if model == "full":
        return [1024, 128, 128, 128, 256, 512], 2048
    if model == "tiny":
        return [128, 16, 16, 16, 32, 64], 256
    raise ValueError(f"unknown CREPE capacity {model!r}")


class _Conv(nn.Module):
    """A (k, 1) Conv2d's parameters in torchcrepe's shapes, run as F.conv1d."""

    def __init__(self, cin: int, cout: int, k: int, gen: torch.Generator):
        super().__init__()
        bound = 1.0 / np.sqrt(cin * k)
        self.weight = nn.Parameter(torch.empty(cout, cin, k, 1).uniform_(-bound, bound,
                                                                          generator=gen))
        self.bias = nn.Parameter(torch.empty(cout).uniform_(-bound, bound, generator=gen))


class _BatchNorm(nn.Module):
    """BatchNorm in eval mode: affine weight / bias, running mean / var (seeded
    draws around the identity until a checkpoint is loaded)."""

    def __init__(self, c: int, gen: torch.Generator):
        super().__init__()
        def draw(lo, hi):
            return torch.empty(c).uniform_(lo, hi, generator=gen)
        self.weight = nn.Parameter(draw(0.5, 1.5))
        self.bias = nn.Parameter(draw(-0.1, 0.1))
        self.register_buffer("running_mean", draw(-0.1, 0.1))
        self.register_buffer("running_var", draw(0.5, 1.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + _BN_EPS)
        return ((x - self.running_mean[:, None]) * inv[:, None] * self.weight[:, None]
                + self.bias[:, None])


class Crepe(nn.Module):
    """CREPE of capacity `model` ('full' or 'tiny'): (B, 1024) normalised
    frames -> (B, 360) bin posteriors. Weights are random from `seed` (convs
    and classifier U(+-1/sqrt(fan_in)), BatchNorm near the identity) until a
    checkpoint is loaded: a seeded network's state_dict is a checkpoint in
    torchcrepe's layout."""

    def __init__(self, model: str = "full", seed: int = 0):
        super().__init__()
        out_ch, in_feats = _spec(model)
        self.model = model
        gen = torch.Generator().manual_seed(seed)
        cin = 1
        for i, cout in enumerate(out_ch, start=1):
            setattr(self, f"conv{i}", _Conv(cin, cout, 512 if i == 1 else 64, gen))
            setattr(self, f"conv{i}_BN", _BatchNorm(cout, gen))
            cin = cout
        self.classifier = nn.Linear(in_feats, PITCH_BINS)
        bound = 1.0 / np.sqrt(in_feats)
        with torch.no_grad():
            self.classifier.weight.uniform_(-bound, bound, generator=gen)
            self.classifier.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames[:, None, :]
        for i in range(1, 7):
            conv = getattr(self, f"conv{i}")
            x = F.conv1d(F.pad(x, _PADS[i - 1]), conv.weight[..., 0], conv.bias,
                         stride=_STRIDES[i - 1])
            x = getattr(self, f"conv{i}_BN")(F.relu(x))   # torchcrepe: ReLU before the BN
            x = F.max_pool1d(x, 2, 2)
        # torchcrepe's permute(0, 2, 1, 3): flatten height-major over (H, C)
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


def load_crepe_state_dict(net: Crepe, state_dict: dict) -> Crepe:
    """Load a torchcrepe state dict (tensors or numpy arrays) into `net`:
    every tensor of the network must be there in its shape; BatchNorm's
    num_batches_tracked is ignored; anything else raises."""
    own = net.state_dict()
    sd = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    missing, surplus = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    wrong = [(k, tuple(sd[k].shape), tuple(own[k].shape)) for k in own
             if k in sd and sd[k].shape != own[k].shape]
    if missing or surplus or wrong:
        raise ValueError(f"not a torchcrepe {net.model!r} state dict: missing {missing[:4]}, "
                         f"surplus {surplus[:4]}, misshapen {wrong[:4]}")
    net.load_state_dict(sd)
    return net


@functools.lru_cache(maxsize=4)
def load_crepe(ckpt_path: str, model: str = "full", device: str = "cuda") -> Crepe:
    """The torchcrepe checkpoint at ckpt_path as an eval-mode Crepe on `device`
    (the card unless device="cpu"); cached per (path, capacity, device)."""
    dev = resolve_device(device)
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return load_crepe_state_dict(Crepe(model), sd).eval().to(dev)


def _bin_to_hz(bins_cents: np.ndarray) -> np.ndarray:
    return 10.0 * 2.0 ** (bins_cents / 1200.0)


def _decode_weighted_argmax(probs: np.ndarray, fmin: float, fmax: float):
    """torchcrepe weighted_argmax: posterior-weighted mean cents over
    +-4 bins around the peak, restricted to [fmin, fmax]."""
    cents_axis = CENTS_PER_BIN * np.arange(PITCH_BINS) + CENTS_OFFSET
    hz_axis = _bin_to_hz(cents_axis)
    masked = probs.copy()
    masked[:, (hz_axis < fmin) | (hz_axis > fmax)] = -np.inf
    peak = np.argmax(masked, axis=1)
    periodicity = probs[np.arange(len(peak)), peak]
    lo = np.maximum(peak - 4, 0)
    hi = np.minimum(peak + 5, PITCH_BINS)
    cents = np.empty(len(peak), np.float64)
    for t in range(len(peak)):  # ragged windows; T is small (frames)
        w = probs[t, lo[t]:hi[t]]
        cents[t] = float(np.sum(w * cents_axis[lo[t]:hi[t]]) / max(np.sum(w), 1e-9))
    return _bin_to_hz(cents), periodicity


def frames_of(audio: np.ndarray, sr: int, hop: int = HOP) -> np.ndarray:
    """audio (T,) at sr -> (n_frames, 1024) float32 frames of the 16 kHz wave,
    padded WINDOW // 2 on both sides (frame t centred at t * hop), each
    normalised to zero mean and unit std (torchcrepe.preprocess)."""
    from scipy.signal import resample_poly

    audio = np.asarray(audio, np.float64)
    if sr != SAMPLE_RATE:
        g = np.gcd(int(sr), SAMPLE_RATE)
        audio = resample_poly(audio, SAMPLE_RATE // g, sr // g)
    audio = np.pad(audio, (WINDOW // 2, WINDOW // 2))
    n_frames = 1 + (len(audio) - WINDOW) // hop
    idx = np.arange(WINDOW)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = audio[idx].astype(np.float32)
    mu = frames.mean(axis=1, keepdims=True)
    sd = np.maximum(frames.std(axis=1, keepdims=True), 1e-10)
    return (frames - mu) / sd


@torch.no_grad()
def posteriors(net: Crepe, frames: np.ndarray, batch_frames: int = 512) -> np.ndarray:
    """(n, 1024) frames -> (n, 360) posteriors, batch_frames at a time on the
    network's device."""
    dev = next(net.parameters()).device
    out = [net(torch.from_numpy(np.ascontiguousarray(frames[s:s + batch_frames])).to(dev))
           .float().cpu().numpy() for s in range(0, len(frames), batch_frames)]
    return np.concatenate(out, axis=0) if out else np.zeros((0, PITCH_BINS), np.float32)


def predict_f0_periodicity(audio: np.ndarray, sr: int, net: Crepe, fmin: float = 50.0,
                           fmax: float = 550.0, batch_frames: int = 512, hop: int = HOP):
    """audio (T,) at sr -> (f0_hz, periodicity) at `hop`-sample hops on the
    16 kHz grid (default 160 = 10 ms): torchcrepe.predict(...,
    return_periodicity=True) with the weighted_argmax decoder."""
    return _decode_weighted_argmax(posteriors(net, frames_of(audio, sr, hop), batch_frames),
                                   fmin, fmax)


def crepe_ckpt_from_env() -> str | None:
    """Path from $NVSE_CREPE_CKPT if it exists (else None -> YIN path)."""
    path = os.environ.get("NVSE_CREPE_CKPT", "")
    return path if path and os.path.exists(path) else None


def crepe_model_from_env() -> str:
    """Capacity from $NVSE_CREPE_MODEL ('full' default, or 'tiny')."""
    return os.environ.get("NVSE_CREPE_MODEL", "full")
