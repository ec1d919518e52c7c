"""UTMOS MOS predictor on the card: wav2vec2-base + the MOS head.

Counterpart of nvse_tpu/metrics/utmos_torch.py (the network, the lightning
checkpoint's names) and utmos_jax.py (`n_samples`: a zero-padded wav scores
as its exact length). The reference (Metrics/utmos.py:54-157) loads the
sarulab-speech UTMOS strong learner, a lightning ``epoch=3-step=7459.ckpt``
that holds the fine-tuned fairseq wav2vec2-base under
``model.feature_extractors.0.ssl_model.*``, so scoring needs no fairseq:

  * ``Wav2Vec2Base``: 7 strided convs (GELU, GroupNorm on the first), LN +
    512 -> 768 projection, the grouped positional conv (k = 128, 16 groups,
    fairseq's weight norm over dim 2: `weight_g` (1, 1, 128), SamePad trim),
    12 post-norm transformer layers (12 heads, 3072 GELU MLP);
  * ``UTMOSModel``: domain (3, 128) and judge (3000, 128) embeddings
    broadcast over time, the decoder BiLSTM (1024 -> 2 x 512), the MLP
    1024 -> 2048 -> 1; score = mean_t * 2 + 3, domain 0, judge 288.

Attention and the MLPs are plain PyTorch. The decoder BiLSTM holds the
port's layout (models/layers.LSTM: w_ih (C, 4H), w_hh (H, 4H), b = b_ih +
b_hh, mapped from ``decoder_rnn.weight_ih_l0[_reverse]`` at load) and runs
ops.lstm.lstm_scan_fused: at C = 1024, H = 512 the card takes the projection
as torch matmuls and one launch of the lstm_scan_bidir2 kernel.

With n_samples (an int, or one a row) the forward is length-aware, as
utmos_jax.utmos_forward: masked GroupNorm statistics on the first conv,
zeros past the valid frames into the positional conv, padded frames
excluded as attention keys, the BiLSTM's backward scan started at each
row's last valid frame (lstm_scan_fused's `lengths`), and the time mean over
the valid frames. Frames past a row's length are never read.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..models.layers import LSTM
from ..ops.lstm import lstm_scan_fused

SSL_DIM = 768
CONV_LAYERS = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
DOMAIN_ID, JUDGE_ID = 0, 288


def valid_frames(n_samples: torch.Tensor) -> torch.Tensor:
    """Wav samples -> frames of the conv front end (each conv VALID)."""
    L = n_samples
    for _dim, k, s in CONV_LAYERS:
        L = torch.div(L - k, s, rounding_mode="floor") + 1
    return L


class _ConvFeatureExtractor(nn.Module):
    """wav2vec2-base conv front end: 7 strided Conv1d without bias, GELU,
    GroupNorm(512, 512) on the first layer only; fairseq's keys
    ``conv_layers.{i}.0`` (conv) and ``conv_layers.0.2`` (GroupNorm)."""

    def __init__(self):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        in_d = 1
        for i, (dim, k, stride) in enumerate(CONV_LAYERS):
            mods = [nn.Conv1d(in_d, dim, k, stride=stride, bias=False), nn.Dropout(0.0)]
            if i == 0:
                mods.append(nn.GroupNorm(dim, dim, affine=True))
            self.conv_layers.append(nn.Sequential(*mods))
            in_d = dim

    def forward(self, wav: torch.Tensor, n_samples: torch.Tensor | None) -> torch.Tensor:
        """wav (B, L) -> (B, T, 512). With n_samples (B,) the first layer's
        GroupNorm takes each row's statistics over its valid frames only."""
        x = wav[:, None]
        lv = n_samples
        for i, layer in enumerate(self.conv_layers):
            conv = layer[0]
            x = conv(x)
            if lv is not None:
                lv = torch.div(lv - conv.kernel_size[0], conv.stride[0], rounding_mode="floor") + 1
            if i == 0:
                gn = layer[2]
                if lv is None:
                    x = gn(x)
                else:
                    msk = (torch.arange(x.shape[-1], device=x.device)[None, :]
                           < lv[:, None])[:, None, :].to(x.dtype)
                    cnt = torch.clamp(lv, min=1).to(x.dtype)[:, None, None]
                    m = (x * msk).sum(-1, keepdim=True) / cnt
                    v = (((x - m) * msk) ** 2).sum(-1, keepdim=True) / cnt
                    x = ((x - m) / torch.sqrt(v + gn.eps) * gn.weight[None, :, None]
                         + gn.bias[None, :, None])
            x = F.gelu(x)
        return x.transpose(1, 2)


class _SelfAttention(nn.Module):
    """12-head attention, fairseq's ``self_attn.{q,k,v,out}_proj``."""

    def __init__(self, dim: int = SSL_DIM, heads: int = 12):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        B, T, D = x.shape

        def split(t):
            return t.view(B, T, self.heads, D // self.heads).transpose(1, 2)

        mask = None if key_mask is None else key_mask[:, None, None, :]
        att = F.scaled_dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                             split(self.v_proj(x)), attn_mask=mask)
        return self.out_proj(att.transpose(1, 2).reshape(B, T, D))


class _TransformerLayer(nn.Module):
    """Post-norm (layer_norm_first False, the base config)."""

    def __init__(self, dim: int = SSL_DIM, ffn: int = 3072):
        super().__init__()
        self.self_attn = _SelfAttention(dim)
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, ffn)
        self.fc2 = nn.Linear(ffn, dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x, key_mask))
        return self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))


class _PosConv(nn.Module):
    """The grouped positional conv with fairseq's weight norm over dim 2
    (nn.utils.weight_norm(conv, dim=2)): weight = g * v / ||v||, the norm
    over the output and input channels at each of the k taps; `weight_g`
    (1, 1, k), `weight_v` (dim, dim / groups, k), as the checkpoint holds them."""

    def __init__(self, dim: int = SSL_DIM, k: int = 128, groups: int = 16):
        super().__init__()
        self.k, self.groups = k, groups
        self.weight_v = nn.Parameter(torch.randn(dim, dim // groups, k) * math.sqrt(4.0 / (k * dim)))
        self.weight_g = nn.Parameter(self.weight_v.data.norm(dim=(0, 1), keepdim=True))
        self.bias = nn.Parameter(torch.zeros(dim))

    def weight(self) -> torch.Tensor:
        norm = self.weight_v.norm(dim=(0, 1), keepdim=True).clamp_min(1e-12)
        return self.weight_g * self.weight_v / norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x, self.weight(), self.bias, padding=self.k // 2, groups=self.groups)
        return y[..., :-1] if self.k % 2 == 0 else y   # fairseq SamePad


class _Encoder(nn.Module):
    def __init__(self, layers: int = 12):
        super().__init__()
        self.pos_conv = nn.ModuleList([_PosConv()])
        self.layer_norm = nn.LayerNorm(SSL_DIM)
        self.layers = nn.ModuleList([_TransformerLayer() for _ in range(layers)])

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        x = x + F.gelu(self.pos_conv[0](x.transpose(1, 2))).transpose(1, 2)
        x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x, key_mask)
        return x


class Wav2Vec2Base(nn.Module):
    """wav2vec2-base forward (features_only) with fairseq's parameter names."""

    def __init__(self):
        super().__init__()
        self.feature_extractor = _ConvFeatureExtractor()
        self.layer_norm = nn.LayerNorm(512)
        self.post_extract_proj = nn.Linear(512, SSL_DIM)
        self.encoder = _Encoder()

    def forward(self, wav: torch.Tensor, n_samples: torch.Tensor | None = None):
        """-> (features (B, T, 768), key mask (B, T) of the valid frames or None)."""
        x = self.post_extract_proj(self.layer_norm(self.feature_extractor(wav, n_samples)))
        mask = None
        if n_samples is not None:
            mask = torch.arange(x.shape[1], device=x.device)[None, :] < valid_frames(n_samples)[:, None]
            x = x * mask[..., None].to(x.dtype)       # the pos conv sees zeros past the length
        return self.encoder(x, mask), mask


class UTMOSModel(nn.Module):
    """SSL features ++ domain ++ judge embedding -> BiLSTM -> MLP -> MOS.
    Random weights from `seed` (torch's default initialisers) until a
    checkpoint is loaded. Inference only: the forward runs without grad."""

    def __init__(self, seed: int = 0):
        super().__init__()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.ssl_model = Wav2Vec2Base()
            self.domain_embedding = nn.Embedding(3, 128)
            self.judge_embedding = nn.Embedding(3000, 128)
            self.decoder_rnn = LSTM(SSL_DIM + 256, 512, bidirectional=True,
                                    gen=torch.Generator().manual_seed(seed))
            self.net = nn.Sequential(nn.Linear(1024, 2048), nn.ReLU(), nn.Dropout(0.3),
                                     nn.Linear(2048, 1))

    @torch.no_grad()
    def forward(self, wav: torch.Tensor, n_samples=None, domain_id: int = DOMAIN_ID,
                judge_id: int = JUDGE_ID) -> torch.Tensor:
        """wav (B, L) float32 at 16 kHz -> MOS (B,). n_samples (an int, or
        (B,)): how many leading samples of each row are real."""
        B = wav.shape[0]
        if n_samples is not None:
            n_samples = torch.as_tensor(n_samples, dtype=torch.long, device=wav.device)
            n_samples = n_samples.expand(B) if n_samples.dim() == 0 else n_samples
        x, mask = self.ssl_model(wav, n_samples)
        T = x.shape[1]
        ids = torch.tensor([domain_id, judge_id], device=wav.device)
        dom = self.domain_embedding(ids[:1]).expand(B, T, -1)
        jud = self.judge_embedding(ids[1:]).expand(B, T, -1)
        x = torch.cat([x, dom, jud], dim=2).contiguous()
        r = self.decoder_rnn
        lengths = None if mask is None else mask.sum(1)
        x = lstm_scan_fused(x, r.w_ih_fwd, r.w_ih_bwd, r.b_fwd, r.b_bwd, r.w_hh_fwd, r.w_hh_bwd,
                            lengths=lengths)
        out = self.net(x)[..., 0]                       # (B, T)
        if mask is None:
            return out.mean(dim=1) * 2.0 + 3.0
        m = mask.to(out.dtype)
        return (out * m).sum(1) / m.sum(1).clamp_min(1.0) * 2.0 + 3.0


# ---------------------------------------------------------------------------
# the lightning checkpoint's names

_PREFIX_MAP = [
    ("feature_extractors.0.ssl_model.", "ssl_model."),
    ("feature_extractors.1.embedding.", "domain_embedding."),
    ("output_layers.0.judge_embedding.", "judge_embedding."),
    ("output_layers.0.decoder_rnn.", "decoder_rnn."),
    ("output_layers.1.net.", "net."),
]

# fairseq pretraining-only tensors dropped by remove_pretraining_modules
_SKIP_SUBSTR = ("mask_emb", "quantizer", "project_q", "final_proj", "label_embs")
# torch.nn.LSTM's names of each direction -> the port's
_RNN = {"": "fwd", "_reverse": "bwd"}


def map_lightning_state_dict(sd: dict) -> dict:
    """Lightning / fairseq names -> UTMOSModel's. The decoder's
    torch.nn.LSTM tensors become the port's layout: weight_ih_l0 (4H, C) ->
    w_ih_fwd (C, 4H), weight_hh_l0 -> w_hh_fwd (H, 4H), b_fwd = bias_ih_l0 +
    bias_hh_l0; `_reverse` -> `_bwd`."""
    out = {}
    for key, value in sd.items():
        k = key[6:] if key.startswith("model.") else key
        if any(s in k for s in _SKIP_SUBSTR):
            continue
        for src, dst in _PREFIX_MAP:
            if k.startswith(src):
                out[dst + k[len(src):]] = value
                break
    for sfx, d in _RNN.items():
        names = [f"decoder_rnn.{n}_l0{sfx}" for n in ("weight_ih", "weight_hh", "bias_ih",
                                                       "bias_hh")]
        if all(n in out for n in names):
            w_ih, w_hh, b_ih, b_hh = (torch.as_tensor(out.pop(n)) for n in names)
            out[f"decoder_rnn.w_ih_{d}"] = w_ih.t().contiguous()
            out[f"decoder_rnn.w_hh_{d}"] = w_hh.t().contiguous()
            out[f"decoder_rnn.b_{d}"] = b_ih + b_hh
    return out


def lightning_state_dict(model: UTMOSModel) -> dict:
    """UTMOSModel's tensors under the lightning checkpoint's names (the
    decoder as torch.nn.LSTM's, its summed bias split as b_ih = b, b_hh = 0):
    `map_lightning_state_dict`'s inverse, to write a checkpoint in the
    public file's layout from seeded weights."""
    out = {}
    for k, v in model.state_dict().items():
        if k.startswith("decoder_rnn."):
            continue
        for src, dst in _PREFIX_MAP:
            if k.startswith(dst):
                out["model." + src + k[len(dst):]] = v.clone()
                break
    rnn = model.decoder_rnn
    for sfx, d in _RNN.items():
        pre = "model.output_layers.0.decoder_rnn."
        out[f"{pre}weight_ih_l0{sfx}"] = getattr(rnn, f"w_ih_{d}").detach().t().contiguous()
        out[f"{pre}weight_hh_l0{sfx}"] = getattr(rnn, f"w_hh_{d}").detach().t().contiguous()
        out[f"{pre}bias_ih_l0{sfx}"] = getattr(rnn, f"b_{d}").detach().clone()
        out[f"{pre}bias_hh_l0{sfx}"] = torch.zeros_like(out[f"{pre}bias_ih_l0{sfx}"])
    return out


def load_utmos(ckpt_path: str, device: str = "cuda") -> UTMOSModel:
    """The UTMOS lightning checkpoint as an eval-mode UTMOSModel on `device`
    (the card unless device="cpu"); a missing tensor raises."""
    dev = resolve_device(device)
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    model = UTMOSModel()
    missing, unexpected = model.load_state_dict(map_lightning_state_dict(sd), strict=False)
    if missing:
        raise RuntimeError(f"UTMOS checkpoint at {ckpt_path} is missing {len(missing)} "
                           f"tensors (e.g. {missing[:4]}); unexpected={unexpected[:4]}")
    return model.eval().to(dev)


def score_dir(deg_dir: str, ckpt_path: str, sr: int = 16000,
              device: str = "cuda") -> tuple[float, float]:
    """Mean / std UTMOS over a wav directory, one file a call at its own
    length (reference Metrics/utmos.py:24-52), on `device`."""
    from ..data.audio_io import load_wav

    model = load_utmos(ckpt_path, device)
    dev = next(model.parameters()).device
    scores = []
    for name in sorted(os.listdir(deg_dir)):
        if not name.endswith(".wav"):
            continue
        audio = np.asarray(load_wav(os.path.join(deg_dir, name), sr), np.float32)
        scores.append(float(model(torch.from_numpy(audio)[None, :].to(dev))[0]))
    if not scores:
        raise RuntimeError(f"no wav files in {deg_dir}")
    return float(np.mean(scores)), float(np.std(scores))
