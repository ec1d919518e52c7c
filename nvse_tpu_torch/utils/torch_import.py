"""Import the reference repo's PyTorch `g_*` checkpoints into the port.

The reference saves each generator as {"generator": state_dict}
(reference utils.py:59-62). One importer per family maps those tensors
onto the port's state_dict by name, with explicit layout conversions;
counterpart of nvse_tpu/utils/torch_import.py, which maps them onto the
JAX package's flax trees. The port keeps the JAX package's parameter
layouts (utils/jax_params.py), so an importer here gives the tensors of
the JAX importer followed by params_from_jax.

  reference                          port
  Conv1d / Conv2d / ConvTranspose    `kernel` as stored (torch layouts)
  weight_norm weight_v / weight_g    `v` / `g` (the split kept; training
                                     steps both), also from torch's
                                     parametrizations original1 / original0
  Linear weight (out, in)            `kernel` (in, out)
  LayerNorm weight                   `scale` (GCRN's per-frequency norms
                                     (F, 1))
  LSTM weight_ih_l0 (4H, in)         `w_ih_fwd` (in, 4H); `_reverse` ->
                                     `_bwd`; b = bias_ih + bias_hh, summed
                                     here as the port holds it

Every importer checks both sides: a port tensor that no checkpoint tensor
fills, a shape that differs, or a checkpoint tensor left unused (apart
from those the reference builds and never runs: ConvTasNet's PReLU_2 /
norm_2) raise ValueError with the full list.

CLI (jax-free; writes a `.pt` bundle {"generator": state_dict} that
InferenceEngine and `python -m nvse_tpu_torch.infer` load through
h.checkpoint_file_load):

    python -m nvse_tpu_torch.utils.torch_import \\
        --cfg_filename nvse_tpu_torch/configs/apnet_config.json \\
        --torch_ckpt /path/to/g_01000000 --out /path/to/g_01000000.pt
"""
from __future__ import annotations

import argparse
import re

import numpy as np
import torch

__all__ = ["IMPORTERS", "import_apnet", "import_apnet2", "import_bsrnn", "import_conv_tf",
           "import_convtasnet", "import_freev", "import_gcrn", "import_generator",
           "import_hddemucas", "import_mrf_generator", "import_vocos", "load_torch_generator"]


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def load_torch_generator(ckpt_path: str) -> dict[str, np.ndarray]:
    """A reference g_* file ({"generator": state_dict}, or a bare state_dict)
    -> {torch name: float32 array}."""
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = state.get("generator", state)
    return {k: _to_numpy(v) for k, v in sd.items()}


# torch.nn.utils.parametrizations.weight_norm stores (g, v) under these names
_ALIASES = {"weight_g": "parametrizations.weight.original0",
            "weight_v": "parametrizations.weight.original1"}


class _Source:
    """A checkpoint's tensors, recording which an importer read."""

    def __init__(self, torch_params: dict):
        self.params = {k: _to_numpy(v) for k, v in torch_params.items()}
        self.used: set[str] = set()
        self.problems: list[str] = []

    def __call__(self, name: str) -> np.ndarray | None:
        stem, _, leaf = name.rpartition(".")
        for key in (name, f"{stem}.{_ALIASES[leaf]}" if leaf in _ALIASES else None):
            if key in self.params:
                self.used.add(key)
                return self.params[key]
        self.problems.append(f"no checkpoint tensor {name}")
        return None

    def lstm(self, prefix: str, layer: int, reverse: bool):
        """(w_ih (in, 4H), w_hh (H, 4H), b_ih + b_hh) of one torch LSTM direction."""
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        w_ih, w_hh = self(f"{prefix}.weight_ih{sfx}"), self(f"{prefix}.weight_hh{sfx}")
        b_ih, b_hh = self(f"{prefix}.bias_ih{sfx}"), self(f"{prefix}.bias_hh{sfx}")
        if any(a is None for a in (w_ih, w_hh, b_ih, b_hh)):
            return None, None, None
        return w_ih.T, w_hh.T, b_ih + b_hh


def _squeezed(shape) -> tuple:
    return tuple(d for d in shape if d != 1)


def _finish(src: _Source, out: dict, template: dict, unused_ok: str | None = None) -> dict:
    """out {port name: array} against the template state_dict: every port
    tensor filled at its shape (up to axes of size 1: a norm's (C, 1) or a
    PReLU's (1,) is reshaped), every checkpoint tensor read (but those
    matching the regex `unused_ok`). Returns the port state_dict."""
    problems = src.problems + [f"port tensor {k} {tuple(t.shape)} left unfilled"
                 for k, t in template.items() if out.get(k) is None]
    problems += [f"port tensor {k}: imported shape {np.shape(out[k])}, expected "
                 f"{tuple(t.shape)}" for k, t in template.items()
                 if out.get(k) is not None and _squeezed(np.shape(out[k])) != _squeezed(t.shape)]
    problems += [f"imported {k} has no port tensor" for k in out if k not in template]
    problems += [f"checkpoint tensor {k} unused" for k in src.params
                 if k not in src.used and not (unused_ok and re.fullmatch(unused_ok, k))]
    if problems:
        raise ValueError("checkpoint import incomplete:\n  " + "\n  ".join(problems))
    return {k: torch.from_numpy(np.ascontiguousarray(out[k], np.float32)).reshape(t.shape)
            for k, t in template.items()}


def _template(h) -> dict:
    from ..models import build_generator

    return build_generator(h)[0].state_dict()


def _lstm(src: _Source, torch_prefix: str, port_prefix: str, out: dict, template: dict,
          layer: int = 0) -> None:
    """A torch LSTM layer's directions onto the port's w_ih_* / w_hh_* / b_*;
    the backward direction where the port layer has one."""
    for d, reverse in (("fwd", False), ("bwd", True)):
        if f"{port_prefix}.w_ih_{d}" in template:
            w_ih, w_hh, b = src.lstm(torch_prefix, layer, reverse)
            out[f"{port_prefix}.w_ih_{d}"] = w_ih
            out[f"{port_prefix}.w_hh_{d}"] = w_hh
            out[f"{port_prefix}.b_{d}"] = b


def _conv(src: _Source, torch_prefix: str, port_prefix: str, out: dict) -> None:
    """A torch conv (any kind: the port keeps torch's layouts)."""
    out[f"{port_prefix}.kernel"] = src(f"{torch_prefix}.weight")
    out[f"{port_prefix}.bias"] = src(f"{torch_prefix}.bias")


def _linear(src: _Source, torch_prefix: str, port_prefix: str, out: dict) -> None:
    w = src(f"{torch_prefix}.weight")
    out[f"{port_prefix}.kernel"] = None if w is None else w.T
    out[f"{port_prefix}.bias"] = src(f"{torch_prefix}.bias")


def _norm(src: _Source, torch_prefix: str, port_prefix: str, out: dict, leaf="scale") -> None:
    """A torch LayerNorm / gLN's weight and bias onto `leaf` and `bias`
    (reshaped to the port's shape by _finish)."""
    out[f"{port_prefix}.{leaf}"] = src(f"{torch_prefix}.weight")
    out[f"{port_prefix}.bias"] = src(f"{torch_prefix}.bias")


# ---------------------------------------------------------------------------
# the conv T-F vocoders: the port keeps the reference's module names
# ---------------------------------------------------------------------------

_LEAF = {"v": "weight_v", "g": "weight_g", "kernel": "weight", "scale": "weight"}


def _by_reference_names(src: _Source, template: dict) -> dict:
    """Port name = reference name up to the leaf: `v` / `g` <- weight_v /
    weight_g, `kernel` <- weight (a Linear's (out, in) transposed), LayerNorm
    `scale` <- weight; bias, GRN gamma / beta as they are."""
    out = {}
    for key, t in template.items():
        mod, _, leaf = key.rpartition(".")
        a = src(f"{mod}.{_LEAF.get(leaf, leaf)}")
        if a is not None and leaf == "kernel" and t.dim() == 2:
            a = a.T
        out[key] = a
    return out


def import_conv_tf(torch_params: dict, h, template: dict | None = None) -> dict:
    """APNet (reference Models/apnet.py:90-157), APNet2 (apnet2.py:69-188),
    FreeV (freeV.py:69-187) and Vocos (models/vocos.py, whose names follow
    APNet2's ConvNeXt conventions): the port keeps the reference's module
    names (ASP_ / PSP_input_conv, ASP_ / PSP_ResNet.{k}.convs1 / convs2.{j},
    norm / norm2, convnext / convnext2.{i} with dwconv, norm, pwconv1, grn,
    pwconv2, final_layer_norm(2), ASP_output_conv, PSP_output_R / I_conv;
    Vocos embed and head). Counterparts of nvse_tpu/utils/torch_import.py's
    import_apnet (:144), import_apnet2 (:245), import_freev (:273) and
    import_vocos (:293)."""
    template = _template(h) if template is None else template
    src = _Source(torch_params)
    return _finish(src, _by_reference_names(src, template), template)


import_apnet = import_apnet2 = import_freev = import_vocos = import_conv_tf


def import_mrf_generator(torch_params: dict, h, template: dict | None = None) -> dict:
    """HiFiGAN (reference Models/hifigan.py:83-133) and iSTFTNet
    (istftnet.py:271-328): conv_pre, ups.{i} (weight-normed transposed convs,
    weight_v (in, out, k) and weight_g (in, 1, 1) kept split as the port's v
    and g), resblocks.{k}.convs1 / convs2.{j} (ResBlock1) or convs.{j}
    (ResBlock2), conv_post; the port keeps these names. Counterpart of
    nvse_tpu/utils/torch_import.py:import_mrf_generator (:83-135)."""
    template = _template(h) if template is None else template
    src = _Source(torch_params)
    return _finish(src, _by_reference_names(src, template), template)


# ---------------------------------------------------------------------------
# the families whose port names differ from the reference's
# ---------------------------------------------------------------------------

def import_bsrnn(torch_params: dict, h, template: dict | None = None) -> dict:
    """BSRNN / BSRNN_24k / BSRNN-L (reference Models/bsrnn.py:112-141;
    torch_import.py:430). The per-band encoder.{i} (LayerNorm, Linear) and
    decoder_mag / decoder_phase.{i} (LayerNorm, Linear, GELU, Linear) are
    stacked into the port's width groups row by row; separator.{k} BSNets
    (time_rnn / band_rnn ResRNNs: norm, rnn, proj; out_norm) map onto
    core.blocks.{k}."""
    from ..models.bsrnn import _band_groups, band_plan

    template = _template(h) if template is None else template
    src = _Source(torch_params)
    out: dict = {}

    def stack(names, fn):
        """One port tensor from per-band checkpoint tensors of one shape."""
        parts = [src(n) for n in names]
        if any(p is None for p in parts):
            return None
        odd = [n for n, p in zip(names, parts) if p.shape != parts[0].shape]
        if odd:
            src.problems += [f"checkpoint tensor {n}: imported shape {src.params[n].shape}, "
                             f"expected {parts[0].shape}" for n in odd]
            return None
        return np.stack([fn(p) for p in parts])

    band = 0
    for gi, (_w, n, _off) in enumerate(_band_groups(band_plan(h.sampling_rate, h.n_fft))):
        bands = range(band, band + n)
        band += n
        row, col = (lambda a: a[None]), (lambda a: a.T)
        enc = "core.encoder"
        out[f"{enc}.ln_scale_{gi}"] = stack([f"encoder.{i}.0.weight" for i in bands], row)
        out[f"{enc}.ln_bias_{gi}"] = stack([f"encoder.{i}.0.bias" for i in bands], row)
        out[f"{enc}.w_{gi}"] = stack([f"encoder.{i}.1.weight" for i in bands], col)
        out[f"{enc}.b_{gi}"] = stack([f"encoder.{i}.1.bias" for i in bands], row)
        for tname, dec in (("decoder_mag", "core.dec_mag"), ("decoder_phase", "core.dec_pha")):
            out[f"{dec}.ln_scale_{gi}"] = stack([f"{tname}.{i}.0.weight" for i in bands], row)
            out[f"{dec}.ln_bias_{gi}"] = stack([f"{tname}.{i}.0.bias" for i in bands], row)
            out[f"{dec}.w1_{gi}"] = stack([f"{tname}.{i}.1.weight" for i in bands], col)
            out[f"{dec}.b1_{gi}"] = stack([f"{tname}.{i}.1.bias" for i in bands], row)
            out[f"{dec}.w2_{gi}"] = stack([f"{tname}.{i}.3.weight" for i in bands], col)
            out[f"{dec}.b2_{gi}"] = stack([f"{tname}.{i}.3.bias" for i in bands], row)
    for k in range(int(h.num_repeat)):
        for rnn in ("time_rnn", "band_rnn"):
            t, p = f"separator.{k}.{rnn}", f"core.blocks.{k}.{rnn}"
            _norm(src, f"{t}.norm", f"{p}.norm", out)
            _lstm(src, f"{t}.rnn", f"{p}.lstm", out, template)
            _linear(src, f"{t}.proj", f"{p}.proj", out)
        _norm(src, f"separator.{k}.out_norm", f"core.blocks.{k}.out_norm", out)
    return _finish(src, out, template)


def import_gcrn(torch_params: dict, h, template: dict | None = None) -> dict:
    """GCRN (reference Models/gcrn.py:86-220; torch_import.py:316): conv{i}.conv1
    / conv2 and bn{i} (encoder), glstm.lstm_list1 / lstm_list2 and ln1 / ln2,
    conv{6..1}_t_{1,2} and bn{6..1}_t_{1,2} (the two decoders, coarse to
    fine), fc1 / fc2."""
    template = _template(h) if template is None else template
    src = _Source(torch_params)
    out: dict = {}
    for i in range(6):
        _conv(src, f"conv{i + 1}.conv1", f"enc_convs.{i}.conv_a", out)
        _conv(src, f"conv{i + 1}.conv2", f"enc_convs.{i}.conv_b", out)
        _norm(src, f"bn{i + 1}", f"enc_norms.{i}", out)
        for br in (1, 2):
            t = f"conv{6 - i}_t_{br}"
            _conv(src, f"{t}.conv1", f"dec{br}.convs.{i}.conv_a", out)
            _conv(src, f"{t}.conv2", f"dec{br}.convs.{i}.conv_b", out)
            _norm(src, f"bn{6 - i}_t_{br}", f"dec{br}.norms.{i}", out)
    groups = sum(k.startswith("glstm.lstms.") and k.endswith(".b_fwd") for k in template) // 2
    for g in range(groups):
        _lstm(src, f"glstm.lstm_list1.{g}", f"glstm.lstms.{g}", out, template)
        _lstm(src, f"glstm.lstm_list2.{g}", f"glstm.lstms.{groups + g}", out, template)
    _norm(src, "glstm.ln1", "glstm.norm1", out)
    _norm(src, "glstm.ln2", "glstm.norm2", out)
    _linear(src, "fc1", "fc1", out)
    _linear(src, "fc2", "fc2", out)
    return _finish(src, out, template)


def import_convtasnet(torch_params: dict, h, template: dict | None = None) -> dict:
    """ConvTasNet (reference Models/convtasnet.py:170-328; torch_import.py:178):
    encoder, LayerN_S, BottleN_S, separation.{i} (conv1x1, PReLU_1, norm_1,
    dwconv, Sc_conv, skip_conv), gen_masks, decoder. Each block's PReLU_2 and
    norm_2 are built by the reference and never run; they are left unused."""
    template = _template(h) if template is None else template
    src = _Source(torch_params)
    out: dict = {}
    _conv(src, "encoder", "encoder", out)
    _norm(src, "LayerN_S", "enc_norm", out, leaf="weight")
    _conv(src, "BottleN_S", "bottleneck", out)
    for i in range(int(h.R) * int(h.X)):
        t, p = f"separation.{i}", f"blocks.{i}"
        _conv(src, f"{t}.conv1x1", f"{p}.conv_in", out)
        out[f"{p}.prelu.alpha"] = src(f"{t}.PReLU_1.weight")
        _norm(src, f"{t}.norm_1", f"{p}.norm", out, leaf="weight")
        _conv(src, f"{t}.dwconv", f"{p}.dwconv", out)
        _conv(src, f"{t}.Sc_conv", f"{p}.res_conv", out)
        if f"{p}.skip_conv.kernel" in template:
            _conv(src, f"{t}.skip_conv", f"{p}.skip_conv", out)
    _conv(src, "gen_masks", "mask_conv", out)
    _conv(src, "decoder", "decoder", out)
    return _finish(src, out, template,
                   unused_ok=r"separation\.\d+\.(PReLU_2\.weight|norm_2\.(weight|bias))")


def import_hddemucas(torch_params: dict, h, template: dict | None = None) -> dict:
    """HD-Demucs (reference Models/hddemucas.py:127-370; torch_import.py:374):
    encoder.{i}.0 / .2, the two-layer lstm.lstm and lstm.linear,
    decoder_mask.{s}.0 / .2 and decoder_map.{s}.0 / .2 (coarse to fine, as
    the port's stages), fb_conv{1,2,3}.0 and the scalar weight."""
    template = _template(h) if template is None else template
    src = _Source(torch_params)
    out: dict = {}
    depth = int(h.depth)
    for i in range(depth):
        _conv(src, f"encoder.{i}.0", f"encoder.{i}.first", out)
        _conv(src, f"encoder.{i}.2", f"encoder.{i}.second", out)
    for layer in (0, 1):
        _lstm(src, "lstm.lstm", f"lstm.lstm{layer}", out, template, layer=layer)
    if "lstm.linear.kernel" in template:
        _linear(src, "lstm.linear", "lstm.linear", out)
    for s in range(depth):
        for dec in ("decoder_mask", "decoder_map"):
            _conv(src, f"{dec}.{s}.0", f"{dec}.{s}.first", out)
            _conv(src, f"{dec}.{s}.2", f"{dec}.{s}.second", out)
    for j in range(3):
        _conv(src, f"fb_conv{j + 1}.0", f"fusion.{j}", out)
    out["weight"] = src("weight")
    return _finish(src, out, template)


IMPORTERS = {
    "APNet": import_apnet, "APNet2": import_apnet2, "FreeV": import_freev,
    "Vocos": import_vocos, "BSRNN": import_bsrnn, "BSRNN_24k": import_bsrnn,
    "GCRN": import_gcrn, "ConvTasNet": import_convtasnet, "HDDemucas": import_hddemucas,
    "HiFiGAN": import_mrf_generator, "iSTFTNet": import_mrf_generator,
}


def import_generator(torch_params: dict, h, template: dict | None = None) -> dict:
    """The importer of h.model_name (IMPORTERS) applied to a checkpoint's
    tensors."""
    if h.model_name not in IMPORTERS:
        raise NotImplementedError(f"no importer for model_name {h.model_name!r} "
                                  f"(have: {sorted(IMPORTERS)})")
    return IMPORTERS[h.model_name](torch_params, h, template)


def main(argv=None) -> None:
    from .config import load_config

    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.utils.torch_import",
                                description="reference g_* checkpoint -> port .pt bundle")
    p.add_argument("--cfg_filename", required=True)
    p.add_argument("--torch_ckpt", required=True,
                   help="reference g_* file (torch.save'd {'generator': state_dict})")
    p.add_argument("--out", required=True,
                   help="output .pt ({'generator': state_dict}); use as h.checkpoint_file_load")
    args = p.parse_args(argv)
    h = load_config(args.cfg_filename)
    sd = import_generator(load_torch_generator(args.torch_ckpt), h)
    torch.save({"generator": sd}, args.out)
    n = sum(t.numel() for t in sd.values())
    print(f"imported {h.model_name}: {n / 1e6:.2f}M params {args.torch_ckpt} -> {args.out}")


if __name__ == "__main__":
    main()
