"""Map JAX-package parameter trees (BSRNN, GCRN, ConvTasNet, HD-Demucs, APNet,
APNet2, FreeV, Vocos, HiFiGAN, iSTFTNet, the discriminators with the MSD's
spectral-norm vectors, the CQT discriminator) onto the port's state_dicts.

Reads plain numpy (e.g. `jax.tree.map(np.asarray, variables["params"])`
done by the caller), so this module imports nothing of JAX. The tests
use it to give both packages the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _copy(node: dict, prefix: str, out: dict) -> None:
    """A node whose leaves keep their names and layouts (LayerNorm, Linear,
    the per-frequency LayerNorm)."""
    for name, a in node.items():
        out[f"{prefix}.{name}"] = _t(a)


def _lstm(lstm: dict, prefix: str, out: dict) -> None:
    for d in ("fwd", "bwd"):
        if f"w_ih_{d}" not in lstm:
            continue
        out[f"{prefix}.w_ih_{d}"] = _t(lstm[f"w_ih_{d}"])
        out[f"{prefix}.w_hh_{d}"] = _t(lstm[f"w_hh_{d}"])
        # the JAX layer sums b_ih + b_hh at parameter time (layers.py:564-566)
        out[f"{prefix}.b_{d}"] = _t(np.asarray(lstm[f"b_ih_{d}"]) + np.asarray(lstm[f"b_hh_{d}"]))


def _res_rnn(node: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.norm.scale"] = _t(node["LayerNorm_0"]["scale"])
    out[f"{prefix}.norm.bias"] = _t(node["LayerNorm_0"]["bias"])
    _lstm(node["LSTM_0"], f"{prefix}.lstm", out)
    out[f"{prefix}.proj.kernel"] = _t(node["Linear_0"]["kernel"])
    out[f"{prefix}.proj.bias"] = _t(node["Linear_0"]["bias"])


def glu_params(node: dict, transposed: bool = False, prefix: str = "",
               out: dict | None = None) -> dict[str, torch.Tensor]:
    """A JAX GluConv2d / GluConvTranspose2d node -> the port module's
    state_dict: the two child convs, kernels HWIO -> OIHW, or for the
    transposed pair (kh, kw, cin, cout) -> (cin, cout, kh, kw), not flipped:
    the JAX layer flips them itself to write the transposed conv as a
    dilated one."""
    out = {} if out is None else out
    child, perm = ("ConvTranspose2d", (2, 3, 0, 1)) if transposed else ("Conv2d", (3, 2, 0, 1))
    for j, dst in enumerate(("conv_a", "conv_b")):
        conv = node[f"{child}_{j}"]
        out[f"{prefix}{dst}.kernel"] = _t(np.transpose(np.asarray(conv["kernel"]), perm))
        out[f"{prefix}{dst}.bias"] = _t(conv["bias"])
    return out


def glstm_params(node: dict, prefix: str = "", out: dict | None = None) -> dict[str, torch.Tensor]:
    """A JAX GLSTM node {LSTM_0..2g-1, LayerNorm_0, LayerNorm_1} -> the port
    module's state_dict (b = b_ih + b_hh)."""
    out = {} if out is None else out
    for i in range(sum(k.startswith("LSTM_") for k in node)):
        _lstm(node[f"LSTM_{i}"], f"{prefix}lstms.{i}", out)
    _copy(node["LayerNorm_0"], f"{prefix}norm1", out)
    _copy(node["LayerNorm_1"], f"{prefix}norm2", out)
    return out


def _gcrn_params(p: dict) -> dict[str, torch.Tensor]:
    """Tree: GluConv2d_{0..5}/Conv2d_{0,1} and bn{1..6} (encoder), GLSTM_0/
    {LSTM_0..2g-1, LayerNorm_0, LayerNorm_1}, GluConvTranspose2d_{0..5}
    (magnitude decoder) and _{6..11} (phase decoder) with
    bn{6-i}_t_{branch}, Linear_0 (fc1), Linear_1 (fc2)."""
    out: dict[str, torch.Tensor] = {}
    for i in range(6):
        glu_params(p[f"GluConv2d_{i}"], False, f"enc_convs.{i}.", out)
        _copy(p[f"bn{i + 1}"], f"enc_norms.{i}", out)
        for branch in (1, 2):
            glu_params(p[f"GluConvTranspose2d_{6 * (branch - 1) + i}"], True,
                       f"dec{branch}.convs.{i}.", out)
            _copy(p[f"bn{6 - i}_t_{branch}"], f"dec{branch}.norms.{i}", out)
    glstm_params(p["GLSTM_0"], "glstm.", out)
    _copy(p["Linear_0"], "fc1", out)
    _copy(p["Linear_1"], "fc2", out)
    return out


def _conv1d(node: dict, prefix: str, out: dict, transposed: bool = False) -> None:
    """Conv1d kernel (k, in / groups, out) -> (out, in / groups, k); a
    ConvTranspose1d kernel (k, in, out) -> (in, out, k), not flipped: the
    JAX layer flips it itself to write the transposed conv as a dilated one."""
    perm = (1, 2, 0) if transposed else (2, 1, 0)
    out[f"{prefix}.kernel"] = _t(np.transpose(np.asarray(node["kernel"]), perm))
    out[f"{prefix}.bias"] = _t(node["bias"])


def _convtasnet_params(p: dict, h) -> dict[str, torch.Tensor]:
    """Tree (the order of nvse_tpu/utils/torch_import.py:import_convtasnet):
    Conv1d_0 (encoder), GlobalLayerNorm_0, Conv1d_1 (bottleneck),
    Conv1DBlock_{i}/{Conv1d_0 (1x1), PReLU_0, GlobalLayerNorm_0 or
    ChannelLayerNorm_0, Conv1d_1 (depthwise), Conv1d_2 (res), Conv1d_3
    (skip)}, Conv1d_2 (mask head), ConvTranspose1d_0 (decoder)."""
    out: dict[str, torch.Tensor] = {}
    _conv1d(p["Conv1d_0"], "encoder", out)
    _copy(p["GlobalLayerNorm_0"], "enc_norm", out)
    _conv1d(p["Conv1d_1"], "bottleneck", out)
    for i in range(int(h.R) * int(h.X)):
        blk, pre = p[f"Conv1DBlock_{i}"], f"blocks.{i}"
        _conv1d(blk["Conv1d_0"], f"{pre}.conv_in", out)
        out[f"{pre}.prelu.alpha"] = _t(np.asarray(blk["PReLU_0"]["alpha"]).reshape(()))
        norm = "GlobalLayerNorm_0" if "GlobalLayerNorm_0" in blk else "ChannelLayerNorm_0"
        _copy(blk[norm], f"{pre}.norm", out)
        _conv1d(blk["Conv1d_1"], f"{pre}.dwconv", out)
        _conv1d(blk["Conv1d_2"], f"{pre}.res_conv", out)
        if "Conv1d_3" in blk:
            _conv1d(blk["Conv1d_3"], f"{pre}.skip_conv", out)
    _conv1d(p["Conv1d_2"], "mask_conv", out)
    _conv1d(p["ConvTranspose1d_0"], "decoder", out, transposed=True)
    return out


def _hddemucas_params(p: dict, h) -> dict[str, torch.Tensor]:
    """Tree (the order of nvse_tpu/utils/torch_import.py:import_hddemucas):
    Conv1d_{2i} / Conv1d_{2i+1} (encoder stage i: strided conv, 1x1),
    BLSTM_0/{LSTM_0, LSTM_1, Linear_0 (absent when causal)}, then per
    decoder stage s (coarse -> fine) Conv1d_{2d+s} / ConvTranspose1d_{s}
    (mask) and Conv1d_{3d+s} / ConvTranspose1d_{d+s} (map), the fusion
    convs Conv1d_{4d+j}, and the scalar `weight`."""
    d = int(h.depth)
    out: dict[str, torch.Tensor] = {}
    for i in range(d):
        _conv1d(p[f"Conv1d_{2 * i}"], f"encoder.{i}.first", out)
        _conv1d(p[f"Conv1d_{2 * i + 1}"], f"encoder.{i}.second", out)
    bl = p["BLSTM_0"]
    _lstm(bl["LSTM_0"], "lstm.lstm0", out)
    _lstm(bl["LSTM_1"], "lstm.lstm1", out)
    if "Linear_0" in bl:
        _copy(bl["Linear_0"], "lstm.linear", out)
    for s in range(d):
        _conv1d(p[f"Conv1d_{2 * d + s}"], f"decoder_mask.{s}.first", out)
        _conv1d(p[f"ConvTranspose1d_{s}"], f"decoder_mask.{s}.second", out, transposed=True)
        _conv1d(p[f"Conv1d_{3 * d + s}"], f"decoder_map.{s}.first", out)
        _conv1d(p[f"ConvTranspose1d_{d + s}"], f"decoder_map.{s}.second", out, transposed=True)
    for j in range(3):
        _conv1d(p[f"Conv1d_{4 * d + j}"], f"fusion.{j}", out)
    out["weight"] = _t(np.asarray(p["weight"], np.float32).reshape(()))
    return out


def _wn_conv1d(node: dict, prefix: str, out: dict) -> None:
    """Weight-norm Conv1d: v (k, in / groups, out) -> (out, in / groups, k),
    g (1, 1, out) -> (out, 1, 1); a folded node (`kernel`) as _conv1d."""
    if "kernel" in node:
        _conv1d(node, prefix, out)
        return
    out[f"{prefix}.v"] = _t(np.transpose(np.asarray(node["v"]), (2, 1, 0)))
    out[f"{prefix}.g"] = _t(np.asarray(node["g"]).reshape(-1, 1, 1))
    out[f"{prefix}.bias"] = _t(node["bias"])


def _wn_conv_transpose1d(node: dict, prefix: str, out: dict) -> None:
    """Weight-norm ConvTranspose1d: v (k, in, out) -> (in, out, k), g (1, in, 1)
    -> (in, 1, 1); a folded node (`kernel`) as _conv1d(transposed=True)."""
    if "kernel" in node:
        _conv1d(node, prefix, out, transposed=True)
        return
    out[f"{prefix}.v"] = _t(np.transpose(np.asarray(node["v"]), (1, 2, 0)))
    out[f"{prefix}.g"] = _t(np.asarray(node["g"]).reshape(-1, 1, 1))
    out[f"{prefix}.bias"] = _t(node["bias"])


def _mrf_params(p: dict) -> dict[str, torch.Tensor]:
    """HiFiGAN / iSTFTNet (the order of nvse_tpu/utils/torch_import.py:
    import_mrf_generator): MRFUpsampler_0/{Conv1d_0 (conv_pre),
    ConvTranspose1d_{i} (ups.i), ResBlock1_{k}/{Conv1d_{2j} (convs1.j),
    Conv1d_{2j+1} (convs2.j)} or ResBlock2_{k}/{Conv1d_j (convs.j)}}, Conv1d_0
    (conv_post); all weight-normed, the port under the reference's names."""
    out: dict[str, torch.Tensor] = {}
    trunk = p["MRFUpsampler_0"]
    _wn_conv1d(trunk["Conv1d_0"], "conv_pre", out)
    for i in range(_count(trunk, "ConvTranspose1d")):
        _wn_conv_transpose1d(trunk[f"ConvTranspose1d_{i}"], f"ups.{i}", out)
    for kind, names in (("1", ("convs1", "convs2")), ("2", ("convs",))):
        for k in range(_count(trunk, f"ResBlock{kind}")):
            blk = trunk[f"ResBlock{kind}_{k}"]
            n = len(names)
            for j in range(_count(blk, "Conv1d")):
                _wn_conv1d(blk[f"Conv1d_{j}"], f"resblocks.{k}.{names[j % n]}.{j // n}", out)
    _wn_conv1d(p["Conv1d_0"], "conv_post", out)
    return out


def _convnext(node: dict, prefix: str, out: dict) -> None:
    """ConvNeXtBlock: Conv1d_0 (dwconv), LayerNorm_0 (norm), Linear_0
    (pwconv1), GRN_0 (grn), Linear_1 (pwconv2)."""
    _conv1d(node["Conv1d_0"], f"{prefix}.dwconv", out)
    _copy(node["LayerNorm_0"], f"{prefix}.norm", out)
    _copy(node["Linear_0"], f"{prefix}.pwconv1", out)
    _copy(node["GRN_0"], f"{prefix}.grn", out)
    _copy(node["Linear_1"], f"{prefix}.pwconv2", out)


def _count(p: dict, stem: str) -> int:
    return sum(k.startswith(f"{stem}_") for k in p)


def _apnet_params(p: dict) -> dict[str, torch.Tensor]:
    """Tree (the order of nvse_tpu/utils/torch_import.py:import_apnet):
    Conv1d_0 (ASP in), ResBlock1_{0..n-1} (ASP; each Conv1d_{2j} = convs1.j,
    Conv1d_{2j+1} = convs2.j), Conv1d_1 (ASP out), Conv1d_2 (PSP in),
    ResBlock1_{n..2n-1}, Conv1d_3 / Conv1d_4 (R / I); all weight-normed."""
    out: dict[str, torch.Tensor] = {}
    n = _count(p, "ResBlock1") // 2
    for branch, first, conv_in in (("ASP", 0, 0), ("PSP", n, 2)):
        _wn_conv1d(p[f"Conv1d_{conv_in}"], f"{branch}_input_conv", out)
        for k in range(n):
            blk = p[f"ResBlock1_{first + k}"]
            for j in range(_count(blk, "Conv1d") // 2):
                _wn_conv1d(blk[f"Conv1d_{2 * j}"], f"{branch}_ResNet.{k}.convs1.{j}", out)
                _wn_conv1d(blk[f"Conv1d_{2 * j + 1}"], f"{branch}_ResNet.{k}.convs2.{j}", out)
    _wn_conv1d(p["Conv1d_1"], "ASP_output_conv", out)
    _wn_conv1d(p["Conv1d_3"], "PSP_output_R_conv", out)
    _wn_conv1d(p["Conv1d_4"], "PSP_output_I_conv", out)
    return out


def _phase_trunk(p: dict, first_block: int, n: int, conv_in: int, norms, out: dict) -> None:
    """APNet2's / FreeV's phase branch: Conv1d_{conv_in}, LayerNorm
    norms[0], ConvNeXtBlock_{first_block..+n-1}, LayerNorm norms[1], then
    Conv1d_{conv_in + 1} / _{conv_in + 2} (R / I)."""
    _conv1d(p[f"Conv1d_{conv_in}"], "PSP_input_conv", out)
    _copy(p[f"LayerNorm_{norms[0]}"], "norm", out)
    for i in range(n):
        _convnext(p[f"ConvNeXtBlock_{first_block + i}"], f"convnext.{i}", out)
    _copy(p[f"LayerNorm_{norms[1]}"], "final_layer_norm", out)
    _conv1d(p[f"Conv1d_{conv_in + 1}"], "PSP_output_R_conv", out)
    _conv1d(p[f"Conv1d_{conv_in + 2}"], "PSP_output_I_conv", out)


def _apnet2_params(p: dict) -> dict[str, torch.Tensor]:
    """Tree (import_apnet2's order): Conv1d_0 (ASP in), LayerNorm_0 (norm2),
    ConvNeXtBlock_{0..n-1} (convnext2), LayerNorm_1 (final_layer_norm2),
    Conv1d_1 (ASP out), then the phase branch from Conv1d_2, LayerNorm_2 /
    _3 and ConvNeXtBlock_{n..2n-1}."""
    out: dict[str, torch.Tensor] = {}
    n = _count(p, "ConvNeXtBlock") // 2
    _conv1d(p["Conv1d_0"], "ASP_input_conv", out)
    _copy(p["LayerNorm_0"], "norm2", out)
    for i in range(n):
        _convnext(p[f"ConvNeXtBlock_{i}"], f"convnext2.{i}", out)
    _copy(p["LayerNorm_1"], "final_layer_norm2", out)
    _conv1d(p["Conv1d_1"], "ASP_output_conv", out)
    _phase_trunk(p, n, n, 2, (2, 3), out)
    return out


def _freev_params(p: dict) -> dict[str, torch.Tensor]:
    """Tree (import_freev's order): ConvNeXtBlock_0 (the amplitude branch,
    convnext2.0), then the phase branch from Conv1d_0, LayerNorm_0 / _1 and
    ConvNeXtBlock_{1..n}."""
    out: dict[str, torch.Tensor] = {}
    _convnext(p["ConvNeXtBlock_0"], "convnext2.0", out)
    _phase_trunk(p, 1, _count(p, "ConvNeXtBlock") - 1, 0, (0, 1), out)
    return out


def _vocos_params(p: dict) -> dict[str, torch.Tensor]:
    """Tree (import_vocos's order): Conv1d_0 (embed), LayerNorm_0 (norm),
    ConvNeXtBlock_{0..n-1} (convnext), LayerNorm_1 (final_layer_norm),
    Linear_0 (head)."""
    out: dict[str, torch.Tensor] = {}
    _conv1d(p["Conv1d_0"], "embed", out)
    _copy(p["LayerNorm_0"], "norm", out)
    for i in range(_count(p, "ConvNeXtBlock")):
        _convnext(p[f"ConvNeXtBlock_{i}"], f"convnext.{i}", out)
    _copy(p["LayerNorm_1"], "final_layer_norm", out)
    _copy(p["Linear_0"], "head", out)
    return out


_FAMILY_MAPS = {"GCRN": _gcrn_params, "APNet": _apnet_params, "APNet2": _apnet2_params,
                "FreeV": _freev_params, "Vocos": _vocos_params, "HiFiGAN": _mrf_params,
                "iSTFTNet": _mrf_params}


def params_from_jax(flax_params_as_numpy: dict, h) -> dict[str, torch.Tensor]:
    """JAX generator params (numpy leaves) -> port state_dict, for the
    models the port has: BSRNN / BSRNN_24k, GCRN (`_gcrn_params`),
    ConvTasNet (`_convtasnet_params`), HD-Demucs (`_hddemucas_params`),
    APNet, APNet2, FreeV, Vocos, HiFiGAN and iSTFTNet (`_apnet_params`, ...,
    `_mrf_params`; weight-norm nodes as `v`, `g`, or `kernel` where
    fold_weight_norm folded them).

    BSRNN tree: BSRNNCore_0/{_GroupedBandEncoder_0, BSNet_{r}/{ResRNN_0
    (time), ResRNN_1 (band), LayerNorm_0 (out norm)}, _GroupedBandDecoder_0
    (mag), _GroupedBandDecoder_1 (phase)}.
    """
    p = flax_params_as_numpy.get("params", flax_params_as_numpy)
    if h.model_name in _FAMILY_MAPS:
        return _FAMILY_MAPS[h.model_name](p)
    if h.model_name == "ConvTasNet":
        return _convtasnet_params(p, h)
    if h.model_name == "HDDemucas":
        return _hddemucas_params(p, h)
    if h.model_name not in ("BSRNN", "BSRNN_24k"):
        raise NotImplementedError(f"no parameter map for {h.model_name!r} yet")
    core = p["BSRNNCore_0"]
    out: dict[str, torch.Tensor] = {}
    for src, dst in (("_GroupedBandEncoder_0", "encoder"),
                     ("_GroupedBandDecoder_0", "dec_mag"),
                     ("_GroupedBandDecoder_1", "dec_pha")):
        for name, a in core[src].items():
            out[f"core.{dst}.{name}"] = _t(a)
    for r in range(int(h.num_repeat)):
        blk = core[f"BSNet_{r}"]
        _res_rnn(blk["ResRNN_0"], f"core.blocks.{r}.time_rnn", out)
        _res_rnn(blk["ResRNN_1"], f"core.blocks.{r}.band_rnn", out)
        out[f"core.blocks.{r}.out_norm.scale"] = _t(blk["LayerNorm_0"]["scale"])
        out[f"core.blocks.{r}.out_norm.bias"] = _t(blk["LayerNorm_0"]["bias"])
    return out


def _conv2d_wn(node: dict, prefix: str, out: dict) -> None:
    """Weight-norm Conv2d: v HWIO -> OIHW, g (1, 1, 1, O) -> (O, 1, 1, 1)."""
    out[f"{prefix}.v"] = _t(np.transpose(np.asarray(node["v"]), (3, 2, 0, 1)))
    out[f"{prefix}.g"] = _t(np.asarray(node["g"]).reshape(-1, 1, 1, 1))
    out[f"{prefix}.bias"] = _t(node["bias"])


def _msd_params(tree: dict, spectral: dict | None) -> dict[str, torch.Tensor]:
    """{DiscriminatorS_0: {SNConv1d_j: {kernel, bias}}, DiscriminatorS_{1,2}:
    {Conv1d_j: {v, g, bias}}} and the flax `spectral` collection
    {DiscriminatorS_0: {SNConv1d_j: {u}}} -> the port MSD's state_dict."""
    if spectral is None:
        raise ValueError("the MSD's state_dict holds the spectral-norm vectors u: pass the "
                         "JAX disc state's `spectral` collection")
    spectral = spectral.get("spectral", spectral)
    out: dict[str, torch.Tensor] = {}
    for i in range(len(tree)):
        d = tree[f"DiscriminatorS_{i}"]
        for j in range(len(d)):
            if f"SNConv1d_{j}" in d:
                _conv1d(d[f"SNConv1d_{j}"], f"discs.{i}.convs.{j}", out)
                u = spectral[f"DiscriminatorS_{i}"][f"SNConv1d_{j}"]["u"]
                out[f"discs.{i}.convs.{j}.u"] = _t(np.asarray(u, np.float32))
            else:
                _wn_conv1d(d[f"Conv1d_{j}"], f"discs.{i}.convs.{j}", out)
    return out


def disc_params_from_jax(disc_params_as_numpy: dict, spectral: dict | None = None):
    """JAX discriminator tree (numpy leaves) -> (MPD, MRD or MSD) state_dicts.

    Tree: {"mpd": {DiscriminatorP_i: {Conv2d_j: {v, g, bias}}},
    "scale": {DiscriminatorR_i: {Conv2d_j: {v, g, bias}}}} for the domains
    "tf" and "joint", or for "time" "scale": {DiscriminatorS_i: ...} with
    `spectral` (the DiscState's power-iteration vectors), as
    nvse_tpu/train/trainer.py:create_states builds them (`_build_discs`).
    The two packages draw the initial u apart, so a comparison carries it.
    """
    mpd: dict[str, torch.Tensor] = {}
    tree = disc_params_as_numpy["mpd"]
    for i in range(len(tree)):
        d = tree[f"DiscriminatorP_{i}"]
        for j in range(len(d)):
            _conv2d_wn(d[f"Conv2d_{j}"], f"discs.{i}.convs.{j}", mpd)
    scale_tree = disc_params_as_numpy["scale"]
    if "DiscriminatorS_0" in scale_tree:
        return mpd, _msd_params(scale_tree, spectral)
    scale: dict[str, torch.Tensor] = {}
    for i in range(len(scale_tree)):
        d = scale_tree[f"DiscriminatorR_{i}"]
        for j in range(len(d)):
            _conv2d_wn(d[f"Conv2d_{j}"], f"discs.{i}.convs.{j}", scale)
    return mpd, scale


def cqtd_params_from_jax(cqtd_params_as_numpy: dict) -> dict[str, torch.Tensor]:
    """The JAX CQT discriminator's tree (the disc state's params["cqtd"]:
    {DiscriminatorCQT_i: {Conv2d_j: {kernel, bias} or {v, g, bias}}}) -> the
    port's MultiScaleSubbandCQTDiscriminator state_dict: Conv2d_j is
    discs.i.convs.j, kernels and v HWIO -> OIHW, g (1, 1, 1, O) -> (O, 1, 1, 1),
    v and g kept apart."""
    out: dict[str, torch.Tensor] = {}
    for i in range(len(cqtd_params_as_numpy)):
        d = cqtd_params_as_numpy[f"DiscriminatorCQT_{i}"]
        for j in range(len(d)):
            node, prefix = d[f"Conv2d_{j}"], f"discs.{i}.convs.{j}"
            if "v" in node:
                _conv2d_wn(node, prefix, out)
            else:
                out[f"{prefix}.kernel"] = _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
                out[f"{prefix}.bias"] = _t(node["bias"])
    return out
