"""Map a JAX-package BSRNN parameter tree onto the port's state_dict.

Reads plain numpy (e.g. `jax.tree.map(np.asarray, variables["params"])`
done by the caller), so this module imports nothing of JAX. The tests
use it to give both packages the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _res_rnn(node: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.norm.scale"] = _t(node["LayerNorm_0"]["scale"])
    out[f"{prefix}.norm.bias"] = _t(node["LayerNorm_0"]["bias"])
    lstm = node["LSTM_0"]
    for d in ("fwd", "bwd"):
        if f"w_ih_{d}" not in lstm:
            continue
        out[f"{prefix}.lstm.w_ih_{d}"] = _t(lstm[f"w_ih_{d}"])
        out[f"{prefix}.lstm.w_hh_{d}"] = _t(lstm[f"w_hh_{d}"])
        # the JAX layer sums b_ih + b_hh at parameter time (layers.py:564-566)
        out[f"{prefix}.lstm.b_{d}"] = _t(np.asarray(lstm[f"b_ih_{d}"]) + np.asarray(lstm[f"b_hh_{d}"]))
    out[f"{prefix}.proj.kernel"] = _t(node["Linear_0"]["kernel"])
    out[f"{prefix}.proj.bias"] = _t(node["Linear_0"]["bias"])


def params_from_jax(flax_params_as_numpy: dict, h) -> dict[str, torch.Tensor]:
    """JAX BSRNN / BSRNN_24k params (numpy leaves) -> port state_dict.

    Tree: BSRNNCore_0/{_GroupedBandEncoder_0, BSNet_{r}/{ResRNN_0 (time),
    ResRNN_1 (band), LayerNorm_0 (out norm)}, _GroupedBandDecoder_0 (mag),
    _GroupedBandDecoder_1 (phase)}.
    """
    if h.model_name not in ("BSRNN", "BSRNN_24k"):
        raise NotImplementedError(f"no parameter map for {h.model_name!r} yet")
    p = flax_params_as_numpy.get("params", flax_params_as_numpy)
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
