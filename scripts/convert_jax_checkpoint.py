#!/usr/bin/env python
"""Convert a JAX Orbax generator bundle (g_XXXXXXXX) into a port g_ bundle.

    python scripts/convert_jax_checkpoint.py --cfg_filename <cfg.json> \
        --jax_ckpt <checkpoint_path>/g_00001000 --out g_00001000.pt

Reads the bundle with nvse_tpu.train.checkpoint.load_generator_params on
the JAX generator's parameter template (as nvse_tpu/infer/engine.py does),
maps the tree onto the port's modules with
nvse_tpu_torch.utils.params_from_jax, and writes {"generator": state_dict},
the bundle the port's training writes and InferenceEngine serves through
checkpoint_file_load. Weight-norm pairs are written as they are in the
bundle; the engine folds them at load.

This script imports both packages (JAX on the CPU), as the tests do; the
port itself imports nothing of JAX. The do_ bundle (optimizer and
discriminator state, to resume a JAX run in the port) is not converted.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def convert(cfg_filename: str, jax_ckpt: str, out: str) -> dict:
    """-> the port state_dict written to `out`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from nvse_tpu.models import build_generator, model_input_bins
    from nvse_tpu.train.checkpoint import load_generator_params
    from nvse_tpu.utils import load_config
    from nvse_tpu_torch.utils import params_from_jax

    h = load_config(cfg_filename)
    gen, _domain = build_generator(h)
    example = jnp.zeros((1, model_input_bins(h), 16), jnp.float32)
    template = gen.init(jax.random.PRNGKey(0), example)["params"]
    params = load_generator_params(jax_ckpt, template)
    state = params_from_jax(jax.tree.map(np.asarray, params), h)
    torch.save({"generator": state}, out)
    return state


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cfg_filename", required=True)
    p.add_argument("--jax_ckpt", required=True, help="an Orbax g_ bundle (a directory)")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    state = convert(args.cfg_filename, args.jax_ckpt, args.out)
    n = sum(t.numel() for t in state.values())
    print(f"wrote {args.out}: {len(state)} tensors, {n} values")


if __name__ == "__main__":
    main()
