#!/usr/bin/env python
"""Convert JAX Orbax checkpoints into the port's bundles.

Two modes:

  * a generator bundle alone (g_XXXXXXXX), for serving:

        python scripts/convert_jax_checkpoint.py --cfg_filename <cfg.json> \
            --jax_ckpt <checkpoint_path>/g_00001000 --out g_00001000.pt

    Reads the bundle with nvse_tpu.train.checkpoint.load_generator_params on
    the JAX generator's parameter template (as nvse_tpu/infer/engine.py does),
    maps the tree onto the port's modules with
    nvse_tpu_torch.utils.params_from_jax, and writes {"generator": state_dict},
    the bundle the port's training writes and InferenceEngine serves through
    checkpoint_file_load. Weight-norm pairs are written as they are in the
    bundle; the engine folds them at load.

  * a training run's g_/do_ pair, to resume it in the port:

        python scripts/convert_jax_checkpoint.py --cfg_filename <cfg.json> \
            --jax_dir <jax checkpoint_path> [--step 1000] --out_dir <port checkpoint_path>

    Takes the newest g_/do_ pair of --jax_dir (or that of --step), and writes
    the port's g_XXXXXXXX and do_XXXXXXXX at the same step into --out_dir;
    `python -m nvse_tpu_torch.train` (or `--joint`) with checkpoint_path set to
    --out_dir resumes from them (train/checkpoint.py `restore_checkpoint`). The
    JAX do_ (nvse_tpu/train/checkpoint.py) holds disc_params, spectral, optim_g,
    optim_d, steps and epoch; the port's holds "mpd", "mrd" or "msd", ("cqtd",)
    "optim_g", "optim_d", "steps" and "epoch" (nvse_tpu_torch/train/checkpoint.py).
    The discriminators map through disc_params_from_jax (the MSD with its
    spectral-norm u) and cqtd_params_from_jax. optax AdamW's ScaleByAdamState
    (count, mu, nu) becomes torch AdamW's per-parameter state (step = count,
    exp_avg = mu, exp_avg_sq = nu), in the parameter groups of the port's
    trainer (train/trainer.py `make_optimizer`); the port reads its staircase
    schedule from that step count, as optax reads it from its own. The port
    trains an LSTM's b_ih + b_hh as one summed bias (in a group with lr x 2 and
    weight decay / 2); both JAX tensors take the same gradient, so their
    moments are equal: the converter checks that they are, raises naming the
    parameter if not, and writes that moment as the summed bias's.

This script imports both packages (JAX on the CPU), as the tests do; the
port itself imports nothing of JAX.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# relative closeness of the two JAX moments of a summed LSTM bias: the same
# gradient, summed by two fused XLA reductions that may order their terms apart
BIAS_MOMENT_RTOL = 1e-5


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


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside an adamw state."""
    import jax

    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s
    raise ValueError("no ScaleByAdamState (optax adamw) in the JAX optimizer state")


def _zero_leaves(tree, prefix: str):
    """The tree with every leaf named prefix* (an LSTM's b_ih_* or b_hh_*) zeroed."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: np.zeros_like(v) if k.startswith(prefix) and not isinstance(v, dict)
                else _zero_leaves(v, prefix) for k, v in tree.items()}
    return tree


def moments_from_jax(tree, to_port) -> dict:
    """A JAX moment tree (mu or nu, numpy leaves, in the params' layout) ->
    {port parameter name: moment}, by `to_port` (the params' mapping, e.g.
    params_from_jax). Where the port sums two JAX tensors (an LSTM's b_ih_* +
    b_hh_*), its moment is theirs, which must be equal: raises ValueError
    naming the parameter where they are not."""
    import numpy as np

    from_ih = to_port(_zero_leaves(tree, "b_hh_"))
    from_hh = to_port(_zero_leaves(tree, "b_ih_"))
    for name, a in from_ih.items():
        b = from_hh[name]
        if not np.allclose(a.numpy(), b.numpy(), rtol=BIAS_MOMENT_RTOL,
                           atol=BIAS_MOMENT_RTOL * float(np.abs(a.numpy()).max(initial=0.0))):
            raise ValueError(f"{name}: the JAX moments of b_ih and b_hh differ (max "
                             f"{float((a - b).abs().max())}), so they do not make one summed "
                             "bias's moment")
    return from_ih


def _jax_templates(h):
    """Shapes of the JAX generator and discriminator states of config h (no
    weights computed), as nvse_tpu/train/trainer.py:create_states builds them."""
    import jax
    import jax.numpy as jnp

    from nvse_tpu.models import build_generator, model_input_bins
    from nvse_tpu.train.trainer import create_states

    gen, domain = build_generator(h)
    example = jnp.zeros((1, model_input_bins(h), 16), jnp.float32)
    return jax.eval_shape(lambda: create_states(h, gen, domain, jax.random.PRNGKey(0), 1,
                                                example))


def _jax_pair(jax_dir: str, step: int | None) -> list:
    """The paths of the JAX g_/do_ pair at `step` (None: the newest); raises
    FileNotFoundError where one is missing."""
    from nvse_tpu.train.checkpoint import checkpoint_step, scan_checkpoint

    if step is None:
        newest = scan_checkpoint(jax_dir, "g_")
        if newest is None:
            raise FileNotFoundError(f"no JAX g_ bundle in {jax_dir}")
        step = checkpoint_step(newest)
    paths = [os.path.join(jax_dir, f"{p}{step:08d}") for p in ("g_", "do_")]
    missing = [p for p in paths if not os.path.isdir(p)]
    if missing:
        raise FileNotFoundError(f"no JAX bundle {missing} for step {step}")
    return paths


def _restore_jax_pair(paths: list, gen_state, disc_state):
    """(g, do) of the JAX g_/do_ bundles at `paths`, read as numpy."""
    import orbax.checkpoint as ocp

    from nvse_tpu.train.checkpoint import _host_restore_args

    ckptr = ocp.PyTreeCheckpointer()
    g_item = {"generator": gen_state.params}
    do_item = {"disc_params": disc_state.params, "spectral": disc_state.spectral,
               "optim_g": gen_state.opt_state, "optim_d": disc_state.opt_state,
               "steps": 0, "epoch": 0}
    g = ckptr.restore(os.path.abspath(paths[0]), item=g_item,
                      restore_args=_host_restore_args(g_item))
    do = ckptr.restore(os.path.abspath(paths[1]), item=do_item,
                       restore_args=_host_restore_args(do_item))
    return g, do


def _disc_moments(tree, spectral, with_cqtd: bool) -> dict:
    """{port disc parameter name ("mpd.*", "mrd.*" / "msd.*", "cqtd.*"): moment}
    of a JAX discriminator moment tree."""
    from nvse_tpu_torch.utils import cqtd_params_from_jax, disc_params_from_jax

    def to_port(t):
        mpd, scale = disc_params_from_jax(t, spectral)
        key = "msd" if "DiscriminatorS_0" in t["scale"] else "mrd"
        out = {**{f"mpd.{k}": v for k, v in mpd.items()},
               **{f"{key}.{k}": v for k, v in scale.items() if not k.endswith(".u")}}
        if with_cqtd:
            out.update({f"cqtd.{k}": v for k, v in cqtd_params_from_jax(t["cqtd"]).items()})
        return out

    return moments_from_jax(tree, to_port)


def _set_adam_state(opt, module, count: int, mu: dict, nu: dict) -> None:
    """torch AdamW's state of every parameter of `module`: step = count,
    exp_avg = mu[name], exp_avg_sq = nu[name]."""
    import torch

    for name, p in module.named_parameters():
        if name not in mu or name not in nu:
            raise KeyError(f"the JAX optimizer state has no moment for the port's {name}")
        if tuple(mu[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX moment {tuple(mu[name].shape)} against parameter "
                             f"{tuple(p.shape)}")
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name].to(p.device, torch.float32).clone(),
                        "exp_avg_sq": nu[name].to(p.device, torch.float32).clone()}


def convert_run(cfg_filename: str, jax_dir: str, out_dir: str, step: int | None = None) -> int:
    """Write the port's g_/do_ pair for the JAX run's pair at `step` (None: the
    newest) into out_dir; -> the step converted."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from nvse_tpu.utils import load_config as jax_load_config
    from nvse_tpu_torch.models import model_input_bins
    from nvse_tpu_torch.train import GANTrainer
    from nvse_tpu_torch.train.checkpoint import save_checkpoint
    from nvse_tpu_torch.utils import (cqtd_params_from_jax, disc_params_from_jax,
                                      load_config, params_from_jax)

    paths = _jax_pair(jax_dir, step)
    hj, h = jax_load_config(cfg_filename), load_config(cfg_filename)
    gen_t, disc_t = _jax_templates(hj)
    g, do = _restore_jax_pair(paths, gen_t, disc_t)
    to_np = lambda t: jax.tree.map(np.asarray, t)                       # noqa: E731
    gparams, dparams = to_np(g["generator"]), to_np(do["disc_params"])
    spectral = None if do["spectral"] is None else to_np(do["spectral"])
    with_cqtd = "cqtd" in dparams

    tr = GANTrainer(h, device="cpu", joint=model_input_bins(h) != h.num_mels)
    tr.generator.load_state_dict(params_from_jax(gparams, h))
    mpd_sd, scale_sd = disc_params_from_jax(dparams, spectral)
    tr.disc["mpd"].load_state_dict(mpd_sd)
    tr.disc[tr.scale_key].load_state_dict(scale_sd)
    if with_cqtd != ("cqtd" in tr.disc):
        raise ValueError(f"the JAX run {'has' if with_cqtd else 'has no'} CQT discriminator, "
                         f"the config's use_cqtd is {bool(h.get('use_cqtd'))}")
    if with_cqtd:
        tr.disc["cqtd"].load_state_dict(cqtd_params_from_jax(dparams["cqtd"]))

    to_gen = lambda t: params_from_jax(t, h)                             # noqa: E731
    for opt, module, state, moments in (
            (tr.opt_g, tr.generator, do["optim_g"], lambda t: moments_from_jax(t, to_gen)),
            (tr.opt_d, tr.disc, do["optim_d"], lambda t: _disc_moments(t, spectral, with_cqtd))):
        adam = _adam_state(state)
        _set_adam_state(opt, module, int(np.asarray(adam.count)), moments(to_np(adam.mu)),
                        moments(to_np(adam.nu)))
    steps = int(do["steps"])
    save_checkpoint(out_dir, steps, int(do["epoch"]), tr, max_to_keep=0)
    return steps


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cfg_filename", required=True)
    p.add_argument("--jax_ckpt", help="an Orbax g_ bundle (a directory): write --out")
    p.add_argument("--out", help="the port g_ bundle to write from --jax_ckpt")
    p.add_argument("--jax_dir", help="a JAX run's checkpoint_path: convert a g_/do_ pair")
    p.add_argument("--step", type=int, default=None,
                   help="the pair's step (default: the newest in --jax_dir)")
    p.add_argument("--out_dir", help="the port checkpoint_path to write the pair into")
    args = p.parse_args()
    if args.jax_dir:
        if not args.out_dir:
            p.error("--jax_dir needs --out_dir")
        step = convert_run(args.cfg_filename, args.jax_dir, args.out_dir, args.step)
        print(f"wrote {args.out_dir}/g_{step:08d} and do_{step:08d}")
        return
    if not (args.jax_ckpt and args.out):
        p.error("give --jax_ckpt and --out (a g_ bundle), or --jax_dir and --out_dir (a run)")
    state = convert(args.cfg_filename, args.jax_ckpt, args.out)
    n = sum(t.numel() for t in state.values())
    print(f"wrote {args.out}: {len(state)} tensors, {n} values")


if __name__ == "__main__":
    main()
