"""Port parity: one joint denoise+vocoder GAN step of each task (the T-F
trainer's joint domain, GANTrainer(joint=True)) against
make_train_step(h, gen, "joint", joint_task=task), on the CPU.

Both sides start from the same seeded numpy weights in the JAX trees'
shapes (params_from_jax / disc_params_from_jax) and the same batch (a clean
wave with a noise floor in every bin; the denoise input adds louder noise).
Compared after one step: every metric at rtol 1e-3, AdamW's first and
second moments per tensor at a relative L2 of 2e-3 (floored at 1e-4 of the
largest, as tests/test_torch_port_train.py), and eval_step on the updated
weights at rtol 1e-3. BSRNN_24k is narrowed to feature_dim 8 and one BSNet,
at segment 2048 and batch 2. Kept apart from tests/test_torch_port_joint.py
so that its two JAX step compiles (about 30 s each on one CPU) run beside
that file's tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.train.trainer import DiscState, GenState
from nvse_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvse_tpu.train.trainer import make_train_step
from nvse_tpu_torch.train import GANTrainer
from nvse_tpu_torch.utils import disc_params_from_jax, params_from_jax

from test_torch_port_bsrnn import jax_params
from test_torch_port_disc import disc_params
from test_torch_port_joint import _h, _waves
from test_torch_port_train import (_adam_mu, _bridge_gen, _np, _port_moments,
                                   assert_moments_close)

KEYS = ("A", "IP", "GD", "PTD", "C", "R", "I", "Mel", "GAN", "FM", "G", "D")
EVAL_KEYS = ("A", "IP", "GD", "PTD", "C", "R", "I", "Mel")


def _adam_nu(opt_state):
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(s, "nu"):
            return s.nu
    raise AssertionError("no ScaleByAdamState in the optimizer state")


def _port_nu(opt, module):
    return {n: opt.state[p]["exp_avg_sq"].detach().cpu() for n, p in module.named_parameters()}


def _disc_tree(tree):
    mpd, mrd = disc_params_from_jax(_np(tree))
    return {**{f"mpd.{k}": v for k, v in mpd.items()}, **{f"mrd.{k}": v for k, v in mrd.items()}}


def run_joint_both(h, task):
    """One joint step per side from the same weights and batch, then the
    eval step of each."""
    jgen, domain = jax_build(h)
    gp = jax_params(jgen, np.zeros((1, 513, 9), np.float32), seed=0)
    dp = disc_params(segment=h.segment_size, periods=h.mpd_reshapes)
    gen_state = GenState.create(apply_fn=jgen.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, 10))
    disc_state = DiscState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, dp),
                                  tx=jax_make_optimizer(h, 10), spectral=None)
    gen_state = gen_state.replace(step=jnp.asarray(0, jnp.int32))
    disc_state = disc_state.replace(step=jnp.asarray(0, jnp.int32))
    fns = make_train_step(h, jgen, "joint", joint_task=task)

    tr = GANTrainer(h, device="cpu", steps_per_epoch=10, joint=True)
    tr.generator.load_state_dict(params_from_jax(gp, h))
    mpd_sd, mrd_sd = disc_params_from_jax(dp)
    tr.disc["mpd"].load_state_dict(mpd_sd)
    tr.disc["mrd"].load_state_dict(mrd_sd)

    clean, noisy = _waves(b=h.batch_size, n=h.segment_size)
    inp = noisy if task == "denoise" else clean
    gen_state, disc_state, jm = fns.train_step(gen_state, disc_state, jnp.asarray(clean),
                                               jnp.asarray(inp))
    pm = tr.step(torch.from_numpy(clean), torch.from_numpy(inp), task)
    _, je = fns.eval_step(gen_state, jnp.asarray(clean[:1]), jnp.asarray(inp[:1]))
    _, pe = tr.eval_step(torch.from_numpy(clean[:1]), torch.from_numpy(inp[:1]), task)
    return dict(
        jax_metrics={k: float(jm[k]) for k in KEYS}, port_metrics={k: float(pm[k]) for k in KEYS},
        jax_eval={k: float(je[k]) for k in EVAL_KEYS}, port_eval={k: float(pe[k]) for k in EVAL_KEYS},
        g_mu=(_port_moments(tr.opt_g, tr.generator),
              _bridge_gen(_adam_mu(gen_state.opt_state), h, half_bias=True)),
        g_nu=(_port_nu(tr.opt_g, tr.generator),
              _bridge_gen(_adam_nu(gen_state.opt_state), h, half_bias=True)),
        d_mu=(_port_moments(tr.opt_d, tr.disc), _disc_tree(_adam_mu(disc_state.opt_state))),
        d_nu=(_port_nu(tr.opt_d, tr.disc), _disc_tree(_adam_nu(disc_state.opt_state))),
    )


@pytest.fixture(scope="module", params=["denoise", "vocoder"])
def joint_step(request):
    return request.param, run_joint_both(_h(), request.param)


def test_joint_step_metrics_match_jax(joint_step):
    task, r = joint_step
    for k in KEYS:
        assert np.isfinite(r["port_metrics"][k]), (task, k)
        np.testing.assert_allclose(r["port_metrics"][k], r["jax_metrics"][k], rtol=1e-3,
                                   err_msg=f"{task} {k}")


def test_joint_step_adamw_moments_match_jax(joint_step):
    _, r = joint_step
    for key in ("g_mu", "g_nu", "d_mu", "d_nu"):
        assert_moments_close(*r[key], rel=2e-3)


def test_joint_eval_step_matches_jax(joint_step):
    task, r = joint_step
    for k in EVAL_KEYS:
        np.testing.assert_allclose(r["port_eval"][k], r["jax_eval"][k], rtol=1e-3,
                                   err_msg=f"{task} {k}")
