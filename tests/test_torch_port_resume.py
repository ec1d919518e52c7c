"""Port parity: a JAX training run resumed in the port.

scripts/convert_jax_checkpoint.py's run mode converts a JAX g_/do_ pair (Orbax)
into the port's g_/do_ bundles; the port's restore_checkpoint loads them, and
the port's next step is held against JAX's next step from the same state on
the same batch, for a tiny BSRNN (T-F trainer, MPD + MRD, LSTM summed biases)
and a tiny joint BSRNN_24k (the T-F trainer's joint domain, both steps on the
denoise task: one JAX compile) here, and a narrowed HiFiGAN (time trainer,
MPD + MSD with its spectral-norm u) in tests/test_torch_port_resume_time.py.
The configs and limits are those of tests/test_torch_port_train.py,
tests/test_torch_port_time_train.py and tests/test_torch_port_joint_step.py,
with the MPD cut to one period (the discriminators are not what the
resume checks: the full MPD + MRD step is held in those files):
  * the restored state equals JAX's after its first step: weights, the MSD's u,
    AdamW's moments (the summed bias's is the JAX b_ih's) and its step count;
  * after the second step every metric at rtol 1e-3, the first moments per
    tensor at a relative L2 of 2e-3, and the updated parameters as the
    harness's `assert_updates_close`.
A do_ whose b_ih and b_hh moments differ makes the converter raise, naming the
port's parameter (tests/test_torch_port_resume_time.py).
"""
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from nvse_tpu.train.trainer import DiscState, GenState
from nvse_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvse_tpu.train.trainer import make_train_step
from nvse_tpu_torch.train import GANTrainer
from nvse_tpu_torch.train.checkpoint import restore_checkpoint
from nvse_tpu_torch.train.trainer import _spectral_buffers
from nvse_tpu_torch.utils import disc_params_from_jax, load_config, params_from_jax

from test_torch_port_bsrnn import jax_params
from test_torch_port_disc import disc_params
from test_torch_port_joint import _h as joint_h, _one_torch_thread  # noqa: F401
from test_torch_port_joint import _waves as joint_waves
from test_torch_port_joint import torch_threads
from test_torch_port_time_train import TIME_METRIC_KEYS, mrf_params, msd_params
from test_torch_port_time_train import _audio as time_audio
from test_torch_port_time_train import _h as time_h
from test_torch_port_train import (KEYS, _adam_mu, _bridge_gen, _np, _port_moments,
                                   assert_moments_close, assert_updates_close)
from test_torch_port_train import _audio as tf_audio
from test_torch_port_train import _h as tf_h

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE = 10                        # steps per epoch on both sides (the lr schedule)
ONE_PERIOD = dict(mpd_reshapes=[2])     # the MPD of tests/test_torch_port_time_train.py


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", os.path.join(REPO, "scripts", "convert_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(model):
    """(h, domain, jax generator, gen_state, disc_state, the (clean, input)
    batch of each of two steps; input None outside the joint domain)."""
    if model == "BSRNN_24k":
        h = joint_h(**ONE_PERIOD)
        jm, domain = jax_build(h)
        gp = jax_params(jm, np.zeros((1, 513, 9), np.float32), seed=0)
        dp, spec = disc_params(segment=h.segment_size, periods=h.mpd_reshapes), None
        audio = [joint_waves(b=h.batch_size, n=h.segment_size, seed=s) for s in (0, 1)]
    elif model == "BSRNN":
        h = tf_h(**ONE_PERIOD)
        jm, domain = jax_build(h)
        gp = jax_params(jm, np.zeros((1, h.num_mels, h.segment_size // h.hop_size + 1),
                                     np.float32), seed=0)
        dp, spec = disc_params(segment=h.segment_size, periods=h.mpd_reshapes), None
        audio = [(tf_audio(2, h.segment_size, seed=s), None) for s in (0, 1)]
    else:
        h = time_h("HiFiGAN")
        jm, domain = jax_build(h)
        gp = mrf_params(jm)
        sp, spec = msd_params()
        dp = {"mpd": disc_params(segment=h.segment_size, periods=h.mpd_reshapes)["mpd"],
              "scale": sp}
        audio = [(time_audio(seed=s), None) for s in (0, 1)]
    gen_state = GenState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, SPE))
    disc_state = DiscState.create(
        apply_fn=None, params=jax.tree.map(jnp.asarray, dp), tx=jax_make_optimizer(h, SPE),
        spectral=None if spec is None else jax.tree.map(jnp.asarray, spec))
    gen_state = gen_state.replace(step=jnp.asarray(0, jnp.int32))
    disc_state = disc_state.replace(step=jnp.asarray(0, jnp.int32))
    return h, domain, jm, gen_state, disc_state, audio


def _jnp(x):
    return None if x is None else jnp.asarray(x)


@pytest.fixture(scope="module", params=["BSRNN", "BSRNN_24k"])
def resumed(request, tmp_path_factory):
    return resume_case(request.param, tmp_path_factory)


def resume_case(model, tmp_path_factory):
    """One JAX step, its g_/do_ pair saved and converted, the port restored from
    the conversion; then the second step on both sides."""
    tmp = tmp_path_factory.mktemp(f"resume_{model}")
    h, domain, jm, gen_state, disc_state, audio = _jax_run(model)
    joint = model == "BSRNN_24k"
    fns = (make_train_step(h, jm, "joint", joint_task="denoise") if joint
           else make_train_step(h, jm, domain))
    gen_state, disc_state, _ = fns.train_step(gen_state, disc_state, *map(_jnp, audio[0]))
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    jax_save_checkpoint(jax_dir, 1, 0, gen_state, disc_state)
    after_one = dict(g=_np(gen_state.params), d=_np(disc_state.params),
                     spectral=None if disc_state.spectral is None else _np(disc_state.spectral),
                     g_mu=_np(_adam_mu(gen_state.opt_state)))
    cfg = str(tmp / "config.json")
    with open(cfg, "w") as f:
        json.dump(dict(h), f)
    assert _converter().convert_run(cfg, jax_dir, port_dir) == 1

    tr = GANTrainer(load_config(cfg), device="cpu", steps_per_epoch=SPE, joint=joint)
    assert restore_checkpoint(port_dir, tr) == (2, 0)
    shutil.rmtree(tmp, ignore_errors=True)      # the bundles, discriminators' moments and all
    # copies: the step below updates the weights and the moments in place
    g1 = {k: v.clone() for k, v in tr.generator.state_dict().items()}
    d1 = {k: v.clone() for k, v in tr.disc.state_dict().items()}
    restored = dict(g=g1, u=[u.clone() for u in _spectral_buffers(tr.disc)],
                    g_mu={k: v.clone() for k, v in _port_moments(tr.opt_g, tr.generator).items()},
                    steps={int(s["step"]) for opt in (tr.opt_g, tr.opt_d)
                           for s in opt.state.values()})

    gen_state, disc_state, jm2 = fns.train_step(gen_state, disc_state, *map(_jnp, audio[1]))
    clean, inp = audio[1]
    pm = (tr.step(torch.from_numpy(clean), torch.from_numpy(inp), "denoise") if joint
          else tr.step(torch.from_numpy(clean)))
    keys = TIME_METRIC_KEYS if model == "HiFiGAN" else KEYS
    scale = "msd" if model == "HiFiGAN" else "mrd"
    spectral = None if disc_state.spectral is None else _np(disc_state.spectral)
    d_mu = disc_params_from_jax(_np(_adam_mu(disc_state.opt_state)), spectral)
    d_new = disc_params_from_jax(_np(disc_state.params), spectral)
    return dict(
        model=model, h=h, after_one=after_one, restored=restored, trainer=tr,
        jax_metrics={k: float(jm2[k]) for k in keys}, port_metrics={k: float(pm[k]) for k in keys},
        g_mu_jax=_bridge_gen(_adam_mu(gen_state.opt_state), h, half_bias=True),
        g_mu_port=_port_moments(tr.opt_g, tr.generator),
        d_mu_jax={**{f"mpd.{k}": v for k, v in d_mu[0].items()},
                  **{f"{scale}.{k}": v for k, v in d_mu[1].items() if not k.endswith(".u")}},
        d_mu_port=_port_moments(tr.opt_d, tr.disc),
        g_new_jax=_bridge_gen(gen_state.params, h, half_bias=False),
        g_new_port=tr.generator.state_dict(), g_old=g1,
        d_new_jax={**{f"mpd.{k}": v for k, v in d_new[0].items()},
                   **{f"{scale}.{k}": v for k, v in d_new[1].items() if not k.endswith(".u")}},
        d_new_port=tr.disc.state_dict(), d_old=d1)


def test_restored_state_is_the_jax_state_after_its_step(resumed):
    check_restored_state(resumed)


def check_restored_state(r):
    want = params_from_jax(r["after_one"]["g"], r["h"])
    assert set(want) == set(r["restored"]["g"])
    for k, v in want.items():
        torch.testing.assert_close(r["restored"]["g"][k], v, rtol=0, atol=0, msg=k)
    # the summed bias's moment is the JAX b_ih's (and b_hh's): half the bridged sum
    mu = _bridge_gen(r["after_one"]["g_mu"], r["h"], half_bias=True)
    for k, v in mu.items():
        torch.testing.assert_close(r["restored"]["g_mu"][k], v, rtol=1e-6, atol=0, msg=k)
    assert r["restored"]["steps"] == {1}
    if r["model"] == "HiFiGAN":           # the MSD's power-iteration vectors u, as JAX left them
        u = disc_params_from_jax(r["after_one"]["d"], r["after_one"]["spectral"])[1]
        got = r["restored"]["u"]
        want_u = [v for k, v in u.items() if k.endswith(".u")]
        assert len(got) == len(want_u) == 8
        for a, b in zip(got, want_u):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_next_step_metrics_match_jax(resumed):
    check_next_metrics(resumed)


def check_next_metrics(r):
    for k, v in r["port_metrics"].items():
        assert np.isfinite(v), k
        np.testing.assert_allclose(v, r["jax_metrics"][k], rtol=1e-3, err_msg=k)


def test_next_step_moments_and_updates_match_jax(resumed):
    check_next_moments_and_updates(resumed)


def check_next_moments_and_updates(r):
    assert_moments_close(r["g_mu_port"], r["g_mu_jax"], rel=2e-3)
    assert_moments_close(r["d_mu_port"], r["d_mu_jax"], rel=2e-3)
    assert_updates_close(r["g_new_port"], r["g_new_jax"], r["g_old"], r["g_mu_jax"])
    assert_updates_close(r["d_new_port"], r["d_new_jax"], r["d_old"], r["d_mu_jax"])
