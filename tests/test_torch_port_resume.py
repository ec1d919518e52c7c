"""Port parity: a JAX training run resumed in the port.

scripts/convert_jax_checkpoint.py's run mode converts a JAX g_/do_ pair (Orbax)
into the port's g_/do_ bundles; the port's restore_checkpoint loads them, and
the port's next step is held against JAX's next step from the same state on
the same batch, for a tiny BSRNN (T-F trainer, MPD + MRD, LSTM summed biases)
and a narrowed HiFiGAN (time trainer, MPD + MSD with its spectral-norm u). The
configs and limits are those of tests/test_torch_port_train.py and
tests/test_torch_port_time_train.py:
  * the restored state equals JAX's after its first step: weights, the MSD's u,
    AdamW's moments (the summed bias's is the JAX b_ih's) and its step count;
  * after the second step every metric at rtol 1e-3, the first moments per
    tensor at a relative L2 of 2e-3, and the updated parameters as the
    harness's `assert_updates_close`.
A do_ whose b_ih and b_hh moments differ makes the converter raise, naming the
port's parameter.
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


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", os.path.join(REPO, "scripts", "convert_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def bundles(tmp_path):
    """A directory for JAX and port bundles, removed after the test: a pair
    with the full-size discriminators' Adam moments is some 0.4 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_run(model):
    """(h, domain, jax generator, gen_state, disc_state, audio of two steps)."""
    if model == "BSRNN":
        h = tf_h()
        jm, domain = jax_build(h)
        gp = jax_params(jm, np.zeros((1, h.num_mels, h.segment_size // h.hop_size + 1),
                                     np.float32), seed=0)
        dp, spec = disc_params(segment=h.segment_size, periods=h.mpd_reshapes), None
        audio = [tf_audio(2, h.segment_size, seed=s) for s in (0, 1)]
    else:
        h = time_h("HiFiGAN")
        jm, domain = jax_build(h)
        gp = mrf_params(jm)
        sp, spec = msd_params()
        dp = {"mpd": disc_params(segment=h.segment_size, periods=h.mpd_reshapes)["mpd"],
              "scale": sp}
        audio = [time_audio(seed=s) for s in (0, 1)]
    gen_state = GenState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, SPE))
    disc_state = DiscState.create(
        apply_fn=None, params=jax.tree.map(jnp.asarray, dp), tx=jax_make_optimizer(h, SPE),
        spectral=None if spec is None else jax.tree.map(jnp.asarray, spec))
    gen_state = gen_state.replace(step=jnp.asarray(0, jnp.int32))
    disc_state = disc_state.replace(step=jnp.asarray(0, jnp.int32))
    return h, domain, jm, gen_state, disc_state, audio


@pytest.fixture(scope="module", params=["BSRNN", "HiFiGAN"])
def resumed(request, tmp_path_factory):
    """One JAX step, its g_/do_ pair saved and converted, the port restored from
    the conversion; then the second step on both sides."""
    model = request.param
    tmp = tmp_path_factory.mktemp(f"resume_{model}")
    h, domain, jm, gen_state, disc_state, audio = _jax_run(model)
    fns = make_train_step(h, jm, domain)
    gen_state, disc_state, _ = fns.train_step(gen_state, disc_state, jnp.asarray(audio[0]), None)
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    jax_save_checkpoint(jax_dir, 1, 0, gen_state, disc_state)
    after_one = dict(g=_np(gen_state.params), d=_np(disc_state.params),
                     spectral=None if disc_state.spectral is None else _np(disc_state.spectral),
                     g_mu=_np(_adam_mu(gen_state.opt_state)))
    cfg = str(tmp / "config.json")
    with open(cfg, "w") as f:
        json.dump(dict(h), f)
    assert _converter().convert_run(cfg, jax_dir, port_dir) == 1

    tr = GANTrainer(load_config(cfg), device="cpu", steps_per_epoch=SPE)
    assert restore_checkpoint(port_dir, tr) == (2, 0)
    shutil.rmtree(tmp, ignore_errors=True)      # the bundles: some 0.9 GB with the discriminators
    # copies: the step below updates the weights and the moments in place
    g1 = {k: v.clone() for k, v in tr.generator.state_dict().items()}
    d1 = {k: v.clone() for k, v in tr.disc.state_dict().items()}
    restored = dict(g=g1, u=[u.clone() for u in _spectral_buffers(tr.disc)],
                    g_mu={k: v.clone() for k, v in _port_moments(tr.opt_g, tr.generator).items()},
                    steps={int(s["step"]) for opt in (tr.opt_g, tr.opt_d)
                           for s in opt.state.values()})

    gen_state, disc_state, jm2 = fns.train_step(gen_state, disc_state, jnp.asarray(audio[1]), None)
    pm = tr.step(torch.from_numpy(audio[1]))
    keys = KEYS if model == "BSRNN" else TIME_METRIC_KEYS
    scale = "mrd" if model == "BSRNN" else "msd"
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
    r = resumed
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
    for k, v in resumed["port_metrics"].items():
        assert np.isfinite(v), k
        np.testing.assert_allclose(v, resumed["jax_metrics"][k], rtol=1e-3, err_msg=k)


def test_next_step_moments_and_updates_match_jax(resumed):
    r = resumed
    assert_moments_close(r["g_mu_port"], r["g_mu_jax"], rel=2e-3)
    assert_moments_close(r["d_mu_port"], r["d_mu_jax"], rel=2e-3)
    assert_updates_close(r["g_new_port"], r["g_new_jax"], r["g_old"], r["g_mu_jax"])
    assert_updates_close(r["d_new_port"], r["d_new_jax"], r["d_old"], r["d_mu_jax"])


def test_converter_raises_where_the_two_bias_moments_differ(bundles):
    """A do_ whose first moment of one b_hh leaf is moved off its b_ih's: the
    converter names the port's summed bias and writes nothing. (The JAX states
    before any step: no step to compile; the unmoved bundles convert in the
    `resumed` fixture.)"""
    h, _, _, gen_state, disc_state, _ = _jax_run("BSRNN")
    moved = []

    def move(path, x):
        name = jax.tree_util.keystr(path)
        if ".mu" in name and "b_hh_" in name and not moved:
            moved.append(name)
            return x + 1e-3
        return x

    opt = jax.tree_util.tree_map_with_path(move, gen_state.opt_state)
    assert moved
    bad = str(bundles / "jax")
    jax_save_checkpoint(bad, 0, 0, gen_state.replace(opt_state=opt), disc_state)
    cfg = str(bundles / "config.json")
    with open(cfg, "w") as f:
        json.dump(dict(h), f)
    out = str(bundles / "port")
    with pytest.raises(ValueError, match=r"\.b_(fwd|bwd): the JAX moments of b_ih and b_hh"):
        _converter().convert_run(cfg, bad, out)
    assert not os.path.exists(out)


def test_converter_takes_a_given_step_and_refuses_a_missing_one(bundles):
    """Of two saved pairs the converter takes the one asked for (the fixture
    takes the newest), and a step with no pair raises before any work."""
    h, _, _, gen_state, disc_state, _ = _jax_run("HiFiGAN")
    jax_dir = str(bundles / "jax")
    for step in (3, 5):
        jax_save_checkpoint(jax_dir, step, 0, gen_state, disc_state, max_to_keep=0)
    cfg = str(bundles / "config.json")
    with open(cfg, "w") as f:
        json.dump(dict(h), f)
    conv, out = _converter(), str(bundles / "port")
    assert conv.convert_run(cfg, jax_dir, out, step=3) == 3
    assert sorted(os.listdir(out)) == ["do_00000003", "g_00000003"]
    with pytest.raises(FileNotFoundError, match="step 4"):
        conv.convert_run(cfg, jax_dir, out, step=4)
