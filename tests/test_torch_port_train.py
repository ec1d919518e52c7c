"""Port parity: one BSRNN GAN training step (T-F trainer, MPD + MRD) against
nvse_tpu.train.make_train_step, from the same weights and batch.

Both sides start from seeded numpy weights in the JAX trees' shapes
(jax.eval_shape, no JAX init), mapped onto the port by params_from_jax /
disc_params_from_jax. Compared after one step:
  * every metric (A, IP, GD, PTD, C, R, I, Mel, GAN, FM, G, D) at rtol 1e-3;
  * the gradients, read from AdamW's first moment (torch exp_avg and optax
    mu are both 0.2 * grad after one step), per tensor at a relative L2 of
    2e-3 (denominator floored at 1e-4 of the largest moment): float32 sums
    in another order through the STFTs, 2 BSNets and the discriminators;
  * the updated parameters (weak alone: the first Adam step is about
    lr * sign(grad)): per tensor, at most 1 % of the elements whose moment
    is above the floor may differ by more than lr / 10.
The port's LSTM bias is b_ih + b_hh of the JAX tree, so its moment is
compared with half the bridged sum and its update with the sum's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.train.trainer import DiscState, GenState
from nvse_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvse_tpu.train.trainer import make_train_step
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.ops import lstm as port_lstm
from nvse_tpu_torch.train import GANTrainer
from nvse_tpu_torch.utils import disc_params_from_jax, params_from_jax

from test_torch_port_bsrnn import jax_params
from test_torch_port_disc import disc_params

KEYS = ("A", "IP", "GD", "PTD", "C", "R", "I", "Mel", "GAN", "FM", "G", "D")
LR = 2e-4


def _h(**kw):
    base = dict(model_name="BSRNN", feature_dim=8, num_repeat=2, dropout=0.0, causal=False,
                sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
                fmin=0, fmax=8000, meloss=None, segment_size=2048, batch_size=2,
                learning_rate=LR, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, mrd_weight=0.1,
                mpd_reshapes=[2, 3, 5, 7, 11], seed=1234)
    base.update(kw)
    return AttrDict(base)


def _audio(b, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    x = 0.3 * np.sin(2 * np.pi * 220 * t)[None, :] + 0.05 * rng.standard_normal((b, n))
    return x.astype(np.float32)


def _adam_mu(opt_state):
    """optax's first moment tree inside an adamw state."""
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu
    raise AssertionError("no ScaleByAdamState in the optimizer state")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge_gen(tree, h, half_bias: bool):
    out = params_from_jax(_np(tree), h)
    if half_bias:   # the summed bias holds two JAX tensors' moments
        out = {k: v * 0.5 if k.endswith((".b_fwd", ".b_bwd")) else v
               for k, v in out.items()}
    return out


def _port_moments(opt, module):
    return {n: opt.state[p]["exp_avg"].detach().cpu() for n, p in module.named_parameters()}


def run_both(h, audio, steps=1):
    """One (or more) step(s) on each side from the same weights and batch."""
    jgen, domain = jax_build(h)
    mel_T = h.segment_size // h.hop_size + 1
    gp = jax_params(jgen, np.zeros((1, h.num_mels, mel_T), np.float32), seed=0)
    dp = disc_params(segment=h.segment_size, periods=h.mpd_reshapes)
    spe = 10
    gen_state = GenState.create(apply_fn=jgen.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, spe))
    disc_state = DiscState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, dp),
                                  tx=jax_make_optimizer(h, spe), spectral=None)
    gen_state = gen_state.replace(step=jnp.asarray(0, jnp.int32))
    disc_state = disc_state.replace(step=jnp.asarray(0, jnp.int32))
    fns = make_train_step(h, jgen, domain)

    tr = GANTrainer(h, device="cpu", steps_per_epoch=spe)
    tr.generator.load_state_dict(params_from_jax(gp, h))
    mpd_sd, mrd_sd = disc_params_from_jax(dp)
    tr.disc["mpd"].load_state_dict(mpd_sd)
    tr.disc["mrd"].load_state_dict(mrd_sd)
    g0 = {k: v.clone() for k, v in tr.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in tr.disc.state_dict().items()}

    jm = pm = None
    for _ in range(steps):
        gen_state, disc_state, jm = fns.train_step(gen_state, disc_state, jnp.asarray(audio), None)
        pm = tr.step(torch.from_numpy(audio))
    d_mu = disc_params_from_jax(_np(_adam_mu(disc_state.opt_state)))
    d_new = disc_params_from_jax(_np(disc_state.params))
    return dict(
        jax_metrics={k: float(jm[k]) for k in KEYS},
        port_metrics={k: float(pm[k]) for k in KEYS},
        g_mu_jax=_bridge_gen(_adam_mu(gen_state.opt_state), h, half_bias=True),
        g_mu_port=_port_moments(tr.opt_g, tr.generator),
        d_mu_jax={**{f"mpd.{k}": v for k, v in d_mu[0].items()},
                  **{f"mrd.{k}": v for k, v in d_mu[1].items()}},
        d_mu_port=_port_moments(tr.opt_d, tr.disc),
        g_new_jax=_bridge_gen(gen_state.params, h, half_bias=False),
        g_new_port=tr.generator.state_dict(), g_old=g0,
        d_new_jax={**{f"mpd.{k}": v for k, v in d_new[0].items()},
                   **{f"mrd.{k}": v for k, v in d_new[1].items()}},
        d_new_port=tr.disc.state_dict(), d_old=d0,
    )


def assert_moments_close(port, ref, rel):
    """Per tensor ||port - ref|| <= rel * max(||ref||, 1e-4 * the largest ||ref||):
    the floor keeps a moment that is float noise around an exact zero (a
    LayerNorm scale over a band of constant log-magnitudes) from counting as
    a relative error of 1."""
    assert set(port) == set(ref)
    floor = 1e-4 * max(v.norm().item() for v in ref.values())
    errs = {k: (port[k] - ref[k]).norm().item() / max(ref[k].norm().item(), floor) for k in ref}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= rel, (worst, errs[worst])
    assert floor > 0


def assert_updates_close(new_port, new_ref, old, mu_ref, lr=LR):
    """Updates agree where the gradient is not float noise around an exact
    zero (|mu| >= 1e-4 of the largest |mu|): there Adam's step is lr * sign."""
    floor = 1e-4 * max(v.abs().max().item() for v in mu_ref.values())
    for k, ref in new_ref.items():
        live = mu_ref[k].abs() >= floor
        d = ((new_port[k] - old[k]) - (ref - old[k])).abs()[live]
        frac = (d > lr / 10).float().mean().item() if d.numel() else 0.0
        assert frac <= 0.01, (k, frac, d.max().item())


@pytest.fixture(scope="module")
def one_step_f32():
    h = _h()
    return run_both(h, _audio(2, h.segment_size))


def test_one_step_metrics_match_jax(one_step_f32):
    r = one_step_f32
    for k in KEYS:
        assert np.isfinite(r["port_metrics"][k]), k
        np.testing.assert_allclose(r["port_metrics"][k], r["jax_metrics"][k], rtol=1e-3, err_msg=k)


def test_one_step_generator_grads_match_jax(one_step_f32):
    assert_moments_close(one_step_f32["g_mu_port"], one_step_f32["g_mu_jax"], rel=2e-3)


def test_one_step_discriminator_grads_match_jax(one_step_f32):
    assert_moments_close(one_step_f32["d_mu_port"], one_step_f32["d_mu_jax"], rel=2e-3)


def test_one_step_updated_params_match_jax(one_step_f32):
    r = one_step_f32
    assert_updates_close(r["g_new_port"], r["g_new_jax"], r["g_old"], r["g_mu_jax"])
    assert_updates_close(r["d_new_port"], r["d_new_jax"], r["d_old"], r["d_mu_jax"])


@pytest.mark.slow
def test_two_steps_match_jax():
    h = _h()
    r = run_both(h, _audio(2, h.segment_size), steps=2)
    for k in KEYS:
        np.testing.assert_allclose(r["port_metrics"][k], r["jax_metrics"][k], rtol=2e-3, err_msg=k)
    assert_moments_close(r["g_mu_port"], r["g_mu_jax"], rel=5e-3)
    assert_moments_close(r["d_mu_port"], r["d_mu_jax"], rel=5e-3)


@pytest.mark.slow
def test_bf16_step_matches_jax():
    # bf16 trunks round at other places in the two frameworks: the metrics
    # and gradients agree to a few bf16 ulps, not to float32 rounding
    h = _h(compute_dtype="bfloat16")
    r = run_both(h, _audio(2, h.segment_size))
    for k in KEYS:
        np.testing.assert_allclose(r["port_metrics"][k], r["jax_metrics"][k], rtol=5e-2, err_msg=k)
    assert_moments_close(r["g_mu_port"], r["g_mu_jax"], rel=0.25)
    assert_moments_close(r["d_mu_port"], r["d_mu_jax"], rel=0.25)


def test_gradient_reaches_every_lstm_parameter_and_training_route_is_taken():
    """Backward through a tiny BSRNN gives every LSTM weight and summed bias a
    nonzero gradient (the fault this guards against: a kernel output without
    grad_fn stops autograd at each BiLSTM); under no_grad the inference
    route runs and the training route does not."""
    from nvse_tpu_torch.models import build_generator

    h = _h(num_repeat=2)
    gen, _ = build_generator(h)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 80, 9)).astype(np.float32) - 4)
    n_fwd = port_lstm.lstm_fwd_hc.launches, len(port_lstm.lstm_fwd_hc.launches_by_shape)
    out = gen(mel)
    (out[-1].square().mean() + out[0].mean()).backward()
    lstm = {n: p for n, p in gen.named_parameters() if ".lstm." in n}
    assert len(lstm) == 2 * 2 * 2 * 3      # repeats x (time, band) x directions x (w_ih, w_hh, b)
    for n, p in lstm.items():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, n
    # the encoder's biases (over bands above fmax the input is constant, its
    # LayerNorm output 0, and the exact gradient of LN scale and projection 0)
    enc = [p for n, p in gen.named_parameters() if n.startswith("core.encoder.b_")]
    assert enc and all(p.grad is not None and p.grad.abs().sum() > 0 for p in enc)
    # on the CPU no kernel launches: the counters stay put on both routes
    assert (port_lstm.lstm_fwd_hc.launches, len(port_lstm.lstm_fwd_hc.launches_by_shape)) == n_fwd

    calls = []
    orig = port_lstm._BiLSTMSaving.apply
    port_lstm._BiLSTMSaving.apply = lambda *a: calls.append(1) or orig(*a)
    try:
        with torch.no_grad():
            gen(mel)
        assert calls == []
        gen(mel)
        assert len(calls) == 2 * h.num_repeat
    finally:
        port_lstm._BiLSTMSaving.apply = orig


def test_eval_full_matches_jax():
    """Full-utterance validation: a 3000-sample utterance zero-padded to a
    16-frame bucket, every metric masked to the frames of real samples; the
    port's no-grad generator takes the inference route."""
    h = _h()
    jgen, domain = jax_build(h)
    gp = jax_params(jgen, np.zeros((1, h.num_mels, 9), np.float32), seed=0)
    gen_state = GenState.create(apply_fn=jgen.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, 10))
    wav = _audio(1, 3000, seed=2)
    audio = np.pad(wav, ((0, 0), (0, 16 * 256 - 3000)))
    _, ref = make_train_step(h, jgen, domain).eval_full(gen_state, jnp.asarray(audio),
                                                        jnp.asarray(3000, jnp.int32))
    tr = GANTrainer(h, device="cpu")
    tr.generator.load_state_dict(params_from_jax(gp, h))
    _, got = tr.eval_full(torch.from_numpy(audio), 3000)
    assert set(got) == set(ref) == {"Mel", "A", "IP", "GD", "PTD", "R", "I", "C"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-3, err_msg=k)
