"""Port parity: the CQT (ops/cqt.py), the multi-scale sub-band CQT
discriminator (models/cqt_discriminator.py) and its wiring into every GAN
trainer (h.use_cqtd) against nvse_tpu.

At the JAX package's own tiny CQTD (tests/test_train_step.py:154-170): one
scale at hop 256, 4 octaves of 12 bins, 8 filters. Seeded numpy weights in
the JAX tree's shapes (jax.eval_shape, no JAX init) go to both packages,
mapped onto the port by cqtd_params_from_jax. Compared:
  * the CQT bank bit for bit, the transform in float32 (sums of 16384 terms
    in another order: atol 1e-7 on values up to ~1e-2) and bfloat16 (one
    rounding of the output: 2e-2 of the peak);
  * the discriminator's logits, feature maps and the gradient of a loss of
    both with respect to the generated wave, at rtol 2e-3 / atol 2e-4;
  * one T-F GAN step (BSRNN feature_dim 8, MPD + MRD + CQTD) against
    make_train_step: the metrics at rtol 1e-5, the AdamW first moments of the
    generator and of all three discriminators at a relative L2 of 2e-3
    (tests/test_torch_port_train.py's rule);
  * the time and joint trainers build disc["cqtd"], the D pass changes every
    CQTD parameter and the G pass none; the do_ bundle carries it
    (tests/test_torch_port_cqtd_trainers.py, its own file so that the two
    halves run on different test workers).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.models.cqt_discriminator import MultiScaleSubbandCQTDiscriminator as JCQTD
from nvse_tpu.ops.cqt import _cqt_kernels_np as jax_bank
from nvse_tpu.ops.cqt import cqt as jax_cqt
from nvse_tpu.train.trainer import DiscState, GenState
from nvse_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvse_tpu.train.trainer import make_train_step
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.models.cqt_discriminator import MultiScaleSubbandCQTDiscriminator
from nvse_tpu_torch.ops.cqt import _cqt_kernels_np, cqt
from nvse_tpu_torch.train import GANTrainer
from nvse_tpu_torch.utils import cqtd_params_from_jax, disc_params_from_jax, params_from_jax

from test_torch_port_bsrnn import jax_params
from test_torch_port_disc import disc_params
from test_torch_port_train import (_adam_mu, _audio, _bridge_gen, _h, _np, _port_moments,
                                   assert_moments_close)
from test_torch_port_joint import _one_torch_thread  # noqa: F401

TINY = dict(use_cqtd=True, cqtd_weight=1.0, cqtd_hop_lengths=[256], cqtd_n_octaves=[4],
            cqtd_bins_per_octaves=[12], cqtd_filters=8)
SR2 = 44100   # the discriminator's CQT runs at twice the 22.05 kHz rate
TOL = dict(rtol=2e-3, atol=2e-4)


def cqtd_params(h, seed=3):
    """Seeded numpy params in the JAX CQTD tree's shapes: plain convs' kernel and
    bias U(+-1/sqrt(fan_in)); weight-normed v like them, g = ||v|| per output
    channel times a draw from [0.5, 1.5], so that g != ||v||."""
    wave = jnp.zeros((2, h.segment_size), jnp.float32)
    shapes = jax.eval_shape(JCQTD.from_config(h).init, jax.random.PRNGKey(0), wave, wave)
    rng = np.random.default_rng(seed)

    def fill(node):
        if "bias" not in node:
            return {k: fill(v) for k, v in node.items()}
        key = "v" if "v" in node else "kernel"
        kh, kw, cin, cout = node[key].shape
        bound = 1.0 / np.sqrt(kh * kw * cin)
        w = rng.uniform(-bound, bound, (kh, kw, cin, cout)).astype(np.float32)
        out = {key: w, "bias": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}
        if key == "v":
            norm = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1, 2)))
            out["g"] = (norm * rng.uniform(0.5, 1.5, cout)).reshape(1, 1, 1, cout).astype(np.float32)
        return out

    return fill(shapes["params"])


def _waves(seed=0, n=2048):
    rng = np.random.default_rng(seed)
    return tuple((0.3 * rng.standard_normal((2, n))).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cqt_and_its_bank_match_jax(dtype):
    bank, klen = _cqt_kernels_np(SR2, 48, 12, 32.70319566257483)
    ref_bank, ref_klen = jax_bank(SR2, 48, 12, 32.70319566257483)
    assert klen == ref_klen == 16384 and not bank.flags.writeable
    np.testing.assert_array_equal(bank, ref_bank)
    x, _ = _waves(n=4096)
    got = cqt(torch.from_numpy(x).to(getattr(torch, dtype)), SR2, 256, 48, 12)
    ref = jax_cqt(jnp.asarray(x).astype(getattr(jnp, dtype)), SR2, 256, 48, 12)
    for g, r in zip(got, ref):
        g, r = g.float().numpy(), np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape == (2, 48, 17)
        atol = 1e-7 if dtype == "float32" else 2e-2 * np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)


def test_discriminator_and_its_input_gradient_match_jax():
    h = _h(**TINY)
    params = cqtd_params(h)
    jmod = JCQTD.from_config(h)
    tmod = MultiScaleSubbandCQTDiscriminator.from_config(h)
    tmod.load_state_dict(cqtd_params_from_jax(params))
    y, y_hat = _waves()
    probe = np.random.default_rng(5)

    def loss(out, xp):
        # a scalar of every logit and feature map, with fixed random weights
        flat = [*out[0], *out[1], *[f for fm in out[2] + out[3] for f in fm]]
        return sum((f * w).sum() for f, w in zip(flat, weights(xp, flat)))

    cache = {}

    def weights(xp, flat):
        if xp not in cache:
            cache[xp] = [probe.standard_normal(tuple(f.shape)).astype(np.float32) for f in flat]
        return cache[xp]

    ref = jmod.apply({"params": params}, jnp.asarray(y), jnp.asarray(y_hat))
    # the reference's maps are NHWC; the port's NCHW
    ref_w = weights("jax", [*ref[0], *ref[1], *[f for fm in ref[2] + ref[3] for f in fm]])
    ref_grad = jax.grad(lambda yh: loss(jmod.apply({"params": params}, jnp.asarray(y), yh),
                                        "jax"))(jnp.asarray(y_hat))
    yh_t = torch.from_numpy(y_hat).requires_grad_(True)
    got = tmod(torch.from_numpy(y), yh_t)
    got_flat = [*got[0], *got[1], *[f.permute(0, 2, 3, 1) for fm in got[2] + got[3] for f in fm]]
    ref_flat = [*ref[0], *ref[1], *[f for fm in ref[2] + ref[3] for f in fm]]
    assert len(got_flat) == len(ref_flat) == 2 + 2 * 5
    for g, r in zip(got_flat, ref_flat):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)
    sum((f * torch.from_numpy(w)).sum() for f, w in zip(got_flat, ref_w)).backward()
    np.testing.assert_allclose(yh_t.grad.numpy(), np.asarray(ref_grad), **TOL)
    assert np.abs(np.asarray(ref_grad)).max() > 0


def test_one_tf_step_with_the_cqt_discriminator_matches_jax():
    h = _h(num_repeat=1, **TINY)
    audio = _audio(2, h.segment_size)
    jgen, domain = jax_build(h)
    gp = jax_params(jgen, np.zeros((1, h.num_mels, h.segment_size // h.hop_size + 1),
                                   np.float32), seed=0)
    dp = {**disc_params(segment=h.segment_size, periods=h.mpd_reshapes), "cqtd": cqtd_params(h)}
    spe = 10
    gen_state = GenState.create(apply_fn=jgen.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, spe))
    disc_state = DiscState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, dp),
                                  tx=jax_make_optimizer(h, spe), spectral=None)
    gen_state = gen_state.replace(step=jnp.asarray(0, jnp.int32))
    disc_state = disc_state.replace(step=jnp.asarray(0, jnp.int32))
    gen_state, disc_state, jm = make_train_step(h, jgen, domain).train_step(
        gen_state, disc_state, jnp.asarray(audio), None)

    tr = GANTrainer(h, device="cpu", steps_per_epoch=spe)
    tr.generator.load_state_dict(params_from_jax(gp, h))
    mpd_sd, mrd_sd = disc_params_from_jax(dp)
    tr.disc["mpd"].load_state_dict(mpd_sd)
    tr.disc["mrd"].load_state_dict(mrd_sd)
    tr.disc["cqtd"].load_state_dict(cqtd_params_from_jax(dp["cqtd"]))
    pm = tr.step(torch.from_numpy(audio))
    for k in ("A", "IP", "GD", "PTD", "C", "R", "I", "Mel", "GAN", "FM", "G", "D"):
        assert np.isfinite(float(pm[k])), k
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert_moments_close(_port_moments(tr.opt_g, tr.generator),
                         _bridge_gen(_adam_mu(gen_state.opt_state), h, half_bias=True), rel=2e-3)
    mu = _np(_adam_mu(disc_state.opt_state))
    mpd_mu, mrd_mu = disc_params_from_jax(mu)
    d_mu = {**{f"mpd.{k}": v for k, v in mpd_mu.items()},
            **{f"mrd.{k}": v for k, v in mrd_mu.items()},
            **{f"cqtd.{k}": v for k, v in cqtd_params_from_jax(mu["cqtd"]).items()}}
    assert_moments_close(_port_moments(tr.opt_d, tr.disc), d_mu, rel=2e-3)
