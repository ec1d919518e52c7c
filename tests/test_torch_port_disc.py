"""Port parity: MPD / MRD and the GAN and spectral losses against nvse_tpu.

Discriminators: the same seeded numpy weights (in the JAX trees' shapes,
mapped by disc_params_from_jax) and the same 2 x 2048 waves through both
packages; every logit and feature map compared (the port's NCHW maps
transposed to the JAX package's NHWC) at rtol 1e-4 / atol 2e-5: float32
convolutions summed in another order. Losses: the same arrays through both,
with and without a frame mask, at rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu import losses as jl
from nvse_tpu.losses.spectral import _masked_mean as jax_masked_mean
from nvse_tpu.models import MultiPeriodDiscriminator as JMPD
from nvse_tpu.models import MultiResolutionDiscriminator as JMRD
from nvse_tpu_torch import losses as tl
from nvse_tpu_torch.losses.spectral import _masked_mean
from nvse_tpu_torch.models.discriminators import MultiPeriodDiscriminator, MultiResolutionDiscriminator
from nvse_tpu_torch.utils import disc_params_from_jax
from test_torch_port_joint import _one_torch_thread  # noqa: F401

SEG = 2048


def disc_params(seed=1, segment=SEG, periods=(2, 3, 5, 7, 11)):
    """Seeded numpy weight-norm params in the JAX T-F discriminator trees'
    shapes (jax.eval_shape, no JAX init): v ~ U(+-1/sqrt(fan_in)),
    g = ||v|| per output channel, bias like v."""
    wave = jnp.zeros((2, segment), jnp.float32)
    rng = np.random.default_rng(seed)

    def conv(node):
        if "v" not in node:
            return {k: conv(v) for k, v in node.items()}
        kh, kw, cin, cout = node["v"].shape
        bound = 1.0 / np.sqrt(kh * kw * cin)
        v = rng.uniform(-bound, bound, (kh, kw, cin, cout)).astype(np.float32)
        g = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1, 2))).reshape(1, 1, 1, cout)
        return {"v": v, "g": g.astype(np.float32),
                "bias": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}

    out = {}
    for key, mod in (("mpd", JMPD(periods=tuple(periods))), ("scale", JMRD())):
        out[key] = conv(jax.eval_shape(mod.init, jax.random.PRNGKey(0), wave, wave)["params"])
    return out


def _waves(seed=0):
    rng = np.random.default_rng(seed)
    y = (0.3 * rng.standard_normal((2, SEG))).astype(np.float32)
    y_hat = (0.3 * rng.standard_normal((2, SEG))).astype(np.float32)
    return y, y_hat


@pytest.fixture(scope="module")
def params():
    return disc_params()


@pytest.mark.parametrize("which", ["mpd", "mrd"])
def test_discriminator_matches_jax(params, which):
    y, y_hat = _waves()
    jmod, tmod, key = ((JMPD(), MultiPeriodDiscriminator(), "mpd") if which == "mpd"
                       else (JMRD(), MultiResolutionDiscriminator(), "scale"))
    ref = jax.jit(jmod.apply)({"params": params[key]}, jnp.asarray(y), jnp.asarray(y_hat))
    tmod.load_state_dict(disc_params_from_jax(params)[0 if which == "mpd" else 1])
    with torch.no_grad():
        got = tmod(torch.from_numpy(y), torch.from_numpy(y_hat))
    tol = dict(rtol=1e-4, atol=2e-5)
    for logits, ref_logits in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **tol)
    n_maps = 0
    for fmaps, ref_fmaps in zip(got[2] + got[3], ref[2] + ref[3]):
        for f, rf in zip(fmaps, ref_fmaps):
            np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), np.asarray(rf), **tol)
            n_maps += 1
    assert n_maps == 2 * len(got[2]) * 6


def test_disc_state_dicts_cover_every_parameter(params):
    mpd_sd, mrd_sd = disc_params_from_jax(params)
    for sd, mod, key in ((mpd_sd, MultiPeriodDiscriminator(), "mpd"),
                         (mrd_sd, MultiResolutionDiscriminator(), "scale")):
        assert set(sd) == set(mod.state_dict())
        for k, v in mod.state_dict().items():
            assert sd[k].shape == v.shape, k
        n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(params[key]))
        assert sum(v.numel() for v in sd.values()) == n_jax


def test_weight_norm_floor_and_init():
    from nvse_tpu_torch.models.layers import Conv2d

    conv = Conv2d(2, 3, (3, 1), gen=torch.Generator().manual_seed(0))
    torch.testing.assert_close(conv.kernel(), conv.v)          # g = ||v|| at init
    with torch.no_grad():
        conv.v.zero_()
    assert torch.isfinite(conv.kernel()).all()                 # ||v|| = 0: the 1e-12 floor


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _nested(rng, shapes):
    return [[rng.standard_normal(s).astype(np.float32) for s in grp] for grp in shapes]


def _to(tree, fn):
    return [[fn(a) for a in grp] for grp in tree]


def test_gan_losses_match_jax():
    rng = np.random.default_rng(0)
    shapes = [[(2, 4, 3), (2, 5)], [(2, 7), (2, 2, 2)]]
    fr, fg = _nested(rng, shapes), _nested(rng, shapes)
    np.testing.assert_allclose(
        float(tl.feature_loss(_to(fr, torch.from_numpy), _to(fg, torch.from_numpy))),
        float(jl.feature_loss(_to(fr, jnp.asarray), _to(fg, jnp.asarray))), rtol=1e-5)
    dr = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 3)]
    dg = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 3)]
    T = lambda xs: [torch.from_numpy(x) for x in xs]
    J = lambda xs: [jnp.asarray(x) for x in xs]
    for t_fn, j_fn in ((tl.ls_discriminator_loss, jl.ls_discriminator_loss),
                       (tl.hinge_discriminator_loss, jl.hinge_discriminator_loss)):
        got, ref = t_fn(T(dr), T(dg)), j_fn(J(dr), J(dg))
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
        np.testing.assert_allclose([float(v) for v in got[1] + got[2]],
                                   [float(v) for v in ref[1] + ref[2]], rtol=1e-5)
    for t_fn, j_fn in ((tl.ls_generator_loss, jl.ls_generator_loss),
                       (tl.hinge_generator_loss, jl.hinge_generator_loss)):
        got, ref = t_fn(T(dg)), j_fn(J(dg))
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
        np.testing.assert_allclose([float(v) for v in got[1]], [float(v) for v in ref[1]], rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_spectral_losses_match_jax(masked):
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.standard_normal((2, 9, 11)).astype(np.float32) * 4 for _ in range(4))
    mask = (np.arange(11) < 7).astype(np.float32) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (tl.amplitude_loss(t(a), t(b), mask=tm), jl.amplitude_loss(j(a), j(b), mask=jm)),
        (tl.stft_consistency_loss(t(a), t(b), t(c), t(d), mask=tm),
         jl.stft_consistency_loss(j(a), j(b), j(c), j(d), mask=jm)),
        (_masked_mean(t(a), tm), jax_masked_mean(j(a), jm)),
        *zip(tl.phase_loss(t(a), t(b), mask=tm), jl.phase_loss(j(a), j(b), mask=jm)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_anti_wrapping_rounds_half_to_even_as_jax():
    x = (np.array([-5, -3, -1, 1, 3, 5, 0.5, 2.2], np.float32) * np.pi).astype(np.float32)
    np.testing.assert_allclose(tl.anti_wrapping_function(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.anti_wrapping_function(jnp.asarray(x))), rtol=1e-6)
