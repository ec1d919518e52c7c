"""Port parity: the whole BSRNN / BSRNN_24k generator against the JAX one.

Both packages get the same weights (numpy values from a seed in the JAX
tree's shapes, mapped by params_from_jax) and the same numpy input; all
five outputs are compared. Tolerances are those of
tests/test_torch_parity.py (rtol 2e-3 / atol 2e-4, phase as the wrapped
difference at atol 5e-3): float32 sums are taken in another order
through 2 BSNets and an iSTFT.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.models import build_generator
from nvse_tpu_torch.utils import params_from_jax

NAMES = ("logamp", "phase", "rea", "imag", "wav")


def _h(model_name, sr, causal=False):
    return AttrDict(dict(
        model_name=model_name, feature_dim=8, num_repeat=2, dropout=0.0, causal=causal,
        sampling_rate=sr, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
        fmin=0, fmax=8000, seed=1234,
    ))


def jax_params(jgen, x, seed=0):
    """Seeded numpy weights in the shapes of the JAX generator's tree
    (eval_shape: no JAX init, whose compile dominates on the CPU)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.asarray(x[:1, :, :8]))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        bound = 1.0 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.3
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def assert_tf_outputs_close(ours, theirs):
    for name, a, b in zip(NAMES, ours, theirs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.isfinite(a).all(), name
        if name == "phase":
            d = np.angle(np.exp(1j * (a.astype(np.float64) - b.astype(np.float64))))
            assert np.abs(d).max() < 5e-3, (name, np.abs(d).max())
        else:
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("model_name,sr,bins,causal", [
    ("BSRNN", 22050, 80, False),
    ("BSRNN_24k", 24000, 513, False),
    ("BSRNN", 22050, 80, True),     # time LSTM on the plain CPU scan
])
def test_generator_matches_jax(model_name, sr, bins, causal):
    h = _h(model_name, sr, causal)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, bins, 40)).astype(np.float32) - 4.0
    jgen, _ = jax_build(h)
    jparams = jax_params(jgen, x)
    theirs = jax.jit(jgen.apply)({"params": jparams}, jnp.asarray(x))

    gen, domain = build_generator(h)
    assert domain == "tf"
    gen.load_state_dict(params_from_jax(jparams, h))
    with torch.no_grad():
        ours = [t.numpy() for t in gen(torch.from_numpy(x))]
    assert ours[-1].shape == (2, 256 * 39)
    assert_tf_outputs_close(ours, theirs)


def test_state_dict_covers_every_parameter():
    h = _h("BSRNN", 22050)
    jgen, _ = jax_build(h)
    jparams = jax_params(jgen, np.zeros((1, 80, 8), np.float32))
    sd = params_from_jax(jparams, h)
    gen, _ = build_generator(h)
    assert set(sd) == set(gen.state_dict())
    for k, v in gen.state_dict().items():
        assert sd[k].shape == v.shape, k
    # LSTM biases are summed: one per direction instead of b_ih and b_hh
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(jparams))
    n_port = sum(v.numel() for v in sd.values())
    n_bias = 2 * 2 * 2 * 4 * 8    # repeats x (time, band) x directions x 4H
    assert n_port == n_jax - n_bias


def test_unported_model_raises_listing_ported():
    h = _h("HiFiGAN", 22050)
    with pytest.raises(NotImplementedError, match="BSRNN"):
        build_generator(h)


def test_random_init_is_seeded():
    h = _h("BSRNN", 22050)
    a, _ = build_generator(h)
    b, _ = build_generator(h)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
