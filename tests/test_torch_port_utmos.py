"""Port parity: UTMOS (nvse_tpu_torch/metrics/utmos.py) against
nvse_tpu/metrics/utmos_torch.py and utmos_jax.py.

Seeded weights of the port's UTMOSModel go to the JAX package's models:
every tensor by name, the decoder BiLSTM in torch.nn.LSTM's layout (the
port's summed bias as bias_ih, bias_hh zero), and the positional conv as
its folded weight. The port holds that conv as fairseq checkpoints do,
weight norm over dim 2 (weight_g (1, 1, 128)); the JAX package's torch model
holds weight_g (768, 1, 1), the norm over the other two dims, so the two
get g and v that fold to the same weight. Compared, on 0.5 s waves:
  * the score against utmos_torch.UTMOSModel at 2e-4 (the JAX package's
    own tolerance, tests/test_utmos_jax.py), and against one un-jitted call
    of utmos_jax.utmos_forward with and without n_samples;
  * a padded and masked score against the exact-length one at 3 pads, 1e-4;
  * the length-aware BiLSTM's plain version (lstm_scan_fused with lengths)
    against utmos_jax._lstm_dir with its mask, on the valid frames;
  * the lightning-layout round trip (lightning_state_dict -> load_utmos) and
    score_dir.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvse_tpu.metrics import utmos_jax
from nvse_tpu.metrics import utmos_torch as J
from nvse_tpu_torch.data.audio_io import write_wav
from nvse_tpu_torch.metrics import utmos as P
from nvse_tpu_torch.ops.lstm import lstm_scan_fused, prefix_reversal
from test_torch_port_joint import _one_torch_thread  # noqa: F401

SR = 16000
TOL = 2e-4


@pytest.fixture(scope="module")
def model():
    return P.UTMOSModel(seed=1).eval()


def jax_package_state_dict(model):
    """The port model's weights in utmos_torch.UTMOSModel's names and shapes."""
    out = {k: v.clone() for k, v in model.state_dict().items() if not k.startswith("decoder_rnn.")}
    w = model.ssl_model.encoder.pos_conv[0].weight().detach()
    out["ssl_model.encoder.pos_conv.0.weight_v"] = w
    out["ssl_model.encoder.pos_conv.0.weight_g"] = w.norm(dim=(1, 2), keepdim=True)
    for k, v in P.lightning_state_dict(model).items():
        if ".decoder_rnn." in k:
            out["decoder_rnn." + k.split(".decoder_rnn.")[1]] = v
    return out


def _wavs(n=SR // 2, b=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.2 * np.sin(2 * np.pi * rng.uniform(120, 300, (b, 1)) * t) + 0.05 * rng.standard_normal((b, n))
    return torch.from_numpy(x.astype(np.float32))


def test_score_matches_the_jax_packages_torch_model(model):
    ref = J.UTMOSModel().eval()
    ref.load_state_dict(jax_package_state_dict(model), strict=True)
    wav = _wavs()
    with torch.no_grad():
        want = ref(wav)
    got = model(wav)
    assert got.shape == (2,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_pos_conv_folds_as_torch_weight_norm_over_dim_2(model):
    pc = model.ssl_model.encoder.pos_conv[0]
    assert tuple(pc.weight_g.shape) == (1, 1, 128)
    conv = torch.nn.Conv1d(768, 768, 128, padding=64, groups=16)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, dim=2)
    with torch.no_grad():
        conv.parametrizations.weight.original0.copy_(pc.weight_g * 1.5)
        conv.parametrizations.weight.original1.copy_(pc.weight_v)
        pc.weight_g.mul_(1.5)
        np.testing.assert_allclose(pc.weight().numpy(), conv.weight.numpy(), rtol=1e-5, atol=1e-6)
        pc.weight_g.div_(1.5)


@pytest.mark.parametrize("pad", [1, 400, 3203])
def test_padded_masked_score_equals_the_exact_one(model, pad):
    wav = _wavs(b=1, seed=pad)
    exact = model(wav)
    padded = torch.cat([wav, torch.zeros(1, pad)], dim=1)
    np.testing.assert_allclose(model(padded, n_samples=wav.shape[1]).numpy(), exact.numpy(),
                               rtol=0, atol=1e-4)


def test_rows_of_different_lengths_in_one_batch(model):
    a, b = _wavs(n=7000, b=1, seed=1), _wavs(n=SR // 2, b=1, seed=2)
    batch = torch.cat([torch.cat([a, torch.zeros(1, b.shape[1] - a.shape[1])], 1), b])
    got = model(batch, n_samples=[a.shape[1], b.shape[1]])
    want = torch.cat([model(a), model(b)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_one_unjitted_utmos_forward_with_and_without_n_samples(model):
    """Both calls on one shape: un-jitted, each JAX op compiles once a shape."""
    params = utmos_jax.torch_to_jax_params(jax_package_state_dict(model))
    wav = _wavs(b=1, seed=3)
    padded = np.pad(wav.numpy(), ((0, 0), (0, 800)))
    want = np.asarray(utmos_jax.utmos_forward(params, jnp.asarray(padded)))
    np.testing.assert_allclose(model(torch.from_numpy(padded)).numpy(), want, rtol=0, atol=TOL)
    want_m = np.asarray(utmos_jax.utmos_forward(params, jnp.asarray(padded),
                                                n_samples=jnp.int32(wav.shape[1])))
    got_m = model(torch.from_numpy(padded), n_samples=wav.shape[1])
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=0, atol=TOL)
    assert abs(float(want_m[0]) - float(want[0])) > 10 * TOL


def test_length_aware_bilstm_matches_the_masked_jax_scan():
    rng = np.random.default_rng(5)
    B, T, C, H = 3, 9, 12, 8
    lengths = [9, 5, 1]
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = {k: (0.3 * rng.standard_normal(s)).astype(np.float32) for k, s in (
        ("w_ih_f", (C, 4 * H)), ("w_ih_b", (C, 4 * H)), ("b_f", (4 * H,)), ("b_b", (4 * H,)),
        ("w_hh_f", (H, 4 * H)), ("w_hh_b", (H, 4 * H)))}
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    got = lstm_scan_fused(torch.from_numpy(x), t["w_ih_f"], t["w_ih_b"], t["b_f"], t["b_b"],
                          t["w_hh_f"], t["w_hh_b"], lengths=lengths).numpy()
    for b, L in enumerate(lengths):
        mask = jnp.arange(T) < L
        xb = jnp.asarray(x[b:b + 1])
        fwd = utmos_jax._lstm_dir(xb, w["w_ih_f"].T, w["w_hh_f"].T, w["b_f"], mask=mask)
        bwd = utmos_jax._lstm_dir(xb, w["w_ih_b"].T, w["w_hh_b"].T, w["b_b"], reverse=True,
                                  mask=mask)
        np.testing.assert_allclose(got[b, :L, :H], np.asarray(fwd)[0, :L], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[b, :L, H:], np.asarray(bwd)[0, :L], rtol=1e-5, atol=1e-6)
    idx = prefix_reversal(T, lengths, "cpu")
    assert idx[:, 1].tolist() == [4, 3, 2, 1, 0, 5, 6, 7, 8]
    with pytest.raises(ValueError, match="lengths"):
        prefix_reversal(T, [10, 1, 1], "cpu")
    with pytest.raises(NotImplementedError, match="inference"):
        lstm_scan_fused(torch.from_numpy(x), t["w_ih_f"].requires_grad_(), t["w_ih_b"], t["b_f"],
                        t["b_b"], t["w_hh_f"], t["w_hh_b"], lengths=lengths)


def test_lightning_checkpoint_round_trip_and_score_dir(model, tmp_path):
    ckpt = tmp_path / "utmos.ckpt"
    sd = P.lightning_state_dict(model)
    assert "model.output_layers.0.decoder_rnn.weight_ih_l0_reverse" in sd
    assert tuple(sd["model.output_layers.0.decoder_rnn.weight_ih_l0"].shape) == (2048, 1024)
    torch.save({"state_dict": sd}, ckpt)
    loaded = P.load_utmos(str(ckpt), device="cpu")
    for (k, v), w in zip(model.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(v, w), k
    wavs = _wavs(b=2, seed=4)
    d = tmp_path / "deg"
    d.mkdir()
    for i in range(2):
        write_wav(str(d / f"{i}.wav"), wavs[i].numpy(), SR)
    mean, std = P.score_dir(str(d), str(ckpt), device="cpu")
    scores = model(wavs).numpy()
    np.testing.assert_allclose([mean, std], [scores.mean(), scores.std()], atol=1e-3)
    torch.save({"state_dict": {k: v for k, v in sd.items() if "judge" not in k}}, ckpt)
    with pytest.raises(RuntimeError, match="missing"):
        P.load_utmos(str(ckpt), device="cpu")
