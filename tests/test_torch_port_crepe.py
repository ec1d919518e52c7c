"""Port parity: CREPE (nvse_tpu_torch/metrics/crepe.py) against
nvse_tpu/metrics/crepe_jax.py.

Seeded weights in torchcrepe's layout (a seeded Crepe's state_dict, its
BatchNorm statistics drawn too) go to both: the port loads them as it loads
torchcrepe's full.pth, the JAX package through its torch_to_jax_params.
Compared: the posteriors of 8 frames at both capacities (float32 convs
summed in another order: atol 1e-6 on values in (0, 1)), the decoded pitch
and periodicity of a short wave, and periodicity_metrics with
$NVSE_CREPE_CKPT set (the port's CREPE on the CPU against the JAX one).
"""
import numpy as np
import pytest
import torch

from nvse_tpu.metrics import crepe_jax
from nvse_tpu.metrics import dsp as jax_dsp
from nvse_tpu_torch.metrics import crepe
from nvse_tpu_torch.metrics import dsp
from test_torch_port_joint import _one_torch_thread  # noqa: F401

SR = 22050


def _params(net):
    return crepe_jax.torch_to_jax_params({k: v.numpy() for k, v in net.state_dict().items()},
                                         net.model)


def _wave(seconds=0.12, seed=0, hz=210.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.mark.parametrize("model", ["tiny", "full"])
def test_posteriors_match_jax(model):
    net = crepe.Crepe(model, seed=3).eval()
    frames = np.random.default_rng(1).standard_normal((8, 1024)).astype(np.float32)
    got = crepe.posteriors(net, frames)
    want = np.asarray(crepe_jax.crepe_forward(_params(net), frames, model))
    assert got.shape == (8, 360)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_predict_f0_periodicity_matches_jax():
    net = crepe.Crepe("tiny", seed=5).eval()
    audio = _wave()
    f0, per = crepe.predict_f0_periodicity(audio, SR, net, batch_frames=16)
    f0_j, per_j = crepe_jax.predict_f0_periodicity(audio, SR, _params(net), "tiny",
                                                   batch_frames=16)
    assert f0.shape == f0_j.shape == (13,)
    np.testing.assert_allclose(f0, f0_j, rtol=1e-5)
    np.testing.assert_allclose(per, per_j, rtol=0, atol=1e-6)


def test_periodicity_metrics_take_the_ports_crepe_from_the_env(monkeypatch, tmp_path):
    net = crepe.Crepe("tiny", seed=7)
    ckpt = tmp_path / "tiny.pth"
    torch.save(net.state_dict(), ckpt)
    monkeypatch.setenv("NVSE_CREPE_CKPT", str(ckpt))
    monkeypatch.setenv("NVSE_CREPE_MODEL", "tiny")
    ref, deg = _wave(seed=0), _wave(seed=1, hz=224.0)
    got = dsp.periodicity_metrics(ref, deg, SR, device="cpu")
    want = jax_dsp.periodicity_metrics(ref, deg, SR)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["periodicity_rmse"], want["periodicity_rmse"], rtol=1e-4)
    assert got["vuv_f1"] == want["vuv_f1"]
    # random weights decode both waves to nearly one pitch: the RMSE is a difference
    # of two pitches that agree to rtol 1e-5 each (1200 log2(1 + 1e-5) = 0.017 cents)
    np.testing.assert_allclose(got["pitch_rmse_cents"], want["pitch_rmse_cents"], atol=0.02)
    monkeypatch.delenv("NVSE_CREPE_CKPT")
    yin = dsp.periodicity_metrics(ref, deg, SR, device="cpu")
    assert yin != got and yin == jax_dsp.periodicity_metrics(ref, deg, SR)


def test_load_refuses_what_is_not_a_torchcrepe_state_dict():
    sd = crepe.Crepe("tiny").state_dict()
    for bad, match in (({k: v for k, v in sd.items() if k != "conv3.bias"}, "missing"),
                       ({**sd, "conv7.weight": sd["conv1.weight"]}, "surplus"),
                       ({**sd, "classifier.weight": sd["classifier.weight"][:, :10]}, "misshapen")):
        with pytest.raises(ValueError, match=match):
            crepe.load_crepe_state_dict(crepe.Crepe("tiny"), bad)
    with pytest.raises(ValueError, match="misshapen"):
        crepe.load_crepe_state_dict(crepe.Crepe("full"), sd)
    net = crepe.load_crepe_state_dict(crepe.Crepe("tiny", seed=9),
                                      {**sd, "conv1_BN.num_batches_tracked": torch.tensor(0)})
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(), sd.values()))
