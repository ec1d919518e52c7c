"""The CQT discriminator in every GAN trainer of the port (h.use_cqtd), at
the tiny CQTD of tests/test_torch_port_cqtd.py and an MPD of one period:
the T-F, time and joint trainers build disc["cqtd"], the D pass changes every
CQTD parameter and the G pass none, and the do_ bundle carries it through a
save and a restore.
"""
import numpy as np
import pytest
import torch

from nvse_tpu_torch.train import GANTrainer
from nvse_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

from test_torch_port_cqtd import TINY
from test_torch_port_train import _audio, _h
from test_torch_port_joint import _one_torch_thread  # noqa: F401


TIME_H = dict(model_name="HiFiGAN", resblock="1", upsample_rates=[8, 8, 2, 2],
              upsample_kernel_sizes=[16, 16, 4, 4], upsample_initial_channel=16,
              resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], mpd_reshapes=[2])
JOINT_H = dict(model_name="BSRNN_24k", feature_dim=8, num_repeat=1, sampling_rate=24000,
               num_mels=100, fmax=12000, mpd_reshapes=[2])


@pytest.mark.parametrize("domain", ["tf", "time", "joint"])
def test_every_trainer_trains_the_cqt_discriminator(domain):
    """D changes every CQTD parameter, G none, and the step is finite."""
    kw = {"tf": dict(num_repeat=1, mpd_reshapes=[2]), "time": TIME_H, "joint": JOINT_H}[domain]
    h = _h(**{**kw, **TINY})
    tr = GANTrainer(h, device="cpu", joint=domain == "joint")
    assert set(tr.disc) == {"mpd", "mrd" if domain != "time" else "msd", "cqtd"}
    assert any(p is q for p in tr.opt_d.param_groups[0]["params"]
               for q in tr.disc["cqtd"].parameters())
    audio = torch.from_numpy(_audio(2, h.segment_size))
    args = (audio, audio, "vocoder") if domain == "joint" else (audio,)
    before = {n: p.detach().clone() for n, p in tr.disc["cqtd"].named_parameters()}
    fwd = tr.generator_forward(*args)
    tr.discriminator_update(fwd)
    after_d = {n: p.detach().clone() for n, p in tr.disc["cqtd"].named_parameters()}
    metrics, _ = tr.generator_update(fwd)
    assert all(not torch.equal(before[n], after_d[n]) for n in before)
    assert all(torch.equal(p, after_d[n]) for n, p in tr.disc["cqtd"].named_parameters())
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_do_bundle_round_trip_restores_the_cqt_discriminator(tmp_path):
    h = _h(num_repeat=1, mpd_reshapes=[2], **TINY)
    tr = GANTrainer(h, device="cpu", steps_per_epoch=4)
    tr.step(torch.from_numpy(_audio(2, h.segment_size)))
    save_checkpoint(str(tmp_path), 1, 0, tr)
    assert "cqtd" in torch.load(tmp_path / "do_00000001", weights_only=True)
    fresh = GANTrainer(_h(num_repeat=1, seed=99, mpd_reshapes=[2], **TINY), device="cpu",
                       steps_per_epoch=4)
    assert not torch.equal(fresh.disc["cqtd"].discs[0].convs[0].kernel,
                           tr.disc["cqtd"].discs[0].convs[0].kernel)
    assert restore_checkpoint(str(tmp_path), fresh) == (2, 0)
    for (k, v), w in zip(tr.disc["cqtd"].state_dict().items(),
                         fresh.disc["cqtd"].state_dict().values()):
        assert torch.equal(v, w), k
    for p, q in zip(tr.disc["cqtd"].parameters(), fresh.disc["cqtd"].parameters()):
        assert torch.equal(tr.opt_d.state[p]["exp_avg"], fresh.opt_d.state[q]["exp_avg"])
