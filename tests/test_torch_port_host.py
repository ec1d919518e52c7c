"""The port's training host side: lr schedule, optimizer groups, data,
checkpoints, the CLI, and serving what training writes (CPU, tiny config)."""
import json
import os
import random
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

from nvse_tpu.data import PrefetchLoader as JaxLoader
from nvse_tpu.data import SegmentDataset as JaxSegments
from nvse_tpu.data import get_dataset_filelist as jax_filelist
from nvse_tpu_torch.data import PrefetchLoader, SegmentDataset, get_dataset_filelist
from nvse_tpu_torch.infer import InferenceEngine
from nvse_tpu_torch.models.layers import LSTM
from nvse_tpu_torch.train import GANTrainer, learning_rate, make_optimizer, train_joint
from nvse_tpu_torch.train.loop import _training_mesh, parallel_plan
from nvse_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint, scan_checkpoint
from nvse_tpu_torch.utils import AttrDict, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "DatasetsScp", "synth")
LISTS = (os.path.join(SYNTH, "train_filelist.txt"), os.path.join(SYNTH, "val_filelist.txt"),
         os.path.join(SYNTH, "wavs"))


def _h(**kw):
    d = dict(model_name="BSRNN", feature_dim=8, num_repeat=1, dropout=0.0, causal=False,
             sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
             fmin=0, fmax=8000, meloss=None, segment_size=2048, batch_size=2,
             learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, mrd_weight=0.1,
             mpd_reshapes=[2, 3], seed=1234)
    d.update(kw)
    return AttrDict(d)


@pytest.mark.parametrize("spe", [1, 7])
def test_learning_rate_is_the_optax_staircase(spe):
    h = _h(lr_decay=0.9)
    sched = optax.exponential_decay(2e-4, transition_steps=spe, decay_rate=0.9, staircase=True)
    for step in (0, spe - 1, spe, 2 * spe, 5 * spe + 3):
        np.testing.assert_allclose(learning_rate(h, spe, step), float(sched(step)), rtol=1e-6)


def test_summed_lstm_bias_steps_as_two_tensors():
    """AdamW on b = b_ih + b_hh (group with copies = 2) equals two AdamW
    tensors b_ih, b_hh with the same gradient, summed; over 3 steps."""
    h = _h()
    lstm = LSTM(4, 8, bidirectional=True, gen=torch.Generator().manual_seed(0))
    opt = make_optimizer(lstm, h, steps_per_epoch=2)
    assert [len(g["params"]) for g in opt.param_groups] == [4, 2]
    b_ih = torch.nn.Parameter(lstm.b_fwd.detach() * 0.3)
    b_hh = torch.nn.Parameter(lstm.b_fwd.detach() * 0.7)
    ref = torch.optim.AdamW([b_ih, b_hh], lr=2e-4, betas=(0.8, 0.99), eps=1e-8, weight_decay=0.01)
    from nvse_tpu_torch.train import apply_update

    for k in range(3):
        g = torch.randn(lstm.b_fwd.shape, generator=torch.Generator().manual_seed(k))
        for p in lstm.parameters():
            p.grad = torch.zeros_like(p)
        lstm.b_fwd.grad = g.clone()
        b_ih.grad, b_hh.grad = g.clone(), g.clone()
        apply_update(opt, h, clip=0.0, skip_nonfinite=False)
        for grp in ref.param_groups:
            grp["lr"] = learning_rate(h, 2, k)
        ref.step()
        torch.testing.assert_close(lstm.b_fwd.detach(), (b_ih + b_hh).detach(), rtol=0, atol=1e-6)


def test_skip_and_clip_stabilisers():
    h = _h()
    lin = torch.nn.Linear(3, 2)
    opt = make_optimizer(lin, h, 1)
    from nvse_tpu_torch.train import apply_update

    before = [p.detach().clone() for p in lin.parameters()]
    for p in lin.parameters():
        p.grad = torch.full_like(p, float("nan"))
    assert apply_update(opt, h, clip=0.0, skip_nonfinite=True) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, lin.parameters()))
    assert not opt.state                                    # the moments never saw the NaNs
    for p in lin.parameters():
        p.grad = torch.full_like(p, 100.0)
    assert apply_update(opt, h, clip=1.0, skip_nonfinite=True) == 1.0
    n = torch.sqrt(sum((opt.state[p]["exp_avg"] / 0.2).square().sum() for p in lin.parameters()))
    np.testing.assert_allclose(float(n), 1.0, rtol=1e-5)    # clipped to global norm 1


def test_segment_crops_match_jax_dataset():
    tr, va = get_dataset_filelist(*LISTS)
    assert (tr, va) == jax_filelist(*LISTS)
    ours, theirs = SegmentDataset(tr, 4096, 22050, seed=7), JaxSegments(tr, 4096, 22050, seed=7)
    assert ours.files == theirs.files
    for i in range(6):
        np.testing.assert_array_equal(ours.segment_at(i, random.Random(i)),
                                      theirs.segment_at(i, random.Random(i)))
        np.testing.assert_array_equal(ours[i], theirs[i])
    # a segment longer than the file is zero-padded
    long_ours = SegmentDataset(tr, 10 ** 6, 22050, seed=7)[0]
    assert long_ours.shape == (10 ** 6,) and long_ours[-1000:].max() == 0.0
    # the Python crops on both sides (the default native crops: test_torch_port_loader.py)
    lo = PrefetchLoader(ours, 4, num_workers=3, seed=3, use_native=False)
    lj = JaxLoader(theirs, 4, num_workers=3, seed=3, use_native=False)
    assert len(lo) == len(lj) == 8
    for a, b in zip(lo, lj):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_save_rotate_manifest_and_resume(tmp_path):
    h = _h()
    tr = GANTrainer(h, device="cpu", steps_per_epoch=4)
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2048)).astype(np.float32) * 0.1)
    tr.step(audio)
    for step in (1, 2, 3):
        save_checkpoint(str(tmp_path), step, 0, tr, max_to_keep=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["checkpoint_d", "checkpoint_g", "do_00000002", "do_00000003",
                     "g_00000002", "g_00000003"]
    assert open(tmp_path / "checkpoint_g").read().split() == ["g_00000002", "g_00000003"]
    assert scan_checkpoint(str(tmp_path), "do_").endswith("do_00000003")
    bundle = torch.load(tmp_path / "g_00000003", weights_only=True)
    assert set(bundle) == {"generator"}

    fresh = GANTrainer(h, device="cpu", steps_per_epoch=4)
    assert restore_checkpoint(str(tmp_path), fresh) == (4, 0)
    for a, b in ((tr.generator, fresh.generator), (tr.disc, fresh.disc)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    for p, q in zip(tr.generator.parameters(), fresh.generator.parameters()):
        assert torch.equal(tr.opt_g.state[p]["exp_avg"], fresh.opt_g.state[q]["exp_avg"])
    assert restore_checkpoint(str(tmp_path / "none"), fresh) == (0, -1)


def test_unported_training_paths_raise(monkeypatch):
    """The multi-GPU rules of nvse_tpu/train/loop.py:86-121 and
    loop_joint.py:38-57: sp_devices that does not divide the ranks warns and
    trains without sequence parallelism; a batch that the data ranks do not
    divide leaves ranks idle, with a warning; the joint loop on more than
    one node raises, before any process group."""
    logs = []
    assert parallel_plan(4, 1, 3, 2, logs.append) == (1, 1)
    assert "sp_devices=2 does not divide the 3 local devices" in logs[0]
    assert "training will use only 1 device(s)" in logs[1]
    logs.clear()
    assert parallel_plan(8, 1, 4, 2, logs.append) == (2, 2) and not logs
    assert parallel_plan(8, 2, 4, 1, logs.append) == (4, 1) and not logs
    with pytest.raises(ValueError, match="divisible by the 3 participating"):
        parallel_plan(8, 3, 4, 1)
    # one process: sp_devices 2 warns and the trainer steps without a mesh
    h = _h(sp_devices=2)
    assert _training_mesh(h, torch.device("cpu"), logs.append) == (None, 1)
    assert "disabling sequence parallelism" in logs[0]
    tr = GANTrainer(h, device="cpu")
    assert tr.mesh is None and not tr.seq_cores[0].seq_group
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2048)).astype(np.float32) * 0.1)
    assert all(np.isfinite(v.item()) for v in tr.step(audio).values())
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="multi-host joint training"):
        train_joint(_h(model_name="BSRNN_24k"), device="cpu")


def test_use_cqtd_builds_the_cqt_discriminator():
    tr = GANTrainer(_h(use_cqtd=True, cqtd_hop_lengths=[256], cqtd_n_octaves=[4],
                       cqtd_bins_per_octaves=[12], cqtd_filters=8), device="cpu")
    assert list(tr.disc) == ["mpd", "mrd", "cqtd"] and len(tr.disc["cqtd"].discs) == 1


def test_train_cli_two_steps_then_serve_the_g_bundle(tmp_path):
    cfg = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "bsrnn_config.json"))
    cfg.update(feature_dim=8, num_repeat=1, segment_size=2048, training_steps=1,
               stdout_interval=1, checkpoint_interval=1000, validation_interval=1000,
               num_workers=2, checkpoint_path=str(tmp_path / "ckpt"),
               test_output_dir=str(tmp_path / "out"))
    cfg.pop("config_path")
    # 4 training files (2 steps an epoch at batch 2), 1 validation utterance
    lines = open(LISTS[0]).read().splitlines()
    (tmp_path / "train.txt").write_text("\n".join(lines[:4]) + "\n")
    (tmp_path / "val.txt").write_text(open(LISTS[1]).read().splitlines()[0] + "\n")
    cfg.update(input_training_wav_list=str(tmp_path / "train.txt"), batch_size=2,
               input_validation_wav_list=str(tmp_path / "val.txt"), raw_wavfile_path=LISTS[2],
               test_input_wavs_dir=os.path.join(REPO, cfg["test_input_wavs_dir"]))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = subprocess.run([sys.executable, "-m", "nvse_tpu_torch.train", "--cfg_filename",
                          str(path), "--device", "cpu"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    log = out.stdout
    assert "resuming at step 0" in log and "step 0 validation:" in log
    assert "epoch 1 step 1 " in log and "training finished" in log
    ckpt = tmp_path / "ckpt"
    assert {"g_00000001", "do_00000001", "config.json"} <= set(os.listdir(ckpt))

    # serving loads the g_ bundle training wrote and decodes with those weights
    h = load_config(str(path))
    h.checkpoint_file_load = str(ckpt / "g_00000001")
    eng = InferenceEngine(h, device="cpu")
    trained = torch.load(ckpt / "g_00000001", weights_only=True)["generator"]
    for k, v in eng.generator.state_dict().items():
        assert torch.equal(v, trained[k]), k
    from nvse_tpu_torch.infer import run_inference

    stats = run_inference(h, limit=1, log_fn=lambda s: None, device="cpu")
    assert stats["files"] == 1 and len(os.listdir(tmp_path / "out")) == 1

    # a larger budget resumes from the newest pair: step 2, then the final save
    from nvse_tpu_torch.train import train

    h.training_steps = 2
    lines = []
    train(h, device="cpu", log_fn=lines.append)
    assert "resuming at step 2" in lines[0]
    assert any(l.startswith("epoch 1 step 2 ") for l in lines), lines   # saved in epoch 0
    assert {"g_00000002", "do_00000002"} <= set(os.listdir(ckpt))


def test_wav_cache_is_consistent_under_concurrent_readers():
    import threading

    tr, _ = get_dataset_filelist(*LISTS)
    ds = SegmentDataset(tr, 4096, 22050, seed=0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [ds.segment_at(i, random.Random(k))
                                                        for i in range(len(ds))])
                   for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert set(ds._cache) == set(ds.files)
    assert ds._cache_bytes == sum(a.nbytes for a in ds._cache.values())


def test_causal_configs_raise_on_cuda_before_touching_it():
    """What is left of the causal guard: the trainer takes a causal config on
    any device, and every hidden size passes the argument check that runs
    before any CUDA call (H = 160 on the wide scan, H = 776 and H = 100 padded
    on the step-wise and narrow kernels), which stops only at the device."""
    from nvse_tpu_torch.ops import lstm as port_lstm
    from nvse_tpu_torch.train.trainer import _check_supported

    _check_supported(_h(causal=True), "tf")
    for H, stem in ((160, "lstm_scan_wide"), (776, "lstm_stepwise"), (100, "lstm_scan")):
        xp, whh = torch.zeros(3, 2, 4 * H), torch.zeros(H, 4 * H)
        assert port_lstm._kernel_source("lstm_scan", H) == stem
        with pytest.raises(ValueError, match="CUDA"):                 # the inference scan
            port_lstm._check_seq_args("lstm_scan", xp, whh)
        with pytest.raises(ValueError, match="CUDA"):                 # the training route
            port_lstm.lstm_fwd_hc(xp.to("meta"), whh.to("meta"))
