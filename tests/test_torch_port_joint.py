"""Port parity: the joint denoise+vocoder BSRNN_24k (serving and its GAN
trainer) against the JAX package, on the CPU.

Compared on seeded numpy inputs:
  * BS.1770-4 loudness (`integrated_loudness`, `k_weight`) to 1e-12: the
    same float64 numpy / scipy code;
  * the joint filelists (both scp styles), `JointDataset.get_batch` (each
    task, with the dataset's shared RNGs and with a per-batch seed) and two
    epochs of `PrefetchJointLoader`: equal bit for bit (the same numpy and
    `random` draws in the same order);
  * the joint input features (ops.spectral.joint_input) against the JAX
    expressions (nvse_tpu/train/trainer.py:252-262) at rtol 2e-3 / atol 2e-4;
  * (tests/test_torch_port_joint_step.py, apart so that its two JAX step
    compiles run beside this file) one GAN step per task against
    make_train_step(h, gen, "joint", joint_task=task);
  * a two-step train_joint run (checkpoints, validation of both tasks) and
    its resume at the restored epoch; the T-F trainer refusing the joint
    config before any CUDA call; serving in both modes.
BSRNN_24k is narrowed to feature_dim 8 and one BSNet, at segment 2048 and
batch 2.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.data import joint_dataset as jax_jd
from nvse_tpu.data import loudness as jax_loudness
from nvse_tpu.data import write_wav
from nvse_tpu.ops import amp_pha_spectrum as jax_amp_pha
from nvse_tpu.ops import inverse_mel as jax_inverse_mel
from nvse_tpu.ops import mel_spectrogram as jax_mel
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.data import joint_dataset as port_jd
from nvse_tpu_torch.data import loudness as port_loudness
from nvse_tpu_torch.infer import run_inference, run_joint_inference
from nvse_tpu_torch.ops.spectral import joint_input
from nvse_tpu_torch.train import GANTrainer, scan_checkpoint, train_joint
from nvse_tpu_torch.utils import load_config


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_TOL = dict(rtol=2e-3, atol=2e-4)
SR = 24000


def _h(**kw):
    base = dict(model_name="BSRNN_24k", feature_dim=8, num_repeat=1, dropout=0.0, causal=False,
                sampling_rate=SR, n_fft=1024, hop_size=256, win_size=1024, num_mels=100,
                fmin=0, fmax=12000, meloss=None, segment_size=2048, batch_size=2,
                learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999,
                mrd_weight=0.1, mpd_reshapes=[2, 3, 5, 7, 11], seed=1234,
                snr_range=[-5, 15], task_dict=["denoise", "vocoder"])
    base.update(kw)
    return AttrDict(base)


# ---------------------------------------------------------------------------
# loudness and the joint dataset
# ---------------------------------------------------------------------------

LOUDNESS_CASES = {
    "noise_24k": (0.1 * np.random.default_rng(0).standard_normal(SR * 2), SR),
    "sine_48k": (np.sin(2 * np.pi * 997.0 * np.arange(48000 * 2) / 48000), 48000),
    "short_block": (0.3 * np.random.default_rng(1).standard_normal(4000), SR),
    "gated": (np.concatenate([np.zeros(SR), 0.2 * np.random.default_rng(2).standard_normal(SR)]),
              SR),
    "silence": (np.zeros(SR), SR),
}


@pytest.mark.parametrize("case", sorted(LOUDNESS_CASES))
def test_loudness_matches_jax(case):
    x, fs = LOUDNESS_CASES[case]
    np.testing.assert_allclose(port_loudness.k_weight(x, fs), jax_loudness.k_weight(x, fs),
                               rtol=1e-12, atol=1e-12)
    got, ref = port_loudness.integrated_loudness(x, fs), jax_loudness.integrated_loudness(x, fs)
    if np.isinf(ref):
        assert got == ref
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def joint_files(tmp_path_factory):
    """4 speech files at 24 kHz of several lengths (one shorter than the
    segment: tiled) and 3 noise files at 48 kHz (resampled on load), one
    near-silent (rejected crops, then the noise floor of _crop_noise)."""
    root = tmp_path_factory.mktemp("joint")
    rng = np.random.default_rng(0)
    speech, noise = [], []
    for i, n in enumerate((5000, 1500, 7000, 3000)):
        t = np.arange(n) / SR
        x = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) + 0.02 * rng.standard_normal(n)
        p = str(root / f"sp{i}.wav")
        write_wav(p, x.astype(np.float32), SR)
        speech.append(p)
    for i, amp in enumerate((0.02, 0.3, 1e-5)):
        p = str(root / f"no{i}.wav")
        write_wav(p, (amp * rng.standard_normal(6000)).astype(np.float32), 48000)
        noise.append(p)
    return str(root), speech, noise


def _lists(root, speech, noise, style):
    names = [os.path.splitext(os.path.basename(p))[0] for p in speech]
    lines = ([f"{n}|x\n" for n in names] if style == "stem"
             else [f"DUMMY1/{n}.wav|utterance\n" for n in names])
    tr = os.path.join(root, f"tr_{style}.txt")
    va = os.path.join(root, f"va_{style}.txt")
    with open(tr, "w") as f:
        f.writelines(lines[:3])
    with open(va, "w") as f:
        f.writelines(lines[3:])
    nz = os.path.join(root, "noise.scp")
    with open(nz, "w") as f:
        f.writelines(p + "\n" for p in noise * 4)
    return tr, va, root, nz


@pytest.mark.parametrize("style", ["stem", "ljspeech"])
def test_joint_filelist_matches_jax(joint_files, style):
    root, speech, noise = joint_files
    args = _lists(root, speech, noise, style)
    got, ref = port_jd.get_joint_filelist(*args), jax_jd.get_joint_filelist(*args)
    assert got == ref
    assert got[0] == speech[:3] and got[1] == speech[3:]
    assert len(got[2]) == 10 and len(got[3]) == 2           # the 90/10 noise split


def _datasets(speech, noise, **kw):
    args = (speech, noise, (-5, 15), 2048, SR, 2)
    return port_jd.JointDataset(*args, **kw), jax_jd.JointDataset(*args, **kw)


@pytest.mark.parametrize("task_dict", [("denoise",), ("vocoder",), ("denoise", "vocoder")],
                         ids=["denoise", "vocoder", "both"])
def test_get_batch_matches_jax_bit_for_bit(joint_files, task_dict):
    _, speech, noise = joint_files
    ours, theirs = _datasets(speech, noise, task_dict=list(task_dict), seed=7)
    tasks = set()
    for index, seed in ((0, None), (1, None), (0, 11), (1, 12345), (3, None)):
        a, b = ours.get_batch(index, seed=seed), theirs.get_batch(index, seed=seed)
        assert a[2] == b[2]
        tasks.add(a[2])
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[0].dtype == np.float32 and a[0].shape == (2, 2048)
        if a[2] == "denoise":
            assert np.abs(a[0]).max() < 1.0 and not np.array_equal(a[0], a[1])
        else:
            np.testing.assert_array_equal(a[0], a[1])
    assert tasks <= set(task_dict)


def test_prefetch_loader_epochs_match_jax_bit_for_bit(joint_files):
    _, speech, noise = joint_files
    ours, theirs = _datasets(speech * 2, noise, seed=3)
    lo = port_jd.PrefetchJointLoader(ours, num_workers=3, seed=3)
    lj = jax_jd.PrefetchJointLoader(theirs, num_workers=3, seed=3)
    for _ in range(2):
        got, ref = list(lo), list(lj)
        assert len(got) == len(ref) == 4
        for a, b in zip(got, ref):
            assert a[2] == b[2]
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    assert lo.epoch == lj.epoch == 2


# ---------------------------------------------------------------------------
# the joint input features
# ---------------------------------------------------------------------------

def _waves(b=2, n=2048, seed=0):
    """(clean, noisy): a sine with a noise floor in every bin (the phase
    losses read the clean wave's phase, which an empty bin leaves to
    rounding), and the same with louder noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    clean = 0.3 * np.sin(2 * np.pi * 220 * t)[None, :] + 0.02 * rng.standard_normal((b, n))
    noisy = clean + 0.1 * rng.standard_normal((b, n))
    return clean.astype(np.float32), noisy.astype(np.float32)


def _jax_joint_input(wave, task, h):
    w = jnp.asarray(wave)
    if task == "denoise":
        return np.asarray(jax_amp_pha(w, h.n_fft, h.hop_size, h.win_size, eps=1e-5)[0])
    melargs = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size, h.win_size)
    inv = jax_inverse_mel(jax_mel(w, *melargs, h.fmin, h.fmax), *melargs, h.fmin, h.fmax)
    return np.asarray(jnp.log(jnp.clip(jnp.abs(inv), 1e-5, None)))


@pytest.mark.parametrize("task", ["denoise", "vocoder"])
def test_joint_input_matches_jax(task):
    h = _h()
    _, noisy = _waves()
    got = joint_input(torch.from_numpy(noisy), task, h).numpy()
    ref = _jax_joint_input(noisy, task, h)
    assert got.shape == ref.shape == (2, 513, 9)
    np.testing.assert_allclose(got, ref, **FEATURE_TOL)
    with pytest.raises(ValueError, match="denoise"):
        joint_input(torch.from_numpy(noisy), "enhance", h)


# ---------------------------------------------------------------------------
# the trainer's joint domain (its step against the JAX step: test_torch_port_joint_step.py)
# ---------------------------------------------------------------------------

def test_joint_step_needs_the_task_and_input_wave():
    tr = GANTrainer(_h(), device="cpu", joint=True)
    clean, noisy = _waves()
    with pytest.raises(ValueError, match="task"):
        tr.step(torch.from_numpy(clean), torch.from_numpy(noisy))
    with pytest.raises(ValueError, match="task"):
        tr.eval_step(torch.from_numpy(clean), None, "denoise")
    with pytest.raises(ValueError, match="eval_step"):
        tr.eval_full(torch.from_numpy(clean[:1]), 2048)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_tf_trainer_refuses_the_joint_model_before_any_cuda_call(device, monkeypatch):
    """The repair: the T-F trainer given BSRNN_24k raises NotImplementedError
    naming the joint entry, before resolve_device (on this CPU a CUDA device
    would raise RuntimeError there) and before any CUDA call."""
    import nvse_tpu_torch.train.trainer as port_trainer

    monkeypatch.setattr(port_trainer, "resolve_device",
                        lambda d: pytest.fail("reached resolve_device"))
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs",
                                 "bsrnn_joint_denoise_vocoder_config.json"))
    h.update(feature_dim=8, num_repeat=1)
    with pytest.raises(NotImplementedError, match=r"python -m nvse_tpu_torch\.train --joint"):
        GANTrainer(h, device=device)
    # and the joint trainer refuses a mel-input model
    with pytest.raises(ValueError, match="log spectrum"):
        GANTrainer(_h(model_name="BSRNN", sampling_rate=22050, num_mels=80, fmax=8000),
                   device=device, joint=True)


# ---------------------------------------------------------------------------
# the loop, the CLI entries, serving
# ---------------------------------------------------------------------------

def _loop_config(tmp_path, joint_files, **kw):
    root, speech, noise = joint_files
    tr, va, raw, nz = _lists(root, speech, noise, "stem")
    h = _h(training_steps=1, training_epochs=5, stdout_interval=1, checkpoint_interval=1000,
           summary_interval=1000, validation_interval=1000, max_to_keep=2, num_workers=2,
           input_training_wav_list=tr, input_validation_wav_list=va, raw_wavfile_path=raw,
           input_noise_wav_list=nz, checkpoint_path=str(tmp_path / "ckpt"))
    h.update(kw)
    return h


def test_train_joint_checkpoints_validates_and_resumes_at_its_epoch(tmp_path, joint_files):
    """3 speech files at batch 2: one step an epoch. Steps 0-1 run epochs 1-2,
    validation of both tasks at step 0 (one item each), the final save at
    step 1 (epoch index 1); the resumed run restores step 2 at that epoch and
    logs it there."""
    h = _loop_config(tmp_path, joint_files)
    logs = []
    train_joint(h, device="cpu", log_fn=logs.append)
    assert os.path.basename(scan_checkpoint(h.checkpoint_path, "g_")) == "g_00000001"
    assert os.path.basename(scan_checkpoint(h.checkpoint_path, "do_")) == "do_00000001"
    assert "training finished (step budget reached)" in logs
    for task in ("denoise", "vocoder"):
        val = [l for l in logs if l.startswith(f"step 0 val[{task}]: ")]
        assert len(val) == 1 and "Mel=" in val[0] and "nan" not in val[0]
    steps = [re.match(r"epoch (\d+) step (\d+) task=(\w+) ", l) for l in logs]
    steps = [(int(m[1]), int(m[2]), m[3]) for m in steps if m]
    assert [(e, s) for e, s, _ in steps] == [(1, 0), (2, 1)]
    assert {t for _, _, t in steps} <= {"denoise", "vocoder"}

    h.update(training_steps=2)
    logs2 = []
    train_joint(h, device="cpu", log_fn=logs2.append)
    assert any("resuming at step 2" in l for l in logs2)
    assert [l.split(" task=")[0] for l in logs2 if l.startswith("epoch ") and " step " in l] \
        == ["epoch 2 step 2"]
    assert os.path.basename(scan_checkpoint(h.checkpoint_path, "g_")) == "g_00000002"


def test_train_cli_joint_flag(tmp_path, joint_files, monkeypatch):
    import sys

    import nvse_tpu_torch.train.__main__ as cli

    h = _loop_config(tmp_path, joint_files, training_steps=0, validation_interval=1000,
                     skip_step0_validation=True)
    cfg = tmp_path / "joint.json"
    cfg.write_text(json.dumps(h))
    seen = []
    monkeypatch.setattr(cli, "train_joint", lambda h, device: seen.append(("joint", h, device)))
    monkeypatch.setattr(cli, "train", lambda h, device: seen.append(("tf", h, device)))
    for argv in (["--joint", "--cfg_filename", str(cfg), "--device", "cpu"], ["--joint"], []):
        monkeypatch.setattr(sys, "argv", ["nvse_tpu_torch.train", *argv])
        cli.main()
    assert [s[0] for s in seen] == ["joint", "joint", "tf"]
    assert seen[0][1].checkpoint_path == h.checkpoint_path and seen[0][2] == "cpu"
    assert seen[1][1].model_name == "BSRNN_24k" and seen[1][2] == "cuda"
    assert seen[2][1].model_name == "BSRNN"


@pytest.mark.parametrize("mode", ["denoise", "vocoder"])
def test_run_joint_inference_on_the_synth24_set(tmp_path, monkeypatch, mode):
    monkeypatch.chdir(REPO)
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs",
                                 "bsrnn_joint_denoise_vocoder_config.json"))
    h.update(feature_dim=8, num_repeat=1, test_output_dir=str(tmp_path / mode),
             test_input_wavs_dir="DatasetsScp/synth24/test_filelist.txt",
             raw_wavfile_path="DatasetsScp/synth24/wavs")
    assert not os.path.exists(h.checkpoint_file_load)
    lines = []
    stats = run_joint_inference(h, mode, limit=2, log_fn=lines.append, device="cpu")
    assert stats["files"] == 2 and stats["rtf"] > 0
    assert lines[-1].startswith("decoded 2 files | wall ")
    from nvse_tpu_torch.data import read_wav

    for name in sorted(os.listdir(tmp_path / mode)):
        y, sr = read_wav(str(tmp_path / mode / name))
        src, _ = read_wav(os.path.join(REPO, "DatasetsScp", "synth24", "wavs", name))
        assert sr == SR and len(y) == len(src) and np.isfinite(y).all()
    with pytest.raises(ValueError, match="--processing_mode"):
        run_inference(h, limit=1, device="cpu")


def test_config_is_a_copy_of_the_jax_packages():
    name = "bsrnn_joint_denoise_vocoder_config.json"
    with open(os.path.join(REPO, "nvse_tpu_torch", "configs", name)) as f:
        ours = json.load(f)
    with open(os.path.join(REPO, "nvse_tpu", "configs", name)) as f:
        assert ours == json.load(f)


NEW_MODULES = ["data/loudness.py", "data/joint_dataset.py", "train/loop_joint.py",
               "train/trainer.py", "train/__main__.py", "infer/joint.py", "infer/__main__.py",
               "ops/spectral.py", "ops/resample.py", "ops/griffin_lim.py",
               "models/hddemucas.py", "models/layers.py", "utils/jax_params.py"]
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|flax|nvse_tpu)(\.|\s|$)", re.M)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_port_modules_import_nothing_of_jax(module):
    with open(os.path.join(REPO, "nvse_tpu_torch", module)) as f:
        assert not _IMPORT.search(f.read()), module
