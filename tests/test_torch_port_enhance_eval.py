"""Port parity: the joint model's enhancement evaluation
(nvse_tpu_torch/metrics/enhance.py and joint_curve.py) against the JAX
package's scripts/enhance_eval.py and scripts/joint_curve_eval.py, run in this
process on the CPU.

Both sides load one weight set through their real paths: JAX Orbax g_
bundles from seeded numpy weights (jax_params), converted into the port's g_
bundles by scripts/convert_jax_checkpoint.py --jax_ckpt. A BSRNN_24k narrowed
to feature_dim 8 and one BSNet decodes 2 files of DatasetsScp/synth24, mixed
with its noise at --snr 5. Compared:
  * enhance: the record's keys; the noisy scores exactly (the same numpy
    mixing and metrics); the enhanced wavs at rtol 2e-3 / atol 2e-4 plus one
    PCM16 step; the enhanced scores and the deltas within ENHANCED_ATOL / _RTOL;
  * joint_curve over steps 1, 3 (missing: skipped) and 2, with both
    packages' DNSMOS score_dir replaced by one deterministic function of the
    audio: the records in order, clean and noisy equal, the decoded ones
    within those limits, the decoded wavs as above; without the DNSMOS
    .onnx files both raise the same FileNotFoundError before any decode;
  * both entries run on the card unless --device cpu, and raise without one.
The converter and the JAX engine each take flax's Module.init only as the tree
their bundle is restored into, and discard its values: it runs here as
jax.eval_shape with zeros (`_init_by_shape`), since BSRNN_24k's eager init
takes 30-55 s on one CPU. Torch runs on one thread.
"""
import contextlib
import glob
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp

import nvse_tpu.metrics.dnsmos as jax_dnsmos
import nvse_tpu_torch.metrics.dnsmos as port_dnsmos
from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.data import read_wav
from nvse_tpu_torch.metrics import enhance, joint_curve

from test_torch_port_bsrnn import jax_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH24 = os.path.join(REPO, "DatasetsScp", "synth24")
WAVE_TOL = dict(rtol=2e-3, atol=2e-4 + 1 / 32768)
# the scores of decoded audio: the two decodes differ by float order
# (WAVE_TOL), which moves every score but the LSD by less than the rounding
# to 4 places; the LSD (a mean of squared log-spectrum differences) takes it
# through near-silent bins of the vocoded signal, 2.6e-4 of its value at most
ENHANCED_ATOL, ENHANCED_RTOL = 2e-3, 1e-3
STEPS = "1,3,2"


def _close(got, want):
    return abs(got - want) <= max(ENHANCED_ATOL, ENHANCED_RTOL * abs(want))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(name, argv, monkeypatch):
    """(stdout lines, stderr) of scripts/<name>.py main() with argv."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        _script(name).main()
    return out.getvalue().splitlines(), err.getvalue()


@pytest.fixture(autouse=True, scope="module")
def _init_by_shape():
    real = nn.Module.init

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda r, *a: real(self, r, *a, **kw), rngs, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", init)
        yield


@pytest.fixture(scope="module")
def cfgs(tmp_path_factory):
    """-> {"jax": cfg path, "port": cfg path, "root": dir}: the same tiny
    joint config, with the JAX Orbax bundles g_00000001 / g_00000002 (seeds 0
    and 1) on one side and their conversions on the other."""
    root = tmp_path_factory.mktemp("enhance_eval")
    noise = root / "noise_filelist.scp"
    noise.write_text("".join(p + "\n" for p in
                             sorted(glob.glob(os.path.join(SYNTH24, "noise", "*.wav")))))
    with open(os.path.join(REPO, "nvse_tpu_torch", "configs",
                           "bsrnn_joint_denoise_vocoder_config.json")) as f:
        base = json.load(f)
    base.update(feature_dim=8, num_repeat=1, input_noise_wav_list=str(noise),
                test_input_wavs_dir=os.path.join(SYNTH24, "test_filelist.txt"),
                raw_wavfile_path=os.path.join(SYNTH24, "wavs"))
    base_cfg = root / "base.json"
    base_cfg.write_text(json.dumps(base))
    jgen, _ = jax_build(AttrDict(base))
    convert = _script("convert_jax_checkpoint").convert
    out = {"root": root}
    for side in ("jax", "port"):
        os.makedirs(root / f"{side}_ckpt")
    for step, seed in ((1, 0), (2, 1)):
        jp = jax_params(jgen, np.zeros((1, 513, 9), np.float32), seed=seed)
        gdir = str(root / "jax_ckpt" / f"g_{step:08d}")
        ocp.PyTreeCheckpointer().save(gdir, {"generator": jax.tree.map(jnp.asarray, jp)})
        convert(str(base_cfg), gdir, str(root / "port_ckpt" / f"g_{step:08d}"))
    for side in ("jax", "port"):
        ck = str(root / f"{side}_ckpt")
        path = root / f"{side}.json"
        path.write_text(json.dumps({**base, "checkpoint_path": ck,
                                    "checkpoint_file_load": os.path.join(ck, "g_00000001"),
                                    "test_output_dir": str(root / f"{side}_out")}))
        out[side] = str(path)
    return out


def _enhance_argv(cfg):
    return ["--cfg_filename", cfg, "--snr", "5", "--limit", "2", "--label", "synth24"]


@pytest.fixture(scope="module")
def enhanced(cfgs):
    with pytest.MonkeyPatch.context() as mp:
        lines, _ = _run_script("enhance_eval", _enhance_argv(cfgs["jax"]), mp)
    want = json.loads("\n".join(lines))
    with contextlib.redirect_stdout(io.StringIO()):
        got = enhance.main([*_enhance_argv(cfgs["port"]), "--device", "cpu"])
    return got, want


def test_enhance_record_has_the_scripts_keys(enhanced):
    got, want = enhanced
    assert set(got) == set(want)
    for k in ("label", "task", "mix_snr_db", "files"):
        assert got[k] == want[k], k
    assert got["files"] == 2 and got["task"] == "denoise" and got["rtf"] > 0


def test_enhance_noisy_scores_equal_the_scripts(enhanced):
    got, want = enhanced
    for m in enhance.METRICS:
        assert got[f"noisy_{m}"] == want[f"noisy_{m}"], m
        assert np.isfinite(got[f"noisy_{m}"]), m


def test_enhanced_wavs_match_the_scripts(enhanced, cfgs):
    root = cfgs["root"]
    names = sorted(os.listdir(root / "jax_out" / "enhanced"))
    assert names == sorted(os.listdir(root / "port_out" / "enhanced")) and len(names) == 2
    for n in names:
        got, sr = read_wav(str(root / "port_out" / "enhanced" / n))
        want, _ = read_wav(str(root / "jax_out" / "enhanced" / n))
        assert sr == 24000 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **WAVE_TOL, err_msg=n)


def test_enhanced_scores_and_deltas_match_the_scripts(enhanced):
    got, want = enhanced
    off = [(k, got[k], want[k]) for m in enhance.METRICS for k in (f"enhanced_{m}", f"delta_{m}")]
    assert all(_close(a, b) for _, a, b in off), off
    for m in enhance.METRICS:
        assert got[f"delta_{m}"] == round(got[f"enhanced_{m}"] - got[f"noisy_{m}"], 4), m


def test_mix_at_snr_scales_the_noise_and_rescales_a_clipping_mix():
    rng = np.random.default_rng(0)
    clean = (0.1 * rng.standard_normal(1000)).astype(np.float32)
    noise = (0.5 * rng.standard_normal(300)).astype(np.float32)          # tiled to 1000
    noisy, ref = enhance.mix_at_snr(clean, noise, 5.0)
    assert ref is clean and len(noisy) == 1000
    n = noisy - clean
    np.testing.assert_allclose(10 * np.log10(np.mean(clean**2) / np.mean(n**2)), 5.0, atol=1e-4)
    np.testing.assert_allclose(n[300:600], n[:300], rtol=1e-6)
    loud, ref = enhance.mix_at_snr(8 * clean, noise, -5.0)     # peaks past 1: both rescaled
    assert np.abs(loud).max() == pytest.approx(1.0) and np.abs(ref).max() < 1.0
    np.testing.assert_allclose(ref / (8 * clean), ref[0] / (8 * clean[0]), rtol=1e-5)
    n = loud - ref
    np.testing.assert_allclose(10 * np.log10(np.mean(ref**2) / np.mean(n**2)), -5.0, atol=1e-4)


# ---------------------------------------------------------------------------
# joint_curve
# ---------------------------------------------------------------------------

def _fake_score_dir(deg_dir, model_dir, csv_path=None, is_personalized=False, workers=8,
                    jobs=1):
    """A deterministic stand-in for DNSMOS's score_dir: per wav, numbers made
    from its samples."""
    rows = []
    for p in sorted(glob.glob(os.path.join(deg_dir, "*.wav"))):
        x, _ = read_wav(p)
        rms, peak = float(np.sqrt(np.mean(x**2))), float(np.abs(x).max())
        rows.append({"filename": p, "SIG": 1 + 10 * rms, "BAK": 1 + 2 * peak,
                     "OVRL": 1 + rms + peak, "P808_MOS": 2 + 5 * rms})
    return rows


def _curve_argv(cfg, root, side):
    return ["--cfg_filename", cfg, "--steps", STEPS, "--snr", "5", "--limit", "2", "--jb", "1",
            "--out", str(root / f"{side}_curve.json"), "--work_dir", str(root / f"{side}_work"),
            "--model_dir", str(root / "no_dnsmos")]


@pytest.fixture(scope="module")
def curves(cfgs):
    root = cfgs["root"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dnsmos, "score_dir", _fake_score_dir)
        mp.setattr(port_dnsmos, "score_dir", _fake_score_dir)
        lines, jax_err = _run_script("joint_curve_eval", _curve_argv(cfgs["jax"], root, "jax"),
                                     mp)
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            got = joint_curve.main([*_curve_argv(cfgs["port"], root, "port"), "--device", "cpu"])
    want = [json.loads(l) for l in lines if l.startswith("{")]
    return got, want, err.getvalue(), jax_err


def _strip(rec):
    return {k: v for k, v in rec.items() if k != "timestamp"}


def test_joint_curve_records_match_the_script(curves):
    got, want, err, jax_err = curves
    signals = [(r["signal"], r.get("step")) for r in got]
    assert signals == [(r["signal"], r.get("step")) for r in want] == [
        ("clean", None), ("noisy", None), ("denoised", 1), ("vocoded", 1), ("denoised", 2),
        ("vocoded", 2)]
    off = []
    for g, w in zip(got, want):
        assert set(g) == set(w), g["signal"]
        if g["signal"] in ("clean", "noisy"):
            assert _strip(g) == _strip(w), g["signal"]
            continue
        for k, v in _strip(w).items():
            if isinstance(v, float):
                off.append((g["signal"], g["step"], k, g[k], v))
            else:
                assert g[k] == v, k
    assert all(_close(a, b) for *_, a, b in off), off
    # DNSMOS of the vocoded signal at the last step only, as the script
    assert "dnsmos_ovr" not in got[3] and "dnsmos_ovr" in got[5]
    assert "!! missing checkpoint" in err and "g_00000003; skipping" in err
    assert err.strip() == jax_err.strip().replace("jax_ckpt", "port_ckpt")


def test_joint_curve_decoded_wavs_match_the_script(curves, cfgs):
    root = cfgs["root"]
    for d in ("clean", "noisy_snr5", "denoised_00000001", "vocoded_00000001",
              "denoised_00000002", "vocoded_00000002"):
        names = sorted(os.listdir(root / "jax_work" / d))
        assert names == sorted(os.listdir(root / "port_work" / d)) and len(names) == 2, d
        for n in names:
            got, _ = read_wav(str(root / "port_work" / d / n))
            want, _ = read_wav(str(root / "jax_work" / d / n))
            if d in ("clean", "noisy_snr5"):
                np.testing.assert_array_equal(got, want, err_msg=f"{d}/{n}")
            else:
                np.testing.assert_allclose(got, want, **WAVE_TOL, err_msg=f"{d}/{n}")


def test_joint_curve_appends_its_records_to_out(curves, cfgs):
    got, *_ = curves
    with open(cfgs["root"] / "port_curve.json") as f:
        assert json.load(f) == got


def test_joint_curve_without_dnsmos_models_raises_as_the_script(cfgs, tmp_path, monkeypatch):
    """No .onnx under --model_dir: the first record raises, after the mixes
    are written and before any checkpoint is decoded."""
    argv = ["--steps", "1", "--limit", "1", "--jb", "1", "--model_dir", str(tmp_path / "none"),
            "--out", str(tmp_path / "q.json")]
    with pytest.raises(FileNotFoundError) as jax_e:
        _run_script("joint_curve_eval", ["--cfg_filename", cfgs["jax"], *argv, "--work_dir",
                                         str(tmp_path / "jax")], monkeypatch)
    with pytest.raises(FileNotFoundError) as port_e:
        joint_curve.main(["--cfg_filename", cfgs["port"], *argv, "--work_dir",
                          str(tmp_path / "port"), "--device", "cpu"])
    assert str(port_e.value) == str(jax_e.value)
    assert "no DNSMOS onnx models" in str(port_e.value)
    assert sorted(os.listdir(tmp_path / "port")) == ["clean", "noisy_snr5"]
    assert not os.path.exists(tmp_path / "q.json")


@pytest.mark.parametrize("entry", ["enhance", "joint_curve"])
def test_entries_run_on_the_card_unless_asked_and_raise_without_one(cfgs, tmp_path, entry,
                                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--cfg_filename", cfgs["port"], "--limit", "1"]
    if entry == "joint_curve":
        argv += ["--steps", "1", "--work_dir", str(tmp_path / "work"), "--out",
                 str(tmp_path / "q.json")]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        {"enhance": enhance, "joint_curve": joint_curve}[entry].main(argv)
    assert not os.listdir(tmp_path)
