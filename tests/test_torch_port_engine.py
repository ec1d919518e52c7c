"""Port parity and behaviour of the inference engine (BSRNN slice), on CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.infer.engine import InferenceEngine as JaxEngine
from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.data import read_wav, write_wav
from nvse_tpu_torch.infer import InferenceEngine, run_inference
from nvse_tpu_torch.utils import params_from_jax

from test_torch_port_bsrnn import jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _h(**kw):
    d = dict(model_name="BSRNN", feature_dim=8, num_repeat=2, dropout=0.0, causal=False,
             sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
             fmin=0, fmax=8000, seed=1234)
    d.update(kw)
    return AttrDict(d)


def test_synthesize_mel_matches_jax_engine_with_bucket_padding():
    # T = 40 pads to the 64-frame bucket with log(1e-5) and crops back
    h = _h()
    mel = np.random.default_rng(0).standard_normal((2, 80, 40)).astype(np.float32) - 4.0
    jgen, _ = jax_build(h)
    jp = jax_params(jgen, mel)
    ref = JaxEngine(h, params=jax.tree.map(jnp.asarray, jp)).synthesize_mel(jnp.asarray(mel),
                                                                           out_len=9000)
    eng = InferenceEngine(h, params=params_from_jax(jp, h), device="cpu")
    got = eng.synthesize_mel(torch.from_numpy(mel), out_len=9000)
    assert got.shape == ref.shape == (2, 9000)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-3, atol=2e-4)
    assert eng.synthesize_mel(mel).shape == (2, 40 * 256)


def test_run_inference_writes_pcm16_and_returns_rtf(tmp_path):
    sr = 22050
    wav_dir = tmp_path / "wavs"
    lengths = [3000, 5000, 20000]     # two length buckets
    for i, n in enumerate(lengths):
        t = np.arange(n) / sr
        write_wav(str(wav_dir / f"W{i}.wav"), (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)), sr)
    out_dir = tmp_path / "out"
    h = _h(test_input_wavs_dir=str(wav_dir), test_output_dir=str(out_dir), infer_batch=2)
    lines = []
    stats = run_inference(h, log_fn=lines.append, device="cpu")
    assert stats["files"] == 3 and stats["rtf"] > 0
    assert stats["audio_sec"] == pytest.approx(sum(lengths) / sr)
    assert lines and lines[0].startswith("decoded 3 files | wall ")
    for i, n in enumerate(lengths):
        y, got_sr = read_wav(str(out_dir / f"W{i}.wav"))
        assert got_sr == sr and y.shape == (n,) and np.isfinite(y).all()
    with open(out_dir / "W0.wav", "rb") as f:
        assert f.read(36)[34] == 16          # bits per sample: PCM16


def test_run_inference_per_file_path(tmp_path):
    wav_dir = tmp_path / "wavs"
    write_wav(str(wav_dir / "A.wav"), np.zeros(4000, np.float32), 22050)
    h = _h(test_input_wavs_dir=str(wav_dir), test_output_dir=str(tmp_path / "out"))
    stats = run_inference(h, batch=1, log_fn=lambda s: None, device="cpu")
    assert stats["files"] == 1
    assert read_wav(str(tmp_path / "out" / "A.wav"))[0].shape == (4000,)


def test_engine_bf16_compute_dtype_runs():
    h = _h(compute_dtype="bfloat16")
    eng = InferenceEngine(h, device="cpu")
    wav = eng.synthesize_mel(np.full((1, 80, 10), -4.0, np.float32))
    assert wav.dtype == np.float32 and wav.shape == (1, 2560) and np.isfinite(wav).all()


def test_engine_defaults_to_cuda_and_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(_h())


def test_port_imports_no_jax_and_nothing_of_nvse_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nvse_tpu_torch\n"
        "for m in pkgutil.walk_packages(nvse_tpu_torch.__path__, 'nvse_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'nvse_tpu'))\n"
        "n = sum(m.startswith('nvse_tpu_torch') for m in sys.modules)\n"
        "print(n, bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 15       # every module was imported


def test_port_scripts_and_smoke_name_no_jax_import():
    """Static twin of the test above for the files it cannot import here
    (they need a GPU): no import statement of the port's package, its
    scripts or chip_smoke.py names jax, flax or nvse_tpu."""
    import ast
    import glob

    files = ([os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "scripts", "compare_torch_lstm_layouts.py"),
              os.path.join(REPO, "scripts", "bench_torch_lstm_kernel.py"),
              os.path.join(REPO, "scripts", "bench_torch_fused_plan.py"),
              os.path.join(REPO, "scripts", "bench_torch_scan_plan.py"),
              os.path.join(REPO, "scripts", "compare_torch_fused_error.py")]
             + glob.glob(os.path.join(REPO, "scripts", "profile_torch_*.py"))
             + glob.glob(os.path.join(REPO, "nvse_tpu_torch", "**", "*.py"), recursive=True))
    assert len(files) >= 30
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "nvse_tpu"), (path, name)
