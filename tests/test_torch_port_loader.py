"""The port's training loader against the JAX package's, the converter of JAX
Orbax generator bundles, and the training loop's TensorBoard samples, on
the CPU.

The JAX loader crops with the native C++ batch decoder of native/ by default
(use_native="auto") wherever its library loads and the corpus is at the
target rate; the port's default must draw the same batches bit for bit.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp

from nvse_tpu.data import PrefetchLoader as JaxLoader
from nvse_tpu.data import SegmentDataset as JaxDataset
from nvse_tpu.data import native as jax_native
from nvse_tpu.infer.engine import InferenceEngine as JaxEngine
from nvse_tpu.models import build_generator as jax_build
from nvse_tpu_torch.data import PrefetchLoader, SegmentDataset, write_wav
from nvse_tpu_torch.data import native as port_native
from nvse_tpu_torch.infer import InferenceEngine
from nvse_tpu_torch.ops.spectral import mel_spectrogram
from nvse_tpu_torch.train.loop import log_validation_sample
from nvse_tpu_torch.utils import AttrDict

from test_export import _hifigan_h
from test_torch_port_bsrnn import jax_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, SEGMENT, BATCH, SEED = 22050, 8192, 4, 1234


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 noise WAVs at the target rate, 1-3 segments long."""
    d = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(0)
    files = []
    for i in range(8):
        p = str(d / f"N{i}.wav")
        write_wav(p, 0.3 * rng.standard_normal(SEGMENT + 3000 * (i + 1)), SR)
        files.append(p)
    return files


def _epochs(loader, n=2):
    return [[b.copy() for b in loader] for _ in range(n)]


def test_default_loader_draws_the_jax_default_batches_bit_for_bit(corpus):
    # the native library is there (built from native/Makefile if it was not)
    assert port_native.available() and jax_native.available()
    jl = JaxLoader(JaxDataset(corpus, SEGMENT, SR, seed=SEED), BATCH, num_workers=2, seed=SEED)
    pl = PrefetchLoader(SegmentDataset(corpus, SEGMENT, SR, seed=SEED), BATCH, num_workers=2,
                        seed=SEED)
    assert jl._native is not None and pl.native
    want, got = _epochs(jl), _epochs(pl)
    assert [len(e) for e in got] == [len(e) for e in want] == [2, 2]
    for we, ge in zip(want, got):
        for w, g in zip(we, ge):
            assert g.dtype == w.dtype == np.float32 and g.shape == (BATCH, SEGMENT)
            np.testing.assert_array_equal(g, w)


def test_python_crops_match_the_jax_python_crops_and_differ_from_native(corpus):
    jl = JaxLoader(JaxDataset(corpus, SEGMENT, SR, seed=SEED), BATCH, num_workers=2, seed=SEED,
                   use_native=False)
    pl = PrefetchLoader(SegmentDataset(corpus, SEGMENT, SR, seed=SEED), BATCH, num_workers=2,
                        seed=SEED, use_native=False)
    assert jl._native is None and not pl.native
    want, got = _epochs(jl), _epochs(pl)
    for we, ge in zip(want, got):
        for w, g in zip(we, ge):
            np.testing.assert_array_equal(g, w)
    native = next(iter(PrefetchLoader(SegmentDataset(corpus, SEGMENT, SR, seed=SEED), BATCH,
                                      num_workers=2, seed=SEED)))
    assert not np.array_equal(native, got[0][0])      # the two paths crop elsewhere


def test_native_path_needs_the_target_rate(corpus):
    # a corpus at another rate is resampled in Python, as the JAX loader does
    pl = PrefetchLoader(SegmentDataset(corpus, SEGMENT, 16000, seed=SEED), BATCH, seed=SEED)
    assert not pl.native
    assert not PrefetchLoader(SegmentDataset(corpus, SEGMENT, SR, split=False), 1).native


# ---------------------------------------------------------------------------
# scripts/convert_jax_checkpoint.py: an Orbax g_ bundle served by the port
# ---------------------------------------------------------------------------

def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", os.path.join(REPO, "scripts", "convert_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_converted_orbax_bundle_serves_as_the_jax_engine_decodes(tmp_path):
    h = AttrDict({**_hifigan_h(), "seed": 1234})
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(h))
    mel = (np.random.default_rng(5).standard_normal((2, 80, 40)) - 4.0).astype(np.float32)
    jgen, _ = jax_build(h)
    jp = jax_params(jgen, mel, seed=2)
    gdir = str(tmp_path / "ckpt" / "g_00000100")
    ocp.PyTreeCheckpointer().save(gdir, {"generator": jax.tree.map(jnp.asarray, jp)})
    out = str(tmp_path / "g_00000100.pt")
    state = _converter().convert(str(cfg), gdir, out)
    assert set(torch.load(out, weights_only=True)) == {"generator"} and state

    want = JaxEngine(AttrDict({**h, "checkpoint_file_load": gdir})).synthesize_mel(
        jnp.asarray(mel), out_len=9000)
    eng = InferenceEngine(AttrDict({**h, "checkpoint_file_load": out}), device="cpu")
    got = eng.synthesize_mel(torch.from_numpy(mel), out_len=9000)
    assert got.shape == np.asarray(want).shape == (2, 9000)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-4)
    # the bundle directory itself is refused, naming the converter
    with pytest.raises(NotImplementedError, match="convert_jax_checkpoint.py"):
        InferenceEngine(AttrDict({**h, "checkpoint_file_load": gdir}), device="cpu")


# ---------------------------------------------------------------------------
# the training loop's TensorBoard samples at validation
# ---------------------------------------------------------------------------

class _Recorder:
    """A SummaryWriter stand-in recording (kind, tag, step)."""

    def __init__(self, fail_audio=False):
        self.calls, self.fail_audio, self.figures = [], fail_audio, {}

    def add_audio(self, tag, snd, step, sample_rate):
        if self.fail_audio:
            raise RuntimeError("no soundfile")
        assert snd.ndim == 2 and snd.shape[1] == 1 and sample_rate == SR
        self.calls.append(("audio", tag, step))

    def add_figure(self, tag, fig, step):
        self.figures[tag] = fig.axes[0].images[0].get_array()
        self.calls.append(("figure", tag, step))


def test_validation_samples_carry_the_jax_loops_tags():
    h = AttrDict({**_hifigan_h(), "seed": 1234})
    rng = np.random.default_rng(0)
    items = [(torch.from_numpy(rng.standard_normal((1, 4096)).astype(np.float32) * 0.1),
              torch.from_numpy(rng.standard_normal((1, 4096)).astype(np.float32) * 0.1))
             for _ in range(5)]
    sw = _Recorder()
    gt_logged = False
    for step in (0, 10):
        ok = True
        for i, (y_g, audio) in enumerate(items):
            if i < 4:                     # the loop logs its first 4 items
                ok &= log_validation_sample(sw, h, i, step, y_g, audio, gt_logged)
        gt_logged |= ok
    first = [f"generated/y_hat_{i}" for i in range(4)] + [f"gt/y_{i}" for i in range(4)]
    want = {("audio", t, 0) for t in first} | {("figure", "generated/y_hat_spec", 0),
                                                ("figure", "gt/y_spec", 0)}
    want |= {("audio", f"generated/y_hat_{i}", 10) for i in range(4)}
    want |= {("figure", "generated/y_hat_spec", 10)}
    assert set(sw.calls) == want and len(sw.calls) == len(want)
    margs = (h.n_fft, h.num_mels, SR, h.hop_size, h.win_size, h.fmin, SR / 2)
    np.testing.assert_array_equal(np.asarray(sw.figures["gt/y_spec"]),
                                  mel_spectrogram(items[0][1], *margs)[0].numpy())
    # audio that cannot be encoded: figures still logged, the ground truth retried later
    sw = _Recorder(fail_audio=True)
    assert not log_validation_sample(sw, h, 0, 0, *items[0], False)
    assert [c[1] for c in sw.calls] == ["generated/y_hat_spec", "gt/y_spec"]
