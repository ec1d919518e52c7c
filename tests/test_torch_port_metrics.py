"""Port parity: the metric package (nvse_tpu_torch/metrics) against nvse_tpu's.

The numpy metrics are the port's copies, so each equals the JAX package's on
the same seeded pairs to 1e-6 (relative; exactly, as a rule). The CLI
(python -m nvse_tpu_torch.metrics <name>) prints the lines of the JAX
package's run_metric_cli / run_multi_metric_cli on the same directories;
metrics/quality.py --skip_decode gives scripts/quality_eval.py's numbers; an
error of the device metric (CREPE) ends the CLI instead of being skipped as a
bad pair.
"""
import contextlib
import importlib.util
import io
import os
import re
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nvse_tpu.metrics as J
import nvse_tpu.metrics.dnsmos as JD
import nvse_tpu.metrics.onnx_np as JO
import nvse_tpu_torch.metrics as P
import nvse_tpu_torch.metrics.dnsmos as PD
import nvse_tpu_torch.metrics.onnx_np as PO
from nvse_tpu.metrics.common import run_metric_cli, run_multi_metric_cli
from nvse_tpu_torch.data.audio_io import load_wav, write_wav
from nvse_tpu_torch.metrics import cli
from test_torch_port_joint import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = os.path.join(REPO, "DatasetsScp", "synth", "wavs")
SR = 16000


def _pair(seed=0, n=SR, noise=0.05):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 1.5 * t)
    ref = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / SR) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    deg = ref + noise * rng.standard_normal(n)
    return ref.astype(np.float32), deg.astype(np.float32)


# name -> the call of a metric package (the port's or the JAX one) on a pair
CASES = {
    "lsd": lambda m, r, d: m.lsd(r, d, SR),
    "snr": lambda m, r, d: m.snr(r, d, SR),
    "si_snr": lambda m, r, d: m.si_snr(r, d, SR),
    "stoi": lambda m, r, d: m.stoi(r, d, SR),
    "estoi": lambda m, r, d: m.estoi(r, d, SR),
    "mcd": lambda m, r, d: m.mcd(r, d, SR),
    "mcd_dtw": lambda m, r, d: m.mcd_dtw(r, d, SR),
    "mcd_sptk": lambda m, r, d: m.mcd_sptk(r, d, SR),
    "mcd_sptk_dtw": lambda m, r, d: m.mcd_sptk_dtw(r, d, SR),
    "pesq_wb": lambda m, r, d: m.pesq_wb(r, d, SR),
    "visqol": lambda m, r, d: m.visqol(r, d, SR),
    "f0_metrics": lambda m, r, d: m.f0_metrics(r, d, SR),
    "f0_rmse": lambda m, r, d: m.f0_rmse(r, d, SR),
    "evaluate_f0_metrics": lambda m, r, d: m.evaluate_f0_metrics(r, d, SR),
    "periodicity_yin": lambda m, r, d: m.periodicity_metrics(r, d, SR),
    "yin_f0_conf": lambda m, r, d: m.yin_f0_conf(d, SR),
    "dio_f0": lambda m, r, d: m.dio_f0(r.astype(np.float64), SR),
    "dtw_path": lambda m, r, d: m.dtw_path(r[:4000].reshape(-1, 20), d[:3000].reshape(-1, 20)),
    "dnsmos_audio_melspec": lambda m, r, d: _dnsmos(m).audio_melspec(np.tile(d, 2)),
    "dnsmos_polyfit_val": lambda m, r, d: (_dnsmos(m).polyfit_val(3.1, 3.4, 2.9),
                                           _dnsmos(m).polyfit_val(3.1, 3.4, 2.9, True)),
}


def _dnsmos(m):
    return PD if m is P else JD


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _flat(e)]
    return list(np.atleast_1d(np.asarray(x, np.float64)).ravel())


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_metric_matches_jax(name):
    ref, deg = _pair()
    got, want = _flat(CASES[name](P, ref, deg)), _flat(CASES[name](J, ref, deg))
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


class _FakeSession:
    """ort.InferenceSession.run for both DNSMOS models (tests/test_dnsmos.py)."""

    def __init__(self, kind):
        self.kind = kind

    def run(self, _outputs, feeds):
        x = feeds["input_1"]
        if self.kind == "p808":
            return [np.array([[2.0 + float(np.abs(x).mean())]], np.float32)]
        return [np.array([[3.0, 3.5, 2.8]], np.float32) + np.float32(np.abs(x).mean())]


def test_dnsmos_compute_score_matches_jax(tmp_path):
    ref, _ = _pair(n=11 * SR)
    wav = tmp_path / "x.wav"
    write_wav(str(wav), ref, SR)
    got = PD.ComputeScore(_FakeSession("primary"), _FakeSession("p808"))(str(wav))
    want = JD.ComputeScore(_FakeSession("primary"), _FakeSession("p808"))(str(wav))
    assert set(got) == set(want) and got["num_hops"] == 2
    for k in want:
        if k != "filename":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


# -- a small ONNX graph, written as protobuf wire format ----------------------

def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(no, wt, payload):
    key = _varint(no << 3 | wt)
    if wt == 0:
        return key + _varint(payload)
    return key + _varint(len(payload)) + payload


def _tensor_proto(name, a):
    a = np.ascontiguousarray(a)
    dt = {np.float32: 1, np.int64: 7}[a.dtype.type]
    return (b"".join(_field(1, 0, d) for d in a.shape) + _field(2, 0, dt)
            + _field(8, 2, name.encode()) + _field(9, 2, a.tobytes()))


def _attr_ints(name, vals):
    return (_field(1, 2, name.encode()) + _field(20, 0, 7)
            + b"".join(_field(8, 0, v) for v in vals))


def _node(op, ins, outs, attrs=()):
    return (b"".join(_field(1, 2, i.encode()) for i in ins)
            + b"".join(_field(2, 2, o.encode()) for o in outs) + _field(4, 2, op.encode())
            + b"".join(_field(5, 2, a) for a in attrs))


def _small_graph(path, w, b, w2, b2):
    """x (1, 4, 10, 10) -> Conv 3x3 pad 1 -> Relu -> MaxPool 2x2 -> Reshape (1, -1)
    -> MatMul -> Add -> Sigmoid."""
    nodes = [
        _node("Conv", ["x", "w", "b"], ["c"], [_attr_ints("kernel_shape", [3, 3]),
                                                _attr_ints("pads", [1, 1, 1, 1]),
                                                _attr_ints("strides", [1, 1])]),
        _node("Relu", ["c"], ["r"]),
        _node("MaxPool", ["r"], ["p"], [_attr_ints("kernel_shape", [2, 2]),
                                        _attr_ints("strides", [2, 2])]),
        _node("Reshape", ["p", "shape"], ["f"]),
        _node("MatMul", ["f", "w2"], ["m"]),
        _node("Add", ["m", "b2"], ["a"]),
        _node("Sigmoid", ["a"], ["y"]),
    ]
    inits = {"w": w, "b": b, "w2": w2, "b2": b2, "shape": np.array([1, -1], np.int64)}
    graph = (b"".join(_field(1, 2, n) for n in nodes)
             + b"".join(_field(5, 2, _tensor_proto(k, v)) for k, v in inits.items())
             + _field(11, 2, _field(1, 2, b"x")) + _field(12, 2, _field(1, 2, b"y")))
    with open(path, "wb") as f:
        f.write(_field(7, 2, graph))


def test_onnx_np_small_graph_matches_jax_and_torch(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4, 10, 10)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((150, 3))).astype(np.float32)
    b2 = rng.standard_normal(3).astype(np.float32)
    path = str(tmp_path / "small.onnx")
    _small_graph(path, w, b, w2, b2)
    got = PO.NumpyOnnxSession(path).run(None, {"x": x})[0]
    want = JO.NumpyOnnxSession(path).run(None, {"x": x})[0]
    np.testing.assert_array_equal(got, want)
    t = F.max_pool2d(F.relu(F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), padding=1)), 2)
    oracle = torch.sigmoid(t.reshape(1, -1) @ torch.from_numpy(w2) + torch.from_numpy(b2))
    np.testing.assert_allclose(got, oracle.numpy(), rtol=1e-5, atol=1e-6)


# -- the CLI -----------------------------------------------------------------

@pytest.fixture(scope="module")
def deg_dir(tmp_path_factory):
    """Three synthetic utterances with noise added, and an unreadable fourth."""
    d = tmp_path_factory.mktemp("deg")
    rng = np.random.default_rng(0)
    for name in ("SY0000", "SY0001", "SY0002"):
        x = load_wav(os.path.join(WAVS, f"{name}.wav"), 22050)
        write_wav(str(d / f"{name}.wav"), x + 0.01 * rng.standard_normal(len(x)).astype(np.float32),
                  22050)
    (d / "SY0003.wav").write_bytes(b"not a wav")
    return str(d)


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


class _SerialPool:
    """multiprocessing.Pool's map in this process: the JAX package's CLI forks a
    pool, whose children would print where redirect_stdout cannot see (and fork
    a multithreaded process)."""

    def __init__(self, processes=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items):
        return [fn(x) for x in items]


def _jax_cli(monkeypatch, argv, fn, *args, **kw):
    import nvse_tpu.metrics.common as jax_common

    monkeypatch.setattr(sys, "argv", ["metric", *argv])
    monkeypatch.setattr(jax_common.mp, "Pool", _SerialPool)
    return _printed(lambda: fn(*args, **kw))


@pytest.mark.parametrize("name", ["lsd", "snr_si", "evaluate_f0"])
def test_cli_prints_the_jax_lines(monkeypatch, deg_dir, name):
    args = ["--ref_dir", WAVS, "--deg_dir", deg_dir, "--jb", "1"]
    if name == "lsd":
        want = _jax_cli(monkeypatch, args, run_metric_cli, "LSD", J.lsd, default_sr=22050)
        got = _printed(lambda: cli.main(["lsd", *args]))
    elif name == "snr_si":
        want = _jax_cli(monkeypatch, args, run_metric_cli, "SI-SNR", J.si_snr, default_sr=22050)
        got = _printed(lambda: cli.main(["snr", "--si", *args]))
    else:
        outputs = cli.MULTI_METRICS["evaluate_f0"][0]
        desc = cli.MULTI_METRICS["evaluate_f0"][3]
        want = _jax_cli(monkeypatch, args, run_multi_metric_cli, outputs,
                        J.evaluate_f0_metrics, default_sr=22050, description=desc)
        got = _printed(lambda: cli.main(["evaluate_f0", *args]))
    # the unreadable file is skipped by both, with the same line
    assert got == want and any(l.startswith("skip SY0003.wav") for l in got)
    assert any("3 pairs" in l for l in got)


def test_cli_serves_every_reference_metric_script():
    scripts = {f[:-3].rstrip("_") for f in os.listdir(os.path.join(REPO, "Metrics"))
               if f.endswith(".py")}
    assert scripts == set(cli.NAMES) and len(cli.NAMES) == 12


def test_evaluate_with_crepe_scores_on_the_device_and_its_errors_end_the_run(
        monkeypatch, deg_dir, tmp_path):
    from nvse_tpu_torch.metrics import crepe

    ckpt = tmp_path / "tiny.pth"
    torch.save(crepe.Crepe("tiny", seed=1).state_dict(), ckpt)
    monkeypatch.setenv("NVSE_CREPE_CKPT", str(ckpt))
    monkeypatch.setenv("NVSE_CREPE_MODEL", "tiny")
    args = ["evaluate", "--ref_dir", WAVS, "--deg_dir", deg_dir, "--device", "cpu"]
    lines = _printed(lambda: cli.main(args))
    assert lines[0].startswith("pitch: CREPE tiny") and "on cpu" in lines[0]
    assert any("3 pairs" in l for l in lines)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(crepe.Crepe, "forward", broken)
    crepe.load_crepe.cache_clear()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cli.main(args)
    # the device is the card unless asked for: no card here, so no score
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(args[:-2])


def test_quality_skip_decode_matches_the_script(monkeypatch, tmp_path, deg_dir):
    import json

    from nvse_tpu_torch.metrics import quality

    cfg = json.load(open(os.path.join(REPO, "nvse_tpu_torch", "configs", "bsrnn_config.json")))
    lst = tmp_path / "test.txt"
    lst.write_text("".join(f"DUMMY1/SY000{i}.wav|x\n" for i in range(4)))
    cfg.update(test_input_wavs_dir=str(lst), raw_wavfile_path=WAVS, test_output_dir=deg_dir)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    spec = importlib.util.spec_from_file_location(
        "quality_eval", os.path.join(REPO, "scripts", "quality_eval.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = ["--cfg_filename", str(path), "--skip_decode", "--limit", "2"]
    monkeypatch.setattr(sys, "argv", ["quality_eval.py", *argv])
    want = json.loads("\n".join(_printed(script.main)))
    got = quality.main(argv)
    for rec in (got, want):
        rec.pop("timestamp")
    assert got == want and got["files"] == 2 and len(got) > 20
    assert not (tmp_path / "quality.json").exists()


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|flax|nvse_tpu)(\.|\s|$)", re.M)
NEW_MODULES = ["ops/cqt.py", "models/cqt_discriminator.py",
               *sorted(f"metrics/{f}" for f in os.listdir(os.path.join(REPO, "nvse_tpu_torch",
                                                                        "metrics"))
                       if f.endswith(".py"))]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_nothing_of_jax(module):
    with open(os.path.join(REPO, "nvse_tpu_torch", module)) as f:
        assert not _IMPORT.search(f.read()), module
