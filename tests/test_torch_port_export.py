"""Serving export of the port (nvse_tpu_torch/infer/export.py) and the kernel
operators it traces through (nvse_tpu_torch/ops/library.py), on the CPU.

The artifact is held against the live port engine on the same weights and,
through params_from_jax, against the JAX generator (rtol 2e-3 / atol 2e-4,
the port's model tolerances). On the CPU each registered operator runs its
plain version, so an artifact exported here decodes here; the card's run is
chip_smoke.py's export phase.
"""
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.infer import InferenceEngine
from nvse_tpu_torch.infer import export as pexport
from nvse_tpu_torch.infer.export import export_decoder, load_decoder
from nvse_tpu_torch.ops import lstm as L
from nvse_tpu_torch.ops import tcn as TCN
from nvse_tpu_torch.utils import params_from_jax

from test_export import _hifigan_h
from test_torch_port_bsrnn import jax_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401

MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
LIVE_ATOL = 1e-5
BASE = dict(sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
            fmin=0, fmax=8000, seed=1234)


def _mel(batch, T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 80, T)) - 4.0).astype(np.float32)


def _bsrnn_h(**kw):
    return AttrDict({**BASE, "model_name": "BSRNN", "feature_dim": 8, "num_repeat": 2,
                     "dropout": 0.0, "causal": False, **kw})


def _jax_decode(jgen, jp, mel):
    out = jax.jit(lambda p, m: jgen.apply({"params": p}, m))(jp, jnp.asarray(mel))
    return np.asarray(out[-1] if isinstance(out, tuple) else out)


def _hifigan_pair():
    h = _hifigan_h()
    jgen, _ = jax_build(h)
    jp = jax_params(jgen, _mel(1, 16))
    return h, jgen, jp, params_from_jax(jp, h)


# ---------------------------------------------------------------------------
# the registered operators: one node each, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _lstm_args(B=2, T=7, C=12, H=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g) * 0.6 - 0.3        # noqa: E731
    return (r(B, T, C), r(C, 4 * H), r(C, 4 * H), r(4 * H), r(4 * H), r(H, 4 * H),
            r(H, 4 * H))


def _tail_args(B=2, T=9, H=16, Bc=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g) * 0.6 - 0.3        # noqa: E731
    return (r(B, T, H), r(B, T, Bc), 1 + r(1, H), r(1, H), r(3, H), r(1, H), r(H, 2 * Bc),
            r(1, 2 * Bc))


@pytest.mark.parametrize("name", ["lstm_scan_fused", "lstm_scan", "lstm_scan_bidir2",
                                  "tcn_block_tail"])
def test_operator_on_cpu_is_the_plain_version_bit_for_bit(name):
    x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b = _lstm_args()
    xp = (x @ w_ih_f + b_f).transpose(0, 1).contiguous()
    xq = (x @ w_ih_b + b_b).transpose(0, 1).contiguous()
    if name == "lstm_scan_fused":
        args = (x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
        want, entry = (L.lstm_scan_fused_plain(*args),), L.lstm_scan_fused(*args)
    elif name == "lstm_scan":
        args = (xp, w_hh_f)
        want, entry = (L.lstm_scan_plain(*args),), L.lstm_scan(*args)
    elif name == "lstm_scan_bidir2":
        args = (xp, xq, w_hh_f, w_hh_b)
        want, entry = L.lstm_scan_bidir2_plain(*args), L.lstm_scan_bidir2(*args)
    else:
        c, xr, gw, gb, wdw, bdw, wrs, brs = _tail_args()
        args = (c, xr, gw, gb, wdw, bdw, wrs, brs, 2, 1e-5)
        a, b2 = TCN._fold(c, gw, gb, 1e-5)
        want = TCN.tcn_block_tail_plain(c, xr, a, b2, wdw, bdw, wrs, brs, 2)
        entry = TCN.tcn_block_tail(*args)
    got = getattr(torch.ops.nvse_torch, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    entry = entry if isinstance(entry, tuple) else (entry,)
    for g, e, w in zip(got, entry, want):
        assert torch.equal(g, w) and torch.equal(e, w)
    # the fake implementation: shapes and dtypes, no kernel
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = getattr(torch.ops.nvse_torch, name)(*[mode.from_tensor(a) if torch.is_tensor(a)
                                                     else a for a in args])
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype) for f in fake] == [(w.shape, w.dtype) for w in want]


# ---------------------------------------------------------------------------
# the conv family: static and symbolic time axis, against the engine and JAX
# ---------------------------------------------------------------------------

def test_hifigan_static_artifact_equals_live_engine_and_jax(tmp_path):
    h, jgen, jp, sd = _hifigan_pair()
    path = str(tmp_path / "hifigan.nvsx")
    meta = export_decoder(h, sd, path, batch=2, frames=24, device="cpu")
    assert (meta["batch"], meta["frames"], meta["device"], meta["ops"]) == (2, 24, "cpu", {})
    mel = _mel(2, 24)
    got = load_decoder(path)(mel).numpy()
    live = InferenceEngine(h, params=sd, device="cpu").forward(torch.from_numpy(mel)).numpy()
    ref = _jax_decode(jgen, jp, mel)
    assert got.shape == live.shape == ref.shape == (2, 24 * h.hop_size)
    np.testing.assert_allclose(got, live, rtol=0, atol=LIVE_ATOL)
    np.testing.assert_allclose(got, ref, **MODEL_TOL)


def test_hifigan_dynamic_artifact_decodes_two_lengths(tmp_path):
    h, jgen, jp, sd = _hifigan_pair()
    path = str(tmp_path / "hifigan_dyn.nvsx")
    assert export_decoder(h, sd, path, batch=1, frames=None, device="cpu")["frames"] is None
    dec = load_decoder(path)
    eng = InferenceEngine(h, params=sd, device="cpu")
    for T in (16, 40):
        mel = _mel(1, T, seed=T)
        got = dec(mel).numpy()
        assert got.shape == (1, T * h.hop_size)
        np.testing.assert_allclose(got, eng.forward(torch.from_numpy(mel)).numpy(), rtol=0,
                                   atol=LIVE_ATOL)
        np.testing.assert_allclose(got, _jax_decode(jgen, jp, mel), **MODEL_TOL)


# ---------------------------------------------------------------------------
# the recurrent families: the kernels as one node each
# ---------------------------------------------------------------------------

def test_bsrnn_artifact_holds_four_fused_nodes_and_equals_engine_and_jax(tmp_path):
    h = _bsrnn_h()
    mel = _mel(2, 16)
    jgen, _ = jax_build(h)
    jp = jax_params(jgen, mel)
    sd = params_from_jax(jp, h)
    path = str(tmp_path / "bsrnn.nvsx")
    meta = export_decoder(h, sd, path, batch=2, frames=16, device="cpu")
    dec = load_decoder(path)
    # 2 BSNets x (time + band BiLSTM), no step of a scan unrolled into the graph
    assert meta["ops"] == pexport.graph_ops(dec.program) == {"lstm_scan_fused": 4}
    assert len(dec.program.graph.nodes) < 1000
    got = dec(mel).numpy()
    live = InferenceEngine(h, params=sd, device="cpu").forward(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, live, rtol=0, atol=LIVE_ATOL)
    np.testing.assert_allclose(got, _jax_decode(jgen, jp, mel), **MODEL_TOL)


_CONVTASNET = dict(model_name="ConvTasNet", N=64, L=16, B=128, H=128, P=3, X=3, R=1,
                   num_spks=1, skip_con=True, init_phase="zero", causal=False,
                   norm="gln", fused_tcn=1)


@pytest.mark.parametrize("model, ops", [
    (_CONVTASNET, {"tcn_block_tail": 3}),
    (dict(model_name="GCRN"), {"lstm_scan_bidir2": 2}),
    (dict(model_name="BSRNN", feature_dim=8, num_repeat=2, dropout=0.0, causal=True),
     {"lstm_scan": 2, "lstm_scan_fused": 2}),
], ids=["convtasnet", "gcrn", "bsrnn_causal"])
def test_recurrent_artifact_nodes_and_live_engine(tmp_path, model, ops):
    h = AttrDict({**BASE, **model})
    path = str(tmp_path / "m.nvsx")
    eng = InferenceEngine(h, device="cpu")                 # weights from h.seed
    meta = export_decoder(h, None, path, batch=2, frames=16, device="cpu")
    dec = load_decoder(path)
    assert meta["ops"] == pexport.graph_ops(dec.program) == ops
    mel = _mel(2, 16, seed=3)
    got = dec(mel)
    want = eng.forward(torch.from_numpy(mel))
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=LIVE_ATOL)


def test_symbolic_frames_on_a_recurrent_family_raises(tmp_path):
    with pytest.raises(ValueError, match="frames="):
        export_decoder(_bsrnn_h(), None, str(tmp_path / "x.nvsx"), frames=None, device="cpu")
    assert not os.path.exists(tmp_path / "x.nvsx")


# ---------------------------------------------------------------------------
# load_decoder refuses what it cannot serve
# ---------------------------------------------------------------------------

def _rewrite_meta(src, dst, **kw):
    with zipfile.ZipFile(src) as z:
        meta, blob = json.loads(z.read("meta.json")), z.read("exported.pt2")
    meta.update(kw)
    with zipfile.ZipFile(dst, "w") as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr("exported.pt2", blob)


def test_load_refuses_a_foreign_format_and_a_device_this_host_lacks(tmp_path):
    h, _, _, sd = _hifigan_pair()
    path = str(tmp_path / "a.nvsx")
    export_decoder(h, sd, path, batch=1, frames=8, device="cpu")
    _rewrite_meta(path, tmp_path / "v99.nvsx", format_version=99)
    with pytest.raises(ValueError, match="format"):
        load_decoder(str(tmp_path / "v99.nvsx"))
    _rewrite_meta(path, tmp_path / "gpu.nvsx", device="cuda", device_name="NVIDIA H100")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            load_decoder(str(tmp_path / "gpu.nvsx"))
    assert load_decoder(path).meta["device"] == "cpu"


# ---------------------------------------------------------------------------
# the CLI, in this process
# ---------------------------------------------------------------------------

def test_export_cli_on_the_cpu_with_round_trip_check(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**_hifigan_h(), "seed": 1234}))
    out = str(tmp_path / "cli.nvsx")
    meta = pexport.main(["--cfg_filename", str(cfg), "--out", out, "--batch", "2",
                         "--frames", "-1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert meta["frames"] is None and meta["batch"] == 2 and os.path.exists(out)
    assert lines[0].startswith("exported HiFiGAN -> ") and "device=cpu" in lines[0]
    err = float(lines[1].rsplit("=", 1)[1])
    assert lines[1].startswith("round-trip check: max|artifact - live| = ") and err <= 1e-5
