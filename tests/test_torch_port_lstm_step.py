"""Port parity: the per-step ablation variants of the fused LSTM
(nvse_tpu_torch/ops/lstm_step.py) against the TPU harness's own variants, on
the CPU.

Each of the five modes of `lstm_step_variant_plain` (the plain version of the
variant kernels of csrc/lstm_fused.cu and csrc/lstm_fused_wide.cu) is held
against the JAX harness's `_variant_kernel(1, mode)` (scripts/profile_lstm_step.py,
imported as it is) run through `pl.pallas_call(..., interpret=True)` with the
block specs of its `build` at k = 1, on the same numpy inputs; `full` against
the forward half of the plain fused BiLSTM; then the wrapper's checks and the
port's harness script (scripts/profile_torch_lstm_step.py) in its CPU mode.
The JAX harness is time-major (T, R, C); the port, like lstm_scan_fused, is
batch-first (R, T, C): its inputs and outputs are transposed here.
Tolerances: float32 rtol/atol 1e-5 (the same arithmetic summed in another
order); `full` against the plain fused BiLSTM 1e-6 (the same float32 operations
on another memory layout).
"""
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nvse_tpu_torch.ops import lstm as port_lstm
from nvse_tpu_torch.ops import lstm_step as port_step
from test_torch_port_joint import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
T, R, C, H = 6, 8, 16, 16


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_harness():
    """scripts/profile_lstm_step.py as it is; its import sets JAX's compilation
    cache directory, which is put back."""
    before = jax.config.jax_compilation_cache_dir
    mod = _load("profile_lstm_step")
    jax.config.update("jax_compilation_cache_dir", before)
    return mod


def _data(seed=0, C=C, H=H):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, R, C)).astype(np.float32)
    w_ih = (rng.standard_normal((C, 4 * H)) * 0.2).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    return x, w_ih, w_hh, b


def _jax_variant(harness, x, w_ih, w_hh, b, mode):
    """`build`'s pallas_call at k = 1 (grid (1, T), one block of all rows),
    in interpret mode, on the given inputs."""
    in_idx = (lambda bb, t: (0, bb, 0)) if mode == "no_indma" else (lambda bb, t: (t, bb, 0))
    call = pl.pallas_call(
        harness._variant_kernel(1, mode),
        grid=(1, T),
        in_specs=[pl.BlockSpec((1, R, C), in_idx),
                  pl.BlockSpec((C, 4 * H), lambda bb, t: (0, 0)),
                  pl.BlockSpec((H, 4 * H), lambda bb, t: (0, 0)),
                  pl.BlockSpec((1, 4 * H), lambda bb, t: (0, 0))],
        out_specs=pl.BlockSpec((1, R, H), lambda bb, t: (t, bb, 0)),
        out_shape=jax.ShapeDtypeStruct((T, R, H), jnp.float32),
        scratch_shapes=[pltpu.VMEM((R, H), jnp.float32), pltpu.VMEM((R, H), jnp.float32)],
        interpret=True,
    )
    return np.asarray(call(*map(jnp.asarray, (x, w_ih, w_hh, b.reshape(1, -1)))))


@pytest.mark.parametrize("mode", port_step.MODES)
def test_variant_plain_matches_the_tpu_harness_variant(jax_harness, mode):
    args = _data()
    ref = _jax_variant(jax_harness, *args, mode)
    x, w_ih, w_hh, b = map(torch.from_numpy, args)
    got = port_step.lstm_step_variant_plain(x.transpose(0, 1), w_ih, w_hh, b, mode)
    assert got.shape == (R, T, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), ref, **TOL)
    if mode == "empty":
        assert not got.any()
    else:
        assert got.abs().max() > 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_is_the_forward_half_of_the_fused_bilstm(dtype):
    x, w_ih, w_hh, b = (torch.from_numpy(a).to(dtype) for a in _data(seed=1))
    x = x.transpose(0, 1)
    got = port_step.lstm_step_variant_plain(x, w_ih, w_hh, b, "full")
    fused = port_lstm.lstm_scan_fused_plain(x, w_ih, w_ih, b, b, w_hh, w_hh)
    assert got.dtype == dtype
    torch.testing.assert_close(got, fused[..., :H], rtol=1e-6, atol=1e-6)


def test_variants_each_drop_their_part():
    """no_indma sees x[0] only; no_dot depends on x[t] and b alone (no
    weights); every variant differs from full."""
    x, w_ih, w_hh, b = map(torch.from_numpy, _data(seed=2))
    x = x.transpose(0, 1)
    run = {m: port_step.lstm_step_variant_plain(x, w_ih, w_hh, b, m) for m in port_step.MODES}
    x0 = x[:, :1].expand_as(x).contiguous()
    torch.testing.assert_close(run["no_indma"], port_step.lstm_step_variant_plain(
        x0, w_ih, w_hh, b, "full"), rtol=0, atol=0)
    torch.testing.assert_close(run["no_dot"], port_step.lstm_step_variant_plain(
        x, 2 * w_ih, -w_hh, b, "no_dot"), rtol=0, atol=0)
    for m in port_step.MODES[1:]:
        assert (run[m] - run["full"]).abs().max() > 1e-3, m


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    args = list(map(torch.from_numpy, _data(seed=3)))
    fn = port_step.lstm_step_variant
    before = fn.launches, dict(fn.launches_by_shape), dict(fn.launches_by_kernel)
    for m in port_step.MODES:
        torch.testing.assert_close(fn(*args, m), port_step.lstm_step_variant_plain(*args, m),
                                   rtol=0, atol=0)
    assert (fn.launches, fn.launches_by_shape, fn.launches_by_kernel) == before


def test_variant_arguments_are_checked_before_touching_gpu():
    x, w_ih, w_hh, b = map(torch.from_numpy, _data(seed=4))
    kernel = port_step._launch_variant
    x_bf = x.transpose(0, 1).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        kernel(x_bf, w_ih, w_hh, b, "full")
    with pytest.raises(ValueError, match="mode"):
        kernel(x_bf, w_ih, w_hh, b, "no_cell")
    with pytest.raises(TypeError):
        kernel(x_bf, w_ih.bfloat16(), w_hh, b, "full")
    with pytest.raises(ValueError, match="contiguous"):
        kernel(x.transpose(0, 1), w_ih, w_hh, b, "full")
    # no_dot tiles x over the gates; past the wide fused kernel's limits
    xc, wc, _, _ = map(torch.from_numpy, _data(seed=4, C=24))
    xc = xc.transpose(0, 1).contiguous()
    for fn in (kernel, port_step.lstm_step_variant_plain):
        with pytest.raises(ValueError, match="C == H"):
            fn(xc, wc, w_hh, b, "no_dot")
    Hw = port_lstm._FUSED_WIDE_MAX_H + 8
    with pytest.raises(NotImplementedError, match="C \\+ H"):
        kernel(torch.zeros(1, 1, 8), torch.zeros(8, 4 * Hw), torch.zeros(Hw, 4 * Hw),
               torch.zeros(4 * Hw), "full")
    assert port_step._kernel_source(128) == "lstm_fused"
    assert port_step._kernel_source(256) == "lstm_fused_wide"


def test_profile_script_main_on_cpu(tmp_path, monkeypatch):
    harness = _load("profile_torch_lstm_step")
    # the harness's shapes at their widths, cut to 3 steps over 8 rows
    monkeypatch.setattr(harness, "SHAPES", {k: (name, 3, 8, c, h) for k, (name, _, _, c, h)
                                            in harness.SHAPES.items()})
    argv = ["--device", "cpu", "--iters", "1", "--shapes", "m_time,l_band"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = harness.main(argv)
    printed = [json.loads(l) for l in out.getvalue().splitlines() if l.startswith("{")]
    assert printed == rows and len(rows) == 2 * len(port_step.MODES)
    keys = {"shape", "T", "B", "C", "H", "dtype", "steps", "variant", "ms", "us_per_step",
            "device"}
    for r in rows:
        assert set(r) == keys and r["device"] == "cpu" and r["steps"] == r["T"] == 3
        assert r["B"] == 8 and r["ms"] > 0 and r["us_per_step"] == pytest.approx(r["ms"] * 1e3 / 3)
    assert [r["variant"] for r in rows[:5]] == list(port_step.MODES)
    assert {(r["shape"], r["H"]) for r in rows} == {("bsrnn_m_time", 128), ("bsrnn_l_band", 256)}
    # --out writes the same lines; --append adds to them
    path = tmp_path / "steps.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        harness.main(argv + ["--out", str(path), "--dtype", "bfloat16"])
        harness.main(argv + ["--out", str(path), "--append", "--shapes", "m_band"])
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(lines) == 3 * len(port_step.MODES)
    assert lines[0]["dtype"] == "bfloat16" and lines[-1]["shape"] == "bsrnn_m_band"
