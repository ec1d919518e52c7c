"""Port parity: `lstm_scan_bidir` (both directions of a BiLSTM as stacked rows
of one scan) and the route of `lstm_scan_fused` past its fused kernels,
against the JAX package, on the CPU.

`lstm_scan_bidir_plain` (the plain version of the kernels of csrc/lstm_scan.cu
and csrc/lstm_scan_wide.cu mode kScanBidir) is held against the XLA reference
`_xla_lstm_scan_bidir` and against the Pallas kernel `_pallas_lstm_scan_bidir`
in interpret mode, on the same numpy inputs; the gradient of the port's
wrapper (its recompute route, `_BidirRecompute`) against `jax.grad` of the JAX
package's `lstm_scan_bidir`. `_fused_route` is checked at HD-Demucs's and the
BSRNN shapes, and the third route's composition (`_projected_bidir2`) against
the plain fused BiLSTM and the JAX package's reference. Last, the port's
bench script (scripts/bench_torch_lstm_kernel.py) runs its main() on the CPU.
Tolerances: float32 rtol/atol 1e-5 (the same arithmetic summed in another
order); bfloat16 rtol/atol 0.05, the limit of the JAX package's own bf16
kernel test (tests/test_pallas_lstm.py:273-287; the two round h to bf16 at the
same place, and a one-ulp flip of a stored h moves later steps); gradients
1e-4 (float32 sums over T steps in another order).
"""
import importlib.util
import io
import json
import os
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.ops import pallas_lstm as jax_lstm
from nvse_tpu_torch.ops import lstm as port_lstm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)
# (T, B, H): the JAX package's own case (T = 21, B = 20: 40 rows, not a multiple of
# the Pallas tile's 8 a direction), an odd B (26 rows), and B = 616 (1232 rows, past
# the Pallas tile of 1152: a tile straddles the two directions there)
SHAPES = [(21, 20, 16), (9, 13, 8), (3, jax_lstm._MAX_BIDIR_TILE // 2 + 40, 8)]


def _data(T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((T, 2 * B, 4 * H)) * 0.4).astype(np.float32)
    ws = (rng.standard_normal((2 * H, 4 * H)) * 0.1).astype(np.float32)
    return xp, ws


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_bidir_plain_matches_xla_bidir(T, B, H):
    xp, ws = _data(T, B, H)
    ref = np.asarray(jax_lstm._xla_lstm_scan_bidir(jnp.asarray(xp), jnp.asarray(ws)))
    got = port_lstm.lstm_scan_bidir_plain(torch.from_numpy(xp), torch.from_numpy(ws))
    assert got.shape == (T, 2 * B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_bidir_plain_matches_pallas_interpret(T, B, H):
    xp, ws = _data(T, B, H, seed=1)
    ref = jax_lstm._pallas_lstm_scan_bidir(jnp.asarray(xp), jnp.asarray(ws), B, interpret=True)
    got = port_lstm.lstm_scan_bidir_plain(torch.from_numpy(xp), torch.from_numpy(ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bidir_plain_bf16_matches_pallas_interpret():
    """bfloat16 inputs and weights: the Pallas kernel's `_hdot` rounds h to
    bf16 before the product and keeps the state f32, as the port does."""
    T, B, H = 21, 20, 16
    xp, ws = _data(T, B, H, seed=2)
    ref = jax_lstm._pallas_lstm_scan_bidir(jnp.asarray(xp).astype(jnp.bfloat16),
                                           jnp.asarray(ws).astype(jnp.bfloat16), B,
                                           interpret=True)
    got = port_lstm.lstm_scan_bidir_plain(torch.from_numpy(xp).bfloat16(),
                                          torch.from_numpy(ws).bfloat16())
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **BF16_TOL)


def test_bidir_rows_scan_with_their_own_direction_only():
    """Each half is the unidirectional scan of its rows with its half of
    w_stack; swapping the halves of w_stack changes the output."""
    xp, ws = map(torch.from_numpy, _data(7, 5, 8, seed=3))
    got = port_lstm.lstm_scan_bidir(xp, ws)
    torch.testing.assert_close(got[:, :5], port_lstm.lstm_scan_plain(xp[:, :5], ws[:8]),
                               rtol=0, atol=0)
    torch.testing.assert_close(got[:, 5:], port_lstm.lstm_scan_plain(xp[:, 5:], ws[8:]),
                               rtol=0, atol=0)
    swapped = port_lstm.lstm_scan_bidir(xp, torch.cat([ws[8:], ws[:8]]))
    assert (swapped - got).abs().max() > 1e-2


def test_bidir_cpu_wrapper_runs_plain_and_counts_no_launch():
    xp, ws = map(torch.from_numpy, _data(6, 4, 8))
    fn = port_lstm.lstm_scan_bidir
    before = fn.launches, dict(fn.launches_by_shape), dict(fn.launches_by_kernel)
    got = fn(xp, ws)
    assert (fn.launches, fn.launches_by_shape, fn.launches_by_kernel) == before
    torch.testing.assert_close(got, port_lstm.lstm_scan_bidir_plain(xp, ws), rtol=0, atol=0)


@pytest.mark.parametrize("T,B,H", [(12, 5, 16), (4, 3, 8)])
def test_bidir_gradient_matches_jax_grad(T, B, H):
    """d xp_cat and d w_stack of the port's wrapper under autograd (the
    `_BidirRecompute` route) against jax.grad through nvse_tpu's
    lstm_scan_bidir (its custom VJP: autodiff of `_xla_lstm_scan_bidir`)."""
    xp, ws = _data(T, B, H, seed=5)
    g = np.random.default_rng(6).standard_normal((T, 2 * B, H)).astype(np.float32)

    def loss(a, w):
        return jnp.sum(jax_lstm.lstm_scan_bidir(a, w) * jnp.asarray(g))

    refs = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(ws))
    targs = [torch.from_numpy(a).requires_grad_() for a in (xp, ws)]
    (port_lstm.lstm_scan_bidir(*targs) * torch.from_numpy(g)).sum().backward()
    for t, ref in zip(targs, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_bidir_autograd_takes_the_recompute_route(monkeypatch):
    applied = []
    orig = port_lstm._BidirRecompute.apply
    monkeypatch.setattr(port_lstm._BidirRecompute, "apply",
                        lambda *a: applied.append(1) or orig(*a))
    xp, ws = map(torch.from_numpy, _data(5, 3, 8, seed=7))
    port_lstm.lstm_scan_bidir(xp, ws)
    with torch.no_grad():
        port_lstm.lstm_scan_bidir(xp.requires_grad_(), ws)
    assert applied == []
    out = port_lstm.lstm_scan_bidir(xp.detach(), ws.requires_grad_())
    assert applied == [1] and out.requires_grad
    out.sum().backward()
    assert ws.grad is not None and ws.grad.abs().sum() > 0


def test_bidir_kernel_arguments_are_checked_before_touching_gpu():
    xp, ws = map(torch.from_numpy, _data(5, 3, 8))
    launch = port_lstm._launch_scan_bidir
    with pytest.raises(ValueError, match="CUDA"):
        launch(xp, ws)
    with pytest.raises(ValueError, match="contiguous"):
        launch(xp.transpose(0, 1), ws)
    with pytest.raises(TypeError):
        launch(xp, ws.bfloat16())
    # past the wide kernel's H and at H % 8 != 0 the launch pads and routes: it
    # stops only at the device
    for H in (port_lstm._WIDE_MAX_H + 8, 100):
        with pytest.raises(ValueError, match="CUDA"):
            launch(torch.zeros(1, 2, 4 * H), torch.zeros(2 * H, 4 * H))
    # which kernel H (padded to a multiple of 8) and the dtype pick
    assert port_lstm._kernel_source("lstm_scan_bidir", 128) == "lstm_scan"
    assert port_lstm._kernel_source("lstm_scan_bidir", 124) == "lstm_scan"
    assert port_lstm._kernel_source("lstm_scan_bidir", 256) == "lstm_scan_wide"
    assert port_lstm._kernel_source("lstm_scan_bidir", 776) == "lstm_stepwise"
    assert port_lstm._kernel_source("lstm_scan_bidir", 128, torch.float16) == "lstm_stepwise"


# ---------------------------------------------------------------------------
# lstm_scan_fused past its fused kernels: the route and its composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,H,route", [
    (128, 128, "lstm_fused"),                     # BSRNN-M
    (256, 256, "lstm_fused_wide"),                # BSRNN-L
    (512, 512, "lstm_fused_wide"),                # the wide kernel's last H
    (768, 768, "projection+lstm_bidir2"),         # HD-Demucs bottleneck, layer 1
    (1536, 768, "projection+lstm_bidir2"),        # layer 2
    (1536, 1024, "projection+lstm_stepwise"),     # past the resident kernels' H <= 768
    (102, 102, "lstm_fused"),                     # padded to C = H = 104
    (763, 508, "lstm_fused_wide"),                # padded to 764 + 512 = 1276 <= 1280
    (770, 508, "projection+lstm_bidir2"),         # padded to 772 + 512 = 1284 > 1280
])
def test_fused_route(C, H, route):
    assert port_lstm._fused_route(C, H) == route
    # float16 takes the step-wise kernel at every shape
    assert port_lstm._fused_route(C, H, dtype=torch.float16) == "projection+lstm_stepwise"


def _fused_args(B, T, C, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in [(C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]]
    return [x, *ws]


@pytest.mark.parametrize("B,T,C,H", [(3, 11, 24, 16), (2, 7, 40, 8)])
def test_projected_bidir2_matches_fused_plain_and_jax(B, T, C, H):
    """The third route's composition (projection in torch, both directions'
    scans through lstm_scan_bidir2, the backward output unflipped), run on the
    CPU where lstm_scan_bidir2 is its plain version, against the fused
    BiLSTM's plain version and the JAX package's reference."""
    args = _fused_args(B, T, C, H)
    got = port_lstm._projected_bidir2(*map(torch.from_numpy, args))
    assert got.shape == (B, T, 2 * H) and got.is_contiguous()
    np.testing.assert_allclose(
        got.numpy(), port_lstm.lstm_scan_fused_plain(*map(torch.from_numpy, args)).numpy(), **TOL)
    ref = jax_lstm._xla_lstm_fused_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_projected_bidir2_checks_shapes_and_dtypes():
    args = list(map(torch.from_numpy, _fused_args(2, 3, 8, 8)))
    with pytest.raises(ValueError, match="weight shapes"):
        port_lstm._projected_bidir2(*args[:5], args[5][:4], args[6])
    with pytest.raises(TypeError):
        port_lstm._projected_bidir2(args[0].bfloat16(), *args[1:])


# ---------------------------------------------------------------------------
# the entry point: scripts/bench_torch_lstm_kernel.py
# ---------------------------------------------------------------------------

def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_script_main_on_cpu_prints_every_variant():
    bench = _script("bench_torch_lstm_kernel")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        counts = bench.main(["--device", "cpu", "--batch", "1", "--frames", "5", "--bands", "3",
                             "--hidden", "8", "--iters", "1"])
    lines = [json.loads(l) for l in out.getvalue().splitlines() if l.startswith("{")]
    want = ["unfused", "dualdot", "blockdiag", "unfused_bf16", "dualdot_bf16", "blockdiag_bf16",
            "endtoend_unfused_f32", "fusedproj_f32", "endtoend_unfused_bf16", "fusedproj_bf16",
            "library", "library_bf16"]
    for shape, (T, B) in {"time_lstm": (5, 3), "band_lstm": (3, 5)}.items():
        rows = [r for r in lines if r["shape"] == shape]
        assert [r["variant"] for r in rows] == want
        for r in rows:
            assert {"shape", "T", "B", "H", "variant", "ms", "device"} <= set(r)
            assert (r["T"], r["B"], r["H"]) == (T, B, 8) and r["ms"] > 0
            assert r["device"] == "cpu"
    # on the CPU the wrappers run their plain versions: no kernel launches
    assert counts and all(not d for d in counts.values())
