"""Port parity: every LSTM entry at any (C, H) and in float16.

On a CUDA tensor each LSTM wrapper zero-pads H to a multiple of 8 and C to one
of 4 (`pad_lstm_args`), runs its kernel and slices the results back
(`slice_lstm_results`); past the resident kernels' H = 768, and in float16, the
route is the step-wise kernel of csrc/lstm_stepwise.cu. Here, on the CPU:
  * the pad/slice pair around each plain version equals the JAX function
    (nvse_tpu/ops/pallas_lstm.py, which takes XLA's scan at these shapes; the
    Pallas residual kernels of pallas_lstm_bwd.py in interpret mode) at odd
    (C, H), forward and gradients, at tests/test_torch_parity.py's rtol 2e-3 /
    atol 2e-4 (float32 sums in another order over a few steps);
  * the route and plan functions pick a kernel, and raise nothing, at
    H = 1024 and in float16;
  * a BSRNN at feature_dim 102 (C = H = 102, padded to 104) matches JAX's,
    with its BiLSTMs on the plain version and on the pad/slice pair;
  * one float16 GAN step of the tiny BSRNN of tests/test_torch_port_train.py
    matches JAX's float16 step: the metrics at rtol 1e-3 (the float32 step's;
    measured 1.1e-4 at most), the AdamW first moments per tensor at a relative
    L2 of 0.1 (measured 0.063 in G, 0.076 in D). They differ where the two
    round apart: the port keeps the LSTM state in float32 where JAX's XLA scan
    carries it in float16 (pallas_lstm.py:61), takes the phase's atan2 in
    float32 (its float16 backward underflows to 0 / 0 at BSRNN-M's width), and
    the CPU JAX MRD takes its convolutions in float32 (its rfft gives float32
    magnitudes, which promote the float16 weights) where the port's run in
    float16.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.ops import pallas_lstm as jax_lstm
from nvse_tpu.ops.pallas_lstm_bwd import lstm_bwd as jax_lstm_bwd
from nvse_tpu.ops.pallas_lstm_bwd import lstm_fwd_hc as jax_lstm_fwd_hc
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.models import build_generator
from nvse_tpu_torch.ops import lstm as port_lstm
from nvse_tpu_torch.ops.lstm import pad_lstm_args, slice_lstm_results
from nvse_tpu_torch.utils import params_from_jax

from test_torch_port_bsrnn import assert_tf_outputs_close, jax_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401
from test_torch_port_train import KEYS, _audio, _h, assert_moments_close, run_both

TOL = dict(rtol=2e-3, atol=2e-4)
ODD = [(10, 13), (102, 100)]            # (C, H): neither a multiple of the kernels'
F16_METRIC_RTOL, F16_MOMENT_REL = 1e-3, 0.1


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _grads(fn, args, g):
    """torch autograd of sum(fn(*args) * g) with respect to every argument."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, g)).backward()
    return [o.detach().numpy() for o in outs], [t.grad.numpy() for t in ts]


def _jax_grads(fn, args, g):
    """The JAX function's outputs and jax.grad of sum(fn(*args) * g)."""
    def outs(*a):
        o = fn(*a)
        return o if isinstance(o, tuple) else (o,)

    ja = [jnp.asarray(a) for a in args]
    loss = lambda *a: sum(jnp.sum(o * c) for o, c in zip(outs(*a), g))   # noqa: E731
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*ja)
    return [np.asarray(o) for o in outs(*ja)], [np.asarray(d) for d in grads]


def _padded(plain, roles, out_roles, H, C=None):
    """`plain` run on pad_lstm_args' arguments, its results sliced back: what
    the wrapper does around its kernel on a CUDA tensor."""
    def fn(*args):
        outs = plain(*pad_lstm_args(args, roles, H, C))
        outs = outs if isinstance(outs, tuple) else (outs,)
        got = slice_lstm_results(outs, out_roles, H)
        return got if len(got) > 1 else got[0]
    return fn


def _close(got, ref, what):
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, err_msg=f"{what} [{i}]", **TOL)


FUSED_ROLES = ("x", "w_ih", "w_ih", "gates", "gates", "w_hh", "w_hh")


@pytest.mark.parametrize("C,H", ODD)
@pytest.mark.parametrize("entry", ["fused", "fused_training", "scan", "scan_training",
                                   "stateful", "bidir2", "bidir2_training", "bidir"])
def test_padded_plain_versions_match_jax(entry, C, H):
    """Forward and gradients of the pad/slice pair around each plain version
    (the training entries: around the autograd Functions of the training
    route, whose forward and backward are lstm_fwd_hc and lstm_bwd) against
    the JAX function and jax.grad."""
    rng = np.random.default_rng(C + H)
    T, B = 5, 3
    w = 1.0 / np.sqrt(H)
    xp, xp2 = _rand(rng, T, B, 4 * H, scale=0.5), _rand(rng, T, B, 4 * H, scale=0.5)
    whh, whh2 = _rand(rng, H, 4 * H, scale=w), _rand(rng, H, 4 * H, scale=w)
    if entry.startswith("fused"):
        args = [_rand(rng, B, T, C), _rand(rng, C, 4 * H, scale=w), _rand(rng, C, 4 * H, scale=w),
                _rand(rng, 4 * H, scale=w), _rand(rng, 4 * H, scale=w), whh, whh2]
        plain = (port_lstm._BiLSTMSaving.apply if entry == "fused_training"
                 else port_lstm.lstm_scan_fused_plain)
        fn = _padded(plain, FUSED_ROLES, ("bidir_out",), H, C)
        ref_fn, g = jax_lstm.lstm_scan_fused, [_rand(rng, B, T, 2 * H)]
    elif entry.startswith("scan"):
        args = [xp, whh]
        plain = port_lstm._ScanSaving.apply if entry == "scan_training" else port_lstm.lstm_scan_plain
        fn = _padded(plain, ("gates", "w_hh"), ("hidden",), H)
        ref_fn, g = jax_lstm.lstm_scan, [_rand(rng, T, B, H)]
    elif entry == "stateful":
        args = [xp, whh, _rand(rng, B, H, scale=0.3), _rand(rng, B, H, scale=0.3)]
        fn = _padded(port_lstm.lstm_scan_stateful_plain, ("gates", "w_hh", "hidden", "hidden"),
                     ("hidden", "hidden"), H)
        ref_fn, g = jax_lstm.lstm_scan_stateful, [_rand(rng, T, B, H), _rand(rng, T, B, H)]
    elif entry.startswith("bidir2"):
        args = [xp, xp2, whh, whh2]
        plain = (port_lstm._Bidir2Saving.apply if entry == "bidir2_training"
                 else port_lstm.lstm_scan_bidir2_plain)
        fn = _padded(plain, ("gates", "gates", "w_hh", "w_hh"), ("hidden", "hidden"), H)
        ref_fn, g = jax_lstm.lstm_scan_bidir2, [_rand(rng, T, B, H), _rand(rng, T, B, H)]
    else:
        args = [np.concatenate([xp, xp2], axis=1), np.concatenate([whh, whh2])]
        fn = _padded(port_lstm.lstm_scan_bidir_plain, ("gates", "w_stack"), ("hidden",), H)
        ref_fn, g = jax_lstm.lstm_scan_bidir, [_rand(rng, T, 2 * B, H)]
    outs, grads = _grads(fn, args, g)
    ref_outs, ref_grads = _jax_grads(ref_fn, args, g)
    _close(outs, ref_outs, f"{entry} outputs")
    if entry != "stateful":            # the JAX streaming scan has no gradient either
        _close(grads, ref_grads, f"{entry} gradients")


@pytest.mark.parametrize("H", [13, 100, 1028])
def test_padded_training_plain_versions_match_the_pallas_residual_kernels(H):
    """lstm_fwd_hc and lstm_bwd (with its dW_hh, and lstm_dw_hh alone) through
    the pad/slice pair against the JAX residual kernels in interpret mode; H =
    1028 is past the resident kernels (the step-wise route on the card)."""
    rng = np.random.default_rng(H)
    T, B = (4, 3) if H < 1000 else (2, 2)
    xp, whh, dhs = (_rand(rng, T, B, 4 * H, scale=0.5), _rand(rng, H, 4 * H, scale=H ** -0.5),
                    _rand(rng, T, B, H))
    hs_j, cs_j = jax_lstm_fwd_hc(jnp.asarray(xp), jnp.asarray(whh), interpret=True, unroll=1)
    fwd = _padded(port_lstm.lstm_fwd_hc_plain, ("gates", "w_hh"), ("hidden", "hidden"), H)
    hs, cs = fwd(torch.from_numpy(xp), torch.from_numpy(whh))
    _close([hs.numpy(), cs.numpy()], [np.asarray(hs_j), np.asarray(cs_j)], "lstm_fwd_hc")
    dx_j, dw_j = jax_lstm_bwd(jnp.asarray(xp), hs_j, cs_j, jnp.asarray(dhs), jnp.asarray(whh),
                              interpret=True, unroll=1)
    bwd = _padded(port_lstm.lstm_bwd_plain, ("gates", "hidden", "hidden", "hidden", "w_hh"),
                  ("gates", "w_hh"), H)
    t = lambda a: torch.tensor(np.asarray(a))              # noqa: E731
    dx, dw = bwd(t(xp), t(hs_j), t(cs_j), t(dhs), t(whh))
    _close([dx.numpy(), dw.numpy()], [np.asarray(dx_j), np.asarray(dw_j)], "lstm_bwd")
    dw2 = _padded(port_lstm.lstm_dw_hh_plain, ("hidden", "gates"), ("w_hh",), H)(t(hs_j), dx)
    _close([dw2.numpy()], [np.asarray(dw_j)], "lstm_dw_hh")


def test_padding_is_zero_in_every_padded_unit_and_gate():
    """The padded units' rows and gate columns hold zeros, and the pair's
    shapes: H 13 -> 16 in each of the four gate blocks, C 10 -> 12."""
    H, C = 13, 10
    x, w_ih, b, w_hh = torch.ones(2, 3, C), torch.ones(C, 4 * H), torch.ones(4 * H), torch.ones(H, 4 * H)
    px, pw_ih, pb, pw_hh = pad_lstm_args((x, w_ih, b, w_hh), ("x", "w_ih", "gates", "w_hh"), H, C)
    assert port_lstm.lstm_padding(H, C) == (16, 12)
    assert (px.shape, pw_ih.shape, pb.shape, pw_hh.shape) == ((2, 3, 12), (12, 64), (64,), (16, 64))
    live = torch.zeros(4, 16, dtype=torch.bool)
    live[:, :H] = True
    assert torch.equal(pb.reshape(4, 16) != 0, live)
    assert torch.equal(pw_hh[:H].reshape(H, 4, 16) != 0, live.expand(H, 4, 16))
    assert not pw_hh[H:].any() and not pw_ih[C:].any() and not px[..., C:].any()
    back = slice_lstm_results((pw_hh, pb), ("w_hh", "gates"), H)
    assert torch.equal(back[0], w_hh) and torch.equal(back[1], b)
    # aligned shapes are left as they are
    assert port_lstm.lstm_padding(16, 12) == (16, 12) and not port_lstm._needs_padding(16, 12)


@pytest.mark.parametrize("H,dtype", [(1024, torch.float32), (1024, torch.bfloat16),
                                     (128, torch.float16), (100, torch.float16),
                                     (102, torch.float32)])
def test_routes_and_plans_take_wide_and_float16_shapes(H, dtype):
    """The route and plan functions pick a kernel at H = 1024 (the step-wise
    kernel), in float16 (the step-wise kernel for the inference scans, the
    resident training kernels for lstm_fwd_hc and lstm_bwd) and at odd H (the
    kernel of the padded H), and the wrappers' checks stop only at the device."""
    stepwise = H > port_lstm._WIDE_MAX_H or dtype == torch.float16
    train_stepwise = H > port_lstm._WIDE_MAX_H
    Hp = port_lstm.lstm_padding(H)[0]
    resident = "lstm_scan" if Hp <= 128 else "lstm_scan_wide"
    want = "lstm_stepwise" if stepwise else resident
    for name in ("lstm_scan", "lstm_scan_stateful", "lstm_scan_bidir"):
        assert port_lstm._kernel_source(name, H, dtype) == want, name
    assert port_lstm._kernel_source("lstm_fwd_hc", H, dtype) == (
        "lstm_stepwise" if train_stepwise else resident)
    assert port_lstm._kernel_source("lstm_dw_hh", H, dtype) == "lstm_bwd"
    H100 = (132, 232448)
    fused = port_lstm.fused_route(H, H, dtype, *H100)
    assert fused == ("projection+lstm_stepwise" if stepwise else "lstm_fused")
    assert port_lstm._fused_route(H, H, dtype=dtype) == fused
    narrow = dict(co_resident=Hp <= 128)
    for name, kernel in (("lstm_fwd_hc", "lstm_scan"), ("lstm_bwd", "lstm_bwd")):
        assert port_lstm.train_route(name, Hp, narrow, dtype) == (
            "lstm_stepwise" if train_stepwise else kernel)
    got = port_lstm.bidir2_plan(34, 8, H, dtype, *H100)
    assert got["plan"]["co_resident"]
    assert got["route"] == ("lstm_stepwise" if stepwise else "lstm_scan")
    if stepwise:
        assert got["plan"]["blocks"] == 2 * (-(-H // 16))
    assert port_lstm.dw_plan(34, 8, Hp, dtype, *H100, 1)["fits"]
    xp, w = torch.zeros(3, 2, 4 * H, dtype=dtype), torch.zeros(H, 4 * H, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        port_lstm._check_seq_args("lstm_scan", xp, w)
    with pytest.raises(ValueError, match="CUDA"):
        port_lstm.lstm_fwd_hc(xp.to("meta"), w.to("meta"))


def test_feature_dim_102_bsrnn_matches_jax(monkeypatch):
    """A BSRNN at feature_dim 102 (its BiLSTMs at C = H = 102, padded to 104 on
    the card) against JAX's, with the port's BiLSTMs on the plain version and
    on the pad/slice pair around it."""
    h = AttrDict(dict(model_name="BSRNN", feature_dim=102, num_repeat=2, dropout=0.0,
                      causal=False, sampling_rate=22050, n_fft=1024, hop_size=256,
                      win_size=1024, num_mels=80, fmin=0, fmax=8000, seed=1234))
    x = np.random.default_rng(0).standard_normal((1, 80, 12)).astype(np.float32) - 4.0
    jgen, _ = jax_build(h)
    jparams = jax_params(jgen, x)
    theirs = jax.jit(jgen.apply)({"params": jparams}, jnp.asarray(x))
    gen, _ = build_generator(h)
    gen.load_state_dict(params_from_jax(jparams, h))
    with torch.no_grad():
        ours = [t.numpy() for t in gen(torch.from_numpy(x))]
    assert_tf_outputs_close(ours, theirs)
    calls = []
    plain = port_lstm.lstm_scan_fused_plain
    padded = _padded(plain, FUSED_ROLES, ("bidir_out",), 102, 102)
    monkeypatch.setattr(port_lstm, "lstm_scan_fused_plain",
                        lambda *a: calls.append(a[0].shape) or padded(*a))
    with torch.no_grad():
        ours_padded = [t.numpy() for t in gen(torch.from_numpy(x))]
    assert len(calls) == 2 * 2 and all(s[-1] == 102 for s in calls)   # repeats x (time, band)
    assert_tf_outputs_close(ours_padded, theirs)


def test_float16_gan_step_matches_jax():
    """One T-F GAN step of the tiny BSRNN in float16 trunks (float32 master
    weights, optimizer states, features and losses; no loss scaling, as JAX)
    against JAX's float16 step. The MPD has one period: the float16 trunk is
    the point (tests/test_torch_port_train.py holds the full MPD + MRD step)."""
    h = _h(compute_dtype="float16", mpd_reshapes=[2])
    r = run_both(h, _audio(2, h.segment_size))
    for k in KEYS:
        assert np.isfinite(r["port_metrics"][k]), k
        np.testing.assert_allclose(r["port_metrics"][k], r["jax_metrics"][k],
                                   rtol=F16_METRIC_RTOL, err_msg=k)
    assert_moments_close(r["g_mu_port"], r["g_mu_jax"], rel=F16_MOMENT_REL)
    assert_moments_close(r["d_mu_port"], r["d_mu_jax"], rel=F16_MOMENT_REL)
