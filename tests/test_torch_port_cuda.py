"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: skipped where no CUDA GPU is visible (a CUDA kernel has
no CPU mode). Run on a GPU machine with
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
(--noconftest: tests/conftest.py sets up JAX, which these tests do not use).
Shapes are small but cover the ragged row tile, each rows-per-block
instance, T = 1, float32 and bfloat16, the 16-launch BSRNN forward, the
causal forward (8 lstm_scan + 8 fused), a streaming chunk (8 or 16
lstm_scan_stateful + 8 fused), lstm_scan_bidir2 from one row to 33 at
H = 64, 128 and GCRN's 448 with the GCRN forward (2 launches), and the
wide training kernels (csrc/lstm_scan_wide.cu mode kFwdHc, csrc/lstm_bwd_wide.cu)
at H = 136-768 up to BSRNN-L's shapes with GCRN's grouped LSTM under autograd, and the
wide inference kernels (csrc/lstm_fused_wide.cu, csrc/lstm_scan_wide.cu: row groups x
unit slices) from one row to 700 at H = 136-768 with W_hh's rows reversed as the
control and a plan that does not fit raising, with the BSRNN-L (H = 256)
forward, causal forward and stream; the TCN block tail (csrc/tcn_tail.cu)
from one step to 700, dilations 1-300 (past T), 2 Bc over two column tiles,
under autograd, and a 24-block ConvTasNet forward (24 launches); the
two-direction scan lstm_scan_bidir (csrc/lstm_scan.cu, csrc/lstm_scan_wide.cu
mode kScanBidir) from one row to 616 a direction at H = 64-768 with its halves
of w_stack swapped as the control, and under autograd; every per-step ablation
variant (nvse_tpu_torch/ops/lstm_step.py) at H = 128 and 256; lstm_scan_fused
past its fused kernels (HD-Demucs's C = 1536, H = 768) on lstm_scan_bidir2's wide route
(csrc/lstm_scan_wide.cu kScanBidir); every route of lstm_scan_bidir2 forced (the
cluster kernel of csrc/lstm_bidir2.cu, csrc/lstm_scan_wide.cu, csrc/lstm_scan.cu) with
the two W_hh swapped as the control, and the route bidir2_plan reads from the card;
the tail at every instance of its plan, and the gLN
statistics kernel against `_fold` (two runs, the same bits);
the redesigned dW_hh reduction at H = 8-768 over T*R = 1-2405 rows, the
redesigned wide fused kernel at its tile edges (rows, T = 1, C != H,
C + H = 1280, H = 136 and 512, unaligned bfloat16 rows of x), and the
redesigned narrow fused kernel (csrc/lstm_fused.cu: clusters holding the
weights, tensor cores in bfloat16) at H = 16 and 128 from one row to BSRNN-M's
band shape, ragged tiles, C != H, H = 120 (units past H) and unaligned
bfloat16 rows of x, with the plan it reads from the card; lstm_scan_fused at
H = 128 where no cluster of that kernel fits (C = 1400): the projection and
lstm_scan_bidir2 on csrc/lstm_scan.cu; the redesigned narrow scan (csrc/lstm_scan.cu: clusters
with W_hh in registers, tensor cores in bfloat16) at H = 8-128 from one row to
700, from zero and from (h0, c0), B7's two W_hh, clusters walking 1-401 tiles
of one to three steps, with W_hh's rows reversed as the control; and the
redesigned wide backward recurrence (csrc/lstm_bwd_wide.cu: row groups x unit
slices, tensor cores in bfloat16) at H = 136-768 from one row and step to 300
rows, with the same control; and the redesigned narrow training kernels
(csrc/lstm_scan.cu mode kFwdHc and csrc/lstm_bwd.cu: clusters with W_hh
resident, the carry exchanged in distributed shared memory, tensor cores in
bfloat16) at H = 8-128, T = 1 and 2, ragged rows, clusters walking several
tiles and BSRNN-M's training shapes, with W_hh's rows reversed as the
control, and the wide route where the plan says no cluster is held; each
with the plan it reads from the card.
"""
import math

import pytest
import torch

from nvse_tpu_torch.ops import lstm as port_lstm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from nvse_tpu_torch import resolve_device

    return resolve_device("cuda")


def _args(B, T, C, H, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = 1.0 / math.sqrt(H)
    x = torch.randn(B, T, C, generator=g)
    ws = [torch.empty(s).uniform_(-b, b, generator=g)
          for s in [(C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]]
    return [t.to("cuda", dtype) for t in [x, *ws]]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,T,C,H", [   # rows per block 2, 4 and 8 on a 132-SM card
    (3, 17, 12, 8), (200, 9, 128, 128), (300, 40, 64, 32)])
def test_kernel_matches_plain(cuda, B, T, C, H, dtype, tol):
    args = _args(B, T, C, H, dtype)
    n0 = port_lstm.lstm_scan_fused.launches
    got = port_lstm.lstm_scan_fused(*args)
    torch.cuda.synchronize()
    assert port_lstm.lstm_scan_fused.launches == n0 + 1
    ref = port_lstm.lstm_scan_fused_plain(*args)
    assert got.dtype == dtype and got.shape == (B, T, 2 * H)
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_kernel_raises_on_unsupported_hidden_size(cuda):
    # past the fused kernels (H > 512, or C + H > 1280) the route is the projection and
    # lstm_scan_bidir2, whose resident kernels take H <= 768: past that, and at an
    # odd (C, H) the wrapper pads, the step-wise kernel (csrc/lstm_stepwise.cu) runs
    for C, H, stem in ((8, port_lstm._WIDE_MAX_H + 8, "lstm_stepwise"),
                       (1536, 1024, "lstm_stepwise"), (102, 100, "lstm_fused")):
        args = _args(2, 3, C, H, torch.float32)
        n0 = dict(port_lstm.lstm_scan_bidir2.launches_by_kernel)
        f0 = dict(port_lstm.lstm_scan_fused.launches_by_kernel)
        with torch.inference_mode():
            got = port_lstm.lstm_scan_fused(*args)
        ref = port_lstm.lstm_scan_fused_plain(*args)
        assert got.shape == (2, 3, 2 * H)
        assert (got - ref).abs().max().item() <= 1e-4
        delta = (_kernel_delta(port_lstm.lstm_scan_bidir2, n0) if stem == "lstm_stepwise"
                 else _kernel_delta(port_lstm.lstm_scan_fused, f0))
        assert delta == {stem: 1}


def test_bsrnn_forward_launches_16_kernels(cuda):
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.utils import AttrDict

    h = AttrDict(dict(model_name="BSRNN", feature_dim=16, num_repeat=8, causal=False,
                      sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024,
                      num_mels=80, fmin=0, fmax=8000, seed=1234))
    mel = torch.full((2, 80, 64), -4.0)
    n0 = port_lstm.lstm_scan_fused.launches
    gpu = InferenceEngine(h, device="cuda").forward(mel).cpu()
    assert port_lstm.lstm_scan_fused.launches - n0 == 16
    cpu = InferenceEngine(h, device="cpu").forward(mel)
    torch.testing.assert_close(gpu, cpu, rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# training kernels: lstm_fwd_hc, lstm_bwd (+ the dW_hh reduction)
# ---------------------------------------------------------------------------

def _seq_args(T, R, H, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(T, R, 4 * H, generator=g)
    whh = torch.empty(H, 4 * H).uniform_(-1 / math.sqrt(H), 1 / math.sqrt(H), generator=g)
    dhs = torch.randn(T, R, H, generator=g)
    return xp.to("cuda", dtype), whh.to("cuda", dtype), dhs.to("cuda", dtype)


# float32: the same arithmetic summed in another order over a few dozen
# steps; bfloat16: hs, cs and dx are stored with 8 bits of mantissa and the
# kernel and plain version may round a value on either side
SEQ_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}


# the narrow training kernels (csrc/lstm_scan.cu mode kFwdHc, csrc/lstm_bwd.cu): H = 8,
# 32, 64, 120 (units past H) and 128; T = 1 and 2; rows no multiple of a tile (37, 203);
# clusters walking several row tiles (2000 rows); BSRNN-M's time and band shapes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,H", [(7, 3, 8), (9, 200, 128), (5, 300, 32), (34, 37, 128),
                                   (1, 5, 128), (2, 5, 128), (9, 37, 120), (9, 203, 64),
                                   (3, 2000, 128), (65, 544, 128), (34, 1040, 128)])
def test_fwd_hc_and_bwd_match_plain(cuda, T, R, H, dtype):
    xp, whh, dhs = _seq_args(T, R, H, dtype)
    fns = port_lstm.lstm_fwd_hc, port_lstm.lstm_bwd, port_lstm.lstm_dw_hh
    n = [f.launches for f in fns]
    k0 = [dict(f.launches_by_kernel) for f in fns[:2]]
    hs, cs = port_lstm.lstm_fwd_hc(xp, whh)
    dx, dw = port_lstm.lstm_bwd(xp, hs, cs, dhs, whh)
    torch.cuda.synchronize()
    assert [f.launches - k for f, k in zip(fns, n)] == [1, 1, 1]
    assert _kernel_delta(port_lstm.lstm_fwd_hc, k0[0]) == {"lstm_scan": 1}
    assert _kernel_delta(port_lstm.lstm_bwd, k0[1]) == {"lstm_bwd": 1}
    hs_ref, cs_ref = port_lstm.lstm_fwd_hc_plain(xp, whh)
    # the backward's reference from the kernel's own residuals, so that a
    # rounding flip in hs/cs does not count twice
    dx_ref, dw_ref = port_lstm.lstm_bwd_plain(xp, hs, cs, dhs, whh)
    atol, rtol = SEQ_TOL[dtype]
    for got, ref in ((hs, hs_ref), (cs, cs_ref), (dx, dx_ref), (dw, dw_ref)):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    if T > 1:                                  # the controls: W_hh's rows reversed
        w_rev = _reversed_rows(whh)
        ctl, _ = port_lstm.lstm_fwd_hc(xp, w_rev)
        assert (ctl.float() - hs_ref.float()).abs().max().item() > atol
        ctl = port_lstm.lstm_bwd_recurrence(xp, hs, cs, dhs, w_rev)
        assert (ctl.float() - dx_ref.float()).abs().max().item() > atol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_take_the_wide_route_where_the_plan_says(cuda, monkeypatch, dtype):
    """At H <= 128, where a narrow kernel's plan says no cluster is held, the
    wrappers take the wide kernels (chosen before the launch, counted under
    their name) and compute the same."""
    T, R, H = 9, 37, 128
    xp, whh, dhs = _seq_args(T, R, H, dtype)
    hs_ref, cs_ref = port_lstm.lstm_fwd_hc_plain(xp, whh)
    none = dict(co_resident=False)
    monkeypatch.setattr(port_lstm, "_scan_card_plan", lambda *a, **kw: none)
    monkeypatch.setattr(port_lstm, "_bwd_narrow_card_plan", lambda *a, **kw: none)
    k0 = [dict(f.launches_by_kernel) for f in (port_lstm.lstm_fwd_hc, port_lstm.lstm_bwd)]
    hs, cs = port_lstm.lstm_fwd_hc(xp, whh)
    dx = port_lstm.lstm_bwd_recurrence(xp, hs, cs, dhs, whh)
    torch.cuda.synchronize()
    assert _kernel_delta(port_lstm.lstm_fwd_hc, k0[0]) == {"lstm_scan_wide": 1}
    assert _kernel_delta(port_lstm.lstm_bwd, k0[1]) == {"lstm_bwd_wide": 1}
    dx_ref, _ = port_lstm.lstm_bwd_plain(xp, hs, cs, dhs, whh)
    atol, rtol = SEQ_TOL[dtype]
    for got, ref in ((hs, hs_ref), (cs, cs_ref), (dx, dx_ref)):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def test_training_kernels_raise_on_unsupported(cuda):
    # past the resident kernels (H = 776: csrc/lstm_stepwise.cu) and at H % 8 != 0
    # (H = 452, padded to 456: csrc/lstm_scan_wide.cu, csrc/lstm_bwd_wide.cu) the
    # wrappers compute what their plain versions do
    for H, fwd_stem, bwd_stem in ((port_lstm._WIDE_MAX_H + 8, "lstm_stepwise", "lstm_stepwise"),
                                  (452, "lstm_scan_wide", "lstm_bwd_wide")):
        xp, whh, dhs = _seq_args(3, 2, H, torch.float32)
        k0 = (dict(port_lstm.lstm_fwd_hc.launches_by_kernel),
              dict(port_lstm.lstm_bwd.launches_by_kernel))
        hs, cs = port_lstm.lstm_fwd_hc(xp, whh)
        dx, dw = port_lstm.lstm_bwd(xp, hs, cs, dhs, whh)
        torch.cuda.synchronize()
        assert _kernel_delta(port_lstm.lstm_fwd_hc, k0[0]) == {fwd_stem: 1}
        assert _kernel_delta(port_lstm.lstm_bwd, k0[1]) == {bwd_stem: 1}
        hs_ref, cs_ref = port_lstm.lstm_fwd_hc_plain(xp, whh)
        dx_ref, dw_ref = port_lstm.lstm_bwd_plain(xp, hs, cs, dhs, whh)
        for got, ref in ((hs, hs_ref), (cs, cs_ref), (dx, dx_ref), (dw, dw_ref)):
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(port_lstm.lstm_dw_hh(hs, dx), port_lstm.lstm_dw_hh_plain(hs, dx),
                                   atol=1e-4, rtol=1e-4)
    xp, whh, dhs = _seq_args(3, 2, 8, torch.float32)
    with pytest.raises(TypeError):
        port_lstm.lstm_fwd_hc(xp, whh.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        port_lstm.lstm_bwd(xp.transpose(0, 1), dhs, dhs, dhs, whh)


# the wide kernels of csrc/lstm_scan_wide.cu (mode kFwdHc) and csrc/lstm_bwd_wide.cu
# (128 < H <= 768): one row and one step, GCRN's training shape (65 steps x 16
# rows), ragged row tiles, BSRNN-L's time and band shapes (544 x 65, 1040 x 34),
# H = 136 and 264 (k padded to 16 in bfloat16, units of 8) and many rows at the widest H
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,H", [(1, 1, 256), (65, 16, 256), (9, 19, 256), (1, 1, 448),
                                   (65, 16, 448), (9, 19, 448), (1, 1, 768), (65, 16, 768),
                                   (9, 19, 768), (65, 544, 256), (34, 1040, 256), (9, 37, 136),
                                   (9, 37, 264), (5, 300, 768)])
def test_wide_training_kernels_match_plain(cuda, T, R, H, dtype):
    xp, whh, dhs = _seq_args(T, R, H, dtype, seed=H + R)
    xp = 0.5 * xp
    fns = port_lstm.lstm_fwd_hc, port_lstm.lstm_bwd, port_lstm.lstm_dw_hh
    n = [f.launches for f in fns]
    k0 = dict(port_lstm.lstm_fwd_hc.launches_by_kernel)
    hs, cs = port_lstm.lstm_fwd_hc(xp, whh)
    dx, dw = port_lstm.lstm_bwd(xp, hs, cs, dhs, whh)
    torch.cuda.synchronize()
    assert [f.launches - k for f, k in zip(fns, n)] == [1, 1, 1]
    assert _kernel_delta(port_lstm.lstm_fwd_hc, k0) == {"lstm_scan_wide": 1}
    assert port_lstm.lstm_fwd_hc.launches_by_shape[(T, R, H, str(dtype)[6:])] >= 1
    hs_ref, cs_ref = port_lstm.lstm_fwd_hc_plain(xp, whh)
    dx_ref, dw_ref = port_lstm.lstm_bwd_plain(xp, hs, cs, dhs, whh)
    atol, rtol = SEQ_TOL[dtype]
    for got, ref in ((hs, hs_ref), (cs, cs_ref), (dx, dx_ref)):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    if T > 1:                                  # the control: W_hh's rows reversed
        ctl, _ = port_lstm.lstm_fwd_hc(xp, _reversed_rows(whh))
        assert (ctl.float() - hs_ref.float()).abs().max().item() > atol
    # dW sums up to T * R products of stored values: held relative to its largest entry
    scale = max(1.0, dw_ref.float().abs().max().item())
    assert dw.dtype == dtype and (dw.float() - dw_ref.float()).abs().max().item() <= atol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_bilstm_on_card_matches_cpu(cuda, dtype):
    B, T, C, H = 5, 11, 16, 32
    cpu = [a.cpu().float() for a in _args(B, T, C, H, torch.float32, seed=3)]
    g = torch.randn(B, T, 2 * H, generator=torch.Generator().manual_seed(4))

    def run(device, dt):
        args = [a.to(device, dt).requires_grad_() for a in cpu]
        out = port_lstm.lstm_scan_fused(*args)
        out.backward(g.to(device, dt))
        return [out.detach().float().cpu()] + [a.grad.float().cpu() for a in args]

    n0 = port_lstm.lstm_scan_fused.launches
    n_fwd, n_bwd = port_lstm.lstm_fwd_hc.launches, port_lstm.lstm_bwd.launches
    gpu = run("cuda", dtype)
    assert port_lstm.lstm_scan_fused.launches == n0          # the training route only
    assert port_lstm.lstm_fwd_hc.launches - n_fwd == 2
    assert port_lstm.lstm_bwd.launches - n_bwd == 2
    ref = run("cpu", dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for got, want in zip(gpu, ref):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# unidirectional scans: lstm_scan, lstm_scan_stateful
# ---------------------------------------------------------------------------

def _state_args(R, H, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [(0.3 * torch.randn(R, H, generator=g)).to("cuda", dtype) for _ in range(2)]


# float32: the same arithmetic summed in another order; bfloat16: h is rounded
# to 8 bits of mantissa each step and a one-ulp flip moves later steps
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,H", [(1, 3, 8), (17, 3, 8), (9, 200, 128), (40, 300, 32),
                                   (34, 37, 128)])
def test_scan_kernels_match_plain(cuda, T, R, H, dtype):
    xp, whh, _ = _seq_args(T, R, H, dtype)
    h0, c0 = _state_args(R, H, dtype)
    n = port_lstm.lstm_scan.launches, port_lstm.lstm_scan_stateful.launches
    hs = port_lstm.lstm_scan(xp, whh)
    hs_st, cs_st = port_lstm.lstm_scan_stateful(xp, whh, h0, c0)
    torch.cuda.synchronize()
    assert (port_lstm.lstm_scan.launches, port_lstm.lstm_scan_stateful.launches) == (n[0] + 1, n[1] + 1)
    ref = port_lstm.lstm_scan_plain(xp, whh)
    ref_h, ref_c = port_lstm.lstm_scan_stateful_plain(xp, whh, h0, c0)
    tol = SCAN_TOL[dtype]
    for got, want in ((hs, ref), (hs_st, ref_h), (cs_st, ref_c)):
        assert got.dtype == dtype and got.shape == (T, R, H)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # the carried state matters: from zeros the stateful kernel gives lstm_scan's hs
    z = torch.zeros_like(h0)
    torch.testing.assert_close(port_lstm.lstm_scan_stateful(xp, whh, z, z)[0], hs, atol=0, rtol=0)
    assert not torch.equal(hs_st, hs)


def test_scan_kernels_raise_on_unsupported(cuda):
    # past the resident scans' H <= 768 the step-wise kernel computes the scans
    H = port_lstm._WIDE_MAX_H + 8
    xp, whh, _ = _seq_args(3, 2, H, torch.float32)
    h0, c0 = _state_args(2, H, torch.float32)
    with torch.inference_mode():
        torch.testing.assert_close(port_lstm.lstm_scan(xp, whh),
                                   port_lstm.lstm_scan_plain(xp, whh), atol=1e-4, rtol=1e-4)
        for got, ref in zip(port_lstm.lstm_scan_stateful(xp, whh, h0, c0),
                            port_lstm.lstm_scan_stateful_plain(xp, whh, h0, c0)):
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    xp, whh, _ = _seq_args(3, 2, 8, torch.float32)
    h0, c0 = _state_args(2, 8, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        port_lstm.lstm_scan(xp.transpose(0, 1), whh)
    with pytest.raises(ValueError, match="shapes"):
        port_lstm.lstm_scan_stateful(xp, whh, h0[:1], c0)
    with pytest.raises(TypeError):
        port_lstm.lstm_scan_stateful(xp, whh, h0.bfloat16(), c0)


def test_scan_stateful_under_autograd_raises(cuda):
    xp, whh, _ = _seq_args(3, 2, 8, torch.float32)
    h0, c0 = _state_args(2, 8, torch.float32)
    with pytest.raises(RuntimeError, match="no gradient"):
        port_lstm.lstm_scan_stateful(xp.requires_grad_(), whh, h0, c0)
    with torch.no_grad():
        hs, _ = port_lstm.lstm_scan_stateful(xp, whh, h0, c0)
    assert hs.shape == (3, 2, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_scan_on_card_matches_cpu(cuda, dtype):
    T, R, H = 11, 5, 32
    xp, whh, g = (a.cpu().float() for a in _seq_args(T, R, H, torch.float32, seed=5))

    def run(device, dt):
        a, w = (t.to(device, dt).requires_grad_() for t in (xp, whh))
        out = port_lstm.lstm_scan(a, w)
        out.backward(g.to(device, dt))
        return [out.detach().float().cpu(), a.grad.float().cpu(), w.grad.float().cpu()]

    n = port_lstm.lstm_scan.launches, port_lstm.lstm_fwd_hc.launches, port_lstm.lstm_bwd.launches
    gpu = run("cuda", dtype)
    assert (port_lstm.lstm_scan.launches, port_lstm.lstm_fwd_hc.launches,
            port_lstm.lstm_bwd.launches) == (n[0], n[1] + 1, n[2] + 1)   # the training route only
    ref = run("cpu", dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for got, want in zip(gpu, ref):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,stateful_per_chunk", [(True, 8), (False, 16)])
def test_bsrnn_causal_forward_and_streaming_launches(cuda, causal, stateful_per_chunk):
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.utils import AttrDict

    h = AttrDict(dict(model_name="BSRNN", feature_dim=16, num_repeat=8, causal=causal,
                      sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024,
                      num_mels=80, fmin=0, fmax=8000, seed=1234))
    mel = torch.randn(2, 80, 64, generator=torch.Generator().manual_seed(0)) - 4.0
    gpu, cpu = InferenceEngine(h, device="cuda"), InferenceEngine(h, device="cpu")
    fns = port_lstm.lstm_scan, port_lstm.lstm_scan_stateful, port_lstm.lstm_scan_fused

    n0 = [f.launches for f in fns]
    wav = gpu.forward(mel).cpu()
    assert [f.launches - n for f, n in zip(fns, n0)] == ([8, 0, 8] if causal else [0, 0, 16])
    torch.testing.assert_close(wav, cpu.forward(mel), rtol=2e-3, atol=2e-4)

    n0 = [f.launches for f in fns]
    got = gpu.synthesize_streaming_stateful(mel, chunk_frames=32, lookahead_frames=8)
    assert [f.launches - n for f, n in zip(fns, n0)] == [0, 2 * stateful_per_chunk, 2 * 8]
    want = cpu.synthesize_streaming_stateful(mel, chunk_frames=32, lookahead_frames=8)
    torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want), rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# two scans in one launch, wide H and few rows: lstm_scan_bidir2
# ---------------------------------------------------------------------------

def _bidir2_args(T, R, H, dtype, seed=0, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    b = 1 / math.sqrt(H)
    xs = [(0.5 * torch.randn(T, R, 4 * H, generator=g)).to(device, dtype) for _ in range(2)]
    ws = [torch.empty(H, 4 * H).uniform_(-b, b, generator=g).to(device, dtype) for _ in range(2)]
    return (*xs, *ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [64, 128, 448])
@pytest.mark.parametrize("T", [1, 65])
@pytest.mark.parametrize("R", [1, 3, 8, 16, 33])      # below, at and over the 8-row tile
def test_bidir2_kernel_matches_plain(cuda, R, T, H, dtype):
    args = _bidir2_args(T, R, H, dtype, seed=R + T)
    n0 = port_lstm.lstm_scan_bidir2.launches
    with torch.inference_mode():
        got = port_lstm.lstm_scan_bidir2(*args)
        torch.cuda.synchronize()
        ref = port_lstm.lstm_scan_bidir2_plain(*args)
    assert port_lstm.lstm_scan_bidir2.launches == n0 + 1
    tol = SCAN_TOL[dtype]
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == (T, R, H)
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)
    assert not torch.equal(got[0], got[1])        # each scan has its own input and weights


def test_bidir2_kernel_at_its_widest_hidden_size(cuda):
    args = _bidir2_args(9, 5, port_lstm._WIDE_MAX_H, torch.float32)
    with torch.inference_mode():
        got = port_lstm.lstm_scan_bidir2(*args)
        ref = port_lstm.lstm_scan_bidir2_plain(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


def test_bidir2_kernel_raises_on_unsupported(cuda):
    H = port_lstm._WIDE_MAX_H + 8
    with torch.inference_mode():
        args = _bidir2_args(2, 2, H, torch.float32)     # the step-wise kernel's two scans
        for got, ref in zip(port_lstm.lstm_scan_bidir2(*args),
                            port_lstm.lstm_scan_bidir2_plain(*args)):
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        xa, xb, wa, wb = _bidir2_args(4, 3, 64, torch.float32)
        with pytest.raises(ValueError, match="contiguous"):
            port_lstm.lstm_scan_bidir2(xa, xb.transpose(0, 1).contiguous().transpose(0, 1), wa, wb)
        with pytest.raises(ValueError, match="contiguous"):
            port_lstm.lstm_scan_bidir2(xa, xb, wa.T.contiguous().T, wb)
        with pytest.raises(TypeError):
            port_lstm.lstm_scan_bidir2(xa, xb, wa, wb.bfloat16())
        with pytest.raises((TypeError, ValueError)):
            port_lstm.lstm_scan_bidir2(xa, xb.bfloat16(), wa, wb.bfloat16())
        with pytest.raises(ValueError):
            port_lstm.lstm_scan_bidir2(xa, xb[:3].contiguous(), wa, wb)
        with pytest.raises(ValueError, match="CUDA"):
            port_lstm.lstm_scan_bidir2(xa, xb, wa, wb.cpu())


# every route of lstm_scan_bidir2, forced: the cluster kernel of csrc/lstm_bidir2.cu
# (one and more blocks a cluster, one and more row tiles, units past H, T = 1), mode
# kScanBidir of csrc/lstm_scan_wide.cu and csrc/lstm_scan.cu, each through its
# two-pointer entry, with the two W_hh swapped as the control the limit must refuse
BIDIR2_ROUTES = [("lstm_bidir2", 1, 1, 448), ("lstm_bidir2", 65, 8, 448), ("lstm_bidir2", 9, 33, 448),
                 ("lstm_bidir2", 17, 7, 136), ("lstm_bidir2", 5, 3, 24), ("lstm_bidir2", 33, 20, 512),
                 ("lstm_scan_wide", 65, 8, 448), ("lstm_scan_wide", 9, 5, 768),
                 ("lstm_scan_wide", 17, 3, 136), ("lstm_scan", 65, 16, 128), ("lstm_scan", 9, 3, 64)]


def _bidir2_route_plan(route, R, H, dtype):
    """The plan of `route` for R rows at H on this card (as bidir2_plan would make it)."""
    props = torch.cuda.get_device_properties(0)
    if route == "lstm_bidir2":
        return port_lstm.bidir2_cluster_plan(R, H, dtype, props.multi_processor_count,
                                             props.shared_memory_per_block_optin)
    if route == "lstm_scan":
        return port_lstm._scan_card_plan(0, R, H, dtype, 2)
    return port_lstm._scan_wide_card_plan(0, R, H, dtype, 2, "lstm_scan_bidir",
                                          port_lstm._bidir2_wide_instances(H, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,T,R,H", BIDIR2_ROUTES)
def test_bidir2_every_route_matches_plain(cuda, route, T, R, H, dtype):
    args = _bidir2_args(T, R, H, dtype, seed=T + R + H)
    plan = _bidir2_route_plan(route, R, H, dtype)
    if not plan["co_resident"]:               # the f32 slice at H = 512 (240 KB): the plan says so
        assert route == "lstm_bidir2" and not plan["fits"] and dtype == torch.float32
        return
    n0 = dict(port_lstm.lstm_scan_bidir2.launches_by_kernel)
    with torch.inference_mode():
        got = port_lstm.lstm_scan_bidir2(*args, route=route, plan=plan)
        torch.cuda.synchronize()
        ref = port_lstm.lstm_scan_bidir2_plain(*args)
        ctl = port_lstm.lstm_scan_bidir2(args[0], args[1], args[3], args[2], route=route, plan=plan)
    assert _kernel_delta(port_lstm.lstm_scan_bidir2, n0) == {route: 2}
    tol = SCAN_TOL[dtype]
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == (T, R, H)
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)
    control = max((c.float() - r.float()).abs().max().item() for c, r in zip(ctl, ref))
    assert T == 1 or control > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bidir2_plan_on_the_card(cuda, dtype):
    """GCRN's shapes take the cluster kernel on an H100 (14 blocks of 32 units a
    scan); HD-Demucs's H = 768 the wide scan; H <= 128 csrc/lstm_scan.cu; each
    plan co-resident."""
    for T, R, H, want in ((1024, 8, 448, "lstm_bidir2"), (128, 8, 448, "lstm_bidir2"),
                          (1024, 8, 768, "lstm_scan_wide"), (65, 16, 128, "lstm_scan")):
        got = port_lstm._bidir2_card_plan(0, R, H, dtype)
        assert got["plan"]["co_resident"]
        if torch.cuda.get_device_properties(0).shared_memory_per_block_optin >= 232448:
            assert got["route"] == want, (R, H, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_bidir2_on_card_matches_cpu(cuda, dtype):
    T, R, H = 11, 5, 128
    cpu = _bidir2_args(T, R, H, torch.float32, seed=7, device="cpu")
    g = torch.Generator().manual_seed(8)
    ga, gb = torch.randn(T, R, H, generator=g), torch.randn(T, R, H, generator=g)

    def run(device, dt):
        args = [a.to(device, dt).requires_grad_() for a in cpu]
        ha, hb = port_lstm.lstm_scan_bidir2(*args)
        torch.autograd.backward([ha, hb], [ga.to(device, dt), gb.to(device, dt)])
        return [t.detach().float().cpu() for t in (ha, hb)] + [a.grad.float().cpu() for a in args]

    fns = port_lstm.lstm_scan_bidir2, port_lstm.lstm_fwd_hc, port_lstm.lstm_bwd
    n0 = [f.launches for f in fns]
    gpu = run("cuda", dtype)
    assert [f.launches - n for f, n in zip(fns, n0)] == [0, 2, 2]     # the training route only
    ref = run("cpu", dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for got, want in zip(gpu, ref):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_bidir2_at_gcrn_width_matches_cpu(cuda, dtype):
    """GCRN's pairs under autograd at H = 448: the wide training kernels on
    the card (2 lstm_fwd_hc + 2 lstm_bwd + 2 dW, no inference kernel)
    against the plain versions on the CPU."""
    T, R, H = 13, 5, 448
    cpu = _bidir2_args(T, R, H, torch.float32, seed=9, device="cpu")
    g = torch.Generator().manual_seed(10)
    ga, gb = torch.randn(T, R, H, generator=g), torch.randn(T, R, H, generator=g)

    def run(device, dt):
        args = [a.to(device, dt).requires_grad_() for a in cpu]
        ha, hb = port_lstm.lstm_scan_bidir2(*args)
        torch.autograd.backward([ha, hb], [ga.to(device, dt), gb.to(device, dt)])
        return [t.detach().float().cpu() for t in (ha, hb)] + [a.grad.float().cpu() for a in args]

    fns = (port_lstm.lstm_scan_bidir2, port_lstm.lstm_fwd_hc, port_lstm.lstm_bwd,
           port_lstm.lstm_dw_hh)
    n0 = [f.launches for f in fns]
    gpu = run("cuda", dtype)
    assert [f.launches - n for f, n in zip(fns, n0)] == [0, 2, 2, 2]
    ref = run("cpu", dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for got, want in zip(gpu, ref):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol * scale


def test_glstm_gradient_on_card_matches_cpu(cuda):
    """GCRN's grouped LSTM at full width (hidden 896 in 2 groups) under
    autograd: output and every parameter's gradient, card against CPU."""
    from nvse_tpu_torch.models.gcrn import GLSTM

    x = torch.randn(2, 128, 9, 7, generator=torch.Generator().manual_seed(11))
    outs = {}
    for device in ("cpu", "cuda"):
        mod = GLSTM(gen=torch.Generator().manual_seed(12)).to(device)
        xd = x.to(device).detach().requires_grad_()
        y = mod(xd)
        (y * y).mean().backward()
        outs[device] = [y.detach().cpu(), xd.grad.cpu()] + [p.grad.cpu() for p in mod.parameters()]
    assert len(outs["cuda"]) == 2 + 12 + 4          # 4 LSTMs x 3 tensors, 2 LayerNorms x 2
    for got, want in zip(outs["cuda"], outs["cpu"]):
        scale = max(1e-3, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale


def test_gcrn_forward_launches_2_bidir2_kernels(cuda):
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.utils import AttrDict

    h = AttrDict(dict(model_name="GCRN", sampling_rate=22050, n_fft=1024, hop_size=256,
                      win_size=1024, num_mels=80, fmin=0, fmax=8000, seed=1234))
    mel = torch.randn(2, 80, 32, generator=torch.Generator().manual_seed(0)) - 4.0
    fns = (port_lstm.lstm_scan_bidir2, port_lstm.lstm_scan, port_lstm.lstm_scan_stateful,
           port_lstm.lstm_scan_fused, port_lstm.lstm_fwd_hc)
    n0 = [f.launches for f in fns]
    gpu = InferenceEngine(h, device="cuda").forward(mel).cpu()
    assert [f.launches - n for f, n in zip(fns, n0)] == [2, 0, 0, 0, 0]
    assert port_lstm.lstm_scan_bidir2.launches_by_shape[(32, 2, 448, "float32")] >= 2
    torch.testing.assert_close(gpu, InferenceEngine(h, device="cpu").forward(mel),
                               rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# the wide inference kernels: csrc/lstm_fused_wide.cu, csrc/lstm_scan_wide.cu
# ---------------------------------------------------------------------------

def _kernel_delta(fn, n0):
    return {k: v - n0.get(k, 0) for k, v in fn.launches_by_kernel.items() if v != n0.get(k, 0)}


# one row and one step, a few rows (one row group of up to 64), row groups of
# more than 64 rows over several row tiles, C in two staged chunks, the widest H
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,T,C,H", [(1, 1, 256, 256), (5, 9, 136, 136), (40, 17, 256, 256),
                                     (700, 6, 260, 256), (150, 5, 8, 512)])
def test_wide_fused_kernel_matches_plain(cuda, B, T, C, H, dtype, tol):
    args = _args(B, T, C, H, dtype, seed=B + T)
    n0 = dict(port_lstm.lstm_scan_fused.launches_by_kernel)
    with torch.inference_mode():
        got = port_lstm.lstm_scan_fused(*args)
    torch.cuda.synchronize()
    assert _kernel_delta(port_lstm.lstm_scan_fused, n0) == {"lstm_fused_wide": 1}
    ref = port_lstm.lstm_scan_fused_plain(*args)
    assert got.dtype == dtype and got.shape == (B, T, 2 * H)
    assert (got.float() - ref.float()).abs().max().item() <= tol
    # the control: the two directions' W_hh swapped must fail the limit
    if T > 1:
        x, wif, wib, bf, bb, whf, whb = args
        ctl = port_lstm.lstm_scan_fused(x, wif, wib, bf, bb, whb, whf)
        assert (ctl.float() - ref.float()).abs().max().item() > tol


# one row and step; ragged rows at H = 136, 264, 448 and 768; BSRNN-L's decode,
# window and chunk shapes (272 x 1024, 34 x 96, 272 x 80, 34 x 80); 700 rows (groups
# of many tiles)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,H", [(1, 1, 256), (17, 3, 136), (9, 272, 256), (34, 34, 256),
                                   (6, 700, 256), (5, 40, 768), (1024, 272, 256),
                                   (96, 34, 256), (80, 272, 256), (80, 34, 256), (9, 37, 264),
                                   (7, 53, 448), (5, 203, 768)])
def test_wide_scan_kernels_match_plain(cuda, T, R, H, dtype):
    xp, whh, _ = _seq_args(T, R, H, dtype, seed=T + R)
    xp = 0.5 * xp
    h0, c0 = _state_args(R, H, dtype)
    n0 = dict(port_lstm.lstm_scan.launches_by_kernel), dict(port_lstm.lstm_scan_stateful.launches_by_kernel)
    with torch.inference_mode():
        hs = port_lstm.lstm_scan(xp, whh)
        hs_st, cs_st = port_lstm.lstm_scan_stateful(xp, whh, h0, c0)
    torch.cuda.synchronize()
    assert _kernel_delta(port_lstm.lstm_scan, n0[0]) == {"lstm_scan_wide": 1}
    assert _kernel_delta(port_lstm.lstm_scan_stateful, n0[1]) == {"lstm_scan_wide": 1}
    ref = port_lstm.lstm_scan_plain(xp, whh)
    ref_h, ref_c = port_lstm.lstm_scan_stateful_plain(xp, whh, h0, c0)
    tol = SCAN_TOL[dtype]
    for got, want in ((hs, ref), (hs_st, ref_h), (cs_st, ref_c)):
        assert got.dtype == dtype and got.shape == (T, R, H)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    z = torch.zeros_like(h0)
    with torch.inference_mode():
        torch.testing.assert_close(port_lstm.lstm_scan_stateful(xp, whh, z, z)[0], hs,
                                   atol=0, rtol=0)
        w_rev = _reversed_rows(whh)            # the control: W_hh's rows reversed
        ctl = port_lstm.lstm_scan(xp, w_rev), *port_lstm.lstm_scan_stateful(xp, w_rev, h0, c0)
    assert not torch.equal(hs_st, hs)
    for got, want in zip(ctl, (ref, ref_h, ref_c)):
        if T > 1 or got is not ctl[0]:        # the stateful scan multiplies h0 at step 0
            assert (got.float() - want.float()).abs().max().item() > tol


def test_wide_scan_raises_where_no_plan_fits(cuda, monkeypatch):
    """A plan that is not co-resident raises before the launch, and a grid that
    is too large for the card is a launch error, never a hang."""
    xp, whh, _ = _seq_args(3, 1000, 256, torch.float32)
    with torch.inference_mode():
        lib = port_lstm._scan_wide_lib()
        hs = torch.empty(3, 1000, 256, device="cuda")
        c_state = torch.empty_like(hs[0])
        plan = port_lstm._scan_wide_card_plan(0, 1000, 256, torch.float32)
        U, TM, _, smem = port_lstm._scan_wide_plan_args(plan)
        err = lib.lstm_scan_wide_launch(0, xp.data_ptr(), whh.data_ptr(), hs.data_ptr(),
                                        c_state.data_ptr(), 1000, 3, 256, U, TM, 1000, smem,
                                        torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err != 0                        # 1000 row groups of 256 / U blocks
        monkeypatch.setattr(port_lstm, "_scan_wide_card_plan",
                            lambda *a: dict(units=None, co_resident=False, groups=0))
        for call in (lambda: port_lstm.lstm_scan(xp, whh),
                     lambda: port_lstm.lstm_fwd_hc(xp, whh),
                     lambda: port_lstm.lstm_scan_bidir(xp[:, :10].contiguous(),
                                                       torch.cat([whh, whh]))):
            with pytest.raises(RuntimeError, match="R=.*H=256.*co-resident"):
                call()


def test_wide_scan_plan_on_the_card(cuda):
    """The plan the wrappers read from this card at BSRNN-L's shapes: every row
    group co-resident, more than 100 blocks, tensor cores in bfloat16."""
    for dtype in (torch.float32, torch.bfloat16):
        for mode, R in (("lstm_fwd_hc", 544), ("lstm_fwd_hc", 1040), ("lstm_scan", 272),
                        ("lstm_scan_stateful", 272), ("lstm_scan", 34)):
            plan = port_lstm._scan_wide_card_plan(0, R, 256, dtype, 1, mode)
            assert plan["co_resident"] and plan["blocks"] > 100
            assert plan["tensor_cores"] == (dtype == torch.bfloat16)
        plan = port_lstm._scan_wide_card_plan(0, 544, 256, dtype, 2, "lstm_scan_bidir")
        assert plan["co_resident"] and plan["launch_dirs"] == 2


def _bsrnn_l(causal):
    from nvse_tpu_torch.utils import AttrDict

    return AttrDict(dict(model_name="BSRNN", feature_dim=256, num_repeat=8, causal=causal,
                         sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024,
                         num_mels=80, fmin=0, fmax=8000, seed=1234))


def test_bsrnn_l_forward_launches_16_wide_kernels(cuda):
    from nvse_tpu_torch.infer import InferenceEngine

    mel = torch.randn(2, 80, 48, generator=torch.Generator().manual_seed(0)) - 4.0
    n0 = dict(port_lstm.lstm_scan_fused.launches_by_kernel)
    gpu = InferenceEngine(_bsrnn_l(False), device="cuda").forward(mel).cpu()
    assert _kernel_delta(port_lstm.lstm_scan_fused, n0) == {"lstm_fused_wide": 16}
    cpu = InferenceEngine(_bsrnn_l(False), device="cpu").forward(mel)
    torch.testing.assert_close(gpu, cpu, rtol=2e-3, atol=2e-4)


def test_bsrnn_l_causal_forward_and_stream_launch_wide_kernels(cuda):
    from nvse_tpu_torch.infer import InferenceEngine

    # 64 frames: one engine bucket, so the offline decode pads nothing
    mel = torch.randn(2, 80, 64, generator=torch.Generator().manual_seed(1)) - 4.0
    gpu, cpu = InferenceEngine(_bsrnn_l(True), device="cuda"), InferenceEngine(_bsrnn_l(True), device="cpu")
    fns = port_lstm.lstm_scan, port_lstm.lstm_scan_stateful, port_lstm.lstm_scan_fused
    n0 = [dict(f.launches_by_kernel) for f in fns]
    wav = gpu.forward(mel).cpu()
    assert [_kernel_delta(f, n) for f, n in zip(fns, n0)] == [
        {"lstm_scan_wide": 8}, {}, {"lstm_fused_wide": 8}]
    torch.testing.assert_close(wav, cpu.forward(mel), rtol=2e-3, atol=2e-4)
    n0 = [dict(f.launches_by_kernel) for f in fns]
    got = gpu.synthesize_streaming_stateful(mel, out_len=63 * 256, chunk_frames=32,
                                            lookahead_frames=8)
    assert [_kernel_delta(f, n) for f, n in zip(fns, n0)] == [
        {}, {"lstm_scan_wide": 16}, {"lstm_fused_wide": 16}]
    # causal: the stream equals the card's own offline decode
    offline = gpu.synthesize_mel(mel, out_len=63 * 256)
    assert abs(got - offline).max() <= 1e-4 * abs(offline).max()


# ---------------------------------------------------------------------------
# the TCN block tail: csrc/tcn_tail.cu
# ---------------------------------------------------------------------------

def _tail_args(B, T, H, Bc, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = torch.randn(B, T, H, generator=g) + 0.5
    x = torch.randn(B, T, Bc, generator=g)
    gw, gb = 1.0 + 0.1 * torch.randn(1, H, generator=g), 0.5 * torch.randn(1, H, generator=g)
    wdw, bdw = torch.randn(3, H, generator=g) / 3, 0.1 * torch.randn(1, H, generator=g)
    wrs = torch.randn(H, 2 * Bc, generator=g) / math.sqrt(H)
    brs = 0.1 * torch.randn(1, 2 * Bc, generator=g)
    return [t.to("cuda", dtype) for t in (c, x, gw, gb, wdw, bdw, wrs, brs)]


# kernel vs plain over max(1, max |plain|): float32 sums in another order; in
# bfloat16 both round q once and store the outputs with 8-bit mantissas
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,T,H,Bc,d", [(1, 1, 8, 4, 1), (3, 700, 512, 128, 1),
                                        (3, 700, 512, 128, 128), (2, 333, 96, 40, 16),
                                        (2, 100, 64, 200, 300)])
def test_tcn_tail_kernel_matches_plain(cuda, B, T, H, Bc, d, dtype, tol):
    from nvse_tpu_torch.ops.tcn import _fold, tcn_block_tail, tcn_block_tail_plain

    c, x, gw, gb, wdw, bdw, wrs, brs = _tail_args(B, T, H, Bc, dtype, seed=T + d)
    n0 = tcn_block_tail.launches
    with torch.inference_mode():
        e, s = tcn_block_tail(c, x, gw, gb, wdw, bdw, wrs, brs, d)
        torch.cuda.synchronize()
        a, b2 = _fold(c, gw, gb, 1e-5)
        e_ref, s_ref = tcn_block_tail_plain(c, x, a, b2, wdw, bdw, wrs, brs, d)
    assert tcn_block_tail.launches == n0 + 1
    assert tcn_block_tail.launches_by_shape[(B, T, H, Bc, d, str(dtype)[6:])] >= 1
    for got, ref in ((e, e_ref), (s, s_ref)):
        assert got.dtype == dtype and got.shape == (B, T, Bc)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * max(1.0, ref.float().abs().max().item())


# every instance of the tail's plan (chunks of 64, 32, 16 channels; 3 or 4 stages in
# bfloat16), B = 1, T past and below the 128-row tile, d at and past the tile, T < d
@pytest.mark.parametrize("B,T,H,Bc,d", [(1, 300, 512, 128, 200), (2, 50, 128, 64, 64),
                                        (1, 129, 256, 128, 128), (3, 257, 64, 32, 1)])
def test_tcn_tail_every_instance_matches_plain(cuda, B, T, H, Bc, d):
    from nvse_tpu_torch.ops.tcn import (_TAIL, _card_tail_plan, _fold, _tail_smem,
                                        tcn_block_tail_kernel, tcn_block_tail_plain)

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        c, x, gw, gb, wdw, bdw, wrs, brs = _tail_args(B, T, H, Bc, dtype, seed=T + d)
        with torch.inference_mode():
            a, b2 = _fold(c, gw, gb, 1e-5)
            ref = tcn_block_tail_plain(c, x, a, b2, wdw, bdw, wrs, brs, d)
            base = _card_tail_plan(0, B, T, H, Bc, d, dtype)
            for kc, st in _TAIL[dtype]:
                smem = _tail_smem(kc, st, d, dtype)
                if smem > limit:
                    continue
                plan = dict(base, kc=kc, stages=st, smem_bytes=smem)
                got = tcn_block_tail_kernel(c, x, a, b2, wdw, bdw, wrs, brs, d, plan=plan)
                torch.cuda.synchronize()
                for g, r in zip(got, ref):
                    err = (g.float() - r.float()).abs().max().item()
                    assert err <= tol * max(1.0, r.float().abs().max().item()), (kc, st)
            # the control: w_rs with its res and skip halves swapped
            swapped = torch.cat([wrs[:, Bc:], wrs[:, :Bc]], dim=1)
            ctl = tcn_block_tail_kernel(c, x, a, b2, wdw, bdw, swapped, brs, d)
            assert max((g.float() - r.float()).abs().max().item() for g, r in zip(ctl, ref)) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,T,H", [(1, 1, 8), (3, 700, 512), (2, 333, 96), (2, 77, 12),
                                   (1, 4063, 512), (3, 101, 7), (140, 37, 13), (200, 64, 64)])
def test_gln_stats_kernel_matches_fold(cuda, B, T, H, dtype):
    """The statistics kernel against `_fold` (float32 sums in another order: 1e-5
    of a and b2), its launch counted on its own and under its own key in the
    tail's launches_by_kernel, the same bits from two runs, and gln_w and gln_b
    swapped as the control; at one batch element (its partials over the whole
    card), at odd T H (element loads, vec 0; 2 bytes an element leave the rows
    unaligned) and at B > 132 (fewer partials than SMs a row), and a third run
    after a call at another B (the tickets left at 0 by every launch)."""
    from nvse_tpu_torch.ops.tcn import _fold, tcn_block_tail, tcn_gln_fold_kernel

    c, _, gw, gb, *_ = _tail_args(B, T, H, 4, dtype, seed=B + T + H)
    n0 = (tcn_gln_fold_kernel.launches, tcn_block_tail.launches_by_kernel.get("tcn_gln_stats", 0))
    with torch.inference_mode():
        got = tcn_gln_fold_kernel(c, gw, gb, 1e-5)
        again = tcn_gln_fold_kernel(c, gw, gb, 1e-5)
        ref = _fold(c, gw, gb, 1e-5)
        ctl = tcn_gln_fold_kernel(c, gb, gw, 1e-5)
        tcn_gln_fold_kernel(c[:1].contiguous(), gw, gb, 1e-5)
        third = tcn_gln_fold_kernel(c, gw, gb, 1e-5)
    assert tcn_gln_fold_kernel.launches == n0[0] + 5
    assert tcn_block_tail.launches_by_kernel["tcn_gln_stats"] == n0[1] + 5
    for g, a, a3, r in zip(got, again, third, ref):
        assert g.dtype == torch.float32 and g.shape == (B, H)
        assert torch.equal(g, a) and torch.equal(g, a3)
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
    assert max((g - r).abs().max().item() for g, r in zip(ctl, ref)) > 1e-2


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gln_stats_kernel_on_two_cards_keeps_its_scratch_apart(two_cards, dtype):
    """The statistics kernel on two cards' default streams (both raw handle 0),
    launched in turns with no wait between the cards, as replicas serve: each
    card's results match `_fold` and its own first run bit for bit, and each
    card holds its own tickets and partials."""
    from nvse_tpu_torch.ops.tcn import _SCRATCH, _fold, tcn_gln_fold_kernel

    cs = []
    for dev, B in zip(two_cards, (16, 8)):
        c, _, gw, gb, *_ = _tail_args(B, 2047, 512, 4, dtype, seed=B)
        cs.append((c.to(dev), gw.to(dev), gb.to(dev)))
    with torch.inference_mode():
        first = [tcn_gln_fold_kernel(c, gw, gb, 1e-5) for c, gw, gb in cs]
        for _ in range(20):
            runs = [tcn_gln_fold_kernel(c, gw, gb, 1e-5) for c, gw, gb in cs]
        for dev in two_cards:
            torch.cuda.synchronize(dev)
        for (c, gw, gb), got, last in zip(cs, first, runs):
            for g, a, r in zip(got, last, _fold(c, gw, gb, 1e-5)):
                assert torch.equal(g, a)
                torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
    for dev in two_cards:
        tickets, part = _SCRATCH[dev, 0]
        assert tickets.device == dev and part.device == dev and not tickets.any()


def test_convtasnet_served_on_two_cards_matches_one(two_cards):
    """ConvTasNet (fused_tcn 1) served by InferenceEngine with a replica on each
    of two cards: the replicas' statistics kernels launch at once on the two
    default streams, and the decode matches the one-card decode."""
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.utils import AttrDict

    h = dict(model_name="ConvTasNet", sampling_rate=22050, n_fft=1024, hop_size=256,
             win_size=1024, num_mels=80, fmin=0, fmax=8000, N=64, L=16, B=128, H=128, P=3,
             X=8, R=3, num_spks=1, skip_con=True, init_phase="griffin_lim", causal=False,
             norm="gln", fused_tcn=1, seed=1234)
    mel = torch.randn(4, 80, 64, generator=torch.Generator().manual_seed(0)) - 4.0
    one = InferenceEngine(AttrDict(h), device="cuda:0")
    dp = InferenceEngine(AttrDict(dict(h, infer_dp_devices=2)), device="cuda:0")
    assert [next(r.parameters()).device for r in dp.replicas] == list(two_cards)
    ref = one.forward(mel).cpu()
    for _ in range(3):
        torch.testing.assert_close(dp.forward(mel).cpu(), ref, rtol=1e-4, atol=1e-5)


def test_tcn_tail_kernel_raises_on_what_it_does_not_take(cuda):
    from nvse_tpu_torch.ops.tcn import tcn_block_tail

    c, x, gw, gb, wdw, bdw, wrs, brs = _tail_args(2, 9, 16, 8, torch.float32)
    with pytest.raises(NotImplementedError, match="3 taps"):
        tcn_block_tail(c, x, gw, gb, torch.zeros(5, 16, device="cuda"), bdw, wrs, brs, 1)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):     # float64
        tcn_block_tail(c.double(), x.double(), gw.double(), gb.double(), wdw.double(),
                       bdw.double(), wrs.double(), brs.double(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        tcn_block_tail(c.transpose(0, 1).contiguous().transpose(0, 1), x, gw, gb, wdw, bdw,
                       wrs, brs, 1)
    with pytest.raises(ValueError, match="dilation"):
        tcn_block_tail(c, x, gw, gb, wdw, bdw, wrs, brs, 0)


def test_tcn_tail_under_autograd_on_card_matches_cpu(cuda):
    from nvse_tpu_torch.ops.tcn import tcn_block_tail

    host = [t.cpu() for t in _tail_args(2, 65, 128, 64, torch.float32, seed=5)]
    cot = [torch.randn(2, 65, 64, generator=torch.Generator().manual_seed(s)) for s in (1, 2)]
    outs = {}
    for device in ("cuda", "cpu"):
        leaves = [t.to(device).requires_grad_() for t in host]
        n0 = tcn_block_tail.launches
        e, s = tcn_block_tail(*leaves, 4)
        assert tcn_block_tail.launches - n0 == (device == "cuda")
        assert e.grad_fn is not None
        torch.autograd.backward([e, s], [t.to(device) for t in cot])
        outs[device] = [e.detach().cpu(), s.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_convtasnet_forward_launches_24_tails(cuda):
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.ops.tcn import tcn_block_tail
    from nvse_tpu_torch.utils import AttrDict

    h = AttrDict(dict(model_name="ConvTasNet", sampling_rate=22050, n_fft=1024, hop_size=256,
                      win_size=1024, num_mels=80, fmin=0, fmax=8000, N=64, L=16, B=128, H=128,
                      P=3, X=8, R=3, num_spks=1, skip_con=True, init_phase="griffin_lim",
                      causal=False, norm="gln", fused_tcn=1, seed=1234))
    mel = torch.randn(2, 80, 32, generator=torch.Generator().manual_seed(0)) - 4.0
    lstms = (port_lstm.lstm_scan_fused, port_lstm.lstm_scan, port_lstm.lstm_scan_bidir2)
    n0, l0 = dict(tcn_block_tail.launches_by_shape), [f.launches for f in lstms]
    gpu = InferenceEngine(h, device="cuda").forward(mel).cpu()
    got = {k: v - n0.get(k, 0) for k, v in tcn_block_tail.launches_by_shape.items()
           if v != n0.get(k, 0)}
    T = (256 * 31 - 16) // 8 + 1
    assert got == {(2, T, 128, 128, 2 ** i, "float32"): 3 for i in range(8)}
    assert [f.launches for f in lstms] == l0
    torch.testing.assert_close(gpu, InferenceEngine(h, device="cpu").forward(mel),
                               rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# both directions as stacked rows of one scan: lstm_scan_bidir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(1, 1, 128), (17, 20, 128), (9, 616, 64), (64, 20, 256),
                                   (5, 3, 136), (9, 40, 256), (4, 5, 768), (9, 37, 264),
                                   (6, 45, 448), (1024, 544, 256), (68, 8192, 256)])
def test_bidir_scan_kernel_matches_plain(cuda, T, B, H, dtype):
    """Ragged B (20, 616: no tile straddles row B), one row, H = 768 (in float32
    one launch a direction: both directions' blocks are not co-resident), the
    bench's time and band shapes at H = 256."""
    g = torch.Generator().manual_seed(T + B + H)
    xp = (0.5 * torch.randn(T, 2 * B, 4 * H, generator=g)).to("cuda", dtype)
    ws = torch.empty(2 * H, 4 * H).uniform_(-1 / math.sqrt(H), 1 / math.sqrt(H),
                                            generator=g).to("cuda", dtype)
    n0 = dict(port_lstm.lstm_scan_bidir.launches_by_kernel)
    with torch.inference_mode():
        got = port_lstm.lstm_scan_bidir(xp, ws)
        torch.cuda.synchronize()
        ref = port_lstm.lstm_scan_bidir_plain(xp, ws)
        ctl = port_lstm.lstm_scan_bidir(xp, torch.cat([ws[H:], ws[:H]]))
    assert _kernel_delta(port_lstm.lstm_scan_bidir, n0) == {
        "lstm_scan" if H <= 128 else "lstm_scan_wide": 2}
    tol = SCAN_TOL[dtype]
    assert got.dtype == dtype and got.shape == (T, 2 * B, H)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    if T > 1:     # the control: each direction's rows on the other's W_hh
        assert (ctl.float() - ref.float()).abs().max().item() > tol


def test_bidir_scan_kernel_raises_on_what_it_does_not_take(cuda):
    H = port_lstm._WIDE_MAX_H + 8
    with torch.inference_mode():
        g = torch.Generator().manual_seed(3)       # the step-wise kernel's two scans
        xp = torch.randn(2, 4, 4 * H, generator=g).cuda()
        ws = (torch.randn(2 * H, 4 * H, generator=g) / math.sqrt(H)).cuda()
        torch.testing.assert_close(port_lstm.lstm_scan_bidir(xp, ws),
                                   port_lstm.lstm_scan_bidir_plain(xp, ws), atol=1e-4, rtol=1e-4)
        xp, ws = torch.zeros(3, 5, 64, device="cuda"), torch.zeros(32, 64, device="cuda")
        with pytest.raises(ValueError, match="even"):
            port_lstm.lstm_scan_bidir(xp, ws)
        with pytest.raises(ValueError, match="w_stack"):
            port_lstm.lstm_scan_bidir(xp[:, :4].contiguous(), ws[:16])
        with pytest.raises(TypeError):
            port_lstm.lstm_scan_bidir(xp[:, :4].contiguous(), ws.bfloat16())


def test_autograd_bidir_scan_on_card_matches_cpu(cuda):
    g = torch.Generator().manual_seed(3)
    host = [0.5 * torch.randn(9, 10, 64, generator=g), 0.2 * torch.randn(32, 64, generator=g)]
    cot = torch.randn(9, 10, 16, generator=g)

    def run(device):
        args = [a.to(device).requires_grad_() for a in host]
        out = port_lstm.lstm_scan_bidir(*args)
        out.backward(cot.to(device))
        return [out.detach().cpu()] + [a.grad.cpu() for a in args]

    n0 = port_lstm.lstm_scan_bidir.launches
    gpu = run("cuda")
    assert port_lstm.lstm_scan_bidir.launches == n0 + 1
    for a, b in zip(gpu, run("cpu")):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the redesigned kernels at their tile edges: the dW_hh reduction (tensor cores
# in bfloat16, 128 x 128 tiles, splits of the T*R rows) and the wide fused
# BiLSTM (unit slices of 8-32, row tiles of 64 / 128, k-chunks of 64 / 32)
# ---------------------------------------------------------------------------

# T*R = 1, 300 (T = 1: h_{-1} only, dW = 0), 481 and 2405 rows: no multiple of
# a stage's 8 or 32 rows, one split and several
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [8, 136, 256, 448, 768])
@pytest.mark.parametrize("T,R", [(1, 1), (1, 300), (13, 37), (65, 37)])
def test_dw_reduction_matches_plain_at_tile_edges(cuda, T, R, H, dtype):
    g = torch.Generator().manual_seed(T * R + H)
    hs = torch.randn(T, R, H, generator=g).to("cuda", dtype)
    dx = torch.randn(T, R, 4 * H, generator=g).to("cuda", dtype)
    n0 = port_lstm.lstm_dw_hh.launches
    with torch.inference_mode():
        dw = port_lstm.lstm_dw_hh(hs, dx)
    torch.cuda.synchronize()
    assert port_lstm.lstm_dw_hh.launches == n0 + 1
    ref = port_lstm.lstm_dw_hh_plain(hs, dx)
    assert dw.dtype == torch.float32 and dw.shape == (H, 4 * H)
    # the same stored values summed in float32 in another order (chip_smoke.py DW_TOL)
    err = (dw - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    assert err <= 1e-4
    if T > 1:                     # the control: h read one step late must fail the limit
        late = port_lstm.lstm_dw_hh_plain(torch.cat([hs[:1] * 0, hs[:-1]]), dx)
        assert (late - ref).abs().max().item() / max(1.0, ref.abs().max().item()) > 1e-4


# 77 and 130 rows (no multiple of 16 or 64), T = 1, C != H, C + H = 1280 at
# H = 256 and 512, H = 136 (8-unit slices), C = 252 (bfloat16 rows of x not
# 16-byte aligned) and 264 (C not a multiple of a k-chunk)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,T,C,H", [(77, 3, 256, 256), (130, 2, 136, 136), (200, 1, 264, 256),
                                     (33, 4, 768, 512), (50, 3, 1024, 256), (65, 3, 252, 256)])
def test_wide_fused_kernel_matches_plain_at_tile_edges(cuda, B, T, C, H, dtype, tol):
    args = _args(B, T, C, H, dtype, seed=B + T + C)
    n0 = dict(port_lstm.lstm_scan_fused.launches_by_kernel)
    with torch.inference_mode():
        got = port_lstm.lstm_scan_fused(*args)
    torch.cuda.synchronize()
    assert _kernel_delta(port_lstm.lstm_scan_fused, n0) == {"lstm_fused_wide": 1}
    ref = port_lstm.lstm_scan_fused_plain(*args)
    assert got.dtype == dtype and got.shape == (B, T, 2 * H)
    assert (got.float() - ref.float()).abs().max().item() <= tol
    if T > 1:                     # the control: the two directions' W_hh swapped
        x, wif, wib, bf, bb, whf, whb = args
        ctl = port_lstm.lstm_scan_fused(x, wif, wib, bf, bb, whb, whf)
        assert (ctl.float() - ref.float()).abs().max().item() > tol


def test_wide_fused_plan_on_the_card(cuda):
    """The plan the wrapper reads from this card at BSRNN-L's band shape: a
    co-resident grid, the widest slice that fits (32 units in bfloat16, 16 in
    float32 on an H100)."""
    for dtype, units in ((torch.bfloat16, 32), (torch.float32, 16)):
        x = torch.zeros(8192, 34, 256, device="cuda", dtype=dtype)
        plan = port_lstm._fused_wide_launch_plan(x, 256, 256)
        assert plan["co_resident"] and plan["groups"] >= 1
        if torch.cuda.get_device_properties(0).shared_memory_per_block_optin >= 232448:
            assert plan["units"] == units


# ---------------------------------------------------------------------------
# the per-step ablation variants of the fused kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,C,H", [(9, 20, 128, 128), (5, 40, 256, 256), (3, 300, 64, 64)])
@pytest.mark.parametrize("mode", ["full", "no_indma", "no_dot", "no_vpu", "empty"])
def test_step_variant_kernels_match_plain(cuda, mode, T, R, C, H, dtype):
    from nvse_tpu_torch.ops import lstm_step

    g = torch.Generator().manual_seed(R + T)
    b = 1 / math.sqrt(H)
    x = torch.randn(R, T, C, generator=g).to("cuda", dtype)
    w_ih, w_hh, bias = (torch.empty(s).uniform_(-b, b, generator=g).to("cuda", dtype)
                        for s in ((C, 4 * H), (H, 4 * H), (4 * H,)))
    n0 = dict(lstm_step.lstm_step_variant.launches_by_kernel)
    with torch.inference_mode():
        got = lstm_step.lstm_step_variant(x, w_ih, w_hh, bias, mode)
        torch.cuda.synchronize()
        ref = lstm_step.lstm_step_variant_plain(x, w_ih, w_hh, bias, mode)
    assert _kernel_delta(lstm_step.lstm_step_variant, n0) == {
        "lstm_fused" if H <= 128 else "lstm_fused_wide": 1}
    assert got.dtype == dtype and got.shape == (R, T, H)
    err = (got.float() - ref.float()).abs().max().item()
    assert err / max(1.0, ref.float().abs().max().item()) <= SCAN_TOL[dtype]
    if mode == "full":            # the production kernel: the forward half of the fused BiLSTM
        with torch.inference_mode():
            fused = port_lstm.lstm_scan_fused(x, w_ih, w_ih, bias, bias, w_hh, w_hh)
        torch.testing.assert_close(got, fused[..., :H], atol=SCAN_TOL[dtype],
                                   rtol=SCAN_TOL[dtype])


# ---------------------------------------------------------------------------
# lstm_scan_fused past its fused kernels: projection + lstm_scan_bidir2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("C,H", [(1536, 768), (768, 768), (8, 520)])
def test_fused_past_its_kernels_takes_the_bidir2_route(cuda, C, H, dtype, tol):
    """HD-Demucs's bottleneck BiLSTM layers (C = 768 and 1536, H = 768) and a
    shape just past the wide fused kernel's H: the projection as torch
    matmuls, then one lstm_scan_bidir2 launch, none of a fused kernel."""
    args = _args(8, 64 if C == 1536 else 9, C, H, dtype, seed=C + H)
    n0 = (dict(port_lstm.lstm_scan_fused.launches_by_kernel),
          dict(port_lstm.lstm_scan_bidir2.launches_by_kernel))
    with torch.inference_mode():
        got = port_lstm.lstm_scan_fused(*args)
    torch.cuda.synchronize()
    assert _kernel_delta(port_lstm.lstm_scan_fused, n0[0]) == {}
    # no cluster holds H = 520 or 768 (17 or 24 blocks of 32 units): the wide scan
    assert _kernel_delta(port_lstm.lstm_scan_bidir2, n0[1]) == {"lstm_scan_wide": 1}
    ref = port_lstm.lstm_scan_fused_plain(*args)
    assert got.dtype == dtype and got.shape == ref.shape
    assert (got.float() - ref.float()).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# the redesigned narrow fused kernel (csrc/lstm_fused.cu, H <= 128)
# ---------------------------------------------------------------------------

# H = 16 (one block a cluster) and 128 (clusters of 2 in bfloat16, 4 in float32):
# one row, ragged tiles (203 rows, 37 steps), more tiles than clusters (1000 rows),
# BSRNN-M's band shape; C != H, C % 8 == 4 (bfloat16 rows of x not 16-byte aligned)
# and H = 120 (units past H in a cluster's last block)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,T,C,H", [(1, 5, 16, 16), (203, 37, 16, 16), (1000, 6, 20, 16),
                                     (1, 5, 128, 128), (203, 37, 128, 128), (8192, 34, 128, 128),
                                     (203, 37, 124, 120), (65, 9, 252, 128)])
def test_narrow_fused_kernel_matches_plain(cuda, B, T, C, H, dtype, tol):
    args = _args(B, T, C, H, dtype, seed=B + T + C)
    n0 = dict(port_lstm.lstm_scan_fused.launches_by_kernel)
    with torch.inference_mode():
        got = port_lstm.lstm_scan_fused(*args)
    torch.cuda.synchronize()
    assert _kernel_delta(port_lstm.lstm_scan_fused, n0) == {"lstm_fused": 1}
    ref = port_lstm.lstm_scan_fused_plain(*args)
    assert got.dtype == dtype and got.shape == (B, T, 2 * H)
    assert (got.float() - ref.float()).abs().max().item() <= tol
    x, wif, wib, bf, bb, whf, whb = args       # the control: the two directions' W_hh swapped
    ctl = port_lstm.lstm_scan_fused(x, wif, wib, bf, bb, whb, whf)
    assert (ctl.float() - ref.float()).abs().max().item() > tol


def test_narrow_fused_plan_on_the_card(cuda):
    """The plan the wrapper reads from this card at BSRNN-M's time shape: clusters
    of 2 blocks of 64 units in bfloat16 and of 4 of 32 in float32 (on a card with an
    H100's shared memory), every tile resident at once."""
    for dtype, units in ((torch.bfloat16, 64), (torch.float32, 32)):
        x = torch.zeros(272, 1024, 128, device="cuda", dtype=dtype)
        plan = port_lstm._fused_narrow_launch_plan(x, 128, 128)
        assert plan["co_resident"] and plan["rounds"] == 1
        if torch.cuda.get_device_properties(0).shared_memory_per_block_optin >= 232448:
            assert (plan["units"], plan["cluster"]) == (units, 128 // units)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_narrow_fused_takes_the_bidir2_route_where_no_cluster_fits(cuda, dtype, tol):
    # C + H past what the blocks of any cluster hold in shared memory (the weight slice
    # beside the x ring): the projection as torch matmuls and lstm_scan_bidir2, which
    # takes csrc/lstm_scan.cu at H <= 128
    args = _args(4, 3, 1400, 128, dtype)
    n0 = {k: dict(f.launches_by_kernel)
          for k, f in (("fused", port_lstm.lstm_scan_fused), ("bidir2", port_lstm.lstm_scan_bidir2))}
    with torch.inference_mode():
        got = port_lstm.lstm_scan_fused(*args)
        torch.cuda.synchronize()
    assert _kernel_delta(port_lstm.lstm_scan_fused, n0["fused"]) == {}
    assert _kernel_delta(port_lstm.lstm_scan_bidir2, n0["bidir2"]) == {"lstm_scan": 1}
    ref = port_lstm.lstm_scan_fused_plain(*args)
    assert got.dtype == dtype and got.shape == (4, 3, 256)
    assert (got.float() - ref.float()).abs().max().item() <= tol


def _narrow_launch(args, inst, ntiles, ncl):
    """csrc/lstm_fused.cu at a plan of the caller's: `ntiles` row tiles of the
    instance `inst` a direction, walked by `ncl` clusters a direction."""
    x = args[0]
    R, T, C = x.shape
    H = args[-1].shape[0]
    plan = port_lstm._fused_narrow_launch_plan(x, C, H)
    U, stages = plan["units"], plan["stages"]
    smem = port_lstm._narrow_smem(U, inst, C, H, x.dtype, stages)
    out = torch.empty(R, T, 2 * H, device="cuda", dtype=x.dtype)
    err = port_lstm._kernel_lib().lstm_fused_launch(
        port_lstm._DTYPE_CODE[x.dtype], *[a.data_ptr() for a in args], out.data_ptr(), R, T, C, H,
        U, inst, ntiles, ncl, stages, smem, torch.cuda.current_stream().cuda_stream)
    port_lstm._raise_on(err, "lstm_fused")
    torch.cuda.synchronize()
    return out


# Clusters that walk many short tiles: every tile boundary of a cluster, where
# the h exchange of one tile ends and the next begins, 1-3 steps apart, at
# 1, 3 and 7 clusters a direction over 16-row tiles (up to 126 tiles a cluster)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("H", [16, 128])
def test_narrow_fused_kernel_walks_many_tiles(cuda, T, H, dtype, tol):
    R = 2011
    args = _args(R, T, H, H, dtype, seed=T + H)
    ref = port_lstm.lstm_scan_fused_plain(*args)
    x, wif, wib, bf, bb, whf, whb = args
    plan = port_lstm._fused_narrow_launch_plan(x, H, H)
    inst = next(i for i in port_lstm._NARROW_INST
                if port_lstm._narrow_tile_rows(plan["units"], i, dtype) >= 16)
    ntiles = math.ceil(R / 16)
    for ncl in (1, 3, 7):
        got = _narrow_launch(args, inst, ntiles, ncl)
        assert (got.float() - ref.float()).abs().max().item() <= tol, ncl
    ctl = _narrow_launch([x, wif, wib, bf, bb, whb, whf], inst, ntiles, 3)   # W_hh swapped
    if T > 1:                                  # at T = 1 no step reads W_hh
        assert (ctl.float() - ref.float()).abs().max().item() > tol


# ---------------------------------------------------------------------------
# the redesigned narrow scan (csrc/lstm_scan.cu: clusters, W_hh in registers,
# h by st.async, tensor cores in bfloat16) at the plans of scan_narrow_plan
# ---------------------------------------------------------------------------

def _reversed_rows(w):
    """W_hh with its k rows reversed: the control a limit must refuse."""
    return w.flip(0).contiguous()


# H = 8 (one block a cluster), 64, 120 (units past H in the last block) and 128;
# one row, ragged rows, 34 (one row a cluster), 272 (BSRNN-M's decode), 700 (more
# than one wave's rows: clusters walk several tiles)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [8, 64, 120, 128])
@pytest.mark.parametrize("T,R", [(1, 1), (5, 34), (9, 203), (3, 700)])
def test_narrow_scan_matches_plain(cuda, T, R, H, dtype):
    xp, whh, _ = _seq_args(T, R, H, dtype, seed=T + R + H)
    h0, c0 = _state_args(R, H, dtype, seed=R + H)
    tol = SCAN_TOL[dtype]
    n0 = {f.__name__: dict(f.launches_by_kernel)
          for f in (port_lstm.lstm_scan, port_lstm.lstm_scan_stateful)}
    with torch.inference_mode():
        hs = port_lstm.lstm_scan(xp, whh)
        hs_st, cs_st = port_lstm.lstm_scan_stateful(xp, whh, h0, c0)
        torch.cuda.synchronize()
        ctl = port_lstm.lstm_scan_stateful(xp, _reversed_rows(whh), h0, c0)[0]
    for f in (port_lstm.lstm_scan, port_lstm.lstm_scan_stateful):
        assert _kernel_delta(f, n0[f.__name__]) == {"lstm_scan": 1 + (f is port_lstm.lstm_scan_stateful)}
    ref = port_lstm.lstm_scan_plain(xp, whh)
    ref_h, ref_c = port_lstm.lstm_scan_stateful_plain(xp, whh, h0, c0)
    for got, want in ((hs, ref), (hs_st, ref_h), (cs_st, ref_c)):
        assert got.dtype == dtype and got.shape == (T, R, H)
        assert (got.float() - want.float()).abs().max().item() <= tol
    # the control: W_hh's rows reversed (from (h0, c0) every step reads W_hh); one
    # row of one step may move by less than the limit
    if T * R > 1:
        assert (ctl.float() - ref_h.float()).abs().max().item() > tol


def _scan_launch(xp, whh, state, inst, ntiles, ncl):
    """csrc/lstm_scan.cu at a plan of the caller's: `ntiles` row tiles of the
    instance `inst`, walked by `ncl` clusters; state (h0, c0) or None."""
    T, R, G = xp.shape
    H = G // 4
    smem = port_lstm._scan_smem(inst, xp.dtype, port_lstm._SCAN_STAGES)
    hs = torch.empty(T, R, H, device="cuda", dtype=xp.dtype)
    cs = torch.empty_like(hs)
    lib, code = port_lstm._scan_lib(), port_lstm._DTYPE_CODE[xp.dtype]
    plan = (R, T, H, inst, ntiles, ncl, port_lstm._SCAN_STAGES, smem,
            torch.cuda.current_stream().cuda_stream)
    if state is None:
        err = lib.lstm_scan_launch(code, xp.data_ptr(), whh.data_ptr(), hs.data_ptr(), *plan)
    else:
        err = lib.lstm_scan_stateful_launch(code, xp.data_ptr(), whh.data_ptr(), state[0].data_ptr(),
                                            state[1].data_ptr(), hs.data_ptr(), cs.data_ptr(), *plan)
    port_lstm._raise_on(err, "lstm_scan")
    torch.cuda.synchronize()
    return hs, cs


# Clusters that walk many short tiles (T = 1-3: every tile boundary, where one
# tile's h exchange ends and the next begins, a step or three apart), 1, 3 and 7
# clusters over tiles of 1 and 16 rows, from zero state and from (h0, c0)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("H", [16, 128])
def test_narrow_scan_walks_many_tiles(cuda, T, H, dtype):
    R = 401
    xp, whh, _ = _seq_args(T, R, H, dtype, seed=T + H)
    h0, c0 = _state_args(R, H, dtype, seed=H)
    tol = SCAN_TOL[dtype]
    ref = port_lstm.lstm_scan_plain(xp, whh)
    ref_h, ref_c = port_lstm.lstm_scan_stateful_plain(xp, whh, h0, c0)
    rows = port_lstm._SCAN[dtype]["rows"]
    inst = next(i for i in port_lstm._SCAN[dtype]["insts"] if rows * i >= 16)
    for ntiles in (R, math.ceil(R / 16)):
        for ncl in (1, 3, 7):
            hs, _ = _scan_launch(xp, whh, None, inst, ntiles, ncl)
            assert (hs.float() - ref.float()).abs().max().item() <= tol, (ntiles, ncl)
            hs, cs = _scan_launch(xp, whh, (h0, c0), inst, ntiles, ncl)
            assert (hs.float() - ref_h.float()).abs().max().item() <= tol, (ntiles, ncl)
            assert (cs.float() - ref_c.float()).abs().max().item() <= tol, (ntiles, ncl)
    ctl, _ = _scan_launch(xp, _reversed_rows(whh), (h0, c0), inst, math.ceil(R / 16), 3)
    assert (ctl.float() - ref_h.float()).abs().max().item() > tol


# B7 on the narrow scan: each direction's rows on its own W_hh, tiles that never
# straddle row B, one row to more rows than a wave holds
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [8, 64, 120, 128])
@pytest.mark.parametrize("T,B", [(1, 1), (3, 37), (6, 600)])
def test_narrow_bidir_scan_matches_plain(cuda, T, B, H, dtype):
    g = torch.Generator().manual_seed(T + B + H)
    xp = (0.5 * torch.randn(T, 2 * B, 4 * H, generator=g)).to("cuda", dtype)
    ws = torch.empty(2 * H, 4 * H).uniform_(-1 / math.sqrt(H), 1 / math.sqrt(H),
                                            generator=g).to("cuda", dtype)
    with torch.inference_mode():
        got = port_lstm.lstm_scan_bidir(xp, ws)
        torch.cuda.synchronize()
        ctl = port_lstm.lstm_scan_bidir(xp, torch.cat([ws[H:], ws[:H]]))
    ref = port_lstm.lstm_scan_bidir_plain(xp, ws)
    tol = SCAN_TOL[dtype]
    assert (got.float() - ref.float()).abs().max().item() <= tol
    if T > 1:                                  # the control: the two W_hh swapped
        assert (ctl.float() - ref.float()).abs().max().item() > tol


def test_narrow_scan_plan_on_the_card(cuda):
    """The plan the wrapper reads from this card: 34 rows over at least 17
    clusters (more than one), 272 rows in one wave."""
    for dtype in (torch.float32, torch.bfloat16):
        for R in (34, 272):
            x = torch.zeros(3, R, 512, device="cuda", dtype=dtype)
            plan = port_lstm._scan_launch_plan(x, R, 128)
            assert plan["co_resident"] and plan["rounds"] == 1 and plan["clusters"] > 1


# ---------------------------------------------------------------------------
# the redesigned wide backward recurrence (csrc/lstm_bwd_wide.cu: row groups x
# unit slices, W_hh resident, tensor cores in bfloat16) at the plans of
# bwd_wide_plan
# ---------------------------------------------------------------------------

# one row and step; a few rows and steps; 300 rows (groups of many 32- and 64-row
# tiles); GCRN's 65 x 16; a band-like 34 x 130; H = 136 (k padded to 16 in
# bfloat16, units of 8), 256 (BSRNN-L), 448 (GCRN), 768 (the widest)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [136, 256, 448, 768])
@pytest.mark.parametrize("T,R", [(1, 1), (3, 5), (2, 300), (65, 16), (34, 130)])
def test_wide_backward_matches_plain(cuda, T, R, H, dtype):
    xp, whh, dhs = _seq_args(T, R, H, dtype, seed=T + R + H)
    xp = 0.5 * xp
    hs, cs = (t.to(dtype) for t in port_lstm.lstm_fwd_hc_plain(xp, whh))
    n0 = dict(port_lstm.lstm_bwd.launches_by_kernel)
    dx = port_lstm.lstm_bwd_recurrence(xp, hs, cs, dhs, whh)
    torch.cuda.synchronize()
    assert _kernel_delta(port_lstm.lstm_bwd, n0) == {"lstm_bwd_wide": 1}
    ctl = port_lstm.lstm_bwd_recurrence(xp, hs, cs, dhs, _reversed_rows(whh))
    ref, _ = port_lstm.lstm_bwd_plain(xp, hs, cs, dhs, whh)
    tol = SEQ_TOL[dtype][0]
    scale = max(1.0, ref.float().abs().max().item())
    assert dx.dtype == dtype and dx.shape == (T, R, 4 * H)
    assert (dx.float() - ref.float()).abs().max().item() <= tol * scale
    if T > 1:                                  # the control: W_hh's rows reversed
        assert (ctl.float() - ref.float()).abs().max().item() > tol * scale


def test_wide_backward_plan_on_the_card(cuda):
    """The plan the wrapper reads from this card at BSRNN-L's shapes: every
    row group co-resident, more than 100 blocks, tensor cores in bfloat16."""
    for dtype in (torch.float32, torch.bfloat16):
        for R in (544, 1040):
            plan = port_lstm._bwd_wide_card_plan(0, R, 256, dtype)
            assert plan["co_resident"] and plan["blocks"] > 100
            assert plan["tensor_cores"] == (dtype == torch.bfloat16)


# ---------------------------------------------------------------------------
# csrc/lstm_stepwise.cu: past the resident kernels' H = 768 and in float16, every
# wrapper at odd and wide H; float16 with its limit (h rounded to 11 bits each step)
# ---------------------------------------------------------------------------

STEP_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("T,R,H", [(1, 1, 1024), (6, 5, 1024), (9, 37, 100), (4, 19, 776)])
def test_stepwise_kernels_match_plain(cuda, T, R, H, dtype):
    """The step-wise forward (inference and residual-saving), backward and the
    float16 dW reduction against the plain versions, with W_hh's rows reversed
    as the control."""
    tol = STEP_TOL[dtype]
    xp, whh, dhs = _seq_args(T, R, H, dtype)
    stepwise = dtype == torch.float16 or H > port_lstm._WIDE_MAX_H
    train_stepwise = H > port_lstm._WIDE_MAX_H    # float16 trains on the resident kernels
    k0 = (dict(port_lstm.lstm_scan.launches_by_kernel),
          dict(port_lstm.lstm_fwd_hc.launches_by_kernel),
          dict(port_lstm.lstm_bwd.launches_by_kernel))
    with torch.inference_mode():
        hs = port_lstm.lstm_scan(xp, whh)
        ctl = port_lstm.lstm_scan(xp, whh.flip(0).contiguous())
    hs_t, cs_t = port_lstm.lstm_fwd_hc(xp, whh)
    dx, dw = port_lstm.lstm_bwd(xp, hs_t, cs_t, dhs, whh)
    torch.cuda.synchronize()
    if stepwise:
        assert _kernel_delta(port_lstm.lstm_scan, k0[0]) == {"lstm_stepwise": 2}
    if train_stepwise:
        assert _kernel_delta(port_lstm.lstm_fwd_hc, k0[1]) == {"lstm_stepwise": 1}
        assert _kernel_delta(port_lstm.lstm_bwd, k0[2]) == {"lstm_stepwise": 1}
    elif dtype == torch.float16:
        for fn, n0 in ((port_lstm.lstm_fwd_hc, k0[1]), (port_lstm.lstm_bwd, k0[2])):
            got = _kernel_delta(fn, n0)
            assert sum(got.values()) == 1 and "lstm_stepwise" not in got, got
    ref = port_lstm.lstm_scan_plain(xp, whh)
    torch.testing.assert_close(hs.float(), ref.float(), atol=tol, rtol=tol)
    if T > 1:
        assert (ctl.float() - ref.float()).abs().max().item() > tol
    for got, want in zip((hs_t, cs_t), port_lstm.lstm_fwd_hc_plain(xp, whh)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    dx_ref, dw_ref = port_lstm.lstm_bwd_plain(xp, hs_t, cs_t, dhs, whh)
    torch.testing.assert_close(dx.float(), dx_ref.float(), atol=tol, rtol=tol)
    scale = dw_ref.float().abs().max().item()
    assert (dw.float() - dw_ref.float()).abs().max().item() <= tol * max(1.0, scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_stepwise_two_scans_and_fused_route_in_one_launch_a_step(cuda, dtype):
    """lstm_scan_bidir2, lstm_scan_bidir and lstm_scan_fused past H = 768 and in
    float16: both scans in one step-wise launch, against the plain versions."""
    tol = STEP_TOL[dtype]
    H = 1024 if dtype == torch.bfloat16 else 100
    args = _bidir2_args(5, 6, H, dtype)
    n0 = dict(port_lstm.lstm_scan_bidir2.launches_by_kernel)
    with torch.inference_mode():
        got = port_lstm.lstm_scan_bidir2(*args)
        fused = port_lstm.lstm_scan_fused(*_args(3, 5, 102, H, dtype))
    assert _kernel_delta(port_lstm.lstm_scan_bidir2, n0) == {"lstm_stepwise": 2}
    for g, r in zip(got, port_lstm.lstm_scan_bidir2_plain(*args)):
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)
    ref = port_lstm.lstm_scan_fused_plain(*_args(3, 5, 102, H, dtype))
    torch.testing.assert_close(fused.float(), ref.float(), atol=tol, rtol=tol)
    xp = torch.cat(args[:2], dim=1)
    ws = torch.cat(args[2:])
    with torch.inference_mode():
        torch.testing.assert_close(port_lstm.lstm_scan_bidir(xp, ws).float(),
                                   port_lstm.lstm_scan_bidir_plain(xp, ws).float(), atol=tol, rtol=tol)


# the resident training kernels in float16 (the bfloat16 layouts with float16
# products): csrc/lstm_scan.cu kFwdHc and csrc/lstm_bwd.cu at H <= 128,
# csrc/lstm_scan_wide.cu kFwdHc and csrc/lstm_bwd_wide.cu past it, at the f16
# limit 1e-2 of the plain versions (hs, cs, dx stored with 11 bits), relative to
# each output's largest value; dhs at 1, at 1e-3 (dgates of 1e-4 ... 1e-7, below
# float16's normal range of 6.1e-5: without the carry's row scale their split
# loses its bits; smaller dhs would be float16 subnormals in dhs and dx themselves,
# on both sides) and at 1e3 (large carries)
F16_LIMIT = 1e-2


@pytest.mark.parametrize("dhs_scale", [1.0, 1e-3, 1e3])
@pytest.mark.parametrize("T,R,H", [(9, 37, 128), (7, 20, 64), (6, 16, 448), (5, 8, 768),
                                   (4, 33, 256), (7, 3, 8), (1, 5, 128), (9, 37, 120),
                                   (3, 2000, 128), (65, 544, 128)])
def test_float16_resident_training_kernels_match_plain(cuda, T, R, H, dhs_scale):
    """lstm_fwd_hc and lstm_bwd in float16 on the resident kernels (none on the
    step-wise one) against their plain versions, and W_hh's rows reversed as the
    control, which the limit refuses; narrow shapes as the bfloat16 ones below (H = 8
    and 120: units past H in a warp's row; T = 1; clusters walking several tiles;
    BSRNN-M's time shape)."""
    xp, whh, dhs = _seq_args(T, R, H, torch.float16, seed=T + R)
    dhs = (dhs.float() * dhs_scale).half()
    k0 = (dict(port_lstm.lstm_fwd_hc.launches_by_kernel), dict(port_lstm.lstm_bwd.launches_by_kernel))
    hs, cs = port_lstm.lstm_fwd_hc(xp, whh)
    dx, dw = port_lstm.lstm_bwd(xp, hs, cs, dhs, whh)
    ctl_dx, _ = port_lstm.lstm_bwd(xp, hs, cs, dhs, whh.flip(0).contiguous())
    torch.cuda.synchronize()
    want_fwd = "lstm_scan" if H <= 128 else "lstm_scan_wide"
    assert set(_kernel_delta(port_lstm.lstm_fwd_hc, k0[0])) <= {want_fwd, "lstm_scan_wide"}
    assert "lstm_stepwise" not in _kernel_delta(port_lstm.lstm_bwd, k0[1])

    def rel(got, want):                      # T = 1: dW_hh is 0 (h_{-1} = 0)
        err = (got.float() - want.float()).abs().max()
        return (err / want.float().abs().max() if err > 0 else err).item()

    for got, want in zip((hs, cs), port_lstm.lstm_fwd_hc_plain(xp, whh)):
        assert rel(got, want) <= F16_LIMIT
    dx_ref, dw_ref = port_lstm.lstm_bwd_plain(xp, hs, cs, dhs, whh)
    assert torch.isfinite(dx.float()).all() and dx_ref.float().abs().max() > 0
    assert rel(dx, dx_ref) <= F16_LIMIT
    assert rel(dw, dw_ref) <= F16_LIMIT
    if T > 1:
        assert rel(ctl_dx, dx_ref) > F16_LIMIT


def test_float16_tcn_tail_and_stats_match_plain(cuda):
    """csrc/tcn_tail.cu's wgmma tail and its statistics in float16 at a small
    ConvTasNet block (2 Bc over two column tiles, a ragged T)."""
    from nvse_tpu_torch.ops import tcn as port_tcn

    g = torch.Generator().manual_seed(5)
    B, T, H, Bc, d = 2, 301, 96, 160, 4
    c = torch.randn(B, T, H, generator=g).cuda().half()
    x = torch.randn(B, T, Bc, generator=g).cuda().half()
    gw, gb = (1 + 0.1 * torch.randn(1, H, generator=g)).cuda().half(), torch.zeros(1, H).cuda().half()
    wdw = (0.3 * torch.randn(3, H, generator=g)).cuda().half()
    bdw = (0.1 * torch.randn(1, H, generator=g)).cuda().half()
    wrs = (torch.randn(H, 2 * Bc, generator=g) / math.sqrt(H)).cuda().half()
    brs = (0.1 * torch.randn(1, 2 * Bc, generator=g)).cuda().half()
    a, b2 = port_tcn.tcn_gln_fold_kernel(c, gw, gb, 1e-5)
    a_ref, b2_ref = port_tcn._fold(c, gw, gb, 1e-5)
    torch.testing.assert_close(a, a_ref.expand_as(a), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(b2, b2_ref.expand_as(b2), atol=1e-4, rtol=1e-4)
    e, s = port_tcn.tcn_block_tail_kernel(c, x, a, b2, wdw, bdw, wrs, brs, d)
    e_ref, s_ref = port_tcn.tcn_block_tail_plain(c, x, a, b2, wdw, bdw, wrs, brs, d)
    for got, ref in ((e, e_ref), (s, s_ref)):
        assert got.dtype == torch.float16
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)
