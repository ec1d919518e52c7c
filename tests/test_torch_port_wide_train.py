"""Port parity: the LSTM training route at a wide hidden size (GCRN's
H = 448) and one GCRN GAN step, against the JAX package, on the CPU.

On the card, H = 448 runs the kernels of csrc/lstm_scan_wide.cu (mode
kFwdHc) and csrc/lstm_bwd_wide.cu; their plain
versions `lstm_fwd_hc_plain` / `lstm_bwd_plain` (what the CPU runs, and
what chip_smoke.py holds the kernels against) are held here against the
Pallas kernels `lstm_fwd_hc` / `lstm_bwd` in interpret mode (unroll 1, as
tests/test_pallas_lstm.py runs them) and against the VJP of the XLA scan
`_xla_lstm_scan`, at T = 5 steps x R = 3 rows.
Tolerances: float32 rtol/atol 1e-5 (the same arithmetic summed in another
order over 448-term products); bfloat16 those of
tests/test_torch_port_lstm_train.py (0.05 forward, 0.1 / 0.15 backward:
the two frameworks round hs, cs and dx_proj to 8 bits at other places).
Then the routing of the training wrappers by H, checked before any CUDA
call, and one GCRN GAN step (T-F trainer, MPD + MRD) against
nvse_tpu.train.make_train_step from the same weights and batch (batch 2 x
2048 samples), at the limits of tests/test_torch_port_train.py: metrics
at rtol 1e-3, G and D AdamW first moments at a relative L2 of 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvse_tpu.ops.pallas_lstm import _xla_lstm_scan
from nvse_tpu.ops.pallas_lstm_bwd import lstm_bwd, lstm_fwd_hc
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.ops import lstm as port_lstm

from test_torch_port_train import KEYS, LR, _audio, assert_moments_close, run_both
from test_torch_port_joint import _one_torch_thread  # noqa: F401

H = 448
F32 = dict(rtol=1e-5, atol=1e-5)


def _seq(T=5, R=3, seed=0):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((T, R, 4 * H)) * 0.5).astype(np.float32)
    whh = rng.uniform(-1, 1, (H, 4 * H)).astype(np.float32) / np.sqrt(H)
    dhs = rng.standard_normal((T, R, H)).astype(np.float32)
    return xp, whh, dhs


def _t(*arrays):
    return [torch.tensor(np.asarray(a, np.float32)) for a in arrays]


def test_fwd_hc_plain_matches_pallas_interpret_f32():
    xp, whh, _ = _seq()
    hs_j, cs_j = lstm_fwd_hc(jnp.asarray(xp), jnp.asarray(whh), interpret=True, unroll=1)
    hs, cs = port_lstm.lstm_fwd_hc_plain(*_t(xp, whh))
    assert hs.shape == cs.shape == (5, 3, H)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), **F32)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), **F32)


def test_bwd_plain_matches_pallas_interpret_f32():
    xp, whh, dhs = _seq(seed=1)
    hs_j, cs_j = lstm_fwd_hc(jnp.asarray(xp), jnp.asarray(whh), interpret=True, unroll=1)
    dx_j, dw_j = lstm_bwd(jnp.asarray(xp), hs_j, cs_j, jnp.asarray(dhs), jnp.asarray(whh),
                          interpret=True, unroll=1)
    dx, dw = port_lstm.lstm_bwd_plain(*_t(xp, hs_j, cs_j, dhs, whh))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **F32)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **F32)


def test_training_route_matches_xla_scan_vjp_f32():
    """hs of the plain forward is the XLA scan's output; the plain backward
    fed the plain forward's residuals gives jax.vjp's (dx_proj, dW_hh)."""
    xp, whh, dhs = _seq(seed=2)
    hs_ref, vjp = jax.vjp(_xla_lstm_scan, jnp.asarray(xp), jnp.asarray(whh))
    dx_ref, dw_ref = vjp(jnp.asarray(dhs))
    hs, cs = port_lstm.lstm_fwd_hc_plain(*_t(xp, whh))
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_ref), **F32)
    dx, dw = port_lstm.lstm_bwd_plain(*_t(xp), hs, cs, *_t(dhs, whh))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), **F32)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **F32)


def test_training_plain_versions_bf16_match_pallas_interpret():
    xp, whh, dhs = _seq(seed=3)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)   # exact
    hs_j, cs_j = lstm_fwd_hc(bf(xp), bf(whh), interpret=True, unroll=1)
    hs, cs = port_lstm.lstm_fwd_hc_plain(tb(bf(xp)), tb(bf(whh)))
    assert hs.dtype == cs.dtype == torch.bfloat16
    for got, ref in ((hs, hs_j), (cs, cs_j)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=0.05, atol=0.05)
    dx_j, dw_j = lstm_bwd(bf(xp), hs_j, cs_j, bf(dhs), bf(whh), interpret=True, unroll=1)
    dx, dw = port_lstm.lstm_bwd_plain(tb(bf(xp)), tb(hs_j), tb(cs_j), tb(bf(dhs)), tb(bf(whh)))
    assert dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(dx_j, np.float32),
                               rtol=0.1, atol=0.1)
    np.testing.assert_allclose(dw.float().numpy(), np.asarray(dw_j, np.float32),
                               rtol=0.1, atol=0.15)


# ---------------------------------------------------------------------------
# which kernel the training wrappers take, decided before any CUDA call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lstm_fwd_hc", "lstm_bwd", "lstm_dw_hh"])
@pytest.mark.parametrize("h,resident", [(448, True), (768, True), (776, False), (452, True)])
def test_training_kernels_take_h_up_to_768_before_touching_gpu(name, h, resident):
    """Every H passes the shape check (which then stops at the device: these
    tensors are on the CPU): H % 8 != 0 is padded, and past the resident
    kernels' H <= 768 the step-wise kernels of csrc/lstm_stepwise.cu take it."""
    xp, whh, st = torch.zeros(2, 3, 4 * h), torch.zeros(h, 4 * h), torch.zeros(2, 3, h)
    if name == "lstm_dw_hh":
        check = lambda: port_lstm._check_seq_args(name, xp, None, st)
    else:
        states = (st,) * (3 if name == "lstm_bwd" else 0)
        check = lambda: port_lstm._check_seq_args(name, xp, whh, *states)
        wide = "lstm_scan_wide" if name == "lstm_fwd_hc" else "lstm_bwd_wide"
        assert port_lstm.train_route(name, port_lstm.lstm_padding(h)[0],
                                     dict(co_resident=False)) == (wide if resident
                                                                  else "lstm_stepwise")
    with pytest.raises(ValueError, match="CUDA"):
        check()


@pytest.mark.parametrize("h,wide", [(8, False), (128, False), (136, True), (448, True),
                                    (768, True)])
def test_training_kernels_pick_the_wide_kernels_above_h_128(h, wide):
    # the narrow kernels' plans run up to H = 128 (on an H100's figures), and the route
    # takes them there; past it the wide kernels
    for dtype in (torch.float32, torch.bfloat16):
        fwd = port_lstm.scan_narrow_plan(16, h, dtype, 132, 232448, mode="lstm_fwd_hc")
        bwd = port_lstm.bwd_narrow_plan(16, h, dtype, 132, 232448)
        assert fwd["co_resident"] == bwd["co_resident"] == (not wide)
        assert port_lstm.train_route("lstm_fwd_hc", h, fwd) == (
            "lstm_scan_wide" if wide else "lstm_scan")
        assert port_lstm.train_route("lstm_bwd", h, bwd) == ("lstm_bwd_wide" if wide else "lstm_bwd")
    # the launch counters name the source: the forward is a mode of the scans
    assert port_lstm._kernel_source("lstm_fwd_hc", h) == ("lstm_scan_wide" if wide else "lstm_scan")
    assert port_lstm._kernel_source("lstm_bwd", h) == ("lstm_bwd_wide" if wide else "lstm_bwd")


def test_cpu_tensors_at_h448_run_the_plain_versions_and_count_no_launch():
    xp, whh, dhs = _t(*_seq(T=3, R=2, seed=4))
    fns = port_lstm.lstm_fwd_hc, port_lstm.lstm_bwd, port_lstm.lstm_dw_hh
    n = [f.launches for f in fns]
    hs, cs = port_lstm.lstm_fwd_hc(xp, whh)
    dx, dw = port_lstm.lstm_bwd(xp, hs, cs, dhs, whh)
    assert [f.launches for f in fns] == n
    torch.testing.assert_close(dx, port_lstm.lstm_bwd_plain(xp, hs, cs, dhs, whh)[0],
                               rtol=0, atol=0)
    assert dw.shape == (H, 4 * H)


# ---------------------------------------------------------------------------
# one GCRN GAN step against make_train_step
# ---------------------------------------------------------------------------

def _gcrn_h(**kw):
    base = dict(model_name="GCRN", sampling_rate=22050, n_fft=1024, hop_size=256,
                win_size=1024, num_mels=80, fmin=0, fmax=8000, meloss=None, segment_size=2048,
                batch_size=2, learning_rate=LR, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999,
                mrd_weight=0.1, mpd_reshapes=[2, 3, 5, 7, 11], seed=1234)
    base.update(kw)
    return AttrDict(base)


@pytest.fixture(scope="module")
def gcrn_step():
    # one MPD period: the GCRN generator's training route is the point
    # (tests/test_torch_port_train.py holds the full MPD + MRD step)
    h = _gcrn_h(mpd_reshapes=[2])
    return run_both(h, _audio(2, h.segment_size))


def test_gcrn_one_step_metrics_match_jax(gcrn_step):
    for k in KEYS:
        assert np.isfinite(gcrn_step["port_metrics"][k]), k
        np.testing.assert_allclose(gcrn_step["port_metrics"][k], gcrn_step["jax_metrics"][k],
                                   rtol=1e-3, err_msg=k)


def test_gcrn_one_step_generator_grads_match_jax(gcrn_step):
    mu = gcrn_step["g_mu_port"]
    glstm = [k for k in mu if k.startswith("glstm.lstms.")]
    assert len(glstm) == 12 and all(mu[k].abs().sum() > 0 for k in glstm)
    assert_moments_close(mu, gcrn_step["g_mu_jax"], rel=2e-3)


def test_gcrn_one_step_discriminator_grads_match_jax(gcrn_step):
    assert_moments_close(gcrn_step["d_mu_port"], gcrn_step["d_mu_jax"], rel=2e-3)
