"""Port parity: SNConv1d and the multi-scale discriminator (MSD) against the
JAX package, on the CPU, and the launch plans of the kernels that the time
trainer runs at new shapes.

  * SNConv1d and the MSD in both update_stats modes (the MSD with the two waves
    in one call and in two): outputs (logits and every feature map), the new u,
    and the gradient of a loss (jax.grad against autograd: the kernel's through
    sigma as well as the quotient); u drawn at init and written only when
    update_stats;
  * the plans of the training kernels at HD-Demucs's bottleneck BiLSTM in a
    step at batch 16 (16 rows x H = 768: csrc/lstm_scan_wide.cu mode kFwdHc,
    csrc/lstm_bwd_wide.cu, the dW_hh reduction of csrc/lstm_bwd.cu) and of
    ConvTasNet's tail at 16 x 2,047 encoder frames (csrc/tcn_tail.cu), on an
    H100's figures.
The MSD at its only width on 512-sample waves; seeded numpy weights in the JAX
trees' shapes, mapped by disc_params_from_jax with the `spectral` collection.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models.discriminators import MultiScaleDiscriminator as JMSD
from nvse_tpu.models.layers import SNConv1d as JSNConv1d
from nvse_tpu_torch.models.discriminators import MultiScaleDiscriminator
from nvse_tpu_torch.models.layers import SNConv1d
from nvse_tpu_torch.ops import lstm as L
from nvse_tpu_torch.ops import tcn as T
from nvse_tpu_torch.utils import disc_params_from_jax

from test_torch_port_joint import _one_torch_thread  # noqa: F401
from test_torch_port_time_train import _u, msd_params
from test_torch_port_train import _np


# ---------------------------------------------------------------------------
# SNConv1d and the MSD
# ---------------------------------------------------------------------------

def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


@pytest.mark.parametrize("update_stats", [True, False])
def test_snconv1d_matches_jax(update_stats):
    cin, cout, k, s, g, p = 8, 12, 5, 2, 2, 2
    rng = np.random.default_rng(1)
    kernel = rng.uniform(-0.3, 0.3, (k, cin // g, cout)).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, (cout,)).astype(np.float32)
    u = rng.standard_normal(cout).astype(np.float32)
    x = rng.standard_normal((2, 19, cin)).astype(np.float32)
    wy = rng.standard_normal((2, 10, cout)).astype(np.float32)
    jm = JSNConv1d(cin, cout, k, stride=s, padding=p, groups=g)

    def jloss(params, xx):
        y, upd = jm.apply({"params": params, "spectral": {"u": u}}, xx, update_stats,
                          mutable=["spectral"])
        return jnp.sum(y * wy), (y, upd["spectral"]["u"])

    (_, (ref, ref_u)), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {"kernel": kernel, "bias": bias}, jnp.asarray(x))

    pm = SNConv1d(cin, cout, k, stride=s, padding=p, groups=g)
    pm.load_state_dict({"kernel": torch.from_numpy(kernel.transpose(2, 1, 0).copy()),
                        "bias": torch.from_numpy(bias), "u": torch.from_numpy(u)})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pm(xt, update_stats)
    (y * torch.from_numpy(wy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pm.u.numpy(), np.asarray(ref_u), rtol=1e-5, atol=1e-6)
    assert update_stats == (not np.array_equal(pm.u.numpy(), u))
    # the gradient reaches the kernel through sigma as well as the quotient (float32
    # sums of ~40 terms of up to ~6: atol 1e-5)
    np.testing.assert_allclose(pm.kernel.grad.numpy(),
                               np.asarray(gp["kernel"]).transpose(2, 1, 0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)


def test_snconv1d_u_is_drawn_at_init_and_written_only_when_asked():
    a = SNConv1d(4, 6, 3, gen=torch.Generator().manual_seed(0))
    b = SNConv1d(4, 6, 3, gen=torch.Generator().manual_seed(0))
    assert torch.equal(a.u, b.u) and a.u.abs().sum() > 0 and "u" in a.state_dict()
    u0 = a.u.clone()
    x = torch.randn(1, 9, 4)
    a(x)
    a.weight()
    assert torch.equal(a.u, u0)
    a(x, update_stats=True)
    assert not torch.equal(a.u, u0)


@pytest.fixture(scope="module")
def msd_pair():
    """(JAX params, spectral, the port MSD with them, the two waves, and the
    JAX reference per update_stats, computed once)."""
    params, spectral = msd_params(seg=512, seed=6)
    pm = MultiScaleDiscriminator()
    pm.load_state_dict(disc_params_from_jax({"mpd": {}, "scale": params}, spectral)[1])
    rng = np.random.default_rng(7)
    y = (0.3 * rng.standard_normal((2, 512))).astype(np.float32)
    y_hat = (0.3 * rng.standard_normal((2, 512))).astype(np.float32)
    jm = JMSD()

    def reference(update_stats):
        def jloss(p):
            out, upd = jm.apply({"params": p, "spectral": spectral}, jnp.asarray(y),
                                jnp.asarray(y_hat), update_stats, mutable=["spectral"])
            r, g, fr, fg = out
            loss = sum(jnp.mean((1 - a) ** 2) + jnp.mean(b ** 2) for a, b in zip(r, g))
            loss = loss + sum(jnp.mean(jnp.abs(a - b)) for da, db in zip(fr, fg)
                              for a, b in zip(da, db))
            return loss, (out, upd["spectral"])

        return jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    refs = {flag: reference(flag) for flag in (True, False)}
    return params, spectral, pm, y, y_hat, refs


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "two_calls"])
@pytest.mark.parametrize("update_stats", [True, False])
def test_msd_matches_jax(msd_pair, update_stats, batched):
    """Either way of running the two waves (one call, or two as the hinge
    models take them) gives the JAX module's outputs, u and gradient."""
    params, spectral, pm, y, y_hat, refs = msd_pair
    pm.batched = batched
    (loss, (ref, ref_spec)), grads = refs[update_stats]

    for m in pm.modules():
        m.zero_grad(set_to_none=True)
    u0 = _u(pm)
    state = {k: v.clone() for k, v in pm.state_dict().items() if k.endswith(".u")}
    out = pm(torch.from_numpy(y), torch.from_numpy(y_hat), update_stats)
    r, g, fr, fg = out
    tl = sum(torch.mean((1 - a) ** 2) + torch.mean(b ** 2) for a, b in zip(r, g))
    tl = tl + sum(torch.mean(torch.abs(a - b)) for da, db in zip(fr, fg) for a, b in zip(da, db))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-5)
    for got, want in zip(r + g, ref[0] + ref[1]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for gd, wd in zip(fr + fg, ref[2] + ref[3]):
        for got, want in zip(gd, wd):   # NCW here, NWC there
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want).transpose(0, 2, 1), rtol=1e-4, atol=1e-5)
    new_u = disc_params_from_jax({"mpd": {}, "scale": params}, _np(ref_spec))[1]
    for k, v in pm.state_dict().items():
        if k.endswith(".u"):
            np.testing.assert_allclose(v.numpy(), new_u[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(u0, _u(pm))) == (not update_stats)
    want = disc_params_from_jax({"mpd": {}, "scale": _np(grads)}, spectral)[1]
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == {k for k in want if not k.endswith(".u")}
    for k, gr in got.items():
        assert gr is not None and torch.isfinite(gr).all(), k
        assert _rel(gr.numpy(), want[k].numpy()) < 1e-3, k
    pm.load_state_dict({**pm.state_dict(), **state})   # the next case starts from the same u


# ---------------------------------------------------------------------------
# the kernels' launch plans at this slice's new shapes
# ---------------------------------------------------------------------------

H100 = (132, 232448)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_kernel_plans_at_hddemucs_shape_on_an_h100(dtype):
    """HD-Demucs's bottleneck BiLSTM in a step at batch 16: 16 rows, H = 768
    (W_hh 9.4 MB in float32): the wide forward (mode kFwdHc) and the wide
    backward, one wave of co-resident blocks, every row once."""
    R, H = 16, 768
    fwd = L.scan_wide_plan(R, H, dtype, *H100, 1, 1, "lstm_fwd_hc")
    bwd = L.bwd_wide_plan(R, H, dtype, *H100)
    keys = ("units", "tile_rows", "groups", "rows_per_group", "blocks")
    want = (16, 32, 2, 8, 96) if dtype == torch.bfloat16 else (8, 32, 1, 16, 96)
    for p in (fwd, bwd):
        assert p["co_resident"] and tuple(p[k] for k in keys) == want
        assert p["blocks"] <= H100[0] and p["smem_bytes"] <= H100[1]
        assert p["tensor_cores"] == (dtype == torch.bfloat16)
    assert L.train_route("lstm_fwd_hc", H, {"co_resident": True}) == "lstm_scan_wide"
    assert L.train_route("lstm_bwd", H, {"co_resident": True}) == "lstm_bwd_wide"
    dw = L.dw_plan(62, R, H, dtype, *H100, 2 if dtype == torch.bfloat16 else 1)
    assert dw["fits"] and dw["tiles"] == (H // 128) * (4 * H // 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [1, 8, 128])
def test_tail_plan_at_convtasnet_training_shape_on_an_h100(dtype, d):
    """ConvTasNet's tail in a step at batch 16: 16 x 2,047 encoder frames,
    H = 512, Bc = 128: one persistent block an SM over the 256 tiles."""
    p = T.tail_plan(16, 2047, 512, 128, d, dtype, *H100)
    assert p["fits"] and p["tiles"] == 16 * -(-2047 // 128) and p["blocks"] == H100[0]
    assert p["smem_bytes"] <= H100[1] and p["tensor_cores"] == (dtype == torch.bfloat16)

