"""Port parity: one GAN training step of a causal BSRNN against
nvse_tpu.train.make_train_step, from the same weights and batch, with the
harness and the limits of tests/test_torch_port_train.py (its own file so
that the two whole-step comparisons run on different test workers).

Also, without JAX: the gradient reaches every LSTM parameter of a causal
generator and the time LSTM takes lstm_scan's two routes as autograd asks.
"""
import numpy as np
import pytest
import torch

from nvse_tpu_torch.ops import lstm as port_lstm

from test_torch_port_train import (KEYS, _audio, _h, assert_moments_close, assert_updates_close,
                                   run_both)


@pytest.fixture(scope="module")
def one_causal_step_f32():
    h = _h(causal=True)
    return run_both(h, _audio(2, h.segment_size, seed=3))


def test_one_causal_step_matches_jax(one_causal_step_f32):
    """causal=True: the time LSTM is unidirectional, its gradient on the
    port's side lstm_scan's residual-saving route (lstm_fwd_hc_plain +
    lstm_bwd_plain under _ScanSaving), on the JAX side lstm_scan's VJP. Same
    limits as the non-causal step."""
    r = one_causal_step_f32
    for k in KEYS:
        assert np.isfinite(r["port_metrics"][k]), k
        np.testing.assert_allclose(r["port_metrics"][k], r["jax_metrics"][k], rtol=1e-3, err_msg=k)
    time_lstm = [k for k in r["g_mu_port"] if ".time_rnn.lstm." in k]
    assert len(time_lstm) == 2 * 3 and not any("bwd" in k for k in time_lstm)
    assert_moments_close(r["g_mu_port"], r["g_mu_jax"], rel=2e-3)
    assert_moments_close(r["d_mu_port"], r["d_mu_jax"], rel=2e-3)
    assert_updates_close(r["g_new_port"], r["g_new_jax"], r["g_old"], r["g_mu_jax"])


def test_causal_gradient_reaches_every_lstm_parameter_and_routes():
    from nvse_tpu_torch.models import build_generator

    h = _h(causal=True)
    gen, _ = build_generator(h)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 80, 9)).astype(np.float32) - 4)
    calls = {"scan": 0, "bi": 0}
    orig = port_lstm._ScanSaving.apply, port_lstm._BiLSTMSaving.apply

    def counted(key, fn):
        def apply(*a):
            calls[key] += 1
            return fn(*a)
        return apply

    port_lstm._ScanSaving.apply = counted("scan", orig[0])
    port_lstm._BiLSTMSaving.apply = counted("bi", orig[1])
    try:
        with torch.no_grad():
            gen(mel)
        assert calls == {"scan": 0, "bi": 0}              # the inference routes
        out = gen(mel)
        assert calls == {"scan": h.num_repeat, "bi": h.num_repeat}
    finally:
        port_lstm._ScanSaving.apply, port_lstm._BiLSTMSaving.apply = orig
    (out[-1].square().mean() + out[0].mean()).backward()
    lstm = {n: p for n, p in gen.named_parameters() if ".lstm." in n}
    assert len(lstm) == h.num_repeat * (3 + 6)            # time: one direction, band: two
    for n, p in lstm.items():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, n
