"""Measurement helpers shared by chip_smoke.py and the port's benchmark
scripts; nothing of the port's computation calls them.

`cudnn_lstm` builds the library yardstick (torch.nn.LSTM, cuDNN on the
card) holding the port's weights, `no_weight_compaction` fails a timing
whose cuDNN call would copy its weights at every call, `launch_delta`
is the launches a wrapper's counter gained since an earlier reading, and
`counted_wrappers` names every kernel wrapper that counts its launches.
"""
from __future__ import annotations

import contextlib
import warnings

import torch

__all__ = ["counted_wrappers", "cudnn_lstm", "launch_delta", "no_weight_compaction"]


def cudnn_lstm(directions, dtype, device="cuda", **kw):
    """torch.nn.LSTM on `device` holding the given (w_ih (C, 4H), w_hh (H, 4H),
    b (4H,)) of each direction (one: unidirectional, two: bidirectional).
    Build it outside inference mode. On the card its weights are laid out as
    one cuDNN buffer: nn.LSTM.flatten_parameters lays out float32 but skips
    bfloat16 (torch.backends.cudnn.is_acceptable does not list the type),
    and cuDNN then compacts the weights at every call, so this calls the op
    that flatten_parameters wraps. On the CPU it is PyTorch's CPU LSTM on
    the same weights."""
    import torch.backends.cudnn.rnn as cudnn_rnn

    (w_ih, w_hh, _), *rest = directions
    lstm = torch.nn.LSTM(w_ih.shape[0], w_hh.shape[0], bidirectional=bool(rest),
                         device=device, dtype=dtype, **kw)
    with torch.no_grad():
        for sfx, (w_ih, w_hh, b) in zip(("", "_reverse"), directions):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(w_ih.T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(w_hh.T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(b)
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
        if torch.device(device).type != "cuda":
            return lstm
        torch._cudnn_rnn_flatten_weight(
            lstm._flat_weights, 4, lstm.input_size, cudnn_rnn.get_cudnn_mode(lstm.mode),
            lstm.hidden_size, lstm.proj_size, lstm.num_layers, lstm.batch_first,
            bool(lstm.bidirectional))
    return lstm


@contextlib.contextmanager
def no_weight_compaction():
    """Raises SystemExit if a cuDNN LSTM call inside warns that its weights
    are compacted at every call: the library's time would include the copy."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield
    if any("contiguous chunk" in str(w.message) for w in caught):
        raise SystemExit("the cuDNN yardstick compacts its weights at every call")


def launch_delta(now: dict, before: dict) -> dict:
    """The launches per key (shape or kernel) made since `before`."""
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def counted_wrappers() -> dict:
    """Every wrapper that launches a kernel of csrc/, by the name its launch
    counts go under (`<wrapper>.launches`, `.launches_by_shape`,
    `.launches_by_kernel`)."""
    from . import lstm as L
    from .lstm_step import lstm_step_variant
    from .tcn import tcn_block_tail, tcn_gln_fold_kernel

    return {"lstm_fwd_hc": L.lstm_fwd_hc, "lstm_bwd": L.lstm_bwd, "lstm_bwd_dw": L.lstm_dw_hh,
            "lstm_scan_fused": L.lstm_scan_fused, "lstm_scan": L.lstm_scan,
            "lstm_scan_stateful": L.lstm_scan_stateful, "lstm_scan_bidir2": L.lstm_scan_bidir2,
            "tcn_block_tail": tcn_block_tail, "tcn_gln_stats": tcn_gln_fold_kernel,
            "lstm_scan_bidir": L.lstm_scan_bidir, "lstm_step_variant": lstm_step_variant}
