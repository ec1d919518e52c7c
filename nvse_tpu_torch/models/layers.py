"""Linear, LayerNorm, LSTM, Conv1d, WNConv1d, ConvTranspose1d,
WNConvTranspose1d, SNConv1d, Conv2d and ConvTranspose2d with torch.nn
semantics, and fold_weight_norm.

Counterparts of nvse_tpu/models/layers.py (Linear, LayerNorm, LSTM
:466-608; Conv1d, ConvTranspose1d :138-285; Conv2d, ConvTranspose2d,
leaky_relu, get_padding :37-46, :287-394). Linear and LSTM keep the JAX
package's names and layouts (Linear `kernel` is (in, out); LSTM `w_ih_*`
is (C, 4H), `w_hh_*` (H, 4H)); the weight-normalised Conv2d keeps the
names `v`, `g`, `bias` in torch's OIHW layout, Conv1d, ConvTranspose1d,
PlainConv2d and ConvTranspose2d the names `kernel`, `bias` in torch's
layouts. The 1-D convs take and return the JAX layers' channels-last
(B, T, C). The weight-normalised WNConv1d keeps `v`, `g`, `bias` in torch's
layout, or `kernel`, `bias` once fold_weight_norm has folded its state_dict
(nvse_tpu/models/layers.py:78-192). utils/jax_params.py maps a flax
tree onto them one to one (SNConv1d's `u` from the flax `spectral`
collection). Random init draws from the caller's
torch.Generator with the JAX package's distributions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.lstm import lstm_scan, lstm_scan_fused, lstm_scan_stateful


def uniform_(shape, bound: float, gen: torch.Generator | None) -> nn.Parameter:
    """U(-bound, bound) parameter drawn on the CPU from `gen`."""
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=gen))


def _kernel_and_bias(kshape, bshape, bound: float, std: float | None, gen):
    """U(+-bound) kernel and bias, or with `std` an N(0, std) kernel and a
    zero bias (the ConvNeXt families' init, nvse_tpu/models/apnet.py:67-72)."""
    if std is None:
        return uniform_(kshape, bound, gen), uniform_(bshape, bound, gen)
    kernel = nn.Parameter(torch.empty(kshape).normal_(0.0, std, generator=gen))
    return kernel, nn.Parameter(torch.zeros(bshape))


class Linear(nn.Module):
    """torch.nn.Linear semantics, U(+-1/sqrt(fan_in)) init (N(0, std) and a
    zero bias with `std`), (in, out) kernel."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator,
                 std: float | None = None):
        super().__init__()
        self.kernel, self.bias = _kernel_and_bias((in_features, out_features), (out_features,),
                                                  1.0 / math.sqrt(in_features), std, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # follows the params' dtype, keeping a bf16 trunk bf16 through the glue
        return x.to(self.kernel.dtype) @ self.kernel + self.bias


class LayerNorm(nn.Module):
    """torch.nn.LayerNorm over the last dim; stats in float32, output in
    the params' dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y.to(self.scale.dtype) * self.scale + self.bias


class LSTM(nn.Module):
    """Single-layer (bi)LSTM with torch.nn.LSTM numerics: (B, T, C) ->
    (B, T, H * (2 if bidirectional else 1)).

    The bias of each direction is b_ih + b_hh, summed when the params are
    made. A bidirectional LSTM runs ops.lstm.lstm_scan_fused, a
    unidirectional one ops.lstm.lstm_scan on its time-major projection
    (the CUDA kernels on the card).

    Streaming decode (initial_state / return_state): the forward
    direction starts from `initial_state` (h, c), each (B, H), through
    ops.lstm.lstm_scan_stateful, and the returned state is its (h, c)
    after `carry_idx` steps (default: all), the state the next chunk
    resumes from. The backward direction of a BiLSTM starts from zeros
    over the given window (its true state would need the whole future);
    callers bound that error with a right lookahead. The state is cast to
    the params' dtype on the way in and comes back in it, as in the JAX
    layer. Returns (y, state) when return_state.
    """

    # each holds b_ih + b_hh of the JAX layer and torch.nn.LSTM, two
    # trained tensors in one (see train/trainer.py:make_optimizer)
    summed_biases = ("b_fwd", "b_bwd")

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool,
                 gen: torch.Generator):
        super().__init__()
        self.bidirectional = bidirectional
        H = hidden_size
        bound = 1.0 / math.sqrt(H)
        for d in ("fwd", "bwd") if bidirectional else ("fwd",):
            self.register_parameter(f"w_ih_{d}", uniform_((input_size, 4 * H), bound, gen))
            self.register_parameter(f"w_hh_{d}", uniform_((H, 4 * H), bound, gen))
            b = uniform_((4 * H,), bound, gen).data + uniform_((4 * H,), bound, gen).data
            self.register_parameter(f"b_{d}", nn.Parameter(b))

    def forward(self, x: torch.Tensor, initial_state=None, return_state: bool = False,
                carry_idx: int | None = None):
        x = x.to(self.w_ih_fwd.dtype)
        if initial_state is not None or return_state:
            return self._forward_streaming(x, initial_state, return_state, carry_idx)
        if not self.bidirectional:
            xg = (x.transpose(0, 1) @ self.w_ih_fwd + self.b_fwd).contiguous()   # (T, B, 4H)
            return lstm_scan(xg, self.w_hh_fwd).transpose(0, 1)
        return lstm_scan_fused(x.contiguous(), self.w_ih_fwd, self.w_ih_bwd,
                               self.b_fwd, self.b_bwd, self.w_hh_fwd, self.w_hh_bwd)

    def _forward_streaming(self, x, initial_state, return_state, carry_idx):
        B, S, _ = x.shape
        zero = x.new_zeros(B, self.w_hh_fwd.shape[0])
        if initial_state is None:
            h0 = c0 = zero
        else:
            h0, c0 = (s.to(x.dtype).contiguous() for s in initial_state)
        xt = x.transpose(0, 1)                                               # (S, B, C)
        hs_f, cs_f = lstm_scan_stateful((xt @ self.w_ih_fwd + self.b_fwd).contiguous(),
                                        self.w_hh_fwd, h0, c0)
        ci = S if carry_idx is None else int(carry_idx)
        state = (hs_f[ci - 1], cs_f[ci - 1])
        y = hs_f.transpose(0, 1)
        if self.bidirectional:
            xg_b = (xt @ self.w_ih_bwd + self.b_bwd).flip(0).contiguous()
            hs_b, _ = lstm_scan_stateful(xg_b, self.w_hh_bwd, zero, zero)
            y = torch.cat([y, hs_b.flip(0).transpose(0, 1)], dim=-1)
        return (y, state) if return_state else y


LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """'same' padding for odd kernels (reference utils.py:47-48)."""
    return (kernel_size * dilation - dilation) // 2


def _wn_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / max(||v||, 1e-12), the norm over every axis but the first."""
    norm = v.flatten(1).norm(dim=1).reshape(-1, *([1] * (v.dim() - 1)))
    return g * v / torch.clamp(norm, min=1e-12)


class Conv2d(nn.Module):
    """Weight-normalised torch.nn.Conv2d on NCHW (the discriminators' conv).

    Counterpart of nvse_tpu/models/layers.py:Conv2d with
    use_weight_norm=True (which is NHWC/HWIO). Parameters: `v` (out, in,
    kh, kw), `g` (out, 1, 1, 1) and `bias` (out,); the weight is
    g * v / max(||v||, 1e-12), the norm over every axis but out-channels
    (torch.nn.utils.weight_norm has no 1e-12 floor). Init as torch:
    U(+-1/sqrt(fan_in)) for v and bias, g = ||v||. The input is cast to the
    weight dtype, as the JAX layer follows its params.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), gen: torch.Generator | None = None, dilation=(1, 1)):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding, self.dilation = tuple(stride), tuple(padding), tuple(dilation)
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        self.v = uniform_((out_channels, in_channels, kh, kw), bound, gen)
        self.g = nn.Parameter(self.v.data.flatten(1).norm(dim=1).reshape(-1, 1, 1, 1))
        self.bias = uniform_((out_channels,), bound, gen)

    def kernel(self) -> torch.Tensor:
        return _wn_weight(self.v, self.g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.kernel(), self.bias, self.stride, self.padding, self.dilation)


def _conv(fn, x, w, bias, stride, padding, **kw):
    """fn = F.conv2d or F.conv_transpose2d on NCHW, the input cast to the
    weight dtype as the JAX layers follow their params."""
    if w.dtype == torch.bfloat16 and w.device.type == "cpu":
        # torch's oneDNN bf16 conv2d on the CPU returned NaN for finite
        # inputs (MRD layer 4, (4, 64, 65, 2) * (64, 64, 3, 3), stride 2);
        # float32 of the bf16 values, rounded once, is a bf16 conv with
        # float32 sums
        return fn(x.to(w.dtype).float(), w.float(), bias.float(), stride, padding,
                  **kw).to(w.dtype)
    return fn(x.to(w.dtype), w, bias, stride, padding, **kw)


def conv2d(x, w, bias, stride=(1, 1), padding=(0, 0), dilation=(1, 1)) -> torch.Tensor:
    """torch conv2d: x (B, I, H, W), w (O, I, kh, kw), bias (O,)."""
    return _conv(F.conv2d, x, w, bias, stride, padding, dilation=dilation)


def conv_transpose2d(x, w, bias, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """torch conv_transpose2d: x (B, I, H, W), w (I, O, kh, kw), bias (O,).
    The JAX layer's form (kernel flipped, input dilated by the stride, padded
    by k - 1 - padding) is this function."""
    return _conv(F.conv_transpose2d, x, w, bias, stride, padding)


class PlainConv2d(nn.Module):
    """torch.nn.Conv2d on NCHW without weight norm (GCRN's convs).
    Counterpart of nvse_tpu/models/layers.py:Conv2d with its defaults;
    parameters `kernel` (out, in, kh, kw) and `bias` (out,), both
    U(+-1/sqrt(in * kh * kw))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), gen: torch.Generator | None = None, dilation=(1, 1)):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding, self.dilation = tuple(stride), tuple(padding), tuple(dilation)
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        self.kernel = uniform_((out_channels, in_channels, kh, kw), bound, gen)
        self.bias = uniform_((out_channels,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.kernel, self.bias, self.stride, self.padding, self.dilation)


class ConvTranspose2d(nn.Module):
    """torch.nn.ConvTranspose2d on NCHW. Counterpart of
    nvse_tpu/models/layers.py:ConvTranspose2d; parameters `kernel`
    (in, out, kh, kw) and `bias` (out,), both U(+-1/sqrt(out * kh * kw)),
    torch's fan-in for a transposed conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), gen: torch.Generator | None = None):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding = tuple(stride), tuple(padding)
        bound = 1.0 / math.sqrt(out_channels * kh * kw)
        self.kernel = uniform_((in_channels, out_channels, kh, kw), bound, gen)
        self.bias = uniform_((out_channels,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2d(x, self.kernel, self.bias, self.stride, self.padding)


class Conv1d(nn.Module):
    """torch.nn.Conv1d on channels-last (B, T, C), without weight norm.
    Counterpart of nvse_tpu/models/layers.py:Conv1d with its defaults;
    parameters `kernel` (out, in / groups, k) and `bias` (out,), both
    U(+-1/sqrt(in / groups * k)) (N(0, std) and a zero bias with `std`).
    The input is cast to the weight dtype. A 1x1 conv (stride 1, no padding,
    one group) is a matrix product over the channels; any other runs
    F.conv1d on (B, C, T)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 gen: torch.Generator | None = None, std: float | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.kernel, self.bias = _kernel_and_bias(
            (out_channels, in_channels // groups, kernel_size), (out_channels,),
            1.0 / math.sqrt(in_channels // groups * kernel_size), std, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.kernel.dtype)
        if self.kernel.shape[-1] == 1 and self.stride == 1 and self.padding == 0 and self.groups == 1:
            return x @ self.kernel[:, :, 0].T + self.bias
        y = F.conv1d(x.transpose(1, 2), self.kernel, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """torch.nn.ConvTranspose1d on channels-last (B, T, C), without weight
    norm: out_len = (T - 1) * stride - 2 * padding + dilation * (k - 1) + 1.
    Counterpart of nvse_tpu/models/layers.py:ConvTranspose1d with its
    defaults (and `dilation`, :193-207); parameters `kernel` (in, out, k) and
    `bias` (out,), both U(+-1/sqrt(out * k)), torch's fan-in for a transposed
    conv. The JAX layer's form (kernel flipped, input dilated by the stride,
    kernel by `dilation`, padded by dilation * (k - 1) - padding) is
    F.conv_transpose1d."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, gen: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        bound = 1.0 / math.sqrt(out_channels * kernel_size)
        self.kernel = uniform_((in_channels, out_channels, kernel_size), bound, gen)
        self.bias = uniform_((out_channels,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.to(self.kernel.dtype).transpose(1, 2), self.kernel, self.bias,
                               self.stride, self.padding, 0, 1, self.dilation)
        return y.transpose(1, 2)


class WNConv1d(nn.Module):
    """Weight-normalised torch.nn.Conv1d on channels-last (B, T, C).

    Counterpart of nvse_tpu/models/layers.py:Conv1d with use_weight_norm
    (which is WIO): parameters `v` (out, in / groups, k), `g` (out, 1, 1)
    and `bias` (out,); the weight is g * v / max(||v||, 1e-12), the norm
    over every axis but out-channels. Init as torch: U(+-1/sqrt(fan_in)) for
    v and bias, g = ||v|| (nvse_tpu/models/hifigan.py:6-12). Loading a
    state_dict that fold_weight_norm folded (`kernel` in place of `v`, `g`)
    turns the layer into a plain conv with that kernel, as the JAX layer
    detects folded params at apply time; an unfolded state_dict turns it
    back. The input is cast to the weight dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        bound = 1.0 / math.sqrt(in_channels // groups * kernel_size)
        self.v = uniform_((out_channels, in_channels // groups, kernel_size), bound, gen)
        self.g = nn.Parameter(self.v.data.flatten(1).norm(dim=1).reshape(-1, 1, 1))
        self.bias = uniform_((out_channels,), bound, gen)

    @property
    def folded(self) -> bool:
        return "kernel" in self._parameters

    def weight(self) -> torch.Tensor:
        return self.kernel if self.folded else _wn_weight(self.v, self.g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight()
        y = F.conv1d(x.to(w.dtype).transpose(1, 2), w, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return y.transpose(1, 2)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        folded = prefix + "kernel" in state_dict
        if folded != self.folded:
            like = self.bias.data
            shape = (self.kernel if self.folded else self.v).shape
            for name in ("kernel",) if self.folded else ("v", "g"):
                del self._parameters[name]
            if folded:
                self.kernel = nn.Parameter(like.new_empty(shape))
            else:
                self.v = nn.Parameter(like.new_empty(shape))
                self.g = nn.Parameter(like.new_empty((shape[0], 1, 1)))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class WNConvTranspose1d(WNConv1d):
    """Weight-normalised torch.nn.ConvTranspose1d on channels-last (B, T, C).

    Counterpart of nvse_tpu/models/layers.py:ConvTranspose1d with
    use_weight_norm (:193-285, whose kernel is (k, in, out)): parameters `v`
    (in, out, k), `g` (in, 1, 1) and `bias` (out,); the weight is
    g * v / max(||v||, 1e-12), the norm over every axis but the input
    channel, as torch's weight_norm (dim 0) takes it on a ConvTranspose1d.
    Init as torch: U(+-1/sqrt(out * k)) for v and bias, g = ||v||. Folds at
    load as WNConv1d (`kernel` (in, out, k) in place of `v`, `g`).
    out_len = (T - 1) * stride - 2 * padding + k."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, gen: torch.Generator | None = None):
        nn.Module.__init__(self)
        self.stride, self.padding = stride, padding
        bound = 1.0 / math.sqrt(out_channels * kernel_size)
        self.v = uniform_((in_channels, out_channels, kernel_size), bound, gen)
        self.g = nn.Parameter(self.v.data.flatten(1).norm(dim=1).reshape(-1, 1, 1))
        self.bias = uniform_((out_channels,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight()
        y = F.conv_transpose1d(x.to(w.dtype).transpose(1, 2), w, self.bias, self.stride,
                               self.padding)
        return y.transpose(1, 2)


class SNConv1d(nn.Module):
    """Spectrally normalised torch.nn.Conv1d on channels-last (B, T, C), one
    power iteration a call.

    Counterpart of nvse_tpu/models/layers.py:SNConv1d (:397-465), the first
    scale of the MSD (reference Models/models.py:221): parameters `kernel`
    (out, in / groups, k) and `bias` (out,), U(+-1/sqrt(in / groups * k)), and
    the buffer `u` (out,), N(0, 1). The kernel as an (out, in / groups * k)
    matrix W is divided by sigma = u' W v, with v = W^T u / ||W^T u|| and
    u' = W v / ||W v|| (each norm + 1e-12) from the stored u. The iteration
    runs in float32 on u and v detached; sigma stays a function of W, so its
    gradient reaches the kernel, and is cast back to the kernel's dtype.
    `u` takes u' only when the caller passes update_stats (the D pass), never
    at init nor in the G pass. This is the JAX package's estimate, not
    torch.nn.utils.spectral_norm, which updates u in every forward of a
    module in training mode."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, gen: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.kernel, self.bias = _kernel_and_bias(
            (out_channels, in_channels // groups, kernel_size), (out_channels,),
            1.0 / math.sqrt(in_channels // groups * kernel_size), None, gen)
        self.register_buffer("u", torch.randn(out_channels, generator=gen))

    def weight(self, update_stats: bool = False) -> torch.Tensor:
        """The normalised kernel; with update_stats, `u` takes u'."""
        w32 = self.kernel.reshape(self.kernel.shape[0], -1).float()
        with torch.no_grad():
            v = w32.T @ self.u
            v = v / (v.norm() + 1e-12)
            u_new = w32 @ v
            u_new = u_new / (u_new.norm() + 1e-12)
        sigma = u_new @ w32 @ v
        if update_stats:
            self.u.copy_(u_new)
        return self.kernel / sigma.to(self.kernel.dtype)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w = self.weight(update_stats)
        y = F.conv1d(x.to(w.dtype).transpose(1, 2), w, self.bias, self.stride, self.padding,
                     1, self.groups)
        return y.transpose(1, 2)


def fold_weight_norm(state_dict: dict) -> dict:
    """Fold every weight-norm pair of a state_dict: `<p>.v`, `<p>.g` become
    `<p>.kernel` = g * v / max(||v||, 1e-12) (the norm over every axis but
    the first), in v's place; every other entry is kept. Counterpart of
    nvse_tpu/models/layers.py:fold_weight_norm and of the reference's
    remove_weight_norm before decoding. A `.g` whose shape is not (out, 1,
    ..., 1) of its `.v` is no pair and stays. Returns a new dict."""
    def is_pair(prefix):
        v, g = state_dict.get(prefix + ".v"), state_dict.get(prefix + ".g")
        return (v is not None and g is not None and g.dim() == v.dim()
                and g.shape[0] == v.shape[0] and g[0].numel() == 1)

    pairs = {k[:-2] for k in state_dict if k.endswith(".v") and is_pair(k[:-2])}
    out = {}
    for key, t in state_dict.items():
        prefix = key[:-2]
        if prefix not in pairs or not key.endswith((".v", ".g")):
            out[key] = t
        elif key.endswith(".v"):
            out[prefix + ".kernel"] = _wn_weight(t, state_dict[prefix + ".g"])
    return out
