"""APNet family: parallel amplitude and phase spectrum predictors, in PyTorch.

Counterpart of nvse_tpu/models/apnet.py (reference Models/apnet.py,
apnet2.py, freeV.py):
  * APNet: weight-normalised input convs, HiFiGAN ResBlock1 trunks averaged
    per branch, leaky_relu(0.01), weight-normalised output convs;
  * APNet2: ConvNeXt-v2 trunks (depthwise k7 conv, LayerNorm, MLP with
    GRN), N(0, 0.02) init, no weight norm;
  * FreeV: APNet2's phase branch; the amplitude branch is one ConvNeXt
    block at dim n_fft // 2 + 1 on the log pseudo-inverse-mel spectrum.
Each maps mel (B, M, T) to (logamp, pha, rea, imag, wav), the wave through
istft_ri. The trunks run channels-last (B, T, C); parameters keep the
reference's module names (utils/torch_import.py maps its g_ checkpoints,
utils/jax_params.py the JAX trees). In a bfloat16 trunk the convs, norms
and MLPs follow the params' dtype, LayerNorm statistics and the iSTFT stay
float32, and sums with the float32 spectra promote, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spectral import hann_window, inverse_mel, istft_ri
from .hifigan import ResBlock1
from .layers import Conv1d, LayerNorm, Linear, WNConv1d, get_padding, leaky_relu

# the ConvNeXt families' weight init, N(0, 0.02) with zero biases (apnet2.py:146-149)
INIT_STD = 0.02


class GRN(nn.Module):
    """Global response norm over time on (B, T, C) (apnet2.py:13-24):
    gamma * (x * nx) + beta + x, nx the per-channel L2 norm over time
    divided by its mean over channels (+ 1e-6). A channel that is zero at
    every frame takes the norm's subgradient 0 at sqrt(0), as torch.norm
    does, not NaN (the double where of nvse_tpu/models/apnet.py:31-57)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sq = torch.sum(x * x, dim=1, keepdim=True)                 # (B, 1, C)
        live = sq > 0
        gx = torch.where(live, torch.sqrt(torch.where(live, sq, torch.ones_like(sq))),
                         torch.zeros_like(sq))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtBlock(nn.Module):
    """Depthwise k7 conv, LayerNorm (eps 1e-6), Linear dim -> mid, exact
    GELU, GRN, Linear mid -> dim, plus the input (apnet2.py:27-66)."""

    def __init__(self, dim: int, intermediate_dim: int, gen: torch.Generator | None = None):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, padding=3, groups=dim, gen=gen, std=INIT_STD)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, intermediate_dim, gen, std=INIT_STD)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = Linear(intermediate_dim, dim, gen, std=INIT_STD)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv1(self.norm(self.dwconv(x)))
        return x + self.pwconv2(self.grn(F.gelu(y)))


def tf_outputs(logamp, pha_r, pha_i, n_fft: int, hop_size: int, win_size: int):
    """(logamp, R, I), each (B, F, T) -> (logamp, atan2(I, R), rea, imag,
    wav): exp(logamp) e^{j pha} synthesised by istft_ri (apnet.py:145-155)."""
    pha = torch.atan2(pha_i, pha_r)
    amp = torch.exp(logamp)
    rea = amp * torch.cos(pha)
    imag = amp * torch.sin(pha)
    wav = istft_ri(rea, imag, n_fft, hop_size, win_size, window=hann_window(win_size))
    return logamp, pha, rea, imag, wav


def _conv(cin: int, cout: int, k: int, gen, weight_norm: bool = False) -> nn.Module:
    """A 'same'-padded conv: weight-normalised (APNet) or N(0, 0.02) (the
    ConvNeXt families)."""
    if weight_norm:
        return WNConv1d(cin, cout, k, padding=get_padding(k), gen=gen)
    return Conv1d(cin, cout, k, padding=get_padding(k), gen=gen, std=INIT_STD)


class APNet(nn.Module):
    """mel (B, M, T) -> (logamp, pha, rea, imag, wav). Reference apnet.py:90-157."""

    def __init__(self, h, gen: torch.Generator):
        super().__init__()
        self.n_fft, self.hop_size, self.win_size = h.n_fft, h.hop_size, h.win_size
        F_bins, M = h.n_fft // 2 + 1, h.num_mels
        for b in ("ASP", "PSP"):
            ch = int(h[f"{b}_channel"])
            setattr(self, f"{b}_input_conv",
                    _conv(M, ch, int(h[f"{b}_input_conv_kernel_size"]), gen, weight_norm=True))
            setattr(self, f"{b}_ResNet", nn.ModuleList(
                ResBlock1(ch, int(k), tuple(d), gen) for k, d in
                zip(h[f"{b}_resblock_kernel_sizes"], h[f"{b}_resblock_dilation_sizes"])))
        self.ASP_output_conv = _conv(int(h.ASP_channel), F_bins,
                                     int(h.ASP_output_conv_kernel_size), gen, weight_norm=True)
        self.PSP_output_R_conv = _conv(int(h.PSP_channel), F_bins,
                                       int(h.PSP_output_R_conv_kernel_size), gen, weight_norm=True)
        self.PSP_output_I_conv = _conv(int(h.PSP_channel), F_bins,
                                       int(h.PSP_output_I_conv_kernel_size), gen, weight_norm=True)

    @staticmethod
    def _branch(x, input_conv, blocks):
        y = input_conv(x)
        acc = None
        for blk in blocks:
            out = blk(y)
            acc = out if acc is None else acc + out
        # F.leaky_relu's default slope (apnet.py:131, 141)
        return leaky_relu(acc / len(blocks), 0.01)

    def forward(self, mel: torch.Tensor):
        x = mel.transpose(-1, -2)                                   # (B, T, M)
        a = self._branch(x, self.ASP_input_conv, self.ASP_ResNet)
        p = self._branch(x, self.PSP_input_conv, self.PSP_ResNet)
        return tf_outputs(self.ASP_output_conv(a).transpose(-1, -2),
                          self.PSP_output_R_conv(p).transpose(-1, -2),
                          self.PSP_output_I_conv(p).transpose(-1, -2),
                          self.n_fft, self.hop_size, self.win_size)


class _PhaseTrunk(nn.Module):
    """APNet2's / FreeV's phase branch: input conv, LayerNorm, ConvNeXt
    blocks, LayerNorm and the R / I output convs (apnet2.py:113-188). Holds
    no parameters of its own (they live on the model under the reference's
    names); mixin of APNet2 and FreeV."""

    def _init_phase_trunk(self, h, gen, dim: int, num_layers: int, intermediate_dim: int):
        F_bins = h.n_fft // 2 + 1
        self.PSP_input_conv = _conv(h.num_mels, int(h.PSP_channel),
                                    int(h.PSP_input_conv_kernel_size), gen)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.convnext = nn.ModuleList(ConvNeXtBlock(dim, intermediate_dim, gen)
                                      for _ in range(num_layers))
        self.final_layer_norm = LayerNorm(dim, eps=1e-6)
        self.PSP_output_R_conv = _conv(dim, F_bins, int(h.PSP_output_R_conv_kernel_size), gen)
        self.PSP_output_I_conv = _conv(dim, F_bins, int(h.PSP_output_I_conv_kernel_size), gen)

    def _phase(self, x):
        p = self.norm(self.PSP_input_conv(x))
        for blk in self.convnext:
            p = blk(p)
        p = self.final_layer_norm(p)
        return (self.PSP_output_R_conv(p).transpose(-1, -2),
                self.PSP_output_I_conv(p).transpose(-1, -2))


class APNet2(_PhaseTrunk):
    """APNet with ConvNeXt-v2 trunks (apnet2.py:69-188). dim, num_layers and
    intermediate_dim are fixed by the reference (512, 8, 1536); the JAX
    package's from_config reads none of them from the config either."""

    def __init__(self, h, gen: torch.Generator, dim: int = 512, num_layers: int = 8,
                 intermediate_dim: int = 1536):
        super().__init__()
        self.n_fft, self.hop_size, self.win_size = h.n_fft, h.hop_size, h.win_size
        self.ASP_input_conv = _conv(h.num_mels, int(h.ASP_channel),
                                    int(h.ASP_input_conv_kernel_size), gen)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.convnext2 = nn.ModuleList(ConvNeXtBlock(dim, intermediate_dim, gen)
                                       for _ in range(num_layers))
        self.final_layer_norm2 = LayerNorm(dim, eps=1e-6)
        self.ASP_output_conv = _conv(int(h.ASP_channel), h.n_fft // 2 + 1,
                                     int(h.ASP_output_conv_kernel_size), gen)
        self._init_phase_trunk(h, gen, dim, num_layers, intermediate_dim)

    def forward(self, mel: torch.Tensor):
        x = mel.transpose(-1, -2)                                   # (B, T, M)
        a = self.norm2(self.ASP_input_conv(x))
        for blk in self.convnext2:
            a = blk(a)
        logamp = self.ASP_output_conv(self.final_layer_norm2(a)).transpose(-1, -2)
        return tf_outputs(logamp, *self._phase(x), self.n_fft, self.hop_size, self.win_size)


class FreeV(_PhaseTrunk):
    """APNet2's phase branch with a pseudo-inverse-mel amplitude branch
    (freeV.py:69-187): one ConvNeXt block at dim ASP_channel (= n_fft // 2 +
    1) on log(clamp(|pinv(mel_basis) exp(mel)|, 1e-5)), or on the log of
    `inv_mel_amp` (B, F, T) when it is given (the T-F trainer's aux_input)."""

    def __init__(self, h, gen: torch.Generator, dim: int = 512, num_layers: int = 8,
                 intermediate_dim: int = 1536):
        super().__init__()
        self.n_fft, self.hop_size, self.win_size = h.n_fft, h.hop_size, h.win_size
        self.mel_args = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size,
                         h.win_size, h.fmin, h.fmax)
        self.convnext2 = nn.ModuleList([ConvNeXtBlock(int(h.ASP_channel), intermediate_dim,
                                                      gen)])
        self._init_phase_trunk(h, gen, dim, num_layers, intermediate_dim)

    def forward(self, mel: torch.Tensor, inv_mel_amp: torch.Tensor | None = None):
        if inv_mel_amp is None:
            inv_amp = torch.clamp(torch.abs(inverse_mel(mel, *self.mel_args)), min=1e-5)
        else:
            inv_amp = inv_mel_amp
        a = torch.log(inv_amp).transpose(-1, -2)                    # (B, T, F)
        for blk in self.convnext2:
            a = blk(a)
        return tf_outputs(a.transpose(-1, -2), *self._phase(mel.transpose(-1, -2)),
                          self.n_fft, self.hop_size, self.win_size)
