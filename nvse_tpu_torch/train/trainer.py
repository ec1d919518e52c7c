"""GAN trainer of the T-F, time and joint domains: one step updates D, then G.

Counterpart of nvse_tpu/train/trainer.py:85-543 with domain "tf"
(reference train_tf_wi_inv.py:158-305: the BSRNN family, GCRN, APNet,
APNet2, FreeV and Vocos), "time" (train_time_wi_inv.py:150-305: HiFiGAN,
iSTFTNet, ConvTasNet and HD-Demucs) and "joint" (the joint
denoise+vocoder BSRNN_24k, train_tf_wi_inv_joint_denoise_vocoder.py):
  tf, joint: L_D = mrd_weight * L_MRD + L_MPD           (LS-GAN)
             L_G = 45 L_A + 100 (IP + GD + PTD) + 20 (L_C + 2.25 (L_R + L_I))
                   + L_GAN + L_FM + 45 L_Mel
  time:      L_D = L_MSD + L_MPD   (LS-GAN for HiFiGAN / iSTFTNet, else hinge)
             L_G = L_GAN + L_FM + 45 L_Mel
With h.use_cqtd every domain adds the multi-scale sub-band CQT discriminator
(models/cqt_discriminator.py): cqtd_weight x its D loss to L_D, and
cqtd_weight x its GAN and feature-matching losses to L_GAN and L_FM
(nvse_tpu/train/trainer.py:152-167, :344-347, :399-404); opt_d covers it.
Features (mel, mel-loss target, and in the T-F domains log-amplitude,
phase, real, imag) are computed on the device from the raw audio batch. The generator runs once
with grad; the discriminators are updated first on its detached output,
and the G losses use the UPDATED discriminators, frozen, so that no D
gradient is left for the next D update. One backward through the G loss
reaches every generator weight: each BiLSTM's backward is the
lstm_bwd kernel per direction (ops/lstm.py), ConvTasNet's fused TCN tails
recompute their plain version (ops/tcn.py).

The time domain's MSD holds spectral norm on its first scale (SNConv1d):
the D pass advances its power-iteration buffers `u` (twice, real then
generated wave, as the JAX module's two calls); the G pass only reads them.
A ConvTasNet / HD-Demucs with init_phase "rand" takes a new initial phase
every step, a uniform draw from a CPU torch.Generator seeded with
h.seed + 0x9A5E + the generator's update count (the JAX step folds the step
into a PRNG key; the draws differ, the rule is the same); validation and
"griffin_lim" take ops.griffin_lim.default_phase.

The joint domain (GANTrainer(..., joint=True)) has the same losses and
discriminators with three differences (nvse_tpu/train/trainer.py:202-262):
the batch is the clean wave and an input wave (noisy for the "denoise"
task, clean for "vocoder"), the generator's input is
ops.spectral.joint_input of the input wave for the step's task, and the
clean wave's log amplitude takes eps 1e-5 in place of 1e-7. The task is an
argument of step / eval_step, so one trainer (one generator, one pair of
discriminators and optimizers) serves both tasks, as the JAX joint loop
shares its states between its two compiled steps.

compute_dtype "bfloat16" or "float16" runs the G and D trunks in that type
from cast copies of the float32 master weights (torch.func.functional_call);
features, losses and optimizer states stay float32, and the casts pass
float32 gradients back, as the JAX step's `_to_compute` does
(nvse_tpu/train/trainer.py:220-236). As there, float16 takes no loss scaling.
On the card every LSTM of a float16 trunk runs the step-wise kernels of
csrc/lstm_stepwise.cu and ConvTasNet's tail the float16 instance of
csrc/tcn_tail.cu.

Over a mesh (GANTrainer(..., mesh=parallel.get_mesh(...)), one process a
rank; nvse_tpu/train/trainer.py:510-536): the batch a rank's step takes is
its rows of the global batch (parallel.shard_batch), parameters and
optimizer states are replicated, each backward's gradients are averaged
over every rank of the mesh before the update (so the clip norm and the
skip decision read the same gradient everywhere), and the returned metrics
are their mean over the mesh: one step over N ranks is one step of one
process on the whole batch. The "rand" phase is drawn for the global batch
on every rank, which takes its rows. A mesh with a "seq" axis runs BSRNN's
trunk sequence-parallel (models/bsrnn.py); the seq ranks of a data rank
hold the same rows, and other generators compute them on each.

A spectrum-input model (BSRNN_24k) given to the T-F trainer raises
NotImplementedError before any CUDA call, naming the joint entry (python -m
nvse_tpu_torch.train --joint). A causal config trains on both devices: its
time LSTM takes lstm_scan's residual-saving route.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from .. import resolve_device
from ..losses import (
    amplitude_loss,
    feature_loss,
    hinge_discriminator_loss,
    hinge_generator_loss,
    ls_discriminator_loss,
    ls_generator_loss,
    phase_loss,
    stft_consistency_loss,
)
from ..losses.spectral import _masked_mean
from ..models import build_generator, model_input_bins
from ..models.discriminators import (MultiPeriodDiscriminator, MultiResolutionDiscriminator,
                                     MultiScaleDiscriminator)
from ..models.cqt_discriminator import MultiScaleSubbandCQTDiscriminator
from ..models.layers import LSTM
from ..ops.griffin_lim import random_phase
from ..models.bsrnn import BSRNNCore
from ..ops.spectral import JOINT_EPS, JOINT_TASKS, amp_pha_spectrum, joint_input, mel_spectrogram
from ..parallel import DATA_AXIS, all_reduce_mean_, axis_rank, axis_size, seq_group



def learning_rate(h, steps_per_epoch: int, updates: int) -> float:
    """lr after `updates` optimizer updates: h.learning_rate decayed by
    h.lr_decay once per epoch, a staircase (optax.exponential_decay with
    staircase=True, as the JAX package schedules it)."""
    return float(h.learning_rate) * float(h.lr_decay) ** (updates // max(1, steps_per_epoch))


def make_optimizer(modules, h, steps_per_epoch: int) -> torch.optim.AdamW:
    """AdamW(betas=(adam_b1, adam_b2), eps=1e-8, weight_decay=0.01) over
    the parameters of `modules` (a module or a list of them), with the
    staircase schedule of `learning_rate` applied by `apply_update`.

    The LSTM layers hold one summed bias b = b_ih + b_hh where the JAX
    layer and torch.nn.LSTM train two tensors with the same gradient.
    One AdamW step on each of the two moves their sum by 2 lr u + lr wd b
    (u the Adam direction), so the summed biases form a group with
    `copies` = 2: lr x 2 and weight decay / 2, which is that update
    exactly, and their gradients count twice in the global norm.
    """
    modules = modules if isinstance(modules, (list, tuple)) else [modules]
    summed, plain = [], []
    for mod in modules:
        for sub in mod.modules():
            own = dict(sub.named_parameters(recurse=False))
            for name, p in own.items():
                (summed if isinstance(sub, LSTM) and name in LSTM.summed_biases else plain).append(p)
    groups = [{"params": plain, "copies": 1, "weight_decay": 0.01}]
    if summed:
        groups.append({"params": summed, "copies": 2, "weight_decay": 0.01 / 2})
    opt = torch.optim.AdamW(groups, lr=float(h.learning_rate),
                            betas=(float(h.adam_b1), float(h.adam_b2)), eps=1e-8)
    opt.steps_per_epoch = max(1, int(steps_per_epoch))
    return opt


def _updates_done(opt: torch.optim.Optimizer) -> int:
    """Optimizer updates applied so far (AdamW's own step count, which a
    skipped update does not advance and a checkpoint restores)."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                return int(st["step"])
    return 0


def _global_norm(opt: torch.optim.Optimizer) -> torch.Tensor:
    sq = [g["copies"] * torch.sum(p.grad.float() ** 2)
          for g in opt.param_groups for p in g["params"] if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


def apply_update(opt: torch.optim.Optimizer, h, clip: float, skip_nonfinite: bool):
    """One AdamW step at the scheduled lr, with the JAX step's opt-in
    stabilisers (trainer.py:85-149): global-norm clipping when clip > 0
    (non-finite norms left unscaled) and, with skip_nonfinite, no update
    at all when the gradient norm is not finite. Returns 1.0 if the
    update was applied, 0.0 if it was skipped."""
    lr = learning_rate(h, opt.steps_per_epoch, _updates_done(opt))
    for g in opt.param_groups:
        g["lr"] = lr * g["copies"]
    if clip > 0.0 or skip_nonfinite:
        norm = _global_norm(opt)
        if skip_nonfinite and not bool(torch.isfinite(norm)):   # one host sync, opt-in
            return 0.0
        if clip > 0.0:
            scale = torch.where(torch.isfinite(norm),
                                torch.clamp(clip / (norm + 1e-16), max=1.0),
                                torch.ones_like(norm))
            for g in opt.param_groups:
                for p in g["params"]:
                    if p.grad is not None:
                        p.grad.mul_(scale)
    opt.step()
    return 1.0


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """No gradient reaches the module's parameters inside the block."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _cast(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    return type(tree)(_cast(t, dtype) for t in tree)


def _spectral_buffers(module: nn.Module) -> list:
    """The MSD's power-iteration vectors (SNConv1d's `u`), in module order."""
    return [b for n, b in module.named_buffers() if n.endswith(".u")]


def _check_supported(h, domain: str) -> None:
    spectrum_input = model_input_bins(h) != h.num_mels
    if domain == "tf" and spectrum_input:
        raise NotImplementedError(
            f"{h.model_name} takes a log spectrum and trains in the joint denoise+vocoder "
            "domain: use python -m nvse_tpu_torch.train --joint (train/loop_joint.py), "
            "not the T-F trainer")
    if domain == "joint" and not spectrum_input:
        raise ValueError(f"the joint trainer feeds a log spectrum; {h.model_name} takes mels")


class GANTrainer:
    """Generator, MPD + MRD (T-F and joint domains) or MPD + MSD (time
    domain), with h.use_cqtd the CQT discriminator beside them, their AdamW
    optimizers and the step functions.

    Weights are random from torch.Generators seeded with h.seed (the
    generator as build_generator draws it, the discriminators from
    h.seed + 1), made on the CPU and moved to `device`. joint=True trains
    in the joint domain (BSRNN_24k); its steps take the task. The domain
    is the registry's (models.build_generator). `mesh` (a DeviceMesh of
    parallel.get_mesh) trains data-parallel over its ranks, and
    sequence-parallel where it has a "seq" axis; every rank builds the same
    weights from the seed.
    """

    def __init__(self, h, device: str | torch.device = "cuda", steps_per_epoch: int = 1,
                 joint: bool = False, mesh=None):
        self.h = h
        generator, domain = build_generator(h)
        _check_supported(h, "joint" if joint else domain)   # before any CUDA call
        self.joint = joint
        self.domain = "joint" if joint else domain
        self.tf_like = self.domain in ("tf", "joint")
        # the joint domain's log amplitude floor (nvse_tpu/train/trainer.py:246)
        self.amp_eps = JOINT_EPS if joint else 1e-7
        self.device = resolve_device(device)
        dgen = torch.Generator().manual_seed(int(h.get("seed", 1234)) + 1)
        self.generator = generator.to(self.device)
        # LS-GAN in the T-F domains and for HiFiGAN / iSTFTNet, hinge for the other
        # time models (nvse_tpu/train/trainer.py:213-218)
        use_ls = self.tf_like or h.model_name in ("HiFiGAN", "iSTFTNet")
        self.d_loss = ls_discriminator_loss if use_ls else hinge_discriminator_loss
        self.g_loss = ls_generator_loss if use_ls else hinge_generator_loss
        # the scale discriminator, its key and weight (nvse_tpu/train/trainer.py:152-167);
        # under the hinge losses the real and generated waves take separate calls
        # (models/discriminators.py: the exact zero of a post conv's bias gradient)
        self.scale_key = "mrd" if self.tf_like else "msd"
        if self.tf_like:
            scale_disc = MultiResolutionDiscriminator(gen=dgen)
        else:
            scale_disc = MultiScaleDiscriminator(gen=dgen, batched=use_ls)
        self.disc = nn.ModuleDict({
            "mpd": MultiPeriodDiscriminator(tuple(h.mpd_reshapes), gen=dgen, batched=use_ls),
            self.scale_key: scale_disc,
        })
        if h.get("use_cqtd"):
            self.disc["cqtd"] = MultiScaleSubbandCQTDiscriminator.from_config(h, gen=dgen)
        self.disc.to(self.device)
        self.cqtd_weight = float(h.get("cqtd_weight", 1.0))
        self.scale_weight = float(h.mrd_weight) if self.tf_like else 1.0
        # a fresh initial phase a step for init_phase "rand" (trainer.py:297-312)
        self.rand_phase = str(getattr(generator, "init_phase", "")).lower() == "rand"
        self.phase_seed = int(h.get("seed", 0)) + 0x9A5E
        self.mesh = mesh
        self.seq_cores = [m for m in generator.modules() if isinstance(m, BSRNNCore)]
        self.opt_g = make_optimizer(self.generator, h, steps_per_epoch)
        self.opt_d = make_optimizer(self.disc, h, steps_per_epoch)
        self.compute_dtype = {"bfloat16": torch.bfloat16,
                              "float16": torch.float16}.get(str(h.get("compute_dtype")))
        self.clip = float(h.get("grad_clip_norm", 0.0) or 0.0)
        self.skip_nonfinite = bool(h.get("skip_nonfinite_updates"))
        sr = h.sampling_rate
        self.melargs = (h.n_fft, h.num_mels, sr, h.hop_size, h.win_size)
        # h.meloss is the fmax of the mel-loss target; null -> sr/2
        self.meloss_fmax = h.get("meloss") or sr / 2.0

    # -- pieces -----------------------------------------------------------
    def _run(self, module: nn.Module, *args, mixed: bool = True, **kwargs):
        """module(*args, **kwargs), in the compute dtype from cast copies of
        the float32 weights when mixed; outputs come back float32. The
        keyword arguments (an initial phase, update_stats) are passed as
        they are; buffers (the MSD's u) stay float32."""
        if not mixed or self.compute_dtype is None:
            return module(*args, **kwargs)
        params = {n: p.to(self.compute_dtype) for n, p in module.named_parameters()}
        out = torch.func.functional_call(module, params, _cast(args, self.compute_dtype),
                                         kwargs)
        return _cast(out, torch.float32)

    def features(self, audio: torch.Tensor, aux_input: torch.Tensor | None = None,
                 task: str | None = None):
        """(generator input, mel-loss target, log-amplitude, phase, real,
        imag) of the clean wave (reference dataset.py:218-244); the time
        domain has the first two only, the rest None. The
        generator input is the clean wave's mel, or in the joint domain
        joint_input of the input wave `aux_input` for `task`
        (dataset_joint_denoise_vocoder.py:344-392)."""
        h = self.h
        meloss = mel_spectrogram(audio, *self.melargs, h.fmin, self.meloss_fmax)
        if self.joint:
            if task not in JOINT_TASKS or aux_input is None:
                raise ValueError(f"a joint step takes the input wave and a task in "
                                 f"{JOINT_TASKS}, not {task!r}")
            inpt = joint_input(aux_input.to(self.device, torch.float32), task, h)
        else:
            inpt = mel_spectrogram(audio, *self.melargs, h.fmin, h.fmax)
        if not self.tf_like:
            return inpt, meloss, None, None, None, None
        logamp, pha, rea, imag = amp_pha_spectrum(audio, h.n_fft, h.hop_size, h.win_size,
                                                  eps=self.amp_eps)
        return inpt, meloss, logamp, pha, rea, imag

    def _consistency(self, rea_g, imag_g, y_gc, mask=None):
        h = self.h
        _, _, rea_gf, imag_gf = amp_pha_spectrum(y_gc, h.n_fft, h.hop_size, h.win_size)
        Tc = min(rea_g.shape[-1], rea_gf.shape[-1])
        return stft_consistency_loss(rea_g[..., :Tc], rea_gf[..., :Tc], imag_g[..., :Tc],
                                     imag_gf[..., :Tc], mask=None if mask is None else mask[:Tc])

    # -- the step ---------------------------------------------------------
    def step(self, audio: torch.Tensor, aux_input: torch.Tensor | None = None,
             task: str | None = None) -> dict:
        """One GAN step on a (B, segment) float32 batch (joint: the clean
        wave, the input wave and the task); returns the metrics as 0-dim
        float32 tensors on the device (no host sync): A, IP, GD, PTD, C, R, I,
        Mel, GAN, FM, G and D; in the time domain Mel, GAN, FM, G and D
        (nvse_tpu/train/trainer.py:405-409)."""
        fwd = self.generator_forward(audio, aux_input, task)
        L_D, ok_d = self.discriminator_update(fwd)
        metrics, ok_g = self.generator_update(fwd)
        metrics["D"] = L_D.detach().float()
        if self.mesh is not None:                  # the global batch's losses
            all_reduce_mean_(list(metrics.values()), self.mesh)
        if self.skip_nonfinite:
            # skipped updates this step: 0 = none, 1 = D or G, 2 = both
            metrics["skip"] = torch.tensor((1.0 - ok_d) + (1.0 - ok_g), device=self.device)
        return metrics

    def _gen_args(self, inpt: torch.Tensor, aux_input: torch.Tensor | None):
        """The generator's arguments: in the T-F domain an aux_input (FreeV's
        and GCRN's inv_mel_amp) follows the mel, as the JAX step passes it
        (nvse_tpu/train/trainer.py:300-311); the joint domain's aux_input is
        the input wave, which joint_input already consumed, and the time
        domain's generators take the mel alone."""
        if self.domain != "tf" or aux_input is None:
            return (inpt,)
        return inpt, aux_input.to(self.device, torch.float32)

    def step_phase(self, mel: torch.Tensor) -> torch.Tensor:
        """The initial phase (B, n_fft // 2 + 1, T) of this step's "rand"
        draw: uniform on [-pi, pi) from a CPU generator seeded with
        h.seed + 0x9A5E + the generator's updates so far."""
        h = self.h
        gen = torch.Generator().manual_seed(self.phase_seed + _updates_done(self.opt_g))
        B = mel.shape[0]                           # this rank's rows of the global draw
        theta = random_phase((B * axis_size(self.mesh, DATA_AXIS), h.n_fft // 2 + 1,
                              mel.shape[-1]), gen, "cpu")
        r = axis_rank(self.mesh, DATA_AXIS)
        return theta[r * B:(r + 1) * B].to(self.device)

    @contextlib.contextmanager
    def _seq_parallel(self):
        """BSRNN's trunk runs over the mesh's seq group inside the block."""
        group = seq_group(self.mesh)
        for core in self.seq_cores:
            core.seq_group = group
        try:
            yield
        finally:
            for core in self.seq_cores:
                core.seq_group = None

    def _average_grads(self, opt: torch.optim.Optimizer) -> None:
        """Each gradient of opt's parameters := its mean over the mesh."""
        if self.mesh is not None:
            all_reduce_mean_([p.grad for g in opt.param_groups for p in g["params"]
                              if p.grad is not None], self.mesh)

    def generator_forward(self, audio: torch.Tensor, aux_input: torch.Tensor | None = None,
                          task: str | None = None) -> dict:
        """Features of the batch and the generator's outputs, with grad."""
        audio = audio.to(self.device, torch.float32)
        feats = self.features(audio, aux_input, task)
        kw = {"theta": self.step_phase(feats[0])} if self.rand_phase else {}
        with self._seq_parallel():
            outs = self._run(self.generator, *self._gen_args(feats[0], aux_input), **kw)
        y_g = outs[-1] if self.tf_like else outs
        y_min = min(y_g.shape[-1], audio.shape[-1])
        return {"feats": feats, "outs": outs, "y_c": audio[..., :y_min],
                "y_gc": y_g[..., :y_min]}

    def _scale(self, y: torch.Tensor, y_hat: torch.Tensor, update_stats: bool):
        """The MRD, or the MSD (advancing its u when update_stats)."""
        if self.tf_like:
            return self._run(self.disc["mrd"], y, y_hat)
        return self._run(self.disc["msd"], y, y_hat, update_stats=update_stats)

    def discriminator_update(self, fwd: dict):
        """L_D on the detached generated wave and one D update
        (reference train_tf_wi_inv.py:190-205). The MSD's u advance; a
        skipped update keeps the old u, as the JAX step. Returns (L_D,
        applied)."""
        y_c, y_g_det = fwd["y_c"], fwd["y_gc"].detach()
        u_old = [u.clone() for u in _spectral_buffers(self.disc)] if self.skip_nonfinite else []
        r_f, g_f, _, _ = self._run(self.disc["mpd"], y_c, y_g_det)
        r_s, g_s, _, _ = self._scale(y_c, y_g_det, update_stats=True)
        L_D = self.d_loss(r_s, g_s)[0] * self.scale_weight + self.d_loss(r_f, g_f)[0]
        if "cqtd" in self.disc:
            r_c, g_c, _, _ = self._run(self.disc["cqtd"], y_c, y_g_det)
            L_D = L_D + self.cqtd_weight * self.d_loss(r_c, g_c)[0]
        self.opt_d.zero_grad(set_to_none=True)
        L_D.backward()
        self._average_grads(self.opt_d)
        ok = apply_update(self.opt_d, self.h, self.clip, self.skip_nonfinite)
        if not ok:
            for u, old in zip(_spectral_buffers(self.disc), u_old):
                u.copy_(old)
        return L_D, ok

    def generator_update(self, fwd: dict):
        """L_G against the updated, frozen discriminators (the MSD's u read,
        not advanced), one backward through the generator and one G update.
        Returns (metrics, applied)."""
        h = self.h
        mel, meloss, logamp, pha, rea, imag = fwd["feats"]
        y_c, y_gc = fwd["y_c"], fwd["y_gc"]
        with _frozen(self.disc):
            y_g_mel = mel_spectrogram(y_gc, *self.melargs, h.fmin, self.meloss_fmax)
            L_Mel = torch.mean(torch.abs(meloss - y_g_mel))
            _, g_f, fr_f, fg_f = self._run(self.disc["mpd"], y_c, y_gc)
            _, g_s, fr_s, fg_s = self._scale(y_c, y_gc, update_stats=False)
            w = self.scale_weight
            L_GAN = self.g_loss(g_s)[0] * w + self.g_loss(g_f)[0]
            L_FM = feature_loss(fr_s, fg_s) * w + feature_loss(fr_f, fg_f)
            if "cqtd" in self.disc:
                _, g_c, fr_c, fg_c = self._run(self.disc["cqtd"], y_c, y_gc)
                L_GAN = L_GAN + self.cqtd_weight * self.g_loss(g_c)[0]
                L_FM = L_FM + self.cqtd_weight * feature_loss(fr_c, fg_c)
            L_G = L_GAN + L_FM + 45.0 * L_Mel
            if self.tf_like:
                logamp_g, pha_g, rea_g, imag_g, _ = fwd["outs"]
                L_A = amplitude_loss(logamp, logamp_g)
                ip, gd, ptd = phase_loss(pha, pha_g)
                # gradients flow through both sides of the consistency loss
                L_C = self._consistency(rea_g, imag_g, y_gc)
                L_R = torch.mean(torch.abs(rea - rea_g))
                L_I = torch.mean(torch.abs(imag - imag_g))
                L_G = (45.0 * L_A + 100.0 * (ip + gd + ptd) + 20.0 * (L_C + 2.25 * (L_R + L_I))
                       + L_G)
            self.opt_g.zero_grad(set_to_none=True)
            L_G.backward()
        self._average_grads(self.opt_g)
        ok_g = apply_update(self.opt_g, h, self.clip, self.skip_nonfinite)
        metrics = {"Mel": L_Mel, "GAN": L_GAN, "FM": L_FM, "G": L_G}
        if self.tf_like:
            metrics.update(A=L_A, IP=ip, GD=gd, PTD=ptd, C=L_C, R=L_R, I=L_I)
        return {k: v.detach().float() for k, v in metrics.items()}, ok_g

    # -- validation (no grad: the BiLSTMs take the inference kernel) ------
    @torch.no_grad()
    def eval_step(self, audio: torch.Tensor, aux_input: torch.Tensor | None = None,
                  task: str | None = None):
        """Full losses on a fixed crop (trainer.py:425-453); float32 weights.
        Joint: the clean wave, the input wave and the task, as step. The
        time domain: Mel only."""
        h = self.h
        audio = audio.to(self.device, torch.float32)
        mel, meloss, logamp, pha, rea, imag = self.features(audio, aux_input, task)
        outs = self.generator(*self._gen_args(mel, aux_input))
        y_g = outs[-1] if self.tf_like else outs
        Tc = min(y_g.shape[-1], audio.shape[-1])
        metrics = {}
        if self.tf_like:
            logamp_g, pha_g, rea_g, imag_g, _ = outs
            ip, gd, ptd = phase_loss(pha, pha_g)
            metrics = {"A": amplitude_loss(logamp, logamp_g), "IP": ip, "GD": gd, "PTD": ptd,
                       "R": torch.mean(torch.abs(rea - rea_g)),
                       "I": torch.mean(torch.abs(imag - imag_g)),
                       "C": self._consistency(rea_g, imag_g, y_g[..., :Tc])}
        y_g_mel = mel_spectrogram(y_g[..., :Tc], *self.melargs, h.fmin, self.meloss_fmax)
        T = min(meloss.shape[-1], y_g_mel.shape[-1])
        metrics["Mel"] = torch.mean(torch.abs(meloss[..., :T] - y_g_mel[..., :T]))
        return y_g, metrics

    @torch.no_grad()
    def eval_full(self, audio: torch.Tensor, n_samples: int):
        """Full-utterance validation (trainer.py:455-508): `audio` (1, L) is
        the utterance zero-padded to a bucket; every metric is masked to the
        frames whose reference features depend only on real samples,
        t * hop + n_fft/2 <= n_samples. The time domain: Mel only. Not the
        joint domain: the joint loop validates crops with eval_step."""
        if self.joint:
            raise ValueError("eval_full validates T-F and time-domain utterances; a joint "
                             "trainer validates crops with eval_step")
        h = self.h
        audio = audio.to(self.device, torch.float32)
        mel, meloss, logamp, pha, rea, imag = self.features(audio)
        outs = self.generator(mel)
        y_g = outs[-1] if self.tf_like else outs
        y_min = min(y_g.shape[-1], audio.shape[-1])
        y_gc = y_g[..., :y_min]
        y_g_mel = mel_spectrogram(y_gc, *self.melargs, h.fmin, self.meloss_fmax)
        Tm = min(meloss.shape[-1], y_g_mel.shape[-1])
        nf = max(1, (int(n_samples) - h.n_fft // 2) // h.hop_size + 1)
        mask_m = (torch.arange(Tm, device=self.device) < nf).float()
        metrics = {"Mel": _masked_mean(torch.abs(meloss[..., :Tm] - y_g_mel[..., :Tm]), mask_m)}
        if not self.tf_like:
            return y_g, metrics
        logamp_g, pha_g, rea_g, imag_g, _ = outs
        Tf = min(pha.shape[-1], pha_g.shape[-1])
        mask = (torch.arange(Tf, device=self.device) < nf).float()
        metrics["A"] = amplitude_loss(logamp[..., :Tf], logamp_g[..., :Tf], mask=mask)
        ip, gd, ptd = phase_loss(pha[..., :Tf], pha_g[..., :Tf], mask=mask)
        metrics.update(IP=ip, GD=gd, PTD=ptd)
        metrics["R"] = _masked_mean(torch.abs(rea[..., :Tf] - rea_g[..., :Tf]), mask)
        metrics["I"] = _masked_mean(torch.abs(imag[..., :Tf] - imag_g[..., :Tf]), mask)
        metrics["C"] = self._consistency(rea_g[..., :Tf], imag_g[..., :Tf], y_gc, mask=mask)
        return y_g, metrics


def fetch_scalars(metrics: dict) -> dict:
    """Metrics dict of device scalars -> python floats in one transfer."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))

