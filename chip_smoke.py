#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (nvse_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits nonzero before
the last line:
  1. build every CUDA kernel of csrc/ from source (one nvcc per source,
     all started together);
  2. hold each kernel against its plain PyTorch version at the shapes of
     its main path, in float32 and bfloat16, and time kernel, plain
     version and the library yardstick (cuDNN's torch.nn.LSTM, which
     the port never calls): the fused inference LSTM at the BSRNN-M
     decode shapes and at the band shapes of a streaming chunk (640 rows
     x 34 steps for 8 streams, 80 for one) and of a context-recompute
     window (96), and at a ragged 203 x 37 with C = 124, H = 120 (held
     only), with its two W_hh swapped as the control (csrc/lstm_fused.cu:
     thread-block clusters with the weights resident, tensor cores in
     bfloat16, the plan of ops/lstm.py `fused_narrow_plan`, named in each
     row's design); lstm_fwd_hc,
     lstm_bwd and the dW_hh reduction at the
     BSRNN-M training shapes (batch 16: 544 rows x 65 steps, 1040 rows x
     34 steps: the narrow kernels, mode kFwdHc of csrc/lstm_scan.cu and the
     cluster recurrence of csrc/lstm_bwd.cu, or the wide ones where
     ops/lstm.py `train_route` picks them, the plans of `scan_narrow_plan` and
     `bwd_narrow_plan` named in their rows' design and the kernel in their
     source), with cuDNN's BiLSTM forward + backward beside the port's,
     and at GCRN's (16 rows x 65 steps, H = 448: the wide forward of
     csrc/lstm_scan_wide.cu and the wide backward of csrc/lstm_bwd_wide.cu,
     the plans of ops/lstm.py `scan_wide_plan` and `bwd_wide_plan` named in
     their rows' design), with one cuBLAS GEMM beside the dW_hh reduction
     (float32 out, as the kernel's, where torch.mm takes out_dtype) and the
     forward and the backward recurrence fed W_hh's rows reversed as the
     controls the limit must refuse;
     lstm_scan at the causal decode and context-recompute window shapes
     (272 rows x 1024 steps, 34 x 96) and lstm_scan_stateful at the
     streaming chunk shapes (272 x 80 for 8 streams, 34 x 80 for one;
     seeded nonzero state; hs and cs) on csrc/lstm_scan.cu (clusters with
     W_hh in registers, h by st.async, tensor cores in bfloat16, the plan
     of ops/lstm.py `scan_narrow_plan` named in each row's design), with
     cuDNN's unidirectional LSTM forward (projection included) beside them
     and, as controls the limit must refuse, W_hh's rows reversed and the
     stateful kernel fed zeros in place of its initial state; a cuDNN call
     that compacts its weights at every call fails the run;
  3. decode B=8 x 1024 mel frames through InferenceEngine with seeded
     random BSRNN-M weights in float32 and bfloat16 (16 kernel launches
     per forward), check the card's output against the CPU's plain path
     on a small input, and print RTF plus the bf16-vs-f32 deviation;
  4. serve the synthetic test set through run_inference;
  5. train: GANTrainer steps at full BSRNN-M width, batch 16 x 16384, in
     float32 and bfloat16 (ms per step, peak memory, losses; finite
     losses, G and D changed, a finite nonzero gradient on all 96 LSTM
     parameters and the encoder, 32 launches per step of each training
     kernel, none of the inference kernel);
  6. one step of a small config on the card against the CPU's plain path
     (losses and AdamW first moments), with a TF32 card step as the
     control that the limits must refuse;
  7. the training CLI (its main(), in this process) for 2 steps with a
     validation pass on the synthetic data, then run_inference decoding
     from the g_ bundle it wrote; train_knobs, the loop's knobs (train/loop.py,
     train/checkpoint.py): the CLI again for 2 steps with a save at each, a
     torch.profiler trace of step 1 (profile_dir, profile_steps 1) that must name
     the step's training kernels as often as they launched, the default async
     saves; then a trainer restored from its bundles: a sync and an async save
     timed as the loop is blocked, a step run during the async write, each async
     bundle equal bit for bit to the sync one; a step under debug_nans (finite
     losses) and one with a NaN planted in _BiLSTMSaving's backward, which must
     raise naming it; then the joint denoise+vocoder BSRNN_24k
     (configs/bsrnn_joint_denoise_vocoder_config.json: 34 bands at 24 kHz,
     BSRNN-M's shapes): joint_train, GANTrainer(joint=True) steps at full
     width, batch 16 x 16384, each task in float32 and bfloat16 (the checks
     of phase 5: 32 launches per step of each training kernel, none of an
     inference kernel); joint_train_vs_cpu_plain, one small step per task
     against the CPU at the limits of phase 6 (TF32 as the control);
     joint_train_cli, main() with --joint for 2 steps on lists written from
     DatasetsScp/synth24 (the noise list with this checkout's paths), with
     the validation of both tasks, then the joint inference entry
     (run_joint_inference) in each mode from the g_ bundle it wrote;
     joint_eval, from that g_ bundle: python -m nvse_tpu_torch.metrics.enhance's
     main() on 2 synth24 files with its noise at 5 dB (every key of the record,
     each score finite, delta = enhanced - noisy), metrics/joint_curve.py's
     batched decode of both modes against the CPU's plain path at the decode
     limits, and joint_curve's main() without the DNSMOS .onnx files raising the
     JAX script's FileNotFoundError (said on the line);
  8. stream, at full BSRNN-M width in float32 and bfloat16: 8 streams x 512
     frames through synthesize_streaming_stateful (chunk 64, lookahead
     16) on the causal config (8 lstm_scan_stateful + 8 fused launches
     per chunk, none of lstm_scan; in float32 equal to the card's offline
     decode with and without lookahead) and on the non-causal one (16 +
     8), per-chunk latency (a clock on the engine's own per-chunk step)
     and streams x real time; the causal offline
     decode at B=8 x 1024 (8 lstm_scan + 8 fused launches per forward)
     and against the CPU's plain path on a small input; run_inference
     with stream=True in both stream modes;
  9. causal training: GANTrainer steps of the causal config at batch 16 x
     16384 in float32 (a finite nonzero gradient on all 72 LSTM
     parameters, 24 launches per step of each training kernel, none of
     an inference kernel);
 10. lstm_scan_bidir2 (two scans in one launch, on the route ops/lstm.py
     `bidir2_plan` picks: GCRN's on the cluster kernel of csrc/lstm_bidir2.cu,
     one thread-block cluster of 14 blocks a scan with W_hh resident and h by
     st.async, tensor cores in bfloat16; H <= 128 on csrc/lstm_scan.cu; H = 768
     on csrc/lstm_scan_wide.cu kScanBidir; the route and plan in each row's
     source and design) against its plain version at the GCRN shapes (decode:
     1024 steps x 8 rows x H = 448; serving the synthetic set: 128 x 8 x 448)
     and at one H <= 128 shape, in float32 and bfloat16, with two cuDNN
     unidirectional LSTM forwards beside it and, as the control the limit must
     refuse, the two W_hh swapped;
 11. GCRN at its full (only) width through InferenceEngine: decode B=8 x
     1024 frames in float32 and bfloat16 (2 lstm_scan_bidir2 launches per
     forward, all on the cluster kernel, none of any other LSTM kernel),
     run_inference on the
     synthetic set, and the card's decode against the CPU's plain path
     on a small input;
 12. the gradient route of lstm_scan_bidir2 on the card (2 lstm_fwd_hc + 2
     lstm_bwd + 2 dW, none of the inference kernel) against the CPU's
     plain autograd at 65 steps x 16 rows, H = 128 and GCRN's H = 448 (the
     wide kernels of csrc/lstm_scan_wide.cu and csrc/lstm_bwd_wide.cu), with the
     two W_hh swapped as the
     control the limit must refuse;
 13. GCRN training (gcrn_train): GANTrainer steps at its full width, batch
     16 x 16384, in float32 and bfloat16 (ms per step, peak memory; a
     finite nonzero gradient on all 12 GLSTM LSTM parameters, 4 launches
     per step of each training kernel at 65 x 16 x 448, none of an
     inference kernel); one GCRN step at batch 2 x 4096 on the card
     against the CPU's plain path at the limits of phase 6, TF32 as the
     control (gcrn_train_vs_cpu_plain); the training CLI with the GCRN
     config for 2 steps, then serving its g_ bundle (gcrn_train_cli);
 14. BSRNN-L (nvse_tpu_torch/configs/bsrnn_l_config.json: feature_dim 256,
     so H = C = 256 in every LSTM, 38,572,293 parameters) on the wide
     kernels: decode B=8 x 1024 in float32 and bfloat16 (16 launches per
     forward of csrc/lstm_fused_wide.cu, none of csrc/lstm_fused.cu) and
     against the CPU's plain path (bsrnn_l_decode, bsrnn_l_decode_vs_cpu_plain),
     run_inference (bsrnn_l_serve); phase 8's streams, causal decode and
     streaming serve on csrc/lstm_scan_wide.cu and csrc/lstm_fused_wide.cu
     (bsrnn_l_stream, bsrnn_l_decode_causal, bsrnn_l_serve_stream); GAN steps
     at batch 16 x 16384 in float32 and bfloat16 (32 launches per step of each
     wide training kernel of csrc/lstm_scan_wide.cu (mode kFwdHc) and
     csrc/lstm_bwd_wide.cu, and
     of the dW_hh reduction, a gradient on all 96 LSTM
     parameters, device busy time and idle share, peak memory) with
     GANTrainer.eval_step on a validation crop (16 wide fused launches;
     bsrnn_l_train, bsrnn_l_validation), one step of 2 BSNets at full width
     against the CPU (bsrnn_l_train_vs_cpu_plain); then (bsrnn_l_kernels) every
     wide kernel against its plain version at BSRNN-M's shapes (fused 272 x
     1024, 8192 x 34, 640 / 80 / 96 x 34; the scans at 272 x 1024, 34 x 96,
     272 x 80, 34 x 80; the training kernels at 544 x 65 and 1040 x 34), with
     the fused kernel's W_hh swapped, the scans', the training forward's and
     the backward's W_hh rows reversed and the stateful kernel's state zeroed
     as controls the limits must refuse (the wide scans of
     csrc/lstm_scan_wide.cu name the plan of ops/lstm.py `scan_wide_plan` in
     their design);
 15. ConvTasNet (nvse_tpu_torch/configs/convtasnet_config.json with fused_tcn
     1: 4,960,409 parameters, Griffin-Lim front, 24 TCN blocks): tcn_kernels,
     the tail kernel of csrc/tcn_tail.cu (wgmma in bfloat16, register-blocked
     float32 FMAs; the plan of ops/tcn.py `tail_plan` in each row's design)
     against tcn_block_tail_plain at the decode shape (8 x 32,735 encoder
     frames, H = 512, Bc = 128) at each dilation 1 ... 128 in float32 and
     bfloat16, and its gLN statistics kernel against `_fold` (tcn_gln_stats,
     torch.var_mean beside it, gln_w and gln_b swapped as the control), with the
     wrapper's time (statistics + tail kernels), the plain version's and the unfused tail as several
     PyTorch calls (gLN, F.conv1d depthwise, one cuBLAS 1x1) as the library
     yardstick, and two controls the limit must refuse (w_rs's res and skip
     halves swapped; at d = 128, c zero-padded before the norm);
     convtasnet_decode, B = 8 x 1024 mel frames in float32 and bfloat16 (24
     tail and 24 statistics launches per forward, 3 per dilation, none of an
     LSTM kernel) with
     the same decode with fused_tcn 0 timed beside it and held to it;
     convtasnet_serve, run_inference on the synthetic set in both dtypes;
     convtasnet_decode_vs_cpu_plain, the card against the CPU's plain path on
     a small input with zero initial phase (TF32 as the control) and the
     Griffin-Lim front on its own;
 16. lstm_scan_bidir (both directions as stacked rows of one scan:
     csrc/lstm_scan.cu at H = 128, each direction's clusters on its own W_hh,
     csrc/lstm_scan_wide.cu mode kScanBidir at
     H = 256) against its plain version at the bench's default shapes (1024
     steps x 2 x 544 rows, 68 x 2 x 8192) at H = 128 and 256 and at a ragged
     64 x 2 x 20, in float32 and bfloat16, with two cuDNN LSTM forwards beside
     it and the halves of w_stack swapped and each half's rows reversed as the
     controls the limit must refuse
     (lstm_scan_bidir_kernels); the port's LSTM-layout bench
     (scripts/bench_torch_lstm_kernel.py) in this process at its default
     shapes and at --hidden 256, 3 timed calls a variant (bench_lstm_kernel);
     lstm_scan_fused at HD-Demucs's
     bottleneck (8 x 1024, H = 768, C = 768 and 1536) in both dtypes, past its
     fused kernels: the projection and one lstm_scan_bidir2 launch a call
     (csrc/lstm_scan_wide.cu kScanBidir: no cluster holds H = 768), held to
     lstm_scan_fused_plain (hddemucs_bottleneck); then HD-Demucs itself
     (configs/hddemucas_config.json, 38,913,021 parameters, Griffin-Lim
     front): decode B = 8 x 1024 mel frames in float32 and bfloat16 (a
     1022-step bottleneck, 2 lstm_scan_bidir2 launches per forward, all on
     csrc/lstm_scan_wide.cu, none of any other kernel), run_inference on the
     synthetic set in both dtypes, the card against the CPU's plain path on
     a small input at zero initial phase with TF32 as the control (hddemucs);
 17. the conv T-F vocoders APNet, APNet2, FreeV and Vocos (configs/apnet_config.json,
     apnet2_config.json, freeV_config.json, vocos_config.json at their published
     widths: 72,191,494 / 31,425,539 / 18,218,509 / 13,480,450 parameters, weights
     from the seed): decode B = 8 x 1024 mel frames in float32 and bfloat16 (APNet's
     weight norm folded at load), run_inference on the synthetic set in both dtypes
     and streamed by context recompute, the card against the CPU's plain path on a
     small input (TF32 as the control) (<name>_decode, <name>_serve,
     <name>_decode_vs_cpu_plain); GANTrainer steps at batch 16 x 16384 in float32 and
     bfloat16 with a finite nonzero gradient on every weight-norm v and g (APNet) or
     GRN gamma and beta (<name>_train), one step at batch 2 x 4096 against the CPU
     at the limits of phase 6, TF32 as the control (<name>_train_vs_cpu_plain); no
     kernel of csrc/ is launched on any of these paths;
 18. the time domain: HiFiGAN and iSTFTNet (configs/hifigan_v1_config.json,
     istftnet_config.json at their published widths: 13,936,130 / 13,262,244
     parameters, weights from the seed) through phase 17's decode, serving and
     card-vs-CPU checks (hifigan_decode, istftnet_serve, ...; their weight-normed
     transposed convs folded at load; T mel frames decode to hop * T samples); the
     time trainer (MPD + MSD, the first scale spectral-normalised; LS-GAN for
     HiFiGAN / iSTFTNet, hinge for ConvTasNet / HD-Demucs): <name>_train, GANTrainer
     steps at batch 16 x 16384 in float32 and bfloat16 of HiFiGAN, iSTFTNet,
     ConvTasNet (fused_tcn 1: 24 tail + 24 statistics launches a step) and HD-Demucs
     (4 lstm_fwd_hc + 4 lstm_bwd + 4 dW launches a step, H = 768), no launch of any
     other kernel, a first step split into its passes (the MSD's 8 vectors u change
     in the D pass and not in the G pass; a finite nonzero gradient on every
     weight-norm v / g, ConvTasNet's tail weights, HD-Demucs's 12 LSTM tensors and
     the 8 SNConv1d kernels); <name>_train_vs_cpu_plain, one step at 2 x 4096 against
     the CPU at the limits of phase 6, TF32 as the control (ConvTasNet and HD-Demucs
     with zero initial phase; at full width and cut in depth: the MRF vocoders one
     resblock a stage, ConvTasNet one repeat of its 8 blocks); hifigan_train_cli, the training CLI with the HiFiGAN
     config for 2 steps with validation, then serving its g_ bundle; time_kernels, the
     training kernels at HD-Demucs's step shape (16 rows, H = 768, cuDNN's BiLSTM
     forward + backward beside them) and the tail and its statistics at ConvTasNet's
     (16 rows), each against its plain version with phase 2's and phase 15's controls;
 19. the CQT discriminator and the evaluation path: cqtd_train, BSRNN-M's T-F
     GAN step with use_cqtd (the reference's CQTD: hops 512 / 256 / 256, 9
     octaves of 24 / 36 / 48 bins, 32 filters, dilations 1, 2, 4) at batch 16 x
     16384 in float32 and bfloat16 (phase 5's checks, 32 launches a step of each
     training kernel; the first step split into its passes: every CQTD parameter
     changed by the D pass with a finite nonzero gradient, none by the G pass;
     the step's CQTs timed in the port's form, one GEMM of the framed wave, and
     as F.conv1d over the bank, with their share of device-busy time);
     cqtd_vs_cpu, one small step with the CQTD of BSRNN-M (T-F) and of HiFiGAN
     (time, LS) against the CPU at phase 6's limits, TF32 as the control; utmos,
     UTMOS at its published widths with seeded weights (3 waves of 2.3-3.9 s at
     their lengths, and padded to a 4 s bucket through the masked forward, one at
     a time and as a batch of 3): card vs CPU within 2e-4, masked vs exact within
     1e-4, ms a second of audio, one lstm_scan_bidir2 launch a forward (H = 512),
     and as the control the masked limit must refuse, the backward scan fed the
     padded input unreversed; crepe, CREPE full with seeded weights in torchcrepe's
     layout, 32 frames' posteriors card vs CPU within 1e-4, frames a second;
     eval_cli, run_inference on the synthetic set with seeded BSRNN-M weights, then
     python -m nvse_tpu_torch.metrics in this process on its output (lsd with 2
     spawned workers, stoi, pesq, mcd, evaluate with CREPE from a seeded
     checkpoint and utmos from a seeded lightning-layout checkpoint, both on the
     card): every number finite, the seconds of each; then (eval_kernels) a row
     for every shape those paths launched (UTMOS's lstm_scan_bidir2 at T x 1 and 3
     rows, H = 512, on csrc/lstm_scan_wide.cu kScanBidir);
 20. serving export (nvse_tpu_torch/infer/export.py; the kernels as registered
     operators, ops/library.py): export, BSRNN-M exported on the card at B=8 x
     1024 in float32 and bfloat16, saved, loaded in this process and decoded: 16
     lstm_scan_fused launches a forward from the artifact, its output against the
     live engine's (float32 within 1e-5, bfloat16 within 1e-3 of the wave's peak),
     the export and load seconds, the artifact's MB, its decode RTF beside the live
     engine's (interleaved live, artifact, artifact, live); at serving's bucket (8 x
     128 frames, float32) an artifact each of ConvTasNet with fused_tcn 1 (24 tail + 24
     statistics launches a forward; zero initial phase, as HD-Demucs), GCRN (2 lstm_scan_bidir2, the cluster kernel),
     HD-Demucs (2 lstm_scan_bidir2 through lstm_scan_fused's projection route) and
     causal BSRNN-M (8 lstm_scan + 8 lstm_scan_fused), each within 1e-5 of its live
     engine; the export CLI in this process on HiFiGAN V1 with a symbolic time axis
     (its round-trip check), the artifact at two lengths against the live engine with
     no kernel launched; then (export_kernels) rows for the shapes they launched;
 21. multi-GPU (nvse_tpu_torch/parallel): dryrun, the port's dry run (python -m
     nvse_tpu_torch.parallel.dryrun --n 4: a DP GAN step of a tiny BSRNN over 4
     ranks, a dp x sp (2 x 2) step within 1e-3 of it, a checkpoint saved by rank 0,
     restored on every rank and continued within 1e-5); dp_train, BSRNN-M's GAN
     step at full width, batch 16 x 16384, in float32 and bfloat16 over the ranks
     (NCCL with a card a rank where there are 2 or more cards, 4 ranks on 4; else 2
     ranks sharing cuda:0 over gloo), its losses, AdamW first moments and updates
     against this process's one-step of phase 5's config (float32 at phase 6's
     limits, bfloat16 at its own), 32 launches a step of each training kernel on
     every rank, the states equal on every rank, ms a step and each rank's compute
     and NCCL device time and idle share; sp_train, the same over a dp x sp mesh
     (BSRNN's trunk sequence-parallel: 34 bands and 65 frames split over 2 seq
     ranks, an all-to-all at each transpose), G and D within 1e-3 of the DP step;
     dp_serve, the engine with infer_dp_devices -1 (a replica a card; two sharing
     cuda:0 on a one-card machine) at B = 8 x 1024 against the one-card decode,
     RTF. The ranks count their launches in their own processes and write them to
     files that this process merges; every shape they launched (their local batch,
     sp's band and frame slices) gets its kernel-vs-plain row (parallel_kernels);
 22. C7, the shapes and the dtype that no resident kernel takes (c7_kernels):
     every LSTM wrapper against its plain version at H = 1024 (4 rows x 6 steps:
     the step-wise kernels of csrc/lstm_stepwise.cu, one launch a step, both scans
     of lstm_scan_bidir2 / lstm_scan_bidir in each step's launch) and at H = 100 and
     (C, H) = (102, 102) (padded to multiples of 8 and 4 by the wrappers), in
     float32, bfloat16 and float16 (float16: the step-wise kernels for the
     inference scans, the resident training kernels below H = 768, the dW
     reduction's tensor cores), the float16 TCN tail and gLN statistics at
     ConvTasNet's decode shape, and the float16 instances of the resident training
     kernels beside bfloat16's at BSRNN-M's, GCRN's and HD-Demucs's training shapes
     (544 x 65, 1040 x 34, 16 x 65, 63 x 16; a cuDNN LSTM layer's forward +
     backward in the same dtype as their library time; c7_f16_vs_bf16 gives the
     time ratio) (these rows held only); a BSRNN at feature_dim 102
     (num_repeat 2) decoding through InferenceEngine in float32 and bfloat16 (the
     fused kernel at the padded 104, 4 launches a forward) against the CPU's plain
     path, and its GAN step against the CPU's plain step (phase 6's limits and
     control); float16 GAN steps of BSRNN-M (feature_dim 128, num_repeat 2) and
     ConvTasNet (full width, one repeat of its 8 blocks: every tail shape of the
     model; the tail kernel under autograd) against the CPU's plain float16 step; then rows for the shapes those paths launched;
 23. the per-step ablation harness (scripts/profile_torch_lstm_step.py) in this
     process at its four shapes in float32 and bfloat16: five variants of one
     direction of csrc/lstm_fused.cu (H = 128) and csrc/lstm_fused_wide.cu
     (H = 256), each against its plain version, `full` against the forward half
     of lstm_scan_fused, and the split of a step into input, products,
     nonlinearities and floor (lstm_step_ablation, lstm_step_split);
 24. each main path above sets the launch counts to 0 when it starts and
     reads them per wrapper and shape when it ends; every other shape that a
     main path launched (serving's 128-frame bucket, the validations, the
     offline decodes beside the streams, the joint CLI's validation and
     serving buckets, ConvTasNet's serving buckets, the bench's scans and
     fused BiLSTMs, HD-Demucs's lstm_scan_bidir2 at its bottleneck and its
     serving bucket, the time steps' tails) gets its
     kernel-vs-plain row in the dtype it ran in, and a launch at a shape with
     no row fails the run;
 25. print the kernels line (one entry per kernel, shape and dtype, each
     with its launches summed over the main paths; the redesigned dW_hh
     reduction, wide and narrow fused BiLSTMs, narrow and wide scans (the
     training forwards among them), narrow and wide backward recurrences, the
     two-scan LSTM's routes and the TCN tail name their design and plan; the
     gLN statistics kernel has its own entry, tcn_gln_stats),
     then the ok line.
Exits nonzero without output when no CUDA GPU is visible.
"""
import contextlib
import functools
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nvse_tpu_torch.ops._measure import cudnn_lstm, launch_delta, no_weight_compaction

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()                   # every phase line gives its seconds since the start

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float16: 989e12}
PEAK_BYTES = 3.35e12
# kernel vs plain: float32 sums in another order over up to 1024 dependent
# steps; bfloat16 rounds h to 8 bits each step (ulp 2^-8 below 1), and a
# one-ulp flip moves later steps by a few ulps; float16 rounds to 11 bits
# (ulp 2^-11 below 1), the same few ulps
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 1e-2}
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}
# generator output on the card vs the CPU's plain path, float32 (the tests'
# tolerances for the whole model: rtol 2e-3, atol 2e-4)
MODEL_RTOL, MODEL_ATOL = 2e-3, 2e-4


def say(**kw):
    print(json.dumps({**kw, "t": round(time.time() - T0, 1)}), flush=True)


def cuda_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """The device time of fn's kernels a call, from torch.profiler (CUPTI): the sum of
    the kernels' own time over `iters` calls, over iters; None when the trace shows
    no device time (then the wall time of cuda_ms is all there is). Whole only in a
    process's first profiler sessions: after the training loop's scheduled trace
    (phase_train_knobs) it reads less than the kernels took, so the smoke itself
    never calls it (scripts/smoke_torch_phases.py --phases gln_shapes does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    return total / 1e3 / iters if total > 0 else None


def cuda_once(fn):
    """fn() and the ms of that one call (CUDA events around it, synchronised):
    the plain versions' time, from the call whose result the kernel is held
    against (a plain version repeats the kernel's arithmetic op by op and is
    no yardstick of speed; one call of it is measurement enough)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_build():
    from nvse_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build_all()
    secs = time.time() - t0
    for name in libs:
        ptxas = [l.strip() for l in _build.build_log(name).splitlines()
                 if "registers" in l or "spill" in l]
        say(phase="build", source=f"nvse_tpu_torch/csrc/{name}.cu", ptxas=ptxas)
    say(phase="build", seconds=round(secs, 3), libraries=sorted(libs))


def _lstm_inputs(R, T, C, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    b = 1.0 / math.sqrt(H)
    x = torch.randn(R, T, C, generator=g)
    w = [torch.empty(s).uniform_(-b, b, generator=g)
         for s in [(C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]]
    return [t.to("cuda", dtype) for t in [x, *w]]


def _cudnn_bilstm(args):
    x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b = args
    return cudnn_lstm([(w_ih_f, w_hh_f, b_f), (w_ih_b, w_hh_b, b_b)], x.dtype,
                       batch_first=True)


def _bound(nbytes, ops, dtype):
    """(bound ms, what binds it): the larger of bytes over the memory rate
    and operations over the peak rate of the type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _bound_ms(R, T, C, H, dtype):
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (R * T * C + 2 * (C * 4 * H + H * 4 * H + 4 * H) + R * T * 2 * H) * item
    ops = 2 * R * T * 2 * (C + H) * 4 * H
    return (*_bound(nbytes, ops, dtype), ops)


# lstm_scan_fused as (label, rows, steps): the time and band BiLSTMs of a decode at B=8 x
# 1024, and the band BiLSTM of a streaming chunk of 8 streams (8 x 80 frames), of one
# stream (80) and of one context-recompute window (96)
FUSED_SHAPES = (("time", 272, 1024), ("band", 8192, 34), ("band_chunk", 640, 34),
                ("band_chunk1", 80, 34), ("band_window", 96, 34))
# a ragged case of csrc/lstm_fused.cu held against its plain version on no main path:
# 203 rows (no multiple of a tile), 37 steps (odd), C = 124 (bfloat16 rows of x not
# 16-byte aligned), H = 120 (units past H in the last block of a cluster)
FUSED_RAGGED = ("ragged", 203, 37, 124, 120)


def _source(name, H, R=None, dtype=None):
    """The csrc path of the kernel that the wrapper `name` launches at H (the
    smoke's lstm_bwd_dw is the wrapper lstm_dw_hh); for the training kernels
    at R rows and dtype, the one `train_route` picks on this card."""
    from nvse_tpu_torch.ops import lstm as L

    if name in L._TRAIN_KERNELS and R is not None:
        stem = _train_route(name, H, dtype, R)[0]
    else:
        stem = L._kernel_source({"lstm_bwd_dw": "lstm_dw_hh"}.get(name, name), H, dtype)
    return f"nvse_tpu_torch/csrc/{stem}.cu"


def _train_route(name, H, dtype, R):
    """(kernel stem, its plan) of the training wrapper `name` (lstm_fwd_hc,
    lstm_bwd) at (R, H, dtype) on this card, as the wrapper picks it (at H
    padded to a multiple of 8)."""
    from nvse_tpu_torch.ops import lstm as L

    H = L.lstm_padding(H)[0]
    probe = torch.empty(1, R, 4 * H, device="cuda", dtype=dtype)
    return L._card_train_route(name, probe, R, H)


DTYPES = (torch.float32, torch.bfloat16)


def phase_kernels(cases, phase="kernel_vs_plain"):
    """lstm_scan_fused at each (label, rows, steps, C, H, dtype) of cases (C = H
    = 128: BSRNN-M, csrc/lstm_fused.cu; 256: BSRNN-L, csrc/lstm_fused_wide.cu),
    with the kernel fed its two W_hh swapped as the control the limit must
    refuse."""
    from nvse_tpu_torch.ops.lstm import lstm_scan_fused, lstm_scan_fused_plain

    rows = []
    for label, R, T, C, H, dtype in cases:
        args = _lstm_inputs(R, T, C, H, dtype, seed=R + T)
        lib = _cudnn_bilstm(args)
        x, wif, wib, bf, bb, whf, whb = args
        with torch.inference_mode(), no_weight_compaction():
            got = lstm_scan_fused(*args)
            ref, plain_ms = cuda_once(lambda: lstm_scan_fused_plain(*args))
            err = (got.float() - ref.float()).abs().max().item()
            lib_err = (lib(args[0])[0].float() - ref.float()).abs().max().item()
            ctl = lstm_scan_fused(x, wif, wib, bf, bb, whb, whf)
            control = (ctl.float() - ref.float()).abs().max().item()
            ms = cuda_ms(lambda: lstm_scan_fused(*args), iters=10)
            library_ms = cuda_ms(lambda: lib(args[0]), iters=10)
        bound, bound_by, ops = _bound_ms(R, T, C, H, dtype)
        row = dict(name="lstm_scan_fused", shape=label, rows=R, steps=T, C=C, H=H,
                   dtype=DT_NAME[dtype], source=_source("lstm_scan_fused", H, dtype=dtype),
                   design=_design("lstm_scan_fused", H, dtype, R=R, T=T, C=C),
                   max_abs_err=err, tol=TOL[dtype], control_max_abs_err=control,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by,
                   tflops=ops / (ms * 1e-3) / 1e12)
        say(phase=phase, **row)
        if not (err <= TOL[dtype]):
            raise SystemExit(f"lstm_scan_fused {label} H={H} {DT_NAME[dtype]}: max abs err "
                             f"{err} over tolerance {TOL[dtype]}")
        if T > 1 and not (control > TOL[dtype]):
            raise SystemExit(f"lstm_scan_fused {label} H={H} {DT_NAME[dtype]}: the control "
                             f"with the two W_hh swapped ({control}) passes the tolerance")
        rows.append(row)
    return rows


# parameters of the generators at full width (BSRNN-L: the paper's 38.61 M less the
# 32 x 1024 b_hh entries that the port sums into one LSTM bias)
N_PARAMS = {"bsrnn_l": 38_572_293}


def _tag(name, phase):
    """Phase names: BSRNN-M's plain, the other configs' prefixed (bsrnn_l_decode)."""
    return phase if name == "bsrnn" else f"{name}_{phase}"


def phase_decode(name="bsrnn"):
    """Full-width BSRNN decode through the engine, f32 and bf16: BSRNN-M
    (csrc/lstm_fused.cu) or BSRNN-L (csrc/lstm_fused_wide.cu), 16 launches
    of its fused kernel per forward and none of the other."""
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.ops.lstm import _kernel_source, _reset_counts, lstm_scan_fused
    from nvse_tpu_torch.ops.spectral import mel_spectrogram

    h = _config(name)
    kernel = _kernel_source("lstm_scan_fused", int(h.feature_dim))
    B, T, iters = 8, 1024, 5
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((B, h.num_mels, T)).astype(np.float32) - 4.0)
    audio_sec = B * (T - 1) * h.hop_size / h.sampling_rate
    per_forward = 2 * int(h.num_repeat)            # time + band BiLSTM per BSNet

    _reset_counts(*_all_counters().values())       # main path starts here
    wavs = {}
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(_config(name, compute_dtype=dtype), device="cuda")
        n_params = sum(p.numel() for p in eng.generator.parameters())
        melc = mel.to("cuda")
        n0 = dict(lstm_scan_fused.launches_by_kernel)
        wav = eng.forward(melc)                    # warmup
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        for _ in range(iters):
            wav = eng.forward(melc)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
        launches = launch_delta(lstm_scan_fused.launches_by_kernel, n0)
        if launches != {kernel: per_forward * (iters + 1)}:
            raise SystemExit(f"{name} {dtype} decode: kernel launches {launches} for {iters + 1} "
                             f"forwards, expected {per_forward} of {kernel} per forward")
        if wav.shape != (B, (T - 1) * h.hop_size) or not torch.isfinite(wav).all():
            raise SystemExit(f"{name} {dtype} decode: bad output {tuple(wav.shape)} "
                             f"finite={bool(torch.isfinite(wav).all())}")
        if name in N_PARAMS and n_params != N_PARAMS[name]:
            raise SystemExit(f"{name} has {n_params} parameters, not {N_PARAMS[name]}")
        wavs[dtype] = wav
        say(phase=_tag(name, "decode"), dtype=dtype, batch=B, frames=T, parameters=n_params,
            wall_ms=wall * 1e3, rtf=audio_sec / wall,
            launches_per_forward={k: v // (iters + 1) for k, v in launches.items()},
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del eng

    w32, wbf = wavs["float32"], wavs["bfloat16"]
    margs = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size, h.win_size, h.fmin,
             h.sampling_rate / 2)
    mel_l1 = (mel_spectrogram(w32, *margs) - mel_spectrogram(wbf, *margs)).abs().mean().item()
    wav_rel = ((w32 - wbf).norm() / (w32.norm() + 1e-9)).item()
    main_counts = _shape_counts()                  # main path ends here
    say(phase=_tag(name, "decode"), bf16_vs_f32_mel_l1=mel_l1, bf16_vs_f32_wav_rel_l2=wav_rel)

    # the card's output against the CPU's plain path, same weights, small input
    small = mel[:2, :, :64]
    cpu = InferenceEngine(h, device="cpu").forward(small)
    gpu = InferenceEngine(h, device="cuda").forward(small).cpu()
    err = (gpu - cpu).abs()
    ok = bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all())
    say(phase=_tag(name, "decode_vs_cpu_plain"), batch=2, frames=64,
        max_abs_err=err.max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL, ok=ok)
    if not ok:
        raise SystemExit(f"{name} decode on the card disagrees with the CPU plain path")
    return main_counts


def phase_serve(name="bsrnn"):
    """run_inference on the synthetic set: 6 files in one batch of 8 at the
    128-frame bucket, through the model's fused kernel alone."""
    from nvse_tpu_torch.infer import run_inference
    from nvse_tpu_torch.ops.lstm import _kernel_source, _reset_counts, lstm_scan_fused

    h = _config(name)
    _reset_counts(*_all_counters().values())       # this main path starts here
    with tempfile.TemporaryDirectory() as out:
        h.test_output_dir = out
        lines = []
        stats = run_inference(h, log_fn=lines.append, device="cuda")
        written = sorted(os.listdir(out))
    counts = _shape_counts()                       # ... and ends here
    launches = {k: dict(c.launches_by_kernel) for k, c in _all_counters().items() if c.launches}
    want = {"lstm_scan_fused": {_kernel_source("lstm_scan_fused", int(h.feature_dim)):
                                lstm_scan_fused.launches}}
    if stats["files"] != 6 or len(written) != 6 or launches != want:
        raise SystemExit(f"{name} serving: {stats} wrote {written}, launches {launches}")
    say(phase=_tag(name, "serve"), line=lines[-1], files=stats["files"], rtf=stats["rtf"],
        launches=launches, launches_by_shape=_str_keys(counts))
    return counts


# training shapes at batch 16 x 16384 samples (65 frames) as (label, rows, steps, H):
# BSRNN-M's time and band BiLSTMs (34 bands, H = 128, csrc/lstm_scan.cu mode kFwdHc and
# csrc/lstm_bwd.cu) and GCRN's
# group LSTMs (H = 448, the wide kernels of csrc/lstm_scan_wide.cu and csrc/lstm_bwd_wide.cu)
TRAIN_SHAPES = (("time", 544, 65, 128), ("band", 1040, 34, 128), ("gcrn", 16, 65, 448))
# BSRNN-L's (H = 256, csrc/lstm_scan_wide.cu and csrc/lstm_bwd_wide.cu)
L_TRAIN_SHAPES = (("time", 544, 65, 256), ("band", 1040, 34, 256))
# training kernels vs plain, as max abs error over max(1, max |plain|):
# float32 sums in another order; bfloat16 stores hs, cs and dx with 8 bits
# of mantissa and the two may round a value apart. The dW reduction sums
# the same stored values in float32 on both sides and returns float32, so
# it is held at the float32 limit in both dtypes. Its control, which the
# limit must refuse: the plain reduction with the last 256 of its
# (step, row) pairs dropped.
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 1e-2}
DW_TOL, DW_CONTROL_ROWS = 1e-4, 256
# one training step on the card vs the CPU's plain path, float32: losses at
# a relative error of STEP_RTOL, AdamW first moments at a per-tensor
# relative L2 of MOMENT_REL (floored at 1e-4 of the largest moment); cuFFT,
# cuDNN and cuBLAS sum in other orders. Their control, which both limits
# must refuse: the same card step with TF32 on in matmuls and cuDNN. On the
# H100 the step read 5.3e-7 / 1.6e-4 and the control 3.1e-4 / 6.8e-2; each
# limit sits near the geometric mean of the two.
STEP_RTOL, MOMENT_REL = 1e-5, 3e-3
# The time models' small steps (TIME_TRAIN) move under float32 rounding alone: the
# CPU's own step on the batch scaled by 1 + 1e-7 (one rounding of the input) moves
# some moments by a percent (ConvTasNet's PReLU slopes, HD-Demucs's deep encoder
# biases: activations a 1e-7 change carries across a ReLU / PReLU kink). For them
# each limit is the larger of the fixed one and PERTURB_FACTOR times that CPU
# step's own reading, and the TF32 control must still fail it.
PERTURB, PERTURB_FACTOR = 1e-7, 3.0
# float16 steps (C7) against the CPU's plain float16 step: losses at F16_STEP_RTOL, about
# ten float16 roundings (2^-11 each; the card and the CPU round at other places: cuBLAS's
# float16 products may reduce in float16, the CPU's in float32), and moments at
# F16_MOMENT_REL, the CPU test's limit against JAX's float16 step
# (tests/test_torch_port_c7.py: 0.076 measured there), or PERTURB_FACTOR times the
# CPU's own step under one float16 rounding of its input (F16_PERTURB), whichever is
# larger; no TF32 control (TF32 rounds float32 products, which a float16 trunk hardly has)
F16_STEP_RTOL, F16_MOMENT_REL, F16_PERTURB = 5e-3, 0.1, 2.0 ** -11


def _err(got, ref):
    """max |got - ref| and that over max(1, max |ref|)."""
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(1.0, ref.float().abs().max().item())


def _training_counters():
    from nvse_tpu_torch.ops import lstm as L

    return {"lstm_fwd_hc": L.lstm_fwd_hc, "lstm_bwd": L.lstm_bwd,
            "lstm_bwd_dw": L.lstm_dw_hh, "lstm_scan_fused": L.lstm_scan_fused,
            "lstm_scan": L.lstm_scan, "lstm_scan_stateful": L.lstm_scan_stateful}


def _launched(counters, fn):
    """fn() and the launches of each counter that it made."""
    n0 = {k: c.launches for k, c in counters.items()}
    out = fn()
    return out, {k: c.launches - n0[k] for k, c in counters.items()}


def _all_counters():
    from nvse_tpu_torch.ops._measure import counted_wrappers

    return counted_wrappers()


def _shape_counts():
    """The launches of every wrapper per shape since its counts were set to 0."""
    return {k: dict(c.launches_by_shape) for k, c in _all_counters().items()}


def _str_keys(counts):
    """counts per wrapper and shape, for a JSON line."""
    return {k: {str(s): n for s, n in d.items()} for k, d in counts.items() if d}


def _dw_library(hs, dx):
    """The dW yardstick: one cuBLAS GEMM of h_{t-1}^T and dx_proj returning what
    the kernel returns, float32 (H, 4H), through torch.mm's out_dtype where this
    build takes it (bf16 in, float32 out); else in the input dtype, its output
    rounded. -> (the call, what it is)."""
    H, G = hs.shape[-1], dx.shape[-1]
    a, b = hs[:-1].reshape(-1, H).T, dx[1:].reshape(-1, G)
    if hs.dtype == torch.float32:
        return (lambda: torch.mm(a, b)), "cuBLAS GEMM, float32"
    try:
        torch.mm(a[:, :8], b[:8], out_dtype=torch.float32)
        return ((lambda: torch.mm(a, b, out_dtype=torch.float32)),
                "cuBLAS GEMM, bfloat16 in, float32 out (torch.mm out_dtype)")
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: torch.mm(a, b)), "cuBLAS GEMM, bfloat16 out (out_dtype not taken here)"


def _design(name, H, dtype, R=None, T=None, C=None):
    """The design of the redesigned kernels at a row's shape, for the kernels
    line: the dW_hh reduction's, the wide fused BiLSTM's, the narrow fused
    BiLSTM's, the narrow and wide scans' (R: the rows of one direction; the
    training forward is a mode of the scans), the narrow and wide backward's
    plans (ops/lstm.py `dw_plan`, `fused_wide_plan`, `fused_narrow_plan`,
    `scan_narrow_plan`, `scan_wide_plan`, `bwd_narrow_plan`, `bwd_wide_plan`)
    as this card takes them; None elsewhere."""
    from nvse_tpu_torch.ops import lstm as L

    if name != "lstm_bwd_dw" and L._stepwise(H, dtype, name):
        p = L.stepwise_plan(R or 1, L.lstm_padding(H)[0], 2 if name == "lstm_scan_bidir" else 1)
        return _stepwise_design(p)
    H, C = L.lstm_padding(H, C)               # the shape the wrapper launches at
    wide = H > L._MAX_H
    f16 = dtype == torch.float16
    mt = "f16" if f16 else "bf16"             # the tensor cores' operand type
    split = "carry dgates split hi + lo" + (" at a power-of-two row scale" if f16 else "")
    if name in L._TRAIN_KERNELS:              # the kernel that train_route picks
        stem, p = _train_route(name, H, dtype, R)
        wide = stem != L._TRAIN_KERNELS[name][0]
        if name == "lstm_fwd_hc" and not wide:
            mma = f"mma.sync m16n8k16 {mt}, f32 h split hi + lo"
            f32 = "f32 FMA, 8 k-slices a unit" + (", passes of 16 rows" if p["inst"] > 16 else "")
            return (f"{mma if p['tensor_cores'] else f32}, clusters of {p['cluster']} x "
                    f"{p['units']} units, W_hh in registers, {p['ntiles']} tiles of <= {p['rows']} "
                    f"rows ({p['tile_rows']}-row instance) on {p['clusters']} clusters, "
                    f"{p['rounds']} a cluster, x ring of {p['stages']} steps, h (and lo) by "
                    f"st.async on mbarriers, exact cell")
        if name == "lstm_bwd" and not wide:
            mma = f"mma.sync m16n8k16 {mt}, W_hh column slice in shared memory, {split}"
            f32 = "f32 FMA, W_hh in registers (8 k-slices / column slices), reduce-scatter"
            return (f"{mma if p['tensor_cores'] else f32}, clusters of {p['cluster']} x "
                    f"{p['units']} units, {p['ntiles']} tiles of <= {p['rows']} rows "
                    f"({p['tile_rows']}-row instance) on {p['clusters']} clusters, {p['rounds']} "
                    f"a cluster, ring of {p['stages']} steps, carry shares by st.async into "
                    f"distributed shared memory (no grid barrier), exact cell")

    if name in L._SCAN_WIDE_MODE and wide:
        dirs = 2 if name == "lstm_scan_bidir" else 1
        p = L._scan_wide_card_plan(0, R, H, dtype, dirs, name)
        mma = (f"mma.sync m16n8k16 {mt}, "
               + ("f32 h split hi + lo" if name == "lstm_fwd_hc" else "h as stored"))
        return (f"{mma if p['tensor_cores'] else 'f32 FMA'}, {p['groups']} row groups x "
                f"{H // p['units']} slices of {p['units']} units a direction ({p['blocks']} "
                f"blocks, {p['launch_dirs']} direction(s) a launch), {p['tiles_per_group']} "
                f"tiles of <= {p['tile_rows']} rows a group, W_hh column slice resident, x_proj "
                f"prefetched by cp.async, one grid barrier a step")

    if name in ("lstm_scan_fused", "lstm_step_variant") and H <= L._MAX_H:
        p = L._fused_narrow_card_plan(0, R, C, H, dtype, 0)
        return (f"{'mma.sync m16n8k16 bf16' if p['tensor_cores'] else 'f32 FMA'}, clusters of "
                f"{p['cluster']} x {p['units']} units, weights resident (k = C + H whole), "
                f"{p['ntiles']} tiles of <= {p['rows']} rows ({p['tile_rows']}-row instance) on "
                f"{p['clusters']} clusters a direction, {p['rounds']} a cluster, x ring of "
                f"{p['stages']} steps, h by st.async on mbarriers (no barrier a step)")
    if name == "lstm_bwd_dw":
        p = L._dw_card_plan(0, T, R, H, dtype)
        mma = f"mma.sync m16n8k16 {'bf16' if dtype == torch.bfloat16 else 'f16'}"
        return (f"{'f32 FMA 8x8/thread' if dtype == torch.float32 else mma}, "
                f"128x128 tiles, cp.async ring of {p['stages']} x {p['tile_k']} rows, "
                f"{p['nsplit']} splits of {p['rows_per_split']} rows")
    if name in ("lstm_scan", "lstm_scan_stateful", "lstm_scan_bidir") and H <= L._MAX_H:
        dirs = 2 if name == "lstm_scan_bidir" else 1
        p = L._scan_card_plan(0, R, H, dtype, dirs)
        return (f"{'mma.sync m16n8k16 bf16' if p['tensor_cores'] else 'f32 FMA, 8 k-slices a unit'}"
                f", clusters of {p['cluster']} x {p['units']} units, W_hh in registers, "
                f"{p['ntiles']} tiles of <= {p['rows']} rows ({p['tile_rows']}-row instance) on "
                f"{p['clusters']} clusters a direction, {p['rounds']} a cluster, x ring of "
                f"{p['stages']} steps, h by st.async on mbarriers, exact cell")
    if name == "lstm_bwd" and wide:
        p = L._bwd_wide_card_plan(0, R, H, dtype)
        mma = f"mma.sync m16n8k16 {mt}, {split}"
        return (f"{mma if p['tensor_cores'] else 'f32 FMA'}, {p['groups']} row groups x "
                f"{H // p['units']} slices of {p['units']} units ({p['blocks']} blocks), {p['tiles_per_group']} tiles of <= {p['tile_rows']} rows "
                f"a group, W_hh column slice resident, carry shares of R_g x H a block, one grid "
                f"barrier a step")
    if name in ("lstm_scan_fused", "lstm_step_variant") and 128 < H and L._fused_route(C, H) == "lstm_fused_wide":
        p = L._fused_wide_card_plan(0, R, C, H, dtype, 0)
        return (f"{'mma.sync m16n8k16 bf16' if dtype == torch.bfloat16 else 'f32 FMA'}, "
                f"{p['units']} units x {p['tile_rows']}-row tiles, cp.async ring of "
                f"{p['stages']} x {p['kc']} k, {p['groups']} row groups")
    return None


def _stepwise_design(p):
    """csrc/lstm_stepwise.cu's plan (ops/lstm.py `stepwise_plan`) in words."""
    return (f"f32 FMA, one launch a step, blocks of {p['tile_rows']} rows x {p['units']} units "
            f"({p['blocks']} blocks, {p['scans']} scan(s) a launch), W_hh staged from L2 "
            f"each step, h in float32 buffers by step parity, exact cell")


def phase_train_kernels(shapes=TRAIN_SHAPES, phase="kernel_vs_plain", dtypes=DTYPES,
                        layer_library=False):
    """lstm_fwd_hc, the lstm_bwd recurrence and the dW_hh reduction at the
    BSRNN-M and GCRN training shapes (or BSRNN-L's, or the ranks'), against
    their plain versions, in `dtypes`; at the BSRNN shapes, cuDNN's BiLSTM
    forward + backward beside the port's. layer_library: at every shape, one
    cuDNN LSTM layer's forward + backward in the row's dtype is the library
    time of the forward's and the recurrence's rows (a layer does both
    directions and the projection: a yardstick, not the same function)."""
    from nvse_tpu_torch.ops import lstm as L

    rows = []
    for label, R, T, H in shapes:
        G = 4 * H
        for dtype in dtypes:
            layer = _bilstm_fwd_bwd_ms(R, T, H, dtype) if layer_library else None
            g = torch.Generator().manual_seed(R + T)
            b = 1.0 / math.sqrt(H)
            xp = (0.5 * torch.randn(T, R, G, generator=g)).to("cuda", dtype)
            whh = torch.empty(H, G).uniform_(-b, b, generator=g).to("cuda", dtype)
            dhs = torch.randn(T, R, H, generator=g).to("cuda", dtype)
            item = xp.element_size()
            ops = 2 * R * T * H * G
            with torch.inference_mode():
                hs, cs = L.lstm_fwd_hc(xp, whh)
                dx = L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh)
                dw = L.lstm_dw_hh(hs, dx)
                (hs_ref, cs_ref), fwd_plain_ms = cuda_once(lambda: L.lstm_fwd_hc_plain(xp, whh))
                (dx_ref, _), bwd_plain_ms = cuda_once(lambda: L.lstm_bwd_plain(xp, hs, cs, dhs, whh))
                dw_ref, dw_plain_ms = cuda_once(lambda: L.lstm_dw_hh_plain(hs, dx))
                errs = {"lstm_fwd_hc": max(_err(hs, hs_ref), _err(cs, cs_ref), key=lambda e: e[1]),
                        "lstm_bwd": _err(dx, dx_ref), "lstm_bwd_dw": _err(dw, dw_ref)}
                # the forward's and the recurrence's control: W_hh's rows reversed
                w_rev = whh.flip(0).contiguous()
                fwd_control = _err(L.lstm_fwd_hc(xp, w_rev)[0], hs_ref)[1]
                bwd_control = _err(L.lstm_bwd_recurrence(xp, hs, cs, dhs, w_rev), dx_ref)[1]
                dx_ctl = dx.clone()
                dx_ctl.view(-1, G)[-DW_CONTROL_ROWS:] = 0
                dw_control = _err(L.lstm_dw_hh_plain(hs, dx_ctl), dw_ref)[1]

                dw_library, dw_library_name = _dw_library(hs, dx)
                dw_library_err = _err(dw_library(), dw_ref)[1]
                dw_library_ms = cuda_ms(dw_library, iters=10)
                times = {
                    "lstm_fwd_hc": (cuda_ms(lambda: L.lstm_fwd_hc(xp, whh), iters=10), fwd_plain_ms),
                    "lstm_bwd": (cuda_ms(lambda: L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh), iters=10),
                                 bwd_plain_ms),
                    "lstm_bwd_dw": (cuda_ms(lambda: L.lstm_dw_hh(hs, dx), iters=10), dw_plain_ms),
                }
            bounds = {
                "lstm_fwd_hc": _bound((R * T * G + H * G + 2 * R * T * H) * item, ops, dtype),
                "lstm_bwd": _bound((2 * R * T * G + 3 * R * T * H + H * G) * item, 2 * ops, dtype),
                "lstm_bwd_dw": _bound(R * T * (H + G) * item + H * G * 4, ops, dtype),
            }
            flops = {"lstm_fwd_hc": ops, "lstm_bwd": 2 * ops, "lstm_bwd_dw": ops}
            tols = {"lstm_fwd_hc": TRAIN_TOL[dtype], "lstm_bwd": TRAIN_TOL[dtype],
                    "lstm_bwd_dw": DW_TOL}
            for name in ("lstm_fwd_hc", "lstm_bwd", "lstm_bwd_dw"):
                (err, rel), (ms, plain_ms), (bound, bound_by) = errs[name], times[name], bounds[name]
                row = dict(name=name, shape=label, rows=R, steps=T, H=H, dtype=DT_NAME[dtype],
                           source=_source(name, H, R, dtype),
                           max_abs_err=err, rel_err=rel, tol=tols[name], ms=ms,
                           plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=bound_by,
                           tflops=flops[name] / (ms * 1e-3) / 1e12)
                if name == "lstm_bwd_dw":
                    row.update(library_ms=dw_library_ms, library_rel_err=dw_library_err,
                               library=dw_library_name, control_rel_err=dw_control,
                               design=_design(name, H, dtype, R=R, T=T))
                if name == "lstm_bwd":
                    row.update(control_rel_err=bwd_control, design=_design(name, H, dtype, R=R))
                if name == "lstm_fwd_hc":
                    row.update(control_rel_err=fwd_control, design=_design(name, H, dtype, R=R))
                if layer is not None and name != "lstm_bwd_dw":
                    row.update(library_ms=layer["cudnn_ms"], port_layer_ms=layer["port_ms"],
                               library="cuDNN LSTM layer forward + backward (both directions, "
                                       "projection included; C = H)")
                say(phase=phase, **row)
                if not (rel <= tols[name]):
                    raise SystemExit(f"{name} {label} {DT_NAME[dtype]}: error {err} "
                                     f"({rel} relative) over tolerance {tols[name]}")
                rows.append(row)
            if not (fwd_control > TRAIN_TOL[dtype]):
                raise SystemExit(f"lstm_fwd_hc {label} {DT_NAME[dtype]}: the control with W_hh's "
                                 f"rows reversed ({fwd_control}) passes the tolerance")
            if not (bwd_control > TRAIN_TOL[dtype]):
                raise SystemExit(f"lstm_bwd {label} {DT_NAME[dtype]}: the control with W_hh's "
                                 f"rows reversed ({bwd_control}) passes the tolerance")
            if not (dw_control > DW_TOL):
                raise SystemExit(f"lstm_bwd_dw {label} {DT_NAME[dtype]}: the control with "
                                 f"{DW_CONTROL_ROWS} pairs dropped ({dw_control}) passes "
                                 f"the tolerance {DW_TOL}")
            if label in ("time", "band", "hddemucs"):
                say(phase="bilstm_train_vs_cudnn", shape=label, rows=R, steps=T, H=H,
                    dtype=DT_NAME[dtype], **_bilstm_fwd_bwd_ms(R, T, H, dtype))
    return rows


# lstm_scan / lstm_scan_stateful at the shapes of their paths (H = 128): the
# causal time LSTM of a B=8 x 1024 decode, of one context-recompute window of
# one file (64 + 2 x 16 frames), and of a streaming chunk (64 + 16) of 8 streams
# and of one
SCAN_SHAPES = (("lstm_scan", "decode", 272, 1024), ("lstm_scan", "window", 34, 96),
               ("lstm_scan_stateful", "chunk", 272, 80),
               ("lstm_scan_stateful", "chunk1", 34, 80))


def phase_scan_kernels(cases, phase="kernel_vs_plain"):
    """lstm_scan and lstm_scan_stateful against their plain versions at each
    (name, label, rows, steps, H, dtype) of cases (C = H = 128: BSRNN-M,
    csrc/lstm_scan.cu; 256: BSRNN-L, csrc/lstm_scan_wide.cu),
    with cuDNN's unidirectional LSTM forward on the same x, weights and state
    (it also does the projection x @ W_ih + b, which the port leaves to a
    torch matmul) as the library yardstick."""
    from nvse_tpu_torch.ops import lstm as L

    rows = []
    for name, label, R, T, H, dtype in cases:
        C, G = H, 4 * H
        stateful = name == "lstm_scan_stateful"
        g = torch.Generator().manual_seed(R + T)
        b = 1.0 / math.sqrt(H)
        x = torch.randn(T, R, C, generator=g).to("cuda", dtype)
        w_ih, bias, whh = (torch.empty(sh).uniform_(-b, b, generator=g).to("cuda", dtype)
                           for sh in ((C, G), (G,), (H, G)))
        h0, c0 = ((0.3 * torch.randn(R, H, generator=g)).to("cuda", dtype) for _ in range(2))
        lib_state = (h0[None], c0[None]) if stateful else None
        item = x.element_size()
        ops = 2 * R * T * H * G
        nbytes = (R * T * (G + H) + H * G) * item
        lib = cudnn_lstm([(w_ih, whh, bias)], dtype)        # time-major, one direction
        with torch.inference_mode(), no_weight_compaction():
            xp = (x @ w_ih + bias).contiguous()
            if stateful:
                nbytes += (R * T * H + 2 * R * H) * item
                run = lambda: L.lstm_scan_stateful(xp, whh, h0, c0)
                plain = lambda: L.lstm_scan_stateful_plain(xp, whh, h0, c0)
            else:
                run = lambda: (L.lstm_scan(xp, whh),)
                plain = lambda: (L.lstm_scan_plain(xp, whh),)
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
            lib_err = (lib(x, lib_state)[0].float() - ref[0].float()).abs().max().item()
            ms = cuda_ms(run, iters=10)
            plain_ms = cuda_ms(plain, iters=2)
            library_ms = cuda_ms(lambda: lib(x, lib_state), iters=10)
            control = None
            if stateful:      # zeros in place of (h0, c0): the limit must refuse it
                z = torch.zeros_like(h0)
                ctl = L.lstm_scan_stateful(xp, whh, z, z)
                control = max((a.float() - r.float()).abs().max().item()
                              for a, r in zip(ctl, ref))
            # W_hh's rows reversed: the limit must refuse it too
            w_rev = whh.flip(0).contiguous()
            ctl = (L.lstm_scan_stateful(xp, w_rev, h0, c0) if stateful
                   else (L.lstm_scan(xp, w_rev),))
            w_control = max((a.float() - r.float()).abs().max().item() for a, r in zip(ctl, ref))
        bound, bound_by = _bound(nbytes, ops, dtype)
        row = dict(name=name, shape=label, rows=R, steps=T, H=H, dtype=DT_NAME[dtype],
                   source=_source(name, H, dtype=dtype), design=_design(name, H, dtype, R=R),
                   max_abs_err=err, tol=TOL[dtype], ms=ms, plain_ms=plain_ms,
                   control_whh_max_abs_err=w_control,
                   library_ms=library_ms, library="cuDNN LSTM forward, projection included",
                   library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by,
                   tflops=ops / (ms * 1e-3) / 1e12)
        if stateful:
            row["control_max_abs_err"] = control
        say(phase=phase, **row)
        if not (err <= TOL[dtype]):
            raise SystemExit(f"{name} {label} H={H} {DT_NAME[dtype]}: max abs err {err} over "
                             f"tolerance {TOL[dtype]}")
        if stateful and not (control > TOL[dtype]):
            raise SystemExit(f"{name} {label} H={H} {DT_NAME[dtype]}: the control with a zero "
                             f"initial state ({control}) passes the tolerance {TOL[dtype]}")
        if (T > 1 or stateful) and not (w_control > TOL[dtype]):
            raise SystemExit(f"{name} {label} H={H} {DT_NAME[dtype]}: the control with W_hh's "
                             f"rows reversed ({w_control}) passes the tolerance {TOL[dtype]}")
        rows.append(row)
    return rows



def _bilstm_fwd_bwd_ms(R, T, H, dtype):
    """One BiLSTM forward + backward at (R, T, C = H): the port's training
    route (torch matmuls + lstm_fwd_hc / lstm_bwd) and cuDNN's LSTM."""
    from nvse_tpu_torch.ops.lstm import lstm_scan_fused

    args = [a.requires_grad_() for a in _lstm_inputs(R, T, H, H, dtype, seed=R)]
    grad = torch.randn(R, T, 2 * H, device="cuda", dtype=dtype)
    lib = _cudnn_bilstm([a.detach() for a in args])
    x_lib = args[0].detach().clone().requires_grad_()

    def port():
        lstm_scan_fused(*args).backward(grad)

    def cudnn():
        lib(x_lib)[0].backward(grad)

    with no_weight_compaction():
        return dict(port_ms=cuda_ms(port, iters=5), cudnn_ms=cuda_ms(cudnn, iters=5))


# config files by phase name where the two differ
CONFIG_FILES = {"joint": "bsrnn_joint_denoise_vocoder", "hifigan": "hifigan_v1",
                "hddemucs": "hddemucas"}
JOINT_TASKS = ("denoise", "vocoder")


def _config(name, **kw):
    """The port's copy of a reference config (bsrnn, gcrn, joint, ...) with overrides."""
    from nvse_tpu_torch.utils import load_config

    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs",
                                 f"{CONFIG_FILES.get(name, name)}_config.json"))
    h.update(kw)
    return h


def _step_args(audio, task, seed):
    """GANTrainer.step's arguments: the batch, or for a joint task the clean
    batch, the input wave (the clean one plus noise for denoise) and the task."""
    if task is None:
        return (audio,)
    if task == "vocoder":
        return audio, audio, task
    g = torch.Generator().manual_seed(seed)
    noise = 0.05 * torch.randn(audio.shape, generator=g).to(audio.device)
    return audio, audio + noise, task


def _audio_batch(B, n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 400, (B, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((B, n))
    return torch.from_numpy(x.astype(np.float32))


def phase_train(model="bsrnn", causal=False, validate=False, cqtd=False):
    """Full-width GAN steps, batch 16 x 16384: BSRNN-M's non-causal config in
    float32 and bfloat16, its causal one (the time LSTM one direction,
    through lstm_scan's residual-saving route) in float32; BSRNN-L (H = 256:
    the wide training kernels of csrc/lstm_scan_wide.cu and csrc/lstm_bwd_wide.cu at
    544 x 65 and 1040 x 34)
    in float32 and bfloat16; GCRN (its four group LSTMs through
    lstm_scan_bidir2's residual-saving route, the wide training kernels at 65
    steps x 16 rows x H = 448) in float32 and bfloat16. Device busy time and
    the idle share from torch.profiler over one more step. With validate,
    GANTrainer.eval_step on a validation crop after the steps: 16 launches
    of the fused inference kernel. The joint BSRNN_24k (34 bands at 24 kHz:
    BSRNN-M's training shapes) trains each task in each dtype from one
    trainer a run, the denoise input the clean batch plus noise. With cqtd,
    BSRNN-M's step with the CQT discriminator at the reference's defaults
    (phase cqtd_train): its first step split into the D and G passes, where
    the D pass must change every CQTD parameter and leave it a finite nonzero
    gradient and the G pass must change none; the CQT's share of the step from
    `_cqt_forms`."""
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    B, iters = 16, 3
    # LSTM launches per step of each training kernel, and the LSTM
    # parameters (3 tensors per direction): BSRNN-M, 8 blocks x (time +
    # band) x directions; GCRN, 2 layers x 2 groups, one direction each
    if model == "gcrn":
        n_lstm, is_lstm = 4, (lambda n: n.startswith("glstm.lstms."))
    else:
        n_lstm, is_lstm = 8 * (1 + 2) if causal else 8 * (2 + 2), (lambda n: ".lstm." in n)
    counters = _all_counters()
    _reset_counts(*counters.values())              # this main path starts here
    dtypes = ("float32",) if causal else ("float32", "bfloat16")
    tasks = JOINT_TASKS if model == "joint" else (None,)
    for dtype, task in [(d, t) for d in dtypes for t in tasks]:
        h = _config(model, compute_dtype=dtype, causal=causal, **({"use_cqtd": True} if cqtd
                                                                   else {}))
        audio = _audio_batch(B, int(h.segment_size), h.sampling_rate, seed=0).to("cuda")
        args = _step_args(audio, task, seed=0)
        tr = GANTrainer(h, device="cuda", steps_per_epoch=2, joint=task is not None)
        before = {n: p.detach().clone() for n, p in
                  [*tr.generator.named_parameters(), *tr.disc.named_parameters()]}
        torch.cuda.reset_peak_memory_stats()
        n0 = {k: (c.launches, dict(c.launches_by_shape), dict(c.launches_by_kernel))
              for k, c in counters.items()}
        if cqtd:                                   # warmup, split into its passes
            cqtd_fails, cqtd_info = _cqtd_passes(tr, args)
        else:
            tr.step(*args)                         # warmup
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(iters):
            metrics = tr.step(*args)
        torch.cuda.synchronize()
        ms = (time.time() - t0) / iters * 1e3
        per_step = {k: (c.launches - n0[k][0]) / (iters + 1) for k, c in counters.items()}

        def per_step_by(i, attr):                  # attr: launches_by_shape or _by_kernel
            return {k: {str(key): n / (iters + 1)
                        for key, n in launch_delta(getattr(c, attr), n0[k][i]).items()}
                    for k, c in counters.items() if c.launches > n0[k][0]}

        by_shape = per_step_by(1, "launches_by_shape")
        by_kernel = per_step_by(2, "launches_by_kernel")
        busy = _busy_ms(lambda: tr.step(*args))
        losses = fetch_scalars(metrics)
        after = dict([*tr.generator.named_parameters(), *tr.disc.named_parameters()])
        unchanged = [n for n, p in after.items() if torch.equal(p.detach(), before[n])]
        lstm = {n: p for n, p in tr.generator.named_parameters() if is_lstm(n)}
        bad_grad = [n for n, p in lstm.items()
                    if p.grad is None or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0]
        if cqtd:
            cqtd_info.update(_cqt_forms(h, B, dtype, busy))
        say(phase="cqtd_train" if cqtd else _tag(model, "train"), causal=causal, dtype=dtype,
            task=task, batch=B, segment=int(h.segment_size), ms_per_step=ms,
            steps_timed=iters, device_busy_ms=busy,
            idle_share=1.0 - busy / ms if busy else "not measured",
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches_per_step=per_step,
            launches_per_step_by_kernel=by_kernel, launches_per_step_by_shape=by_shape,
            lstm_params=len(lstm), losses=losses, **(cqtd_info if cqtd else {}))
        fails = cqtd_fails if cqtd else []
        if not all(math.isfinite(v) for v in losses.values()):
            fails.append(f"non-finite losses {losses}")
        if unchanged:
            fails.append(f"parameters not updated: {unchanged[:5]} ({len(unchanged)})")
        if len(lstm) != 3 * n_lstm or bad_grad:
            fails.append(f"{len(lstm)} LSTM params, without a finite nonzero grad: {bad_grad[:5]}")
        if model != "gcrn":
            enc = {n: p for n, p in tr.generator.named_parameters()
                   if n.startswith("core.encoder.b_")}
            bad_enc = [n for n, p in enc.items() if p.grad is None or p.grad.abs().sum() == 0]
            if not enc or bad_enc:
                fails.append(f"encoder without gradient: {bad_enc}")
        expect = {k: 0 for k in counters}              # no inference kernel inside a step
        expect.update(lstm_fwd_hc=n_lstm, lstm_bwd=n_lstm, lstm_bwd_dw=n_lstm)
        if per_step != expect:
            fails.append(f"launches per step {per_step}, expected {expect}")
        if validate:
            fails += _validate(tr, h, counters, model)
        if fails:
            raise SystemExit(f"train {model} causal={causal} {dtype} task={task}: "
                             + "; ".join(fails))
        del tr, before, after, lstm
        torch.cuda.empty_cache()
    return _shape_counts()                         # ... and ends here


def _device_ms(fn):
    """(ms of NCCL's kernels, ms of every other kernel) on the device during one
    fn(), from torch.profiler (one stream). NCCL's kernels count the time they
    wait for the other ranks too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [0.0, 0.0]
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith(("Optimizer.", "ProfilerStep"))):
            us[not e.name.startswith("nccl")] += e.device_time
    return us[0] / 1e3, us[1] / 1e3


def _busy_ms(fn):
    """Device-busy ms of one fn() from torch.profiler (the sum of its kernel
    times; one stream), or None when the profiler shows no device time."""
    return sum(_device_ms(fn)) or None


def _validate(tr, h, counters, model):
    """GANTrainer.eval_step on the first validation utterance's crop of one
    training segment, as the loop validates with validation_full false: its
    BiLSTMs run no-grad, through the fused inference kernel. -> failures."""
    import random

    from nvse_tpu_torch.data import SegmentDataset, get_dataset_filelist
    from nvse_tpu_torch.ops.lstm import _kernel_source
    from nvse_tpu_torch.train import fetch_scalars

    _, files = get_dataset_filelist(h.input_training_wav_list, h.input_validation_wav_list,
                                    h.raw_wavfile_path)
    ds = SegmentDataset(files, h.segment_size, h.sampling_rate, split=True, shuffle=False,
                        seed=h.seed)
    audio = torch.from_numpy(ds.segment_at(0, random.Random(0x5EED))[None, :])
    n0 = {k: dict(c.launches_by_kernel) for k, c in counters.items()}
    y, metrics = tr.eval_step(audio)
    vals = fetch_scalars(metrics)
    launches = {k: launch_delta(c.launches_by_kernel, n0[k]) for k, c in counters.items()}
    launches = {k: v for k, v in launches.items() if v}
    say(phase=_tag(model, "validation"),
        samples=audio.shape[-1], launches=launches, metrics=vals)
    want = {"lstm_scan_fused": {_kernel_source("lstm_scan_fused", int(h.feature_dim)):
                                2 * int(h.num_repeat)}}
    fails = []
    if launches != want:
        fails.append(f"validation launches {launches}, expected {want}")
    if not all(math.isfinite(v) for v in vals.values()) or not torch.isfinite(y).all():
        fails.append(f"validation not finite: {vals}")
    return fails


def _set_tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# the small step of phase_train_vs_cpu_plain: BSRNN-M narrowed; BSRNN-L at its
# full width (H = 256: the wide training kernels at 34 x 17 and 34 x 34), two
# BSNets; GCRN has no width knobs and runs at its full width (the wide training
# kernels at 17 steps x 2 rows x H = 448), as do the conv T-F vocoders (APNet2's
# and FreeV's widths are fixed); all at batch 2 x 4096 samples. The time domain is
# cut in depth, which its two CPU steps (plain and perturbed) pay for most: the MRF
# vocoders keep one resblock a stage (kernel 3, dilations 1, 3, 5), ConvTasNet one
# repeat (R 1) of its 8 blocks, dilations 1 ... 128
MRF_DEPTH = dict(resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]])
SMALL_STEP = {"bsrnn": dict(feature_dim=16, num_repeat=2), "gcrn": {},
              "bsrnn_l": dict(num_repeat=2), "joint": dict(feature_dim=16, num_repeat=2),
              "apnet": {}, "apnet2": {}, "freeV": {}, "vocos": {},
              # the time domain at full width: the MRF vocoders; ConvTasNet and HD-Demucs (the
              # H = 768 training kernels at 2 rows) with zero initial phase, so that no random
              # draw or Griffin-Lim differs. Their hinge losses give the post convs' biases a
              # gradient of -1 + 1 where every logit is inside the margins: exactly 0 on the
              # CPU, float noise in the card's reductions, and AdamW's first step moves a bias
              # by a good part of lr for any nonzero noise. At learning rate 0 the D update
              # leaves the discriminators as they are on both sides, and the G pass is
              # compared on the same discriminators (the moments are the gradients, lr
              # aside). ConvTasNet's step runs its plain trunk (fused_tcn 0): at this init its
              # gradients amplify the tail kernel's float32 forward differences (PERF.md §6),
              # and the kernel is held at the training shapes by time_kernels.
              "hifigan": dict(MRF_DEPTH), "istftnet": dict(MRF_DEPTH),
              "convtasnet": dict(fused_tcn=0, init_phase="zero", learning_rate=0.0, R=1),
              "hddemucs": dict(init_phase="zero", learning_rate=0.0)}


def phase_train_vs_cpu_plain(model="bsrnn", cqtd=False):
    """A small config, one step on the card and one on the CPU's plain path
    from the same seeded weights and batch; and the control: one more card
    step with TF32 on, which both limits must refuse. The joint model: one
    step of each task. With cqtd, the config with the CQT discriminator at the
    reference's defaults (phase cqtd_vs_cpu)."""
    for task in JOINT_TASKS if model == "joint" else (None,):
        _train_vs_cpu_plain(model, task, cqtd)


def _train_vs_cpu_plain(model, task, cqtd=False, phase=None, perturbed=None, **over):
    """One step of SMALL_STEP[model] (with `over` on top) on the card against the
    CPU's plain step; float32 with the TF32 control, or with over's
    compute_dtype "float16" at the float16 limits; with `perturbed` (default:
    the time models and float16) each limit at least PERTURB_FACTOR times the
    CPU's own step under one rounding of its input. -> the card step's
    launches per wrapper and shape (the counts set to 0 before it)."""
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    h = _config(model, segment_size=4096, batch_size=2, **{**SMALL_STEP[model], **over},
                **({"use_cqtd": True} if cqtd else {}))
    f16 = str(h.get("compute_dtype")) == "float16"
    audio = _audio_batch(2, 4096, h.sampling_rate, seed=1)
    out = {}
    perturbed = (model in TIME_TRAIN or f16) if perturbed is None else perturbed
    runs = ("cuda", "cpu") if f16 else ("cuda", "cuda_tf32", "cpu")
    runs += ("cpu_perturbed",) if perturbed else ()
    perturb = F16_PERTURB if f16 else PERTURB
    counts = {}
    for run in runs:
        tr = GANTrainer(h, device="cpu" if run.startswith("cpu") else "cuda", steps_per_epoch=2,
                        joint=task is not None)
        batch = audio * (1.0 + perturb) if run == "cpu_perturbed" else audio
        if run == "cuda":
            _reset_counts(*_all_counters().values())       # the card's step starts here
        _set_tf32(run == "cuda_tf32")
        try:
            losses = fetch_scalars(tr.step(*_step_args(batch, task, seed=1)))
        finally:
            _set_tf32(False)
        if run == "cuda":
            counts = _shape_counts()                       # ... and ends here
        # a parameter that no loss reaches (ConvTasNet's last residual 1x1 when skip
        # connections sum) has no AdamW state, on either side
        moments = {n: opt.state[p]["exp_avg"].detach().cpu()
                   for opt, mod in ((tr.opt_g, tr.generator), (tr.opt_d, tr.disc))
                   for n, p in mod.named_parameters() if "exp_avg" in opt.state[p]}
        out[run] = losses, moments
    lc, mc = out["cpu"]
    floor = 1e-4 * max(v.norm().item() for v in mc.values())

    def readings(run):
        lg, mg = out[run]
        loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
        mom = {k: (mg[k] - mc[k]).norm().item() / max(mc[k].norm().item(), floor) for k in mc}
        worst = max(mom, key=mom.get)
        return loss_rel, mom[worst], worst

    loss_rel, mom_rel, worst = readings("cuda")
    loss_tol, mom_tol = (F16_STEP_RTOL, F16_MOMENT_REL) if f16 else (STEP_RTOL, MOMENT_REL)
    perturbed, control = {}, {}
    if "cpu_perturbed" in out:
        p_loss, p_mom, p_worst = readings("cpu_perturbed")
        loss_tol = max(loss_tol, PERTURB_FACTOR * p_loss)
        mom_tol = max(mom_tol, PERTURB_FACTOR * p_mom)
        perturbed = dict(cpu_perturbed_loss_rel=p_loss, cpu_perturbed_moment_rel=p_mom,
                         cpu_perturbed_worst_moment=p_worst, perturbation=perturb)
    refused = True
    if "cuda_tf32" in out:
        ctl_loss_rel, ctl_mom_rel, _ = readings("cuda_tf32")
        refused = ctl_loss_rel > loss_tol and ctl_mom_rel > mom_tol
        control = dict(tf32_control_loss_rel=ctl_loss_rel, tf32_control_moment_rel=ctl_mom_rel,
                       control_refused=refused)
    finite = all(math.isfinite(v) for v in out["cuda"][0].values()) and all(
        bool(torch.isfinite(m).all()) for m in out["cuda"][1].values())
    ok = finite and loss_rel <= loss_tol and mom_rel <= mom_tol
    say(phase=phase or ("cqtd_vs_cpu" if cqtd else _tag(model, "train_vs_cpu_plain")), task=task,
        model=model, **{**SMALL_STEP[model], **over}, segment=4096, batch=2, finite=finite,
        worst_loss_rel=loss_rel, loss_rtol=loss_tol, worst_moment_rel=mom_rel,
        worst_moment=worst, moment_rel_tol=mom_tol, **perturbed, **control, ok=ok,
        losses=out["cuda"][0])
    if not ok:
        raise SystemExit(f"one {model} training step (task {task}, {over}) on the card "
                         "disagrees with the CPU plain path")
    if not refused:
        raise SystemExit(f"the {model} TF32 control step (task {task}) passes a limit of the "
                         "card-vs-CPU comparison")
    return counts


def _joint_lists(tmp):
    """The joint config's lists on DatasetsScp/synth24 (24 kHz speech, 48 kHz
    noise), written into tmp with the paths of this checkout: the noise list
    of the data directory holds absolute paths of another tree."""
    src = os.path.join(REPO, "DatasetsScp", "synth24")
    noise = sorted(os.path.join(src, "noise", n) for n in os.listdir(os.path.join(src, "noise"))
                   if n.endswith(".wav"))
    nz = os.path.join(tmp, "noise_filelist.scp")
    with open(nz, "w") as f:
        f.writelines(p + "\n" for p in noise)
    return dict(input_training_wav_list=os.path.join(src, "train_filelist.txt"),
                input_validation_wav_list=os.path.join(src, "val_filelist.txt"),
                test_input_wavs_dir=os.path.join(src, "test_filelist.txt"),
                raw_wavfile_path=os.path.join(src, "wavs"), input_noise_wav_list=nz)


def phase_train_cli(model="bsrnn", keep_g=None):
    """The training CLI (python -m nvse_tpu_torch.train --cfg_filename, its
    main() run in this process) on a copy of the model's config for 2
    full-width steps with a validation pass on the synthetic data, then
    run_inference decoding from the g_ bundle it wrote. The joint model:
    main() with --joint on lists of DatasetsScp/synth24, validation of both
    tasks, then the joint inference entry (run_joint_inference) in each
    mode from the g_ bundle. keep_g: a path that receives a copy of the g_
    bundle."""
    from nvse_tpu_torch.infer import run_inference, run_joint_inference
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.train.__main__ import main as train_cli

    joint = model == "joint"
    _reset_counts(*_all_counters().values())       # this main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        h = _config(model, checkpoint_path=os.path.join(tmp, "ckpt"), training_steps=1,
                    stdout_interval=1, checkpoint_interval=10 ** 6,
                    validation_interval=10 ** 6, test_output_dir=os.path.join(tmp, "out"),
                    **(_joint_lists(tmp) if joint else {}))
        cfg = os.path.join(tmp, "config.json")
        with open(cfg, "w") as f:
            json.dump(h, f)
        argv, sys.argv = sys.argv, ["nvse_tpu_torch.train", *(["--joint"] if joint else []),
                                    "--cfg_filename", cfg]
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as log:
                train_cli()
        finally:
            sys.argv = argv
        secs = time.time() - t0
        lines = log.getvalue().splitlines()
        written = sorted(os.listdir(h.checkpoint_path))
        h.checkpoint_file_load = os.path.join(h.checkpoint_path, "g_00000001")
        if keep_g:
            shutil.copyfile(h.checkpoint_file_load, keep_g)
        served, files = [], []
        if joint:
            for mode in JOINT_TASKS:
                h.test_output_dir = os.path.join(tmp, mode)
                stats = run_joint_inference(h, mode, limit=2, log_fn=served.append,
                                            device="cuda")
                files.append(stats["files"] == len(os.listdir(h.test_output_dir)) == 2)
        else:
            stats = run_inference(h, limit=1, log_fn=served.append, device="cuda")
            files.append(stats["files"] == 1)
    counts = _shape_counts()                       # ... and ends here
    validated = ([f"step 0 val[{t}]:" for t in JOINT_TASKS] if joint
                 else ["step 0 validation:"])
    # which crops the loader took (PrefetchLoader.native: the C++ batch decoder of
    # native/, or Python where it does not load); the joint loader has one path
    crops = [l for l in lines if l.startswith("training crops:")]
    ok = ({"g_00000001", "do_00000001"} <= set(written) and all(files)
          and all(any(l.startswith(v) for l in lines) for v in validated)
          and any("training finished" in l for l in lines) and len(crops) == (not joint))
    say(phase=_tag(model, "train_cli"), seconds=secs, written=written, crops=crops,
        log=lines[-(6 if joint else 4):], serve=served[-2:], launches_by_shape=_str_keys(counts),
        ok=ok)
    if not ok:
        raise SystemExit(f"the {model} training CLI path did not checkpoint, validate and serve")
    return counts


def _trees_equal(a, b):
    """Two loaded bundles equal tensor for tensor (dtype, shape, bits) and in
    every other value."""
    if isinstance(a, torch.Tensor):
        bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)   # noqa: E731
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(bits(a), bits(b))))
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_trees_equal(a[k], b[k])
                                                                  for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_trees_equal(x, y) for x, y in zip(a, b)))
    return a == b


# the CUDA kernels of the training route's three wrappers, by name in a trace:
# lstm_fwd_hc (csrc/lstm_scan.cu / lstm_scan_wide.cu / lstm_stepwise.cu), lstm_bwd's
# recurrence (csrc/lstm_bwd.cu / lstm_bwd_wide.cu / lstm_stepwise.cu), the dW reduction
# (csrc/lstm_bwd.cu lstm_dw_mma_kernel / lstm_dw_fma_kernel)
TRACE_KERNELS = {"lstm_fwd_hc": ("lstm_scan_kernel", "lstm_scan_wide_kernel",
                                 "lstm_stepwise"),
                 "lstm_bwd": ("lstm_bwd_cluster_kernel", "lstm_bwd_wide_kernel",
                              "lstm_stepwise"),
                 "lstm_bwd_dw": ("lstm_dw_mma_kernel", "lstm_dw_fma_kernel")}


def phase_train_knobs(device="cuda"):
    """The training loop's knobs (train/loop.py, train/checkpoint.py) at full
    BSRNN-M width, batch 16 x 16384: the training CLI (phase_train_cli's setup)
    for 2 steps with checkpoint_interval 1, profile_dir set, profile_steps 1
    and the default async saves; its trace must exist and name the step's
    hand-written training kernels (TRACE_KERNELS, as many of each as the step
    launched). Then a trainer restored from the CLI's bundles: a synchronous
    save and an asynchronous one of its state, timed as the caller is blocked,
    a step run while the write is in flight, and after the wait each async
    bundle equal bit for bit to the synchronous one; one step under debug_nans
    (loop._setup_debug: anomaly mode) with finite losses, and one with a NaN
    planted in the gradients that the training route's autograd.Function
    (_BiLSTMSaving: lstm_fwd_hc forward, lstm_bwd backward) returns, which
    must raise naming it."""
    from nvse_tpu_torch.ops import lstm as L
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.train import (GANTrainer, fetch_scalars, restore_checkpoint,
                                      save_checkpoint, wait_for_checkpoints)
    from nvse_tpu_torch.train.__main__ import main as train_cli
    from nvse_tpu_torch.train.loop import _setup_debug
    from nvse_tpu_torch.utils import AttrDict

    fails = []
    _reset_counts(*_all_counters().values())       # this main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        h = _config("bsrnn", checkpoint_path=os.path.join(tmp, "ckpt"), training_steps=1,
                    stdout_interval=1, checkpoint_interval=1, validation_interval=10 ** 6,
                    skip_step0_validation=True, profile_dir=prof, profile_steps=1,
                    test_output_dir=os.path.join(tmp, "out"))
        cfg = os.path.join(tmp, "config.json")
        with open(cfg, "w") as f:
            json.dump(h, f)
        argv, sys.argv = sys.argv, ["nvse_tpu_torch.train", "--cfg_filename", cfg,
                                    "--device", device]
        counters = _training_counters()
        n0 = {k: c.launches for k, c in counters.items()}
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as log:
                train_cli()
        finally:
            sys.argv = argv
        cli_s = time.time() - t0
        per_step = {k: (c.launches - n0[k]) // 2 for k, c in counters.items()
                    if k in TRACE_KERNELS}
        lines = log.getvalue().splitlines()
        traces = [n for n in os.listdir(prof) if n.endswith(".pt.trace.json")] \
            if os.path.isdir(prof) else []
        in_trace = {}
        if len(traces) == 1:
            with open(os.path.join(prof, traces[0])) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
            in_trace = {k: sum(any(p in n for p in pats) for n in kernels)
                        for k, pats in TRACE_KERNELS.items()}
            names = sorted({n for n in kernels if any(p in n for pats in TRACE_KERNELS.values()
                                                       for p in pats)})
        else:
            fails.append(f"{len(traces)} traces under profile_dir: {traces}")
            names = []
        if device == "cuda" and not (all(in_trace.values()) and all(per_step.values())):
            fails.append(f"training kernels in the trace {in_trace}, launched a step {per_step}")
        if sum(l == "profiler trace stopped" for l in lines) != 1 or \
                "training finished (step budget reached)" not in lines:
            fails.append(f"the CLI's log: {lines[-4:]}")

        # async against sync on a trainer holding the CLI's state
        tr = GANTrainer(h, device=device, steps_per_epoch=2)
        restore_checkpoint(h.checkpoint_path, tr)
        audio = _audio_batch(int(h.batch_size), int(h.segment_size), h.sampling_rate,
                             seed=3).to(device)
        sync_dir, async_dir = os.path.join(tmp, "sync"), os.path.join(tmp, "async")
        t0 = time.time()
        save_checkpoint(sync_dir, 2, 0, tr)
        sync_s = time.time() - t0
        t0 = time.time()
        save_checkpoint(async_dir, 2, 0, tr, async_save=True)
        async_s = time.time() - t0
        tr.step(audio)                             # in place, while the write runs
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        wait_for_checkpoints()
        wait_s = time.time() - t0
        unequal = [n for n in ("g_00000002", "do_00000002") if not _trees_equal(
            torch.load(os.path.join(async_dir, n), weights_only=True),
            torch.load(os.path.join(sync_dir, n), weights_only=True))]
        if unequal or sorted(os.listdir(async_dir)) != sorted(os.listdir(sync_dir)):
            fails.append(f"async bundles unlike the sync ones: {unequal}")
        mb = sum(os.path.getsize(os.path.join(sync_dir, n))
                 for n in ("g_00000002", "do_00000002")) / 2 ** 20

        # debug_nans: finite losses; then a NaN in the LSTM kernel's backward
        prev = _setup_debug(AttrDict(debug_nans=True), lambda s: None)
        try:
            t0 = time.time()
            losses = fetch_scalars(tr.step(audio))
            debug_ms = (time.time() - t0) * 1e3
            real = L._BiLSTMSaving.backward
            L._BiLSTMSaving.backward = staticmethod(
                lambda ctx, g: tuple(d * float("nan") for d in real(ctx, g)))
            try:
                tr.step(audio)
                raised = None
            except RuntimeError as e:
                raised = str(e)
            finally:
                L._BiLSTMSaving.backward = staticmethod(real)
        finally:
            torch.autograd.set_detect_anomaly(*prev)
        if not all(math.isfinite(v) for v in losses.values()):
            fails.append(f"non-finite losses under debug_nans: {losses}")
        if not raised or "Function '_BiLSTMSavingBackward' returned nan" not in raised:
            fails.append(f"the planted NaN raised {raised!r}")
        if torch.is_anomaly_enabled():
            fails.append("anomaly mode left on")
        del tr
    counts = _shape_counts()                       # ... and ends here
    if device == "cuda":
        torch.cuda.empty_cache()
    say(phase="train_knobs", cli_seconds=cli_s, trace_kernels=names,
        trace_launches=in_trace, launches_per_step=per_step,
        trace_matches_launches=in_trace == per_step, bundles_mb=mb,
        sync_save_blocking_s=sync_s, async_save_blocking_s=async_s, async_wait_s=wait_s,
        async_equals_sync=not unequal, debug_nans_losses=losses, debug_nans_step_ms=debug_ms,
        planted_nan_raised=(raised or "")[:120], launches_by_shape=_str_keys(counts),
        ok=not fails)
    if fails:
        raise SystemExit("train_knobs: " + "; ".join(fails))
    return counts


def phase_joint_eval(g_bundle, device="cuda"):
    """The joint model's enhancement evaluation from the g_00000001 that
    phase_train_cli("joint") wrote (full-width BSRNN_24k): metrics.enhance's
    main() on 2 files of DatasetsScp/synth24 with its noise at 5 dB on the card
    (every key of the record, each score finite, delta = enhanced - noisy);
    joint_curve's batched decode of both modes on the card against the same
    decode on the CPU's plain path (the decode phases' limits); and
    joint_curve's main() without the DNSMOS .onnx files under its --model_dir,
    which must raise the JAX script's FileNotFoundError (with them it runs and
    its DNSMOS scores must be finite)."""
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.metrics import enhance, joint_curve
    from nvse_tpu_torch.infer.engine import resolve_filelist
    from nvse_tpu_torch.ops.lstm import _reset_counts

    fails = []
    _reset_counts(*_all_counters().values())       # this main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        shutil.copyfile(g_bundle, os.path.join(ckpt, "g_00000001"))
        h = _config("joint", checkpoint_path=ckpt,
                    checkpoint_file_load=os.path.join(ckpt, "g_00000001"),
                    test_output_dir=os.path.join(tmp, "out"), **_joint_lists(tmp))
        cfg = os.path.join(tmp, "config.json")
        with open(cfg, "w") as f:
            json.dump(h, f)
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = enhance.main(["--cfg_filename", cfg, "--limit", "2", "--snr", "5",
                                "--device", device])
        enhance_s = time.time() - t0
        want = {"label", "task", "mix_snr_db", "files", "rtf", "timestamp",
                *(f"{t}_{m}" for t in ("noisy", "enhanced", "delta") for m in enhance.METRICS)}
        if set(rec) != want or rec["files"] != 2:
            fails.append(f"enhance record keys {sorted(set(rec) ^ want)}, files {rec['files']}")
        scores = {k: v for k, v in rec.items() if k.split("_")[0] in ("noisy", "enhanced",
                                                                      "delta")}
        if not all(isinstance(v, float) and math.isfinite(v) for v in scores.values()):
            fails.append(f"enhance scores not finite: {scores}")
        elif any(abs(rec[f"delta_{m}"] - round(rec[f"enhanced_{m}"] - rec[f"noisy_{m}"], 4))
                 > 1e-9 for m in enhance.METRICS):
            fails.append("delta_* is not enhanced_* - noisy_*")

        files = resolve_filelist(h)[:2]
        _, _, cleans, noisys = joint_curve.write_mixes(h, files, 5.0, os.path.join(tmp, "mix"))
        eng = InferenceEngine(h, device=device)
        t0 = time.time()
        decoded = joint_curve.batched_decode(eng, h, cleans, noisys)
        decode_s = time.time() - t0
        counts = _shape_counts()                   # ... and ends here
        ref = joint_curve.batched_decode(InferenceEngine(h, device="cpu"), h, cleans, noisys)
        errs, ok_modes = {}, []
        for mode, got, cpu in zip(JOINT_TASKS, decoded, ref):
            got, cpu = torch.from_numpy(got), torch.from_numpy(cpu)
            err = (got - cpu).abs()
            errs[mode] = {"max_abs_err": err.max().item(),
                          "max_abs_ref": cpu.abs().max().item()}
            ok_modes.append(got.shape == cpu.shape == (2, max(len(c) for c in cleans.values()))
                            and bool(torch.isfinite(got).all())
                            and bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all()))
        if not all(ok_modes):
            fails.append(f"the batched decode on the card disagrees with the CPU: {errs}")

        model_dir = os.environ.get("NVSE_DNSMOS_DIR", os.path.join(REPO, "Metrics", "DNSMOS"))
        have = any(os.path.exists(os.path.join(model_dir, n))
                   for n in ("sig_bak_ovr.onnx", "model_v8.onnx"))
        argv = ["--cfg_filename", cfg, "--steps", "1", "--limit", "2", "--jb", "2",
                "--model_dir", model_dir, "--work_dir", os.path.join(tmp, "curve"),
                "--out", os.path.join(tmp, "curve.json"), "--device", device]
        dnsmos = None
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                records = joint_curve.main(argv)
            dnsmos = {r["signal"]: r.get("dnsmos_ovr") for r in records}
            if not have or not all(isinstance(v, float) and math.isfinite(v)
                                    for v in dnsmos.values()):
                fails.append(f"joint_curve's DNSMOS: {dnsmos}")
        except FileNotFoundError as e:
            dnsmos = f"not run: {e}"
            if have or "no DNSMOS onnx models under" not in str(e):
                fails.append(f"joint_curve raised {e}")
    say(phase="joint_eval", enhance_seconds=enhance_s, record={k: rec[k] for k in sorted(rec)},
        batched_decode_s=decode_s, batch=2, decode_vs_cpu_plain=errs, rtol=MODEL_RTOL,
        atol=MODEL_ATOL, dnsmos=dnsmos, launches_by_shape=_str_keys(counts), ok=not fails)
    if fails:
        raise SystemExit("joint_eval: " + "; ".join(fails))
    return counts


# state-carrying streaming of a causal config against the card's own offline
# decode, float32: max |diff| / max |offline| (the JAX package's test limit;
# the two differ only in float order); of a non-causal config: the mean
# |diff| / mean |offline| away from the edges, bounded by the lookahead
STREAM_EXACT_REL, STREAM_NONCAUSAL_REL = 1e-4, 0.15


@contextlib.contextmanager
def _chunk_clock(eng):
    """Puts a clock on the engine's per-chunk step while the caller runs a
    streaming entry point: yields a list that receives the host time at
    which each chunk's step is entered, the card idle. The time from one
    entry to the next is one chunk as a user waits for it: the step on the
    card, the frames' copy to the host and the overlap-add."""
    stamps, step = [], eng._stream_step

    def clocked(*args, **kw):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return step(*args, **kw)

    eng._stream_step = clocked
    try:
        yield stamps
    finally:
        del eng._stream_step


def phase_stream(name="bsrnn"):
    """Streaming and causal decode at full width, f32 and bf16: BSRNN-M
    (csrc/lstm_scan.cu, csrc/lstm_fused.cu) or BSRNN-L (their wide
    counterparts, csrc/lstm_scan_wide.cu and csrc/lstm_fused_wide.cu)."""
    from nvse_tpu_torch.infer import InferenceEngine, run_inference
    from nvse_tpu_torch.ops import lstm as L

    counters = {"lstm_scan": L.lstm_scan, "lstm_scan_stateful": L.lstm_scan_stateful,
                "lstm_scan_fused": L.lstm_scan_fused}
    L._reset_counts(*_all_counters().values())     # this main path starts here

    base = _config(name)
    B, T, c, la = 8, 512, 64, 16
    n_chunks = T // c
    rng = np.random.default_rng(1)
    mel = torch.from_numpy(rng.standard_normal((B, base.num_mels, T)).astype(np.float32) - 4.0)
    out_len = (T - 1) * base.hop_size
    chunk_audio_sec = B * c * base.hop_size / base.sampling_rate

    # 8 concurrent streams through synthesize_streaming_stateful
    for causal, per_chunk in ((True, 8), (False, 16)):
        for dtype in ("float32", "bfloat16"):
            eng = InferenceEngine(_config(name, causal=causal, compute_dtype=dtype), device="cuda")
            eng.synthesize_streaming_stateful(mel[..., :c], chunk_frames=c, lookahead_frames=la)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _chunk_clock(eng) as stamps:
                wav, counts = _launched(counters, lambda: eng.synthesize_streaming_stateful(
                    mel, out_len=out_len, chunk_frames=c, lookahead_frames=la))
                stamps.append(time.perf_counter())    # the last chunk ends with the flush
            wall = stamps[-1] - t0
            ms = sorted(np.diff(stamps) * 1e3)
            expect = {"lstm_scan": 0, "lstm_scan_stateful": per_chunk * n_chunks,
                      "lstm_scan_fused": 8 * n_chunks}
            offline = eng.synthesize_mel(mel, out_len=out_len)
            rel_max = float(np.abs(wav - offline).max() / (np.abs(offline).max() + 1e-9))
            sl = slice(la * base.hop_size, out_len - la * base.hop_size)
            rel_mean = float(np.abs(wav[:, sl] - offline[:, sl]).mean()
                             / (np.abs(offline[:, sl]).mean() + 1e-9))
            line = dict(phase=_tag(name, "stream"), causal=causal, dtype=dtype, streams=B, frames=T,
                        chunk_frames=c, lookahead_frames=la, chunks=n_chunks,
                        launches_per_chunk={k: v / n_chunks for k, v in counts.items()},
                        wall_ms_per_chunk_mean=wall * 1e3 / n_chunks,
                        streams_x_realtime=B * out_len / base.sampling_rate / wall,
                        vs_offline_rel_max=rel_max, vs_offline_interior_rel_mean=rel_mean)
            fails = []
            if counts != expect:
                fails.append(f"launches {counts}, expected {expect}")
            if wav.shape != (B, out_len) or not np.isfinite(wav).all():
                fails.append(f"bad output {wav.shape}")
            if causal and dtype == "float32":
                wav0 = eng.synthesize_streaming_stateful(mel, out_len=out_len, chunk_frames=c,
                                                         lookahead_frames=0)
                rel0 = float(np.abs(wav0 - offline).max() / (np.abs(offline).max() + 1e-9))
                line.update(vs_offline_rel_max_no_lookahead=rel0, rel_max_tol=STREAM_EXACT_REL)
                if not (rel_max < STREAM_EXACT_REL and rel0 < STREAM_EXACT_REL):
                    fails.append(f"streaming differs from the offline decode: {rel_max} with, "
                                 f"{rel0} without lookahead, limit {STREAM_EXACT_REL}")
            if not causal:
                line.update(interior_rel_mean_tol=STREAM_NONCAUSAL_REL)
                if dtype == "float32" and not (rel_mean < STREAM_NONCAUSAL_REL):
                    fails.append(f"interior error {rel_mean} over {STREAM_NONCAUSAL_REL}")
            line.update(wall_ms_per_chunk_p50=ms[len(ms) // 2], wall_ms_per_chunk_max=ms[-1],
                        streams_x_realtime_p50=chunk_audio_sec / (ms[len(ms) // 2] * 1e-3))
            say(**line)
            if fails:
                raise SystemExit(f"{name} stream causal={causal} {dtype}: " + "; ".join(fails))
            del eng

    # causal offline decode, B = 8 x 1024
    B2, T2, iters = 8, 1024, 5
    mel2 = torch.from_numpy(rng.standard_normal((B2, base.num_mels, T2)).astype(np.float32)
                            - 4.0).to("cuda")
    audio_sec = B2 * (T2 - 1) * base.hop_size / base.sampling_rate
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(_config(name, causal=True, compute_dtype=dtype), device="cuda")
        eng.forward(mel2)                          # warmup
        torch.cuda.synchronize()
        t0 = time.time()
        wav, counts = _launched(counters, lambda: [eng.forward(mel2) for _ in range(iters)][-1])
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
        say(phase=_tag(name, "decode_causal"), dtype=dtype, batch=B2, frames=T2, wall_ms=wall * 1e3,
            rtf=audio_sec / wall, launches_per_forward={k: v / iters for k, v in counts.items()})
        if counts != {"lstm_scan": 8 * iters, "lstm_scan_stateful": 0, "lstm_scan_fused": 8 * iters}:
            raise SystemExit(f"{name} causal decode {dtype}: launches {counts} for {iters} "
                             "forwards")
        if wav.shape != (B2, (T2 - 1) * base.hop_size) or not torch.isfinite(wav).all():
            raise SystemExit(f"{name} causal decode {dtype}: bad output {tuple(wav.shape)}")
        del eng

    # run_inference(stream=True) on the synthetic set, both stream modes
    for dtype in ("float32", "bfloat16"):
        for mode in ("recompute", "stateful"):
            with tempfile.TemporaryDirectory() as out:
                h = _config(name, causal=True, compute_dtype=dtype, stream_mode=mode,
                            test_output_dir=out)
                lines = []
                stats, counts = _launched(counters, lambda: run_inference(
                    h, stream=True, device="cuda", log_fn=lines.append))
                written = sorted(os.listdir(out))
            say(phase=_tag(name, "serve_stream"), dtype=dtype, stream_mode=mode, line=lines[-1],
                files=stats["files"], rtf=stats["rtf"], launches=counts)
            used = counts["lstm_scan_stateful" if mode == "stateful" else "lstm_scan"]
            if stats["files"] != 6 or len(written) != 6 or used == 0:
                raise SystemExit(f"{name} streaming serve {dtype} {mode}: {stats} wrote {written}, "
                                 f"launches {counts}")
    main_counts = _shape_counts()                  # ... and ends here
    used = {k: set(c.launches_by_kernel) for k, c in counters.items()}
    want = {k: {L._kernel_source(k, int(base.feature_dim))} for k in counters}
    say(phase=_tag(name, "stream_kernels"),
        launches_by_kernel={k: c.launches_by_kernel for k, c in counters.items()})
    if used != want:
        raise SystemExit(f"{name} streaming and causal paths launched {used}, expected {want}")

    # the card's causal decode against the CPU's plain path, same weights, small input
    h = _config(name, causal=True)
    small = mel[:2, :, :64]
    cpu = InferenceEngine(h, device="cpu").forward(small)
    gpu = InferenceEngine(h, device="cuda").forward(small).cpu()
    err = (gpu - cpu).abs()
    ok = bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all())
    say(phase=_tag(name, "decode_causal_vs_cpu_plain"), batch=2, frames=64,
        max_abs_err=err.max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL, ok=ok)
    if not ok:
        raise SystemExit(f"{name} causal decode on the card disagrees with the CPU plain path")
    return main_counts


# lstm_scan_bidir2 as (label, steps, rows, H): GCRN's grouped LSTM at the
# B=8 x 1024 decode and at the serving shape of the synthetic set (6 files of
# 82 frames in one batch of 8 at the 128-frame bucket), and one shape the
# H <= 128 kernels also take
BIDIR2_SHAPES = (("decode", 1024, 8, 448), ("serve", 128, 8, 448), ("small", 65, 16, 128))


def _bidir2_design(route, p, dtype):
    """The route's plan of lstm_scan_bidir2 (ops/lstm.py `bidir2_plan`) in words."""
    if route == "lstm_stepwise":
        return _stepwise_design(p)
    if route == "lstm_bidir2":
        prod = ("mma.sync m16n8k16 bf16, W_hh slice in registers" if dtype == torch.bfloat16
                else "f32 FMA, W_hh slice in registers + shared memory")
        return (f"{prod}, clusters of {p['cluster']} x {p['units']} units a scan, {p['ntiles']} "
                f"tiles of <= {p['rows']} rows ({p['tile_rows']}-row instance), {p['blocks']} "
                f"blocks, h by st.async on mbarriers (no grid barrier), one block barrier a "
                f"step, exact cell")
    if route == "lstm_scan":
        return (f"csrc/lstm_scan.cu two-direction clusters of {p['cluster']} x {p['units']} "
                f"units, {p['ntiles']} tiles of <= {p['rows']} rows a scan, two pointers")
    return (f"csrc/lstm_scan_wide.cu kScanBidir, {p['groups']} row groups x slices of "
            f"{p['units']} units ({p['tile_rows']}-row tiles), {p['launch_dirs']} direction(s) "
            f"a launch, two pointers, one grid barrier a step")


def phase_bidir2_kernels(cases, phase="kernel_vs_plain"):
    """lstm_scan_bidir2 against its plain version at each (label, steps,
    rows, H, dtype) of cases, on the route ops/lstm.py `bidir2_plan` picks on
    this card (the cluster kernel of csrc/lstm_bidir2.cu, csrc/lstm_scan.cu or
    csrc/lstm_scan_wide.cu), named in the row's source and design; the
    library yardstick is two cuDNN unidirectional LSTM forwards (input H,
    hidden H) on the x that the port projects outside its kernel; the control,
    which the limit must refuse, is the kernel with its two W_hh swapped."""
    from nvse_tpu_torch.ops import lstm as L

    rows = []
    for label, T, R, H, dtype in cases:
        G = 4 * H
        g = torch.Generator().manual_seed(T + R + H)
        b = 1.0 / math.sqrt(H)
        xs = [torch.randn(T, R, H, generator=g).to("cuda", dtype) for _ in range(2)]
        w_ih, bias, whh = ([torch.empty(sh).uniform_(-b, b, generator=g).to("cuda", dtype)
                            for _ in range(2)] for sh in ((H, G), (G,), (H, G)))
        libs = [cudnn_lstm([(w_ih[i], whh[i], bias[i])], dtype) for i in range(2)]
        item = xs[0].element_size()
        ops = 2 * 2 * R * T * H * G
        nbytes = 2 * (R * T * (G + H) + H * G) * item
        with torch.inference_mode(), no_weight_compaction():
            xp = [(xs[i] @ w_ih[i] + bias[i]).contiguous() for i in range(2)]
            run = lambda: L.lstm_scan_bidir2(xp[0], xp[1], whh[0], whh[1])
            plain = lambda: L.lstm_scan_bidir2_plain(xp[0], xp[1], whh[0], whh[1])
            library = lambda: (libs[0](xs[0])[0], libs[1](xs[1])[0])
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
            lib_err = max((a.float() - r.float()).abs().max().item()
                          for a, r in zip(library(), ref))
            ctl = L.lstm_scan_bidir2(xp[0], xp[1], whh[1], whh[0])
            control = max((a.float() - r.float()).abs().max().item() for a, r in zip(ctl, ref))
            ms = cuda_ms(run, iters=10)
            plain_ms = cuda_ms(plain, iters=2)
            library_ms = cuda_ms(library, iters=10)
        bound, bound_by = _bound(nbytes, ops, dtype)
        plan = L._bidir2_card_plan(0, R, L.lstm_padding(H)[0], dtype)
        route = plan["route"]
        row = dict(name="lstm_scan_bidir2", shape=label, rows=R, steps=T, H=H,
                   dtype=DT_NAME[dtype], source=f"nvse_tpu_torch/csrc/{route}.cu",
                   design=_bidir2_design(route, plan["plan"], dtype),
                   max_abs_err=err, tol=TOL[dtype], ms=ms,
                   us_per_step=ms * 1e3 / T, plain_ms=plain_ms, library_ms=library_ms,
                   library="2 cuDNN LSTM forwards, projection included",
                   library_max_abs_err=lib_err, control_max_abs_err=control,
                   bound_ms=bound, bound_by=bound_by, tflops=ops / (ms * 1e-3) / 1e12)
        say(phase=phase, **row)
        if not (err <= TOL[dtype]):
            raise SystemExit(f"lstm_scan_bidir2 {label} {DT_NAME[dtype]}: max abs err {err} "
                             f"over tolerance {TOL[dtype]}")
        if not (control > TOL[dtype]):
            raise SystemExit(f"lstm_scan_bidir2 {label} {DT_NAME[dtype]}: the control with "
                             f"the two W_hh swapped ({control}) passes the tolerance "
                             f"{TOL[dtype]}")
        rows.append(row)
    return rows


def phase_gcrn():
    """GCRN (8.28 M parameters, no width knobs) through the engine: decode at
    B=8 x 1024 in float32 and bfloat16, run_inference on the synthetic set,
    the card against the CPU's plain path."""
    from nvse_tpu_torch.infer import InferenceEngine, run_inference
    from nvse_tpu_torch.ops.spectral import mel_spectrogram

    from nvse_tpu_torch.ops.lstm import _reset_counts

    counters = _all_counters()
    _reset_counts(*counters.values())              # this main path starts here

    base = _config("gcrn")
    B, T, iters = 8, 1024, 5
    rng = np.random.default_rng(2)
    mel = torch.from_numpy(rng.standard_normal((B, base.num_mels, T)).astype(np.float32) - 4.0)
    melc = mel.to("cuda")
    audio_sec = B * (T - 1) * base.hop_size / base.sampling_rate
    wavs = {}
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(_config("gcrn", compute_dtype=dtype), device="cuda")
        n_params = sum(p.numel() for p in eng.generator.parameters())
        eng.forward(melc)                          # warmup
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        wav, counts = _launched(counters, lambda: [eng.forward(melc) for _ in range(iters)][-1])
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
        say(phase="gcrn_decode", dtype=dtype, batch=B, frames=T, parameters=n_params,
            wall_ms=wall * 1e3, rtf=audio_sec / wall,
            launches_per_forward={k: v / iters for k, v in counts.items()},
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        expect = {k: (2 * iters if k == "lstm_scan_bidir2" else 0) for k in counters}
        if counts != expect:
            raise SystemExit(f"GCRN decode {dtype}: launches {counts} for {iters} forwards, "
                             "expected 2 lstm_scan_bidir2 per forward and no other LSTM kernel")
        by_kernel = dict(counters["lstm_scan_bidir2"].launches_by_kernel)
        if set(by_kernel) != {"lstm_bidir2"}:
            raise SystemExit(f"GCRN decode {dtype}: lstm_scan_bidir2 launched {by_kernel}, "
                             "expected the cluster kernel of csrc/lstm_bidir2.cu only")
        if wav.shape != (B, (T - 1) * base.hop_size) or not torch.isfinite(wav).all():
            raise SystemExit(f"GCRN decode {dtype}: bad output {tuple(wav.shape)}")
        if not 0.98 * 8.28e6 <= n_params <= 1.02 * 8.28e6:
            raise SystemExit(f"GCRN has {n_params} parameters, not the 8.28 M of its full width")
        wavs[dtype] = wav
        del eng
    w32, wbf = wavs["float32"], wavs["bfloat16"]
    margs = (base.n_fft, base.num_mels, base.sampling_rate, base.hop_size, base.win_size,
             base.fmin, base.sampling_rate / 2)
    mel_l1 = (mel_spectrogram(w32, *margs) - mel_spectrogram(wbf, *margs)).abs().mean().item()
    wav_rel = ((w32 - wbf).norm() / (w32.norm() + 1e-9)).item()
    say(phase="gcrn_decode", bf16_vs_f32_mel_l1=mel_l1, bf16_vs_f32_wav_rel_l2=wav_rel)

    # run_inference on the synthetic set (weights from the seed: the config's
    # checkpoint file is not part of the repository)
    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as out:
            lines = []
            stats, counts = _launched(counters, lambda: run_inference(
                _config("gcrn", compute_dtype=dtype, test_output_dir=out), device="cuda",
                log_fn=lines.append))
            written = sorted(os.listdir(out))
        say(phase="gcrn_serve", dtype=dtype, line=lines[-1], files=stats["files"],
            rtf=stats["rtf"], launches=counts)
        others = sum(v for k, v in counts.items() if k != "lstm_scan_bidir2")
        if (stats["files"] != 6 or len(written) != 6 or counts["lstm_scan_bidir2"] == 0
                or others):
            raise SystemExit(f"GCRN serving {dtype}: {stats} wrote {written}, launches {counts}")
    main_counts = _shape_counts()                  # ... and ends here

    # the card's decode against the CPU's plain path, same weights, small input
    small = mel[:2, :, :64]
    cpu = InferenceEngine(base, device="cpu").forward(small)
    gpu = InferenceEngine(base, device="cuda").forward(small).cpu()
    err = (gpu - cpu).abs()
    ok = bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all())
    say(phase="gcrn_decode_vs_cpu_plain", batch=2, frames=64, max_abs_err=err.max().item(),
        max_abs_ref=cpu.abs().max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL, ok=ok)
    if not ok:
        raise SystemExit("GCRN decode on the card disagrees with the CPU plain path")
    return main_counts


def phase_bidir2_grad():
    """lstm_scan_bidir2 under autograd on the card, its residual-saving route
    (lstm_fwd_hc and lstm_bwd per scan) against the CPU's plain autograd:
    at H = 128 (the kernels of csrc/lstm_bwd.cu) and at GCRN's training
    shape, 65 steps x 16 rows x H = 448 (csrc/lstm_scan_wide.cu); the control,
    which the limit must refuse, is the card's route with the two W_hh
    swapped."""
    from nvse_tpu_torch.ops import lstm as L

    counters = _all_counters()
    names = ("hs_a", "hs_b", "dx_proj_a", "dx_proj_b", "dW_hh_a", "dW_hh_b")
    for T, R, H in ((65, 16, 128), (65, 16, 448)):
        g = torch.Generator().manual_seed(11 + H)
        b = 1.0 / math.sqrt(H)
        host = ([0.5 * torch.randn(T, R, 4 * H, generator=g) for _ in range(2)]
                + [torch.empty(H, 4 * H).uniform_(-b, b, generator=g) for _ in range(2)])
        cots = [torch.randn(T, R, H, generator=g) for _ in range(2)]

        def run(device, swap=False):
            args = [a.to(device).detach().requires_grad_() for a in host]
            xa, xb, wa, wb = args
            outs = L.lstm_scan_bidir2(xa, xb, *((wb, wa) if swap else (wa, wb)))
            torch.autograd.backward(list(outs), [c.to(device) for c in cots])
            return [o.detach().cpu() for o in outs] + [a.grad.cpu() for a in args]

        gpu, counts = _launched(counters, lambda: run("cuda"))
        cpu = run("cpu")
        errs = {n: _err(a, r)[1] for n, a, r in zip(names, gpu, cpu)}
        control = max(_err(a, r)[1] for a, r in zip(run("cuda", swap=True), cpu))
        expect = {k: 0 for k in counters}
        expect.update(lstm_fwd_hc=2, lstm_bwd=2, lstm_bwd_dw=2)
        ok = all(e <= TRAIN_TOL[torch.float32] for e in errs.values())
        refused = control > TRAIN_TOL[torch.float32]
        say(phase="bidir2_grad_vs_cpu_plain", steps=T, rows=R, H=H, rel_err=errs,
            tol=TRAIN_TOL[torch.float32], control_rel_err=control, launches=counts, ok=ok,
            control_refused=refused)
        if not ok or counts != expect:
            raise SystemExit(f"lstm_scan_bidir2 gradient route at H = {H}: errors {errs}, "
                             f"launches {counts}, expected {expect}")
        if not refused:
            raise SystemExit(f"lstm_scan_bidir2 gradient route at H = {H}: the control with "
                             f"the W_hh swapped ({control}) passes the tolerance")

# ---------------------------------------------------------------------------
# ConvTasNet: the TCN block tail (csrc/tcn_tail.cu) and mel->wave serving
# ---------------------------------------------------------------------------

# the tail at ConvTasNet's decode shape: B = 8 x 1024 mel frames -> hop * 1023 =
# 261,888 samples -> (261,888 - 16) / 8 + 1 = 32,735 encoder frames; H = 512, Bc = 128;
# the dilations of one repeat of 8 blocks
TCN_B, TCN_T, TCN_H, TCN_BC = 8, (256 * 1023 - 16) // 8 + 1, 512, 128
TCN_DILATIONS = tuple(2 ** i for i in range(8))
TCN_CONTROL_DILATION = 128
GLN_DECODE_BOUND = 2.0     # the gLN statistics at the decode shape: at most 2 x the bound
# ConvTasNet at full width: N = 512, H = 512, 24 blocks (the JAX init's count)
CONVTASNET_PARAMS = 4_960_409
# the card's decode against the CPU's plain path, float32, as max |card - cpu| over
# max |cpu|: with zero initial phase (the trunk and the tail kernel; the control, TF32
# on in matmuls and cuDNN, must be refused) at MODEL_PEAK_REL; Griffin-Lim's 32
# momentum iterations carry rounding from one iteration to the next (float32 against
# float64 on the CPU: 6.3e-4 of the peak at 2 x 64 frames), so the Griffin-Lim front,
# card against CPU, at GL_PEAK_REL
MODEL_PEAK_REL, GL_PEAK_REL = 1e-4, 5e-3
# the fused decode against the unfused one on the card: float32 at MODEL_PEAK_REL;
# bfloat16, where the two round at other places, the fused decode's relative L2
# distance to the float32 decode at most BF16_FUSED_RATIO times the unfused one's
BF16_FUSED_RATIO = 1.5


def _tail_inputs(B, T, H, Bc, dtype, seed):
    """(c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs) on the card: c with a
    nonzero mean (a PReLU'd projection) and a nonzero gLN shift, so that a
    tap that read b2 in place of 0 at the sequence ends shows."""
    g = torch.Generator().manual_seed(seed)
    c = torch.randn(B, T, H, generator=g) + 0.5
    x = torch.randn(B, T, Bc, generator=g)
    gw, gb = 1.0 + 0.1 * torch.randn(1, H, generator=g), 0.5 * torch.randn(1, H, generator=g)
    wdw, bdw = torch.randn(3, H, generator=g) / 3, 0.1 * torch.randn(1, H, generator=g)
    wrs = torch.randn(H, 2 * Bc, generator=g) / math.sqrt(H)
    brs = 0.1 * torch.randn(1, 2 * Bc, generator=g)
    return [t.to("cuda", dtype) for t in (c, x, gw, gb, wdw, bdw, wrs, brs)]


def _tail_library(c, x, gw, gb, wdw, bdw, wrs, brs, d):
    """The unfused tail as several PyTorch calls, in the input dtype: gLN
    (two-pass, as the unfused module), F.conv1d depthwise (PyTorch's own
    depthwise kernel at these shapes, not cuDNN's), one cuBLAS product for
    the concatenated res|skip 1x1, the residual add."""
    import torch.nn.functional as F

    B, T, H = c.shape
    Bc = x.shape[-1]
    mean = c.mean(dim=(1, 2), keepdim=True)
    var = ((c - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    n = gw * (c - mean) / torch.sqrt(var + 1e-5) + gb
    q = F.conv1d(n.transpose(1, 2), wdw.T.unsqueeze(1), bdw.reshape(H), padding=d, dilation=d,
                 groups=H)
    out = torch.addmm(brs, q.transpose(1, 2).reshape(B * T, H), wrs).reshape(B, T, 2 * Bc)
    return x + out[..., :Bc], out[..., Bc:]


def _tail_bound(B, T, H, Bc, dtype):
    """(bound ms, what binds it, operations): c and x read once, both outputs
    written once, the weights and the folded gLN; the res|skip product plus
    the norm and the three taps."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (B * T * (H + 3 * Bc) + 5 * H + 2 * H * Bc + 2 * Bc) * item + 2 * B * H * 4
    ops = 2 * B * T * H * 2 * Bc + 8 * B * T * H
    return (*_bound(nbytes, ops, dtype), ops)


def phase_tcn_kernels(cases, phase="tcn_kernels"):
    """The tail kernel against tcn_block_tail_plain at each (label, B, T, H,
    Bc, dilation, dtype) of cases, with its time, the wrapper's (the gLN
    fold plus the kernel), the plain version's and the unfused tail's as
    several PyTorch calls (the library yardstick); as controls the limit must
    refuse, the kernel on w_rs with its res and skip halves swapped and, at
    dilation 128, on c zero-padded before the norm."""
    import torch.nn.functional as F

    from nvse_tpu_torch.ops.tcn import (_card_tail_plan, _fold, tcn_block_tail,
                                        tcn_block_tail_kernel, tcn_block_tail_plain)

    rows = []
    for label, B, T, H, Bc, d, dtype in cases:
        c, x, gw, gb, wdw, bdw, wrs, brs = _tail_inputs(B, T, H, Bc, dtype, seed=d + T)
        with torch.inference_mode():
            a, b2 = _fold(c, gw, gb, 1e-5)
            args = (c, x, a, b2, wdw, bdw, wrs, brs, d)
            got = tcn_block_tail_kernel(*args)
            ref, plain_ms = cuda_once(lambda: tcn_block_tail_plain(*args))
            err = max((_err(g, r) for g, r in zip(got, ref)), key=lambda e: e[1])
            swapped = torch.cat([wrs[:, Bc:], wrs[:, :Bc]], dim=1)
            ctl = tcn_block_tail_kernel(c, x, a, b2, wdw, bdw, swapped, brs, d)
            controls = {"w_rs_halves_swapped": max(_err(g, r)[1] for g, r in zip(ctl, ref))}
            if d == TCN_CONTROL_DILATION:
                pad = (0, 0, d, d)
                ctl = tcn_block_tail_kernel(F.pad(c, pad), F.pad(x, pad), a, b2, wdw, bdw, wrs,
                                            brs, d)
                controls["padded_before_norm"] = max(_err(g[:, d:-d], r)[1]
                                                     for g, r in zip(ctl, ref))
            lib = _tail_library(c, x, gw, gb, wdw, bdw, wrs, brs, d)
            lib_err = max(_err(g, r)[1] for g, r in zip(lib, ref))
            ms = cuda_ms(lambda: tcn_block_tail_kernel(*args), iters=10)
            wrapper_ms = cuda_ms(lambda: tcn_block_tail(c, x, gw, gb, wdw, bdw, wrs, brs, d),
                                 iters=10)
            library_ms = cuda_ms(lambda: _tail_library(c, x, gw, gb, wdw, bdw, wrs, brs, d),
                                 iters=10)
        bound, bound_by, ops = _tail_bound(B, T, H, Bc, dtype)
        p = _card_tail_plan(0, B, T, H, Bc, d, dtype)
        wgmma = f"wgmma m64n256k16 {'bf16' if dtype == torch.bfloat16 else 'f16'}, A (q) from registers"
        design = (f"{wgmma if p['tensor_cores'] else 'f32 FMA, 8 x 16 a thread'}"
                  f", 128 x 256 tiles on {p['blocks']} persistent blocks, chunks of {p['kc']} "
                  f"channels in {p['stages']} cp.async stages")
        row = dict(name="tcn_block_tail", shape=label, rows=B, steps=T, H=H, Bc=Bc, dilation=d,
                   dtype=DT_NAME[dtype], source="nvse_tpu_torch/csrc/tcn_tail.cu", design=design,
                   max_abs_err=err[0], rel_err=err[1], tol=TOL[dtype],
                   control_rel_err=controls, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_max_rel_err=lib_err,
                   library="unfused tail, several calls: gLN, F.conv1d depthwise, "
                           "one cuBLAS res|skip product, the residual add",
                   bound_ms=bound, bound_by=bound_by, tflops=ops / (ms * 1e-3) / 1e12)
        say(phase=phase, **row)
        if not (err[1] <= TOL[dtype]):
            raise SystemExit(f"tcn_block_tail {label} {DT_NAME[dtype]}: error {err} over "
                             f"tolerance {TOL[dtype]}")
        passed = [k for k, v in controls.items() if not (v > TOL[dtype])]
        if passed:
            raise SystemExit(f"tcn_block_tail {label} {DT_NAME[dtype]}: controls {passed} pass "
                             f"the tolerance: {controls}")
        rows.append(row)
    return rows


def phase_gln_stats(cases, phase="tcn_kernels", bound_limit=None, device_time=False):
    """The gLN statistics kernel of csrc/tcn_tail.cu (tcn_gln_fold_kernel: a, b2
    from one read of c) against `_fold`, its plain version, at each (label, B,
    T, H, dtype) of cases, with torch.var_mean over (T, H) as the library
    yardstick; the control, which the limit must refuse, is the kernel fed
    gln_w and gln_b swapped. ms and library_ms are back-to-back calls between CUDA
    events, the host path included, two readings of each in turns; two runs must
    give the same bits. Fails, once every row is printed, where the kernel is
    slower than var_mean in both readings past var_mean's slower one, or (with
    bound_limit) takes more than bound_limit x its bound. device_time: kernel_ms and
    library_kernel_ms, the device time alone from torch.profiler, which only the
    first profiler session of a process reads whole (`device_ms`)."""
    from nvse_tpu_torch.ops.tcn import _fold, gln_stats_partials, tcn_gln_fold_kernel

    rows, slow = [], []
    for label, B, T, H, dtype in cases:
        c, _, gw, gb, *_ = _tail_inputs(B, T, H, 8, dtype, seed=T + H)
        with torch.inference_mode():
            got = tcn_gln_fold_kernel(c, gw, gb, 1e-5)
            again = tcn_gln_fold_kernel(c, gw, gb, 1e-5)
            torch.cuda.synchronize()
            same_bits = all(torch.equal(g, a) for g, a in zip(got, again))
            ref = _fold(c, gw, gb, 1e-5)
            err = max((_err(g, r) for g, r in zip(got, ref)), key=lambda e: e[1])
            ctl = tcn_gln_fold_kernel(c, gb, gw, 1e-5)
            control = max(_err(g, r)[1] for g, r in zip(ctl, ref))
            run = lambda: tcn_gln_fold_kernel(c, gw, gb, 1e-5)
            lib = lambda: torch.var_mean(c, dim=(1, 2), correction=0)
            # back to back, the host path included: 100 calls a reading, in turns
            ms = cuda_ms(run, iters=100)
            library_ms = cuda_ms(lib, iters=100)
            device = dict(kernel_ms=device_ms(run, 20), library_kernel_ms=device_ms(lib, 20)) \
                if device_time else {}
            library_ms2, ms2 = cuda_ms(lib, iters=100), cuda_ms(run, iters=100)
            plain_ms = cuda_ms(lambda: _fold(c, gw, gb, 1e-5), iters=10)
        item = c.element_size()
        # c read once, gln_w and gln_b, a and b2 written; a sum and a fma an element
        bound, bound_by = _bound(B * T * H * item + 2 * H * item + 2 * B * H * 4, 2 * B * T * H,
                                 torch.float32)
        P = gln_stats_partials(B, T, H, torch.cuda.get_device_properties(0).multi_processor_count)
        row = dict(name="tcn_gln_stats", shape=label, rows=B, steps=T, H=H, dtype=DT_NAME[dtype],
                   source="nvse_tpu_torch/csrc/tcn_tail.cu",
                   design=f"one launch: {P} runs a batch element ({B * P} blocks), 4 x 16-byte "
                          "loads in flight a thread, float32 sums, the last block of a batch "
                          "element (integer ticket) folds the partials in a fixed order",
                   max_abs_err=err[0], rel_err=err[1], tol=TOL[dtype], control_rel_err=control,
                   same_bits=same_bits, ms=ms, ms_again=ms2, **device,
                   plain_ms=plain_ms, library_ms=library_ms, library_ms_again=library_ms2,
                   library="torch.var_mean over (T, H)", bound_ms=bound, bound_by=bound_by,
                   bound_limit=bound_limit, gb_per_s=B * T * H * item / (ms * 1e-3) / 1e9)
        say(phase=phase, **row)
        if min(ms, ms2) > max(library_ms, library_ms2):
            slow.append(f"{label} {DT_NAME[dtype]}: {ms:.4f} / {ms2:.4f} ms against "
                        f"torch.var_mean's {library_ms:.4f} / {library_ms2:.4f}")
        if bound_limit is not None and min(ms, ms2) > bound_limit * bound:
            slow.append(f"{label} {DT_NAME[dtype]}: {min(ms, ms2):.4f} ms over {bound_limit} x "
                        f"its bound {bound:.4f}")
        if not same_bits:
            raise SystemExit(f"tcn_gln_stats {label} {DT_NAME[dtype]}: two runs differ")
        if not (err[1] <= TOL[dtype]):
            raise SystemExit(f"tcn_gln_stats {label} {DT_NAME[dtype]}: error {err} over "
                             f"tolerance {TOL[dtype]}")
        if not (control > TOL[dtype]):
            raise SystemExit(f"tcn_gln_stats {label} {DT_NAME[dtype]}: the control with gln_w "
                             f"and gln_b swapped ({control}) passes the tolerance")
        rows.append(row)
    if slow:
        raise SystemExit("tcn_gln_stats slower than its limits: " + "; ".join(slow))
    return rows


def _rel_peak(got, ref):
    """max |got - ref| over max |ref|."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def phase_convtasnet():
    """ConvTasNet (configs/convtasnet_config.json, 4.96 M parameters) with
    fused_tcn on through the engine: decode B = 8 x 1024 mel frames in
    float32 and bfloat16 (24 tail launches per forward, 3 at each dilation,
    none of an LSTM kernel), the same decode with fused_tcn off timed beside
    it, then run_inference on the synthetic set; afterwards the card against
    the CPU's plain path on a small input."""
    from nvse_tpu_torch.infer import InferenceEngine, run_inference
    from nvse_tpu_torch.ops.griffin_lim import griffin_lim
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.ops.spectral import inverse_mel, mel_spectrogram
    from nvse_tpu_torch.ops.tcn import tcn_block_tail

    counters = _all_counters()
    _reset_counts(*counters.values())              # this main path starts here
    base = _config("convtasnet", fused_tcn=1)
    B, T, iters = 8, 1024, 3
    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.standard_normal((B, base.num_mels, T)).astype(np.float32) - 4.0)
    melc = mel.to("cuda")
    audio_sec = B * (T - 1) * base.hop_size / base.sampling_rate
    n_blocks = int(base.R) * int(base.X)
    wavs = {}
    for dtype in ("float32", "bfloat16"):
        for fused in (1, 0):
            eng = InferenceEngine(_config("convtasnet", fused_tcn=fused, compute_dtype=dtype),
                                  device="cuda")
            n_params = sum(p.numel() for p in eng.generator.parameters())
            eng.forward(melc)                      # warmup
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n0 = dict(tcn_block_tail.launches_by_shape)
            t0 = time.time()
            wav, counts = _launched(counters, lambda: [eng.forward(melc) for _ in range(iters)][-1])
            torch.cuda.synchronize()
            wall = (time.time() - t0) / iters
            by_dilation = {key[4]: n // iters for key, n in
                           launch_delta(tcn_block_tail.launches_by_shape, n0).items()}
            say(phase="convtasnet_decode", dtype=dtype, fused_tcn=fused, batch=B, frames=T,
                encoder_frames=TCN_T, parameters=n_params, wall_ms=wall * 1e3,
                rtf=audio_sec / wall, launches_per_forward={k: v / iters for k, v in counts.items()},
                tail_launches_per_forward_by_dilation=by_dilation,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            expect = {k: (n_blocks * iters * fused if k in ("tcn_block_tail", "tcn_gln_stats")
                          else 0) for k in counters}
            want_d = {d: 3 for d in TCN_DILATIONS} if fused else {}
            if counts != expect or by_dilation != want_d:
                raise SystemExit(f"ConvTasNet decode {dtype} fused_tcn={fused}: launches {counts}"
                                 f" by dilation {by_dilation}, expected {n_blocks} tail and "
                                 f"{n_blocks} statistics launches per forward when fused (3 per "
                                 "dilation), no other kernel")
            if wav.shape != (B, (T - 1) * base.hop_size) or not torch.isfinite(wav).all():
                raise SystemExit(f"ConvTasNet decode {dtype}: bad output {tuple(wav.shape)}")
            if n_params != CONVTASNET_PARAMS:
                raise SystemExit(f"ConvTasNet has {n_params} parameters, not {CONVTASNET_PARAMS}")
            wavs[dtype, fused] = wav
            del eng
            torch.cuda.empty_cache()
    f32, bf, bf_u = wavs["float32", 1], wavs["bfloat16", 1], wavs["bfloat16", 0]
    margs = (base.n_fft, base.num_mels, base.sampling_rate, base.hop_size, base.win_size,
             base.fmin, base.sampling_rate / 2)
    fused_vs_unfused = _rel_peak(f32, wavs["float32", 0])
    dev = dict(bf16_vs_f32_mel_l1=(mel_spectrogram(f32, *margs)
                                   - mel_spectrogram(bf, *margs)).abs().mean().item(),
               bf16_vs_f32_wav_rel_l2=_rel_l2(bf, f32),
               bf16_unfused_vs_f32_wav_rel_l2=_rel_l2(bf_u, f32),
               f32_fused_vs_unfused_peak_rel=fused_vs_unfused, limit=MODEL_PEAK_REL,
               bf16_fused_ratio_limit=BF16_FUSED_RATIO)
    say(phase="convtasnet_decode", **dev)
    if not (fused_vs_unfused <= MODEL_PEAK_REL):
        raise SystemExit(f"ConvTasNet float32: the fused decode is {fused_vs_unfused} of the "
                         f"peak from the unfused one, over {MODEL_PEAK_REL}")
    if not (dev["bf16_vs_f32_wav_rel_l2"]
            <= BF16_FUSED_RATIO * dev["bf16_unfused_vs_f32_wav_rel_l2"]):
        raise SystemExit(f"ConvTasNet bfloat16: the fused decode is further from the float32 "
                         f"decode than {BF16_FUSED_RATIO} x the unfused one's: {dev}")

    # run_inference on the synthetic set (weights from the seed), fused_tcn on
    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as out:
            lines = []
            stats, counts = _launched(counters, lambda: run_inference(
                _config("convtasnet", fused_tcn=1, compute_dtype=dtype, test_output_dir=out),
                device="cuda", log_fn=lines.append))
            written = sorted(os.listdir(out))
        say(phase="convtasnet_serve", dtype=dtype, line=lines[-1], files=stats["files"],
            rtf=stats["rtf"], launches=counts)
        others = sum(v for k, v in counts.items() if k not in ("tcn_block_tail", "tcn_gln_stats"))
        if (stats["files"] != 6 or len(written) != 6 or counts["tcn_block_tail"] == 0
                or counts["tcn_block_tail"] % n_blocks or others
                or counts["tcn_gln_stats"] != counts["tcn_block_tail"]):
            raise SystemExit(f"ConvTasNet serving {dtype}: {stats} wrote {written}, "
                             f"launches {counts}")
    main_counts = _shape_counts()                  # ... and ends here

    # the card against the CPU's plain path, same weights, small input: the trunk
    # (zero phase) with TF32 as the control, then the Griffin-Lim front
    small = mel[:2, :, :64]
    h0 = _config("convtasnet", fused_tcn=1, init_phase="zero")
    cpu = InferenceEngine(h0, device="cpu").forward(small)
    gpu_eng = InferenceEngine(h0, device="cuda")
    gpu = gpu_eng.forward(small).cpu()
    _set_tf32(True)
    try:
        tf32 = gpu_eng.forward(small).cpu()
    finally:
        _set_tf32(False)

    def within(got):
        err = (got - cpu).abs()
        return bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all()) and \
            _rel_peak(got, cpu) <= MODEL_PEAK_REL

    ok, refused = within(gpu), not within(tf32)
    margs = (base.n_fft, base.num_mels, base.sampling_rate, base.hop_size, base.win_size,
             base.fmin, base.fmax)
    mag = torch.clamp(inverse_mel(small, *margs).abs(), min=1e-5)
    theta = torch.rand(mag.shape, generator=torch.Generator().manual_seed(0)) * 2 * math.pi - math.pi
    gl_args = (base.n_fft, base.hop_size, base.win_size)
    gl = _rel_peak(griffin_lim(mag.cuda(), *gl_args, theta=theta).cpu(),
                   griffin_lim(mag, *gl_args, theta=theta))
    say(phase="convtasnet_decode_vs_cpu_plain", batch=2, frames=64, init_phase="zero",
        max_abs_err=(gpu - cpu).abs().max().item(), peak_rel_err=_rel_peak(gpu, cpu),
        max_abs_ref=cpu.abs().max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL,
        peak_rel_limit=MODEL_PEAK_REL, ok=ok, tf32_control_peak_rel_err=_rel_peak(tf32, cpu),
        control_refused=refused, griffin_lim_peak_rel_err=gl, griffin_lim_limit=GL_PEAK_REL)
    if not ok:
        raise SystemExit("ConvTasNet decode on the card disagrees with the CPU plain path")
    if not refused:
        raise SystemExit("ConvTasNet decode vs the CPU: the TF32 control passes the limits")
    if not (gl <= GL_PEAK_REL):
        raise SystemExit(f"Griffin-Lim on the card is {gl} of the peak from the CPU's")
    return main_counts


# ---------------------------------------------------------------------------
# the two-direction scan (B7) behind the LSTM-layout bench, the per-step
# ablation harness (B8), and lstm_scan_fused at HD-Demucs's bottleneck
# ---------------------------------------------------------------------------

# lstm_scan_bidir as (label, steps, rows of one direction, H): the bench's defaults
# (batch 8, 1024 frames, 68 bands: the time LSTM over 8 x 68 rows, the band LSTM over
# 8 x 1024) at H = 128 and 256, and a ragged B held against its plain version only
BIDIR_SHAPES = tuple((label, T, B, H) for H in (128, 256)
                     for label, T, B in (("time", 1024, 544), ("band", 68, 8192),
                                         ("ragged", 64, 20)))
# rows held against their plain version on no main path: not in the kernels line
C7_HELD_LABELS = ("c7_h1024", "c7_h100")
# the float16 instances of the resident training kernels, beside bfloat16, at the shapes of
# the training paths (BSRNN-M's time and band BiLSTMs, GCRN's, HD-Demucs's): held against
# their plain versions (no main path trains in float16 at these shapes)
C7_F16_TRAIN = (("c7_f16_time", 544, 65, 128), ("c7_f16_band", 1040, 34, 128),
                ("c7_f16_gcrn", 16, 65, 448), ("c7_f16_hddemucs", 63, 16, 768))
C7_F16_LABELS = tuple(label for label, *_ in C7_F16_TRAIN)
HELD_ONLY = {"lstm_scan_bidir2": ("small", *C7_HELD_LABELS),
             "lstm_scan_bidir": ("ragged", *C7_HELD_LABELS),
             "lstm_scan_fused": ("ragged", *C7_HELD_LABELS, "c7_c102"),
             **{n: C7_HELD_LABELS for n in ("lstm_scan", "lstm_scan_stateful")},
             **{n: (*C7_HELD_LABELS, *C7_F16_LABELS) for n in ("lstm_fwd_hc", "lstm_bwd",
                                                              "lstm_bwd_dw")},
             "tcn_block_tail": tuple(f"c7_decode_d{2 ** i}" for i in range(8)),
             "tcn_gln_stats": ("c7_decode",)}


def _script(name):
    """scripts/<name>.py as a module (its main() is called in this process)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_bidir_kernels(cases, phase="lstm_scan_bidir_kernels"):
    """lstm_scan_bidir against its plain version at each (label, steps, rows
    of one direction B, H, dtype) of cases: csrc/lstm_scan.cu at H <= 128,
    csrc/lstm_scan_wide.cu mode kScanBidir above. Each direction's x_proj is
    its x @ W_ih + b; the library yardstick is two cuDNN unidirectional LSTM
    forwards on those x, the projection included; the control, which the
    limit must refuse, is the kernel with the halves of w_stack swapped."""
    from nvse_tpu_torch.ops import lstm as L

    rows = []
    for label, T, B, H, dtype in cases:
        G = 4 * H
        g = torch.Generator().manual_seed(T + B + H)
        b = 1.0 / math.sqrt(H)
        xs = [torch.randn(T, B, H, generator=g).to("cuda", dtype) for _ in range(2)]
        w_ih, bias, whh = ([torch.empty(sh).uniform_(-b, b, generator=g).to("cuda", dtype)
                            for _ in range(2)] for sh in ((H, G), (G,), (H, G)))
        libs = [cudnn_lstm([(w_ih[i], whh[i], bias[i])], dtype) for i in range(2)]
        item = xs[0].element_size()
        ops = 2 * 2 * B * T * H * G
        nbytes = (2 * B * T * (G + H) + 2 * H * G) * item
        with torch.inference_mode(), no_weight_compaction():
            xp = torch.cat([xs[i] @ w_ih[i] + bias[i] for i in range(2)], dim=1).contiguous()
            ws = torch.cat(whh).contiguous()
            run = lambda: L.lstm_scan_bidir(xp, ws)
            plain = lambda: L.lstm_scan_bidir_plain(xp, ws)
            library = lambda: (libs[0](xs[0])[0], libs[1](xs[1])[0])
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            err = (got.float() - ref.float()).abs().max().item()
            lib_err = (torch.cat(library(), dim=1).float() - ref.float()).abs().max().item()
            ctl = L.lstm_scan_bidir(xp, torch.cat(whh[::-1]).contiguous())
            control = (ctl.float() - ref.float()).abs().max().item()
            ctl = L.lstm_scan_bidir(xp, torch.cat([w.flip(0) for w in whh]).contiguous())
            w_control = (ctl.float() - ref.float()).abs().max().item()
            ms = cuda_ms(run, iters=10)
            plain_ms = cuda_ms(plain, iters=2, warmup=0)
            library_ms = cuda_ms(library, iters=10)
        bound, bound_by = _bound(nbytes, ops, dtype)
        row = dict(name="lstm_scan_bidir", shape=label, rows=2 * B, steps=T, H=H,
                   dtype=DT_NAME[dtype], source=_source("lstm_scan_bidir", H, dtype=dtype),
                   design=_design("lstm_scan_bidir", H, dtype, R=B),
                   max_abs_err=err, tol=TOL[dtype], ms=ms, us_per_step=ms * 1e3 / T,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library="2 cuDNN LSTM forwards, projection included",
                   library_max_abs_err=lib_err, control_max_abs_err=control,
                   control_whh_max_abs_err=w_control,
                   bound_ms=bound, bound_by=bound_by, tflops=ops / (ms * 1e-3) / 1e12)
        say(phase=phase, **row)
        if not (err <= TOL[dtype]):
            raise SystemExit(f"lstm_scan_bidir {label} H={H} {DT_NAME[dtype]}: max abs err "
                             f"{err} over tolerance {TOL[dtype]}")
        if not (control > TOL[dtype]):
            raise SystemExit(f"lstm_scan_bidir {label} H={H} {DT_NAME[dtype]}: the control with "
                             f"the halves of w_stack swapped ({control}) passes the tolerance")
        if not (w_control > TOL[dtype]):
            raise SystemExit(f"lstm_scan_bidir {label} H={H} {DT_NAME[dtype]}: the control with "
                             f"each half's rows reversed ({w_control}) passes the tolerance")
        rows.append(row)
    return rows


def phase_bench_lstm_kernel():
    """The port's LSTM-layout bench (scripts/bench_torch_lstm_kernel.py), its
    main() in this process at its default shapes and at --hidden 256, with 3
    timed calls a variant: every variant at the time and band shapes in
    float32 and bfloat16. -> its launches per wrapper and shape, which must
    include lstm_scan_bidir in both dtypes."""
    from nvse_tpu_torch.ops.lstm import _reset_counts

    bench = _script("bench_torch_lstm_kernel")
    _reset_counts(*_all_counters().values())       # this main path starts here
    t0 = time.time()
    for argv in ([], ["--hidden", "256"]):         # the kernel rows time each kernel at 10
        bench.main([*argv, "--iters", "3"])
    counts = _shape_counts()                       # ... and ends here
    say(phase="bench_lstm_kernel", seconds=time.time() - t0, launches_by_shape=_str_keys(counts))
    got = {(H, dt) for T, R, H, dt in counts["lstm_scan_bidir"]}
    want = {(H, dt) for H in (128, 256) for dt in ("float32", "bfloat16")}
    if got != want:
        raise SystemExit(f"the bench launched lstm_scan_bidir at {sorted(got)}, not {sorted(want)}")
    return counts


# lstm_scan_fused at HD-Demucs's bottleneck BiLSTM (nvse_tpu/models/hddemucas.py:55-71):
# 8 rows x 1024 frames, H = 768, layer 1 C = 768, layer 2 C = 1536
HDDEMUCS_SHAPES = ((8, 1024, 768, 768), (8, 1024, 1536, 768))


def phase_hddemucs_bottleneck():
    """lstm_scan_fused past its fused kernels, at HD-Demucs's bottleneck shapes
    in float32 and bfloat16: the projection as torch matmuls and one
    lstm_scan_bidir2 launch a call (at H = 768 mode kScanBidir of
    csrc/lstm_scan_wide.cu: no cluster holds the slice), none of a fused
    kernel, against lstm_scan_fused_plain. -> its launches per wrapper and
    shape (the bidir2 rows come from phase_rest)."""
    from nvse_tpu_torch.ops import lstm as L

    L._reset_counts(*_all_counters().values())     # this main path starts here
    for B, T, C, H in HDDEMUCS_SHAPES:
        for dtype in DTYPES:
            args = _lstm_inputs(B, T, C, H, dtype, seed=C + H)
            n0 = {k: dict(c.launches_by_kernel) for k, c in _all_counters().items()}
            with torch.inference_mode():
                got = L.lstm_scan_fused(*args)
                torch.cuda.synchronize()
                launches = {k: launch_delta(c.launches_by_kernel, n0[k])
                            for k, c in _all_counters().items()}
                ms = cuda_ms(lambda: L.lstm_scan_fused(*args), iters=5)
            ref = L.lstm_scan_fused_plain(*args)
            err = (got.float() - ref.float()).abs().max().item()
            launches = {k: v for k, v in launches.items() if v}
            say(phase="hddemucs_bottleneck", rows=B, steps=T, C=C, H=H, dtype=DT_NAME[dtype],
                route=L._fused_route(C, H), launches=launches, max_abs_err=err,
                tol=TOL[dtype], ms=ms)
            if launches != {"lstm_scan_bidir2": {"lstm_scan_wide": 1}}:
                raise SystemExit(f"lstm_scan_fused C={C} H={H}: launches {launches}, expected one "
                                 "of lstm_scan_bidir2 (csrc/lstm_scan_wide.cu kScanBidir)")
            if not (err <= TOL[dtype]) or got.shape != (B, T, 2 * H):
                raise SystemExit(f"lstm_scan_fused C={C} H={H} {DT_NAME[dtype]}: max abs err "
                                 f"{err} over tolerance {TOL[dtype]}")
    return _shape_counts()                         # ... and ends here


# HD-Demucs at its shipped width (hidden 48, depth 5, growth 2): 38,925,309 parameters
# in the JAX tree less the 4 x 4 x 768 b_hh entries that the port sums into one bias
HDDEMUCS_PARAMS = 38_913_021


def phase_hddemucs():
    """HD-Demucs (configs/hddemucas_config.json: Griffin-Lim front, 5 GLU stages,
    the BiLSTM bottleneck at H = 768) through the engine: decode B = 8 x 1024
    mel frames in float32 and bfloat16 (a bottleneck of 1022 steps; 2
    lstm_scan_bidir2 launches per forward, on csrc/lstm_scan_wide.cu
    kScanBidir, none of any other LSTM kernel), then run_inference on the
    synthetic set in both dtypes; afterwards the card against the CPU's plain
    path on a small input with zero initial phase (TF32 as the control)."""
    from nvse_tpu_torch.infer import InferenceEngine, run_inference
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.ops.spectral import mel_spectrogram

    counters = _all_counters()
    _reset_counts(*counters.values())              # this main path starts here
    base = _config("hddemucas")
    B, T, iters = 8, 1024, 3
    rng = np.random.default_rng(5)
    mel = torch.from_numpy(rng.standard_normal((B, base.num_mels, T)).astype(np.float32) - 4.0)
    melc = mel.to("cuda")
    audio_sec = B * (T - 1) * base.hop_size / base.sampling_rate
    wavs = {}
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(_config("hddemucas", compute_dtype=dtype), device="cuda")
        n_params = sum(p.numel() for p in eng.generator.parameters())
        steps = eng.generator.valid_length((T - 1) * base.hop_size) * base.resample
        for _ in range(int(base.depth)):
            steps = (steps - int(base.kernel_size)) // int(base.stride) + 1
        eng.forward(melc)                          # warmup
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = dict(counters["lstm_scan_bidir2"].launches_by_kernel)
        t0 = time.time()
        wav, counts = _launched(counters, lambda: [eng.forward(melc) for _ in range(iters)][-1])
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
        by_kernel = launch_delta(counters["lstm_scan_bidir2"].launches_by_kernel, n0)
        say(phase="hddemucs_decode", dtype=dtype, batch=B, frames=T, bottleneck_steps=steps,
            parameters=n_params, wall_ms=wall * 1e3, rtf=audio_sec / wall,
            launches_per_forward={k: v / iters for k, v in counts.items()},
            bidir2_by_kernel=by_kernel, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        expect = {k: (2 * iters if k == "lstm_scan_bidir2" else 0) for k in counters}
        if counts != expect or by_kernel != {"lstm_scan_wide": 2 * iters}:
            raise SystemExit(f"HD-Demucs decode {dtype}: launches {counts} ({by_kernel}), expected "
                             "2 lstm_scan_bidir2 per forward on csrc/lstm_scan_wide.cu, no other")
        if wav.shape != (B, (T - 1) * base.hop_size) or not torch.isfinite(wav).all():
            raise SystemExit(f"HD-Demucs decode {dtype}: bad output {tuple(wav.shape)}")
        if n_params != HDDEMUCS_PARAMS:
            raise SystemExit(f"HD-Demucs has {n_params} parameters, not {HDDEMUCS_PARAMS}")
        wavs[dtype] = wav
        del eng
        torch.cuda.empty_cache()
    f32, bf = wavs["float32"], wavs["bfloat16"]
    margs = (base.n_fft, base.num_mels, base.sampling_rate, base.hop_size, base.win_size,
             base.fmin, base.sampling_rate / 2)
    say(phase="hddemucs_decode",
        bf16_vs_f32_mel_l1=(mel_spectrogram(f32, *margs) - mel_spectrogram(bf, *margs))
        .abs().mean().item(), bf16_vs_f32_wav_rel_l2=_rel_l2(bf, f32))

    # run_inference on the synthetic set (weights from the seed)
    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as out:
            lines = []
            stats, counts = _launched(counters, lambda: run_inference(
                _config("hddemucas", compute_dtype=dtype, test_output_dir=out), device="cuda",
                log_fn=lines.append))
            written = sorted(os.listdir(out))
        say(phase="hddemucs_serve", dtype=dtype, line=lines[-1], files=stats["files"],
            rtf=stats["rtf"], launches=counts)
        others = sum(v for k, v in counts.items() if k != "lstm_scan_bidir2")
        if (stats["files"] != 6 or len(written) != 6 or counts["lstm_scan_bidir2"] == 0
                or counts["lstm_scan_bidir2"] % 2 or others):
            raise SystemExit(f"HD-Demucs serving {dtype}: {stats} wrote {written}, "
                             f"launches {counts}")
    main_counts = _shape_counts()                  # ... and ends here

    # the card against the CPU's plain path, same weights, small input, zero phase
    small = mel[:2, :, :64]
    h0 = _config("hddemucas", init_phase="zero")
    cpu = InferenceEngine(h0, device="cpu").forward(small)
    gpu_eng = InferenceEngine(h0, device="cuda")
    gpu = gpu_eng.forward(small).cpu()
    _set_tf32(True)
    try:
        tf32 = gpu_eng.forward(small).cpu()
    finally:
        _set_tf32(False)

    def within(got):
        err = (got - cpu).abs()
        return bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all()) and \
            _rel_peak(got, cpu) <= MODEL_PEAK_REL

    ok, refused = within(gpu), not within(tf32)
    say(phase="hddemucs_decode_vs_cpu_plain", batch=2, frames=64, init_phase="zero",
        max_abs_err=(gpu - cpu).abs().max().item(), peak_rel_err=_rel_peak(gpu, cpu),
        max_abs_ref=cpu.abs().max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL,
        peak_rel_limit=MODEL_PEAK_REL, ok=ok, tf32_control_peak_rel_err=_rel_peak(tf32, cpu),
        control_refused=refused)
    if not ok:
        raise SystemExit("HD-Demucs decode on the card disagrees with the CPU plain path")
    if not refused:
        raise SystemExit("HD-Demucs decode vs the CPU: the TF32 control passes the limits")
    return main_counts


# the conv T-F vocoders (ROADMAP A3) at their published widths: config name ->
# parameters (the JAX trees' counts; APNet's before weight norm is folded)
TF_VOCODERS = {"apnet": 72_191_494, "apnet2": 31_425_539, "freeV": 18_218_509,
               "vocos": 13_480_450}
# the MRF vocoders (time domain; configs/hifigan_v1_config.json, istftnet_config.json):
# parameters at the published widths; T mel frames decode to hop * T samples
MRF_VOCODERS = {"hifigan": 13_936_130, "istftnet": 13_262_244}


def _no_launches(counts):
    return not any(counts.values())


def phase_tf_vocoder(name):
    """APNet, APNet2, FreeV or Vocos (configs/<name>_config.json), or the MRF
    vocoders HiFiGAN and iSTFTNet (MRF_VOCODERS), seeded random weights, through
    the engine: decode B = 8 x 1024 mel frames in float32 and bfloat16 (weight
    norm folded at load: APNet's convs, HiFiGAN's and iSTFTNet's convs and
    transposed convs), run_inference on the synthetic set in both dtypes and
    streamed by context recompute in float32; no launch of any kernel of csrc/
    (these models run convolutions, GELU, LayerNorm and the iSTFT, which stay
    PyTorch). Then the card against the CPU's plain path on a small input, TF32
    as the control."""
    from nvse_tpu_torch.infer import InferenceEngine, run_inference
    from nvse_tpu_torch.models import build_generator
    from nvse_tpu_torch.models.layers import WNConv1d
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.ops.spectral import mel_spectrogram

    counters = _all_counters()
    _reset_counts(*counters.values())              # this main path starts here
    base = _config(name)
    n_params = sum(p.numel() for p in build_generator(base)[0].parameters())
    want_params = {**TF_VOCODERS, **MRF_VOCODERS}[name]
    if n_params != want_params:
        raise SystemExit(f"{name} has {n_params} parameters, not {want_params}")
    B, T, iters = 8, 1024, 3
    rng = np.random.default_rng(6)
    mel = torch.from_numpy(rng.standard_normal((B, base.num_mels, T)).astype(np.float32) - 4.0)
    melc = mel.to("cuda")
    out_len = (T if name in MRF_VOCODERS else T - 1) * base.hop_size
    audio_sec = B * out_len / base.sampling_rate
    wavs = {}
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(_config(name, compute_dtype=dtype), device="cuda")
        wn = [m for m in eng.generator.modules() if isinstance(m, WNConv1d)]
        eng.forward(melc)                          # warmup
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        wav, counts = _launched(counters, lambda: [eng.forward(melc) for _ in range(iters)][-1])
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
        say(phase=_tag(name, "decode"), dtype=dtype, batch=B, frames=T, parameters=n_params,
            weight_norm_convs_folded=sum(m.folded for m in wn), wall_ms=wall * 1e3,
            rtf=audio_sec / wall, launches=counts,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if not _no_launches(counts) or not all(m.folded for m in wn):
            raise SystemExit(f"{name} decode {dtype}: launches {counts}, expected none; "
                             f"{sum(m.folded for m in wn)} of {len(wn)} weight-norm convs folded")
        if wav.shape != (B, out_len) or not torch.isfinite(wav).all():
            raise SystemExit(f"{name} decode {dtype}: bad output {tuple(wav.shape)}")
        wavs[dtype] = wav
        del eng
        torch.cuda.empty_cache()
    f32, bf = wavs["float32"], wavs["bfloat16"]
    margs = (base.n_fft, base.num_mels, base.sampling_rate, base.hop_size, base.win_size,
             base.fmin, base.sampling_rate / 2)
    say(phase=_tag(name, "decode"),
        bf16_vs_f32_mel_l1=(mel_spectrogram(f32, *margs) - mel_spectrogram(bf, *margs))
        .abs().mean().item(), bf16_vs_f32_wav_rel_l2=_rel_l2(bf, f32))

    # run_inference on the synthetic set (weights from the seed): batched in each
    # dtype, and file by file in chunks by context recompute
    for dtype, stream in (("float32", False), ("bfloat16", False), ("float32", True)):
        with tempfile.TemporaryDirectory() as out:
            lines = []
            stats, counts = _launched(counters, lambda: run_inference(
                _config(name, compute_dtype=dtype, test_output_dir=out), device="cuda",
                log_fn=lines.append, stream=stream))
            written = sorted(os.listdir(out))
        say(phase=_tag(name, "serve"), dtype=dtype, stream=stream, line=lines[-1],
            files=stats["files"], rtf=stats["rtf"], launches=counts)
        if stats["files"] != 6 or len(written) != 6 or not _no_launches(counts):
            raise SystemExit(f"{name} serving {dtype} stream={stream}: {stats} wrote {written}, "
                             f"launches {counts}")
    main_counts = _shape_counts()                  # ... and ends here

    # the card against the CPU's plain path, same weights, small input
    small = mel[:2, :, :64]
    cpu = InferenceEngine(base, device="cpu").forward(small)
    gpu_eng = InferenceEngine(base, device="cuda")
    gpu = gpu_eng.forward(small).cpu()
    _set_tf32(True)
    try:
        tf32 = gpu_eng.forward(small).cpu()
    finally:
        _set_tf32(False)

    def within(got):
        err = (got - cpu).abs()
        return bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all()) and \
            _rel_peak(got, cpu) <= MODEL_PEAK_REL

    ok, refused = within(gpu), not within(tf32)
    say(phase=_tag(name, "decode_vs_cpu_plain"), batch=2, frames=64,
        max_abs_err=(gpu - cpu).abs().max().item(), peak_rel_err=_rel_peak(gpu, cpu),
        max_abs_ref=cpu.abs().max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL,
        peak_rel_limit=MODEL_PEAK_REL, ok=ok, tf32_control_peak_rel_err=_rel_peak(tf32, cpu),
        control_refused=refused)
    if not ok:
        raise SystemExit(f"{name} decode on the card disagrees with the CPU plain path")
    if not refused:
        raise SystemExit(f"{name} decode vs the CPU: the TF32 control passes the limits")
    return main_counts


def phase_tf_vocoder_train(name):
    """GANTrainer steps of APNet, APNet2, FreeV or Vocos at the published
    width, batch 16 x 16384, in float32 and bfloat16 (ms per step, device busy
    time and idle share, peak memory, losses): finite losses, every G and D
    parameter changed, a finite nonzero gradient on every weight-norm v and g
    (APNet: weight norm is not folded in training) and every GRN gamma and
    beta (the ConvNeXt families), and no launch of any kernel of csrc/."""
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    B, iters = 16, 3
    counters = _all_counters()
    _reset_counts(*counters.values())              # this main path starts here
    for dtype in ("float32", "bfloat16"):
        h = _config(name, compute_dtype=dtype)
        audio = _audio_batch(B, int(h.segment_size), h.sampling_rate, seed=0).to("cuda")
        tr = GANTrainer(h, device="cuda", steps_per_epoch=2)
        before = {n: p.detach().clone() for n, p in
                  [*tr.generator.named_parameters(), *tr.disc.named_parameters()]}
        torch.cuda.reset_peak_memory_stats()
        metrics = tr.step(audio)                   # warmup
        torch.cuda.synchronize()
        t0 = time.time()
        metrics, counts = _launched(counters, lambda: [tr.step(audio) for _ in range(iters)][-1])
        torch.cuda.synchronize()
        ms = (time.time() - t0) / iters * 1e3
        busy = _busy_ms(lambda: tr.step(audio))
        losses = fetch_scalars(metrics)
        after = dict([*tr.generator.named_parameters(), *tr.disc.named_parameters()])
        unchanged = [n for n, p in after.items() if torch.equal(p.detach(), before[n])]
        leaves = (".v", ".g") if name == "apnet" else (".gamma", ".beta")
        held = {n: p for n, p in tr.generator.named_parameters() if n.endswith(leaves)}
        bad_grad = [n for n, p in held.items() if p.grad is None
                    or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0]
        say(phase=_tag(name, "train"), dtype=dtype, batch=B, segment=int(h.segment_size),
            ms_per_step=ms, steps_timed=iters, device_busy_ms=busy,
            idle_share=1.0 - busy / ms if busy else "not measured",
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
            held_params=len(held), held=leaves, losses=losses)
        fails = []
        if not all(math.isfinite(v) for v in losses.values()):
            fails.append(f"non-finite losses {losses}")
        if unchanged:
            fails.append(f"parameters not updated: {unchanged[:5]} ({len(unchanged)})")
        if not held or bad_grad:
            fails.append(f"{len(held)} {leaves} params, without a finite nonzero grad: "
                         f"{bad_grad[:5]}")
        if not _no_launches(counts):
            fails.append(f"kernel launches {counts}, expected none")
        if fails:
            raise SystemExit(f"train {name} {dtype}: " + "; ".join(fails))
        del tr, before, after, held
        torch.cuda.empty_cache()
    return _shape_counts()                         # ... and ends here


# the time trainer's models (phase name -> config overrides) and the launches a step
# makes of each counted wrapper (none of any other): ConvTasNet's 24 TCN tails and
# their gLN statistics in the forward (the backward recomputes the plain tail, as the
# JAX custom VJP recomputes XLA's); HD-Demucs's two bottleneck BiLSTMs, each direction
# through the residual-saving training forward, the backward recurrence and the dW_hh
# reduction (csrc/lstm_scan_wide.cu kFwdHc, csrc/lstm_bwd_wide.cu, csrc/lstm_bwd.cu)
TIME_TRAIN = {"hifigan": ({}, {}), "istftnet": ({}, {}),
              "convtasnet": (dict(fused_tcn=1), {"tcn_block_tail": 24, "tcn_gln_stats": 24}),
              "hddemucs": ({}, {"lstm_fwd_hc": 4, "lstm_bwd": 4, "lstm_bwd_dw": 4})}


def _time_held(name, module):
    """The generator parameters whose gradient a time-domain step must reach:
    the MRF vocoders' weight-norm v and g (the transposed convs' too);
    ConvTasNet's fused tail weights (gLN, depthwise conv, skip 1x1); HD-Demucs's
    12 bottleneck LSTM tensors."""
    if name in MRF_VOCODERS:
        keep = lambda n: n.endswith((".v", ".g"))
    elif name == "convtasnet":
        keep = lambda n: n.endswith((".norm.weight", ".dwconv.kernel", ".skip_conv.kernel"))
    else:
        keep = lambda n: n.startswith("lstm.lstm")
    return {n: p for n, p in module.named_parameters() if keep(n)}


def phase_time_train(name):
    """GANTrainer steps of a time-domain model at its published width, batch 16 x
    16384, in float32 and bfloat16, through the time trainer (MPD + MSD; LS-GAN for
    HiFiGAN / iSTFTNet, hinge for ConvTasNet / HD-Demucs): ms per step, device busy
    time and idle share, peak memory, finite losses, every parameter changed, the
    launches per step of TIME_TRAIN. The first step runs split into its passes: the
    MSD's spectral-norm vectors u must change in the D pass and not in the G pass,
    and after it every generator parameter of `_time_held` and every SNConv1d kernel
    must hold a finite nonzero gradient."""
    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars
    from nvse_tpu_torch.train.trainer import _spectral_buffers

    kw, per_step = TIME_TRAIN[name]
    B, iters = 16, 2
    counters = _all_counters()
    _reset_counts(*counters.values())              # this main path starts here
    for dtype in ("float32", "bfloat16"):
        h = _config(name, compute_dtype=dtype, **kw)
        audio = _audio_batch(B, int(h.segment_size), h.sampling_rate, seed=0).to("cuda")
        tr = GANTrainer(h, device="cuda", steps_per_epoch=2)
        before = {n: p.detach().clone() for n, p in
                  [*tr.generator.named_parameters(), *tr.disc.named_parameters()]}
        torch.cuda.reset_peak_memory_stats()
        u0 = [u.clone() for u in _spectral_buffers(tr.disc)]
        fwd = tr.generator_forward(audio)
        tr.discriminator_update(fwd)
        u1 = [u.clone() for u in _spectral_buffers(tr.disc)]
        tr.generator_update(fwd)
        u2 = [u.clone() for u in _spectral_buffers(tr.disc)]
        del fwd
        held = {**_time_held(name, tr.generator),
                **{f"disc.{n}": p for n, p in tr.disc.named_parameters()
                   if n.startswith("msd.discs.0.") and n.endswith(".kernel")}}
        bad_grad = [n for n, p in held.items() if p.grad is None
                    or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0]
        torch.cuda.synchronize()
        t0 = time.time()
        metrics, counts = _launched(counters, lambda: [tr.step(audio) for _ in range(iters)][-1])
        torch.cuda.synchronize()
        ms = (time.time() - t0) / iters * 1e3
        busy = _busy_ms(lambda: tr.step(audio))
        losses = fetch_scalars(metrics)
        after = dict([*tr.generator.named_parameters(), *tr.disc.named_parameters()])
        unchanged = [n for n, p in after.items() if torch.equal(p.detach(), before[n])]
        u_d = sum(not torch.equal(a, b) for a, b in zip(u0, u1))
        u_g = sum(not torch.equal(a, b) for a, b in zip(u1, u2))
        per = {k: v / iters for k, v in counts.items()}
        # f32 steps trace more kernel time than their wall time (kernels overlapped or
        # ran longer under the profiler): no idle share there
        say(phase=f"{name}_train", dtype=dtype, batch=B, segment=int(h.segment_size),
            ms_per_step=ms, steps_timed=iters, device_busy_ms=busy,
            idle_share=1.0 - busy / ms if busy and busy <= ms else "not measured",
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches_per_step=per,
            held_params=len(held), u_vectors=len(u0), u_changed_in_d_pass=u_d,
            u_changed_in_g_pass=u_g, loss=tr.d_loss.__name__, losses=losses)
        fails = []
        if not all(math.isfinite(v) for v in losses.values()):
            fails.append(f"non-finite losses {losses}")
        if unchanged:
            fails.append(f"parameters not updated: {unchanged[:5]} ({len(unchanged)})")
        if len(held) <= 8 or bad_grad:
            fails.append(f"{len(held)} held params, without a finite nonzero grad: "
                         f"{bad_grad[:5]}")
        if len(u0) != 8 or u_d != 8 or u_g:
            fails.append(f"{len(u0)} spectral-norm vectors, {u_d} changed in the D pass and "
                         f"{u_g} in the G pass (expected 8, 8, 0)")
        expect = {k: per_step.get(k, 0) for k in counters}
        if per != expect:
            fails.append(f"launches per step {per}, expected {expect}")
        if fails:
            raise SystemExit(f"train {name} {dtype}: " + "; ".join(fails))
        del tr, before, after, held
        torch.cuda.empty_cache()
    return _shape_counts()                         # ... and ends here


# ---------------------------------------------------------------------------
# the CQT discriminator in the GAN step, and the evaluation path
# ---------------------------------------------------------------------------

def _cqtd_passes(tr, args):
    """One GAN step split into its passes: the D pass must change every CQTD
    parameter and leave each a finite nonzero gradient, the G pass none.
    -> (failures, readings)."""
    cq = tr.disc["cqtd"]
    p0 = {n: p.detach().clone() for n, p in cq.named_parameters()}
    fwd = tr.generator_forward(*args)
    tr.discriminator_update(fwd)
    p1 = {n: p.detach().clone() for n, p in cq.named_parameters()}
    bad_grad = [n for n, p in cq.named_parameters() if p.grad is None
                or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0]
    tr.generator_update(fwd)
    d_same = [n for n in p0 if torch.equal(p0[n], p1[n])]
    g_moved = [n for n, p in cq.named_parameters() if not torch.equal(p.detach(), p1[n])]
    fails = []
    if d_same or g_moved or bad_grad:
        fails.append(f"CQTD parameters the D pass left ({d_same[:3]}), the G pass moved "
                     f"({g_moved[:3]}), without a finite nonzero gradient ({bad_grad[:3]}) "
                     f"of {len(p0)}")
    return fails, dict(cqtd_params=len(p0), cqtd_param_count=sum(p.numel() for p in p0.values()),
                       cqtd_changed_in_d_pass=len(p0) - len(d_same),
                       cqtd_changed_in_g_pass=len(g_moved))


@functools.lru_cache(maxsize=None)
def _cqt_conv_weight(sr, n_bins, bpo, device, dtype):
    from nvse_tpu_torch.ops.cqt import cqt_bank

    return torch.from_numpy(cqt_bank(sr, n_bins, bpo).T.copy()).to(device, dtype)[:, None, :]


def _cqt_conv1d(x, sr, hop, n_bins, bpo):
    """The CQT as F.conv1d of the padded wave over the bank (cuDNN): the other
    form ops/cqt.py could take, timed beside it; the weight made on the card once."""
    import torch.nn.functional as F

    w = _cqt_conv_weight(sr, n_bins, bpo, x.device, x.dtype)
    pad = w.shape[-1] // 2
    out = F.conv1d(F.pad(x[:, None], (pad, pad)), w, stride=hop)
    return out[:, :n_bins], out[:, n_bins:]


def _cqt_forms(h, B, dtype, busy_ms):
    """The CQTs of one step (per scale: the D pass's real and generated waves, the
    G pass's real wave, and the G pass's generated wave with its input gradient)
    at the step's shapes and dtype, in the port's form (ops/cqt.py: one GEMM of
    the framed wave and the bank) and as F.conv1d over the bank (`_cqt_conv1d`);
    the forms' max |difference|, each one's ms a step and its share of the step's
    device-busy time."""
    from nvse_tpu_torch.models.cqt_discriminator import MultiScaleSubbandCQTDiscriminator
    from nvse_tpu_torch.ops.cqt import cqt, cqt_bank
    from nvse_tpu_torch.ops.resample import upsample2

    dt = getattr(torch, dtype)
    x = upsample2(_audio_batch(B, int(h.segment_size), h.sampling_rate, seed=5).to("cuda"))
    x = x.to(dt)
    scales = [(2 * h.sampling_rate, d.hop_length, d.bins_per_octave * d.n_octaves,
               d.bins_per_octave) for d in MultiScaleSubbandCQTDiscriminator.from_config(h).discs]
    out, err, flops = {}, 0.0, 0
    for name, fn in (("unfold_gemm", cqt), ("conv1d", _cqt_conv1d)):
        xg = x.detach().clone().requires_grad_(True)

        def forward():
            with torch.no_grad():
                return [fn(x, *s) for s in scales]

        def with_grad():
            for s in scales:
                re, im = fn(xg, *s)
                (re.sum() + im.sum()).backward()

        fwd_ms, grad_ms = cuda_ms(forward, iters=5), cuda_ms(with_grad, iters=5)
        out[name] = dict(ms_per_step=3 * fwd_ms + grad_ms, forward_ms=fwd_ms,
                         forward_backward_ms=grad_ms,
                         share_of_busy=(3 * fwd_ms + grad_ms) / busy_ms if busy_ms else None)
        res = forward()
        if name == "unfold_gemm":
            ref = res
            for (sr, _, nb, bpo), (re, _) in zip(scales, res):
                flops += 2 * B * re.shape[-1] * cqt_bank(sr, nb, bpo).shape[0] * 2 * nb
        else:
            err = max((a.float() - b.float()).abs().max().item()
                      for ra, rb in zip(res, ref) for a, b in zip(ra, rb))
    return dict(cqt_forms=out, cqt_forms_max_abs_diff=err, cqt_gflop_per_forward=flops / 1e9,
                cqt_form_used="unfold_gemm")


UTMOS_SECONDS, UTMOS_BUCKET = (2.3, 3.1, 3.9), 4 * 16000
UTMOS_CARD_ATOL, UTMOS_MASK_ATOL = 2e-4, 1e-4


def _speechlike(seconds, sr, seed):
    """A wave with a moving pitch, formant-like amplitude and noise (1, n)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 120 + 60 * np.sin(2 * np.pi * 0.7 * t + seed)
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / sr) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))
    return torch.from_numpy((x + 0.02 * rng.standard_normal(n)).astype(np.float32))[None]


def phase_utmos():
    """UTMOS at its published widths (wav2vec2-base, 12 layers, the decoder
    BiLSTM C = 1024, H = 512), seeded weights, on the card: 3 waves of 2.3-3.9 s
    scored at their lengths and, zero-padded to a 4 s bucket, through the masked
    forward (n_samples), one at a time and as one batch of 3; each card score
    against the CPU's plain path (UTMOS_CARD_ATOL), each masked score against the
    exact one (UTMOS_MASK_ATOL); ms per second of audio; one lstm_scan_bidir2
    launch a forward (lstm_scan_fused's projection route), counted here and held
    by phase_rest. Control, which the masked limit must refuse: the backward scan
    fed the padded input unreversed (lstm_scan_fused without lengths)."""
    from nvse_tpu_torch.metrics import utmos as U
    from nvse_tpu_torch.ops.lstm import _reset_counts, lstm_scan_bidir2

    wavs = [_speechlike(s, 16000, i) for i, s in enumerate(UTMOS_SECONDS)]
    cpu = U.UTMOSModel(seed=0).eval()
    n_params = sum(p.numel() for p in cpu.parameters())
    cpu_scores = [cpu(w).item() for w in wavs]
    card = U.UTMOSModel(seed=0).eval().to("cuda")
    padded = torch.cat([torch.nn.functional.pad(w, (0, UTMOS_BUCKET - w.shape[1]))
                        for w in wavs]).to("cuda")
    lengths = [w.shape[1] for w in wavs]

    _reset_counts(*_all_counters().values())       # this main path starts here
    exact = [card(w.to("cuda")).item() for w in wavs]      # (warmup)
    forwards = len(wavs)
    torch.cuda.synchronize()
    t0, iters = time.time(), 3
    for _ in range(iters):
        for w in wavs:
            card(w.to("cuda"))
    torch.cuda.synchronize()
    ms_per_audio_s = (time.time() - t0) * 1e3 / (iters * sum(UTMOS_SECONDS))
    forwards += iters * len(wavs)
    masked = [card(padded[i:i + 1], n_samples=n).item() for i, n in enumerate(lengths)]
    batch = card(padded, n_samples=lengths).cpu().tolist()
    forwards += len(wavs) + 1
    counts = _shape_counts()                       # ... and ends here
    launched = lstm_scan_bidir2.launches

    real = U.lstm_scan_fused
    U.lstm_scan_fused = lambda *a, lengths=None: real(*a)     # the control: no reversal
    try:
        control = [card(padded[i:i + 1], n_samples=n).item() for i, n in enumerate(lengths)]
    finally:
        U.lstm_scan_fused = real
    card_err = max(abs(a - b) for a, b in zip(exact, cpu_scores))
    mask_err = max(abs(a - b) for a, b in zip(masked + batch, exact + exact))
    ctl_err = max(abs(a - b) for a, b in zip(control, exact))
    say(phase="utmos", parameters=n_params, seconds=UTMOS_SECONDS, bucket_samples=UTMOS_BUCKET,
        scores=exact, cpu_scores=cpu_scores, masked_scores=masked, batch_scores=batch,
        card_vs_cpu_max_abs=card_err, card_atol=UTMOS_CARD_ATOL, masked_vs_exact_max_abs=mask_err,
        mask_atol=UTMOS_MASK_ATOL, control_unreversed_max_abs=ctl_err,
        ms_per_audio_second=ms_per_audio_s, forwards=forwards, bidir2_launches=launched,
        launches_by_shape=_str_keys(counts))
    fails = []
    if not all(math.isfinite(v) for v in exact + masked + batch):
        fails.append("non-finite scores")
    if not card_err <= UTMOS_CARD_ATOL:
        fails.append(f"card vs CPU {card_err} over {UTMOS_CARD_ATOL}")
    if not mask_err <= UTMOS_MASK_ATOL:
        fails.append(f"masked vs exact {mask_err} over {UTMOS_MASK_ATOL}")
    if not ctl_err > UTMOS_MASK_ATOL:
        fails.append(f"the unreversed control ({ctl_err}) passes {UTMOS_MASK_ATOL}")
    if launched != forwards or sum(n for d in counts.values() for n in d.values()) != forwards:
        fails.append(f"{launched} lstm_scan_bidir2 launches for {forwards} forwards: {counts}")
    if fails:
        raise SystemExit("utmos: " + "; ".join(fails))
    return counts


CREPE_ATOL = 1e-4


def phase_crepe():
    """CREPE full (22.2 M parameters) with seeded weights in torchcrepe's layout,
    loaded as a checkpoint is (load_crepe), on the card: the posteriors of 32
    normalised frames against the CPU's plain path (CREPE_ATOL on values in
    (0, 1)), and frames a second at 512 frames a batch."""
    from nvse_tpu_torch.metrics import crepe as C

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "full.pth")
        torch.save(C.Crepe("full", seed=4).state_dict(), ckpt)
        net = C.load_crepe(ckpt, "full", "cuda")
        cpu = C.load_crepe(ckpt, "full", "cpu")
    frames = C.frames_of(_speechlike(0.4, 16000, 9)[0].numpy(), 16000)[:32]
    got, ref = C.posteriors(net, frames), C.posteriors(cpu, frames)
    err = float(np.abs(got - ref).max())
    batch = torch.randn(512, 1024, generator=torch.Generator().manual_seed(0)).to("cuda")
    with torch.no_grad():
        ms = cuda_ms(lambda: net(batch), iters=5)
    say(phase="crepe", parameters=sum(p.numel() for p in net.parameters()), frames=len(frames),
        max_abs_err=err, atol=CREPE_ATOL, posterior_range=[float(ref.min()), float(ref.max())],
        ms_per_512_frames=ms, frames_per_second=512 / (ms * 1e-3))
    if not (err <= CREPE_ATOL and np.isfinite(got).all()):
        raise SystemExit(f"crepe: card posteriors off the CPU's by {err} (atol {CREPE_ATOL})")


def phase_eval_cli():
    """The evaluation path: run_inference serves the synthetic test set with
    seeded BSRNN-M weights on the card, then python -m nvse_tpu_torch.metrics in
    this process scores the decodes against the clean wavs: lsd (2 spawned
    workers, after CUDA is up), stoi, pesq, mcd, evaluate (CREPE full from a
    seeded torchcrepe-layout checkpoint, on the card) and utmos (from a seeded
    lightning-layout checkpoint, on the card). Every printed number must be
    finite; the seconds of each."""
    import re

    from nvse_tpu_torch.infer import run_inference
    from nvse_tpu_torch.metrics import cli
    from nvse_tpu_torch.metrics import crepe as C
    from nvse_tpu_torch.metrics import utmos as U
    from nvse_tpu_torch.ops.lstm import _reset_counts

    h = _config("bsrnn")
    _reset_counts(*_all_counters().values())       # this main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "decoded")
        h.test_output_dir = out
        t0 = time.time()
        stats = run_inference(h, log_fn=lambda line: None, device="cuda")
        decode_s = time.time() - t0
        crepe_ckpt, utmos_ckpt = os.path.join(tmp, "full.pth"), os.path.join(tmp, "utmos.ckpt")
        torch.save(C.Crepe("full", seed=2).state_dict(), crepe_ckpt)
        torch.save({"state_dict": U.lightning_state_dict(U.UTMOSModel(seed=3))}, utmos_ckpt)
        pair = ["--ref_dir", os.path.join(REPO, h.raw_wavfile_path), "--deg_dir", out]
        runs = [("lsd", pair + ["--jb", "2"]), ("stoi", pair + ["--jb", "1"]),
                ("pesq", pair + ["--jb", "1"]), ("mcd", pair + ["--jb", "1"]),
                ("evaluate", pair + ["--jb", "1"]), ("utmos", ["--deg_dir", out, "--ckpt", utmos_ckpt])]
        env = {k: os.environ.get(k) for k in ("NVSE_CREPE_CKPT", "NVSE_CREPE_MODEL")}
        os.environ.update(NVSE_CREPE_CKPT=crepe_ckpt, NVSE_CREPE_MODEL="full")
        results = {}
        try:
            for name, argv in runs:
                buf = io.StringIO()
                t0 = time.time()
                with contextlib.redirect_stdout(buf):
                    cli.main([name, *argv])
                lines = buf.getvalue().splitlines()
                nums = [float(v) for l in lines for v in re.findall(r"-?\d+\.\d+|nan|inf", l)]
                results[name] = dict(lines=lines, seconds=time.time() - t0, numbers=nums)
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            C.load_crepe.cache_clear()
    counts = _shape_counts()                       # ... and ends here
    say(phase="eval_cli", files=stats["files"], decode_seconds=decode_s, rtf=stats["rtf"],
        metrics=results, launches_by_shape=_str_keys(counts))
    bad = [n for n, r in results.items() if not r["numbers"]
           or not all(math.isfinite(v) for v in r["numbers"]) or any("n/a" in l for l in r["lines"])]
    if stats["files"] != 6 or bad or "CREPE full" not in results["evaluate"]["lines"][0]:
        raise SystemExit(f"eval_cli: {stats['files']} files decoded; metrics without finite "
                         f"numbers: {bad}; {results.get('evaluate', {}).get('lines')}")
    if not counts.get("lstm_scan_bidir2"):
        raise SystemExit(f"eval_cli: UTMOS launched no lstm_scan_bidir2: {counts}")
    return counts


# serving export (nvse_tpu_torch/infer/export.py): BSRNN-M at the decode phase's batch, then
# one artifact of each kernel family at serving's bucket (8 x 128 frames), each with the
# kernel launches one forward of the artifact must make (per wrapper, per kernel source).
# ConvTasNet and HD-Demucs start from zero phase: their Griffin-Lim front (32 stft / istft
# rounds, held on the live engine by phases 15 and 16) would add ~30 s of tracing
EXPORT_B, EXPORT_T, EXPORT_SERVE_T, EXPORT_ITERS = 8, 1024, 128, 5
EXPORT_SERVE = (("convtasnet", dict(fused_tcn=1, init_phase="zero"),
                 {"tcn_block_tail": {"tcn_tail": 24, "tcn_gln_stats": 24},
                  "tcn_gln_stats": {"tcn_gln_stats": 24}}),
                ("gcrn", {}, {"lstm_scan_bidir2": {"lstm_bidir2": 2}}),
                ("hddemucs", dict(init_phase="zero"), {"lstm_scan_bidir2": {"lstm_scan_wide": 2}}),
                ("bsrnn", dict(causal=True), {"lstm_scan": {"lstm_scan": 8},
                                              "lstm_scan_fused": {"lstm_fused": 8}}))
# artifact vs live engine (the same kernels on the same inputs): float32 at 1e-5, bfloat16
# at 1e-3 of the wave's peak; the conv family's symbolic time axis (the iSTFT envelope summed
# in the graph) and the CLI's round trip at the CLI's 1e-4
EXPORT_F32_TOL, EXPORT_BF16_REL, EXPORT_CLI_TOL = 1e-5, 1e-3, 1e-4
CARD = ""                          # nvidia-smi's name and power limit, set by main()


def _kernel_launches(counters, fn):
    """fn() (synchronised) and the launches it made per wrapper and kernel source."""
    n0 = {k: dict(c.launches_by_kernel) for k, c in counters.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: d for k, c in counters.items()
                 if (d := launch_delta(c.launches_by_kernel, n0[k]))}


def _wall_ms(fn, iters):
    """ms a call of fn over iters synchronised calls after a warmup, as phase 3."""
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) / iters * 1e3


def _export_case(tmp, name, h, B, T, expect, counters):
    """Export h's decoder at (B, T) on the card, save, load in this process and
    decode: one forward's launches must be `expect`, the output the live engine's.
    -> (engine, decoder, mel, meta, seconds to export, to load, MB, live wave)."""
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.infer.export import export_decoder, load_decoder

    rng = np.random.default_rng(11)
    mel = torch.from_numpy(rng.standard_normal((B, h.num_mels, T)).astype(np.float32) - 4.0)
    mel = mel.to("cuda")
    eng = InferenceEngine(h, device="cuda")
    path = os.path.join(tmp, f"{name}.nvsx")
    t0 = time.time()
    meta = export_decoder(h, eng.generator.state_dict(), path, batch=B, frames=T)
    export_s = time.time() - t0
    t0 = time.time()
    dec = load_decoder(path)
    load_s = time.time() - t0
    live = eng.forward(mel)
    art, launches = _kernel_launches(counters, lambda: dec(mel))
    if launches != expect:
        raise SystemExit(f"export {name}: one forward of the artifact launched {launches}, "
                         f"expected {expect}")
    if art.shape != live.shape or not torch.isfinite(art).all():
        raise SystemExit(f"export {name}: bad output {tuple(art.shape)} against {tuple(live.shape)}")
    return eng, dec, mel, meta, export_s, load_s, os.path.getsize(path) / 1e6, art, live


def phase_export():
    """Serving export: BSRNN-M (full width) exported on the card at B=8 x 1024 in
    float32 and bfloat16, saved, loaded in this process and decoded: 16
    lstm_scan_fused launches a forward from the artifact, its output held to the
    live engine's, its RTF beside the engine's (measured as phase 3, interleaved
    live, artifact, artifact, live); then at serving's bucket (8 x 128 frames, float32)
    ConvTasNet with fused_tcn 1 (24 tail + 24 statistics launches; zero phase, as
    HD-Demucs), GCRN (2
    lstm_scan_bidir2, the cluster kernel), HD-Demucs (2 lstm_scan_bidir2 through
    lstm_scan_fused's projection route, csrc/lstm_scan_wide.cu) and causal BSRNN-M
    (8 lstm_scan + 8 lstm_scan_fused); then the CLI (python -m
    nvse_tpu_torch.infer.export, in this process) on HiFiGAN V1 with a symbolic time
    axis and its round-trip check, the artifact decoding two lengths against the live
    engine with no kernel launched."""
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.infer.export import load_decoder
    from nvse_tpu_torch.infer.export import main as export_cli
    from nvse_tpu_torch.ops.lstm import _reset_counts

    counters = _all_counters()
    _reset_counts(*counters.values())              # this main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            h = _config("bsrnn", compute_dtype=dtype)
            eng, dec, mel, meta, export_s, load_s, mb, art, live = _export_case(
                tmp, f"bsrnn_{dtype}", h, EXPORT_B, EXPORT_T,
                {"lstm_scan_fused": {"lstm_fused": 16}}, counters)
            err, peak = (art - live).abs().max().item(), live.abs().max().item()
            limit = EXPORT_F32_TOL if dtype == "float32" else EXPORT_BF16_REL * peak
            audio_sec = EXPORT_B * (EXPORT_T - 1) * h.hop_size / h.sampling_rate
            ms = {"live": [], "artifact": []}
            for who in ("live", "artifact", "artifact", "live"):
                fn = (lambda: eng.forward(mel)) if who == "live" else (lambda: dec(mel))
                ms[who].append(_wall_ms(fn, EXPORT_ITERS))
            say(phase="export", model="bsrnn", dtype=dtype, batch=EXPORT_B, frames=EXPORT_T,
                card=CARD, export_s=export_s, load_s=load_s, artifact_mb=mb,
                graph_ops=meta["ops"], launches_per_forward={"lstm_scan_fused": 16},
                max_abs_err=err, limit=limit, wall_ms=ms,
                rtf_artifact=[audio_sec / t * 1e3 for t in ms["artifact"]],
                rtf_live=[audio_sec / t * 1e3 for t in ms["live"]])
            if not err <= limit:
                raise SystemExit(f"export bsrnn {dtype}: artifact vs live engine {err} > {limit}")
            del eng, dec
        for name, kw, expect in EXPORT_SERVE:
            h = _config(name, **kw)
            tag = f"{name}_causal" if kw.get("causal") else name
            eng, dec, mel, meta, export_s, load_s, mb, art, live = _export_case(
                tmp, tag, h, EXPORT_B, EXPORT_SERVE_T, expect, counters)
            err = (art - live).abs().max().item()
            say(phase="export", model=tag, dtype="float32", batch=EXPORT_B,
                frames=EXPORT_SERVE_T, card=CARD, export_s=export_s, load_s=load_s,
                artifact_mb=mb, graph_ops=meta["ops"], launches_per_forward=expect,
                max_abs_err=err, limit=EXPORT_F32_TOL)
            if not err <= EXPORT_F32_TOL:
                raise SystemExit(f"export {tag}: artifact vs live engine {err} > {EXPORT_F32_TOL}")
            del eng, dec
        # the CLI: HiFiGAN V1 with a symbolic time axis, its round-trip check in the CLI
        cfg = os.path.join(REPO, "nvse_tpu_torch", "configs", "hifigan_v1_config.json")
        path = os.path.join(tmp, "hifigan.nvsx")
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            meta = export_cli(["--cfg_filename", cfg, "--out", path, "--batch", "2",
                               "--frames", "-1"])
        cli_s = time.time() - t0
        lines = buf.getvalue().splitlines()
        dec = load_decoder(path)
        eng = InferenceEngine(_config("hifigan"), device="cuda")
        errs = {}
        for T in (100, 400):
            mel = torch.from_numpy(np.random.default_rng(T).standard_normal(
                (2, 80, T)).astype(np.float32) - 4.0).to("cuda")
            art, launches = _kernel_launches(counters, lambda: dec(mel))
            live = eng.forward(mel)
            if launches or art.shape != live.shape:
                raise SystemExit(f"export hifigan T={T}: launches {launches}, shape "
                                 f"{tuple(art.shape)} against {tuple(live.shape)}")
            errs[T] = (art - live).abs().max().item()
        say(phase="export", model="hifigan", dtype="float32", cli=lines, cli_s=cli_s,
            frames=meta["frames"], card=CARD, max_abs_err=errs, limit=EXPORT_CLI_TOL)
        if not all(e <= EXPORT_CLI_TOL for e in errs.values()):
            raise SystemExit(f"export hifigan: artifact vs live engine {errs}")
        del eng, dec
    return _shape_counts()                         # ... and ends here


def _train_shapes(counts, label):
    """(label, rows, steps, H) of each training-forward shape a path launched."""
    return sorted({(label, R, T, H) for T, R, H, _ in counts["lstm_fwd_hc"]})


# kernel vs plain for the ablation variants, as max |err| over max(1, max |plain|):
# no_vpu's h has no tanh and may grow; where it passes ABLATION_GROW its output is
# checked for finiteness only
ABLATION_GROW = 1e3


def _ablation_bound(mode, R, T, C, H, dtype):
    """(bound ms, what binds it) of one variant: one direction's reads and
    writes, and its two products where it does them."""
    item = torch.tensor([], dtype=dtype).element_size()
    x = {"no_indma": R * C, "empty": 0}.get(mode, R * T * C)
    weights = {"no_dot": 4 * H, "empty": 0}.get(mode, C * 4 * H + H * 4 * H + 4 * H)
    ops = 0 if mode in ("no_dot", "empty") else 2 * R * T * (C + H) * 4 * H
    return _bound((x + weights + R * T * H) * item, ops, dtype)


def phase_lstm_step_ablation():
    """The per-step ablation harness (scripts/profile_torch_lstm_step.py), its
    main() in this process at its four shapes in float32 and bfloat16: five
    variants of one direction of csrc/lstm_fused.cu (H = 128) and of
    csrc/lstm_fused_wide.cu (H = 256). Each variant's output against its plain
    version on the harness's inputs, with a control the limit must refuse:
    W_hh with its rows reversed where the variant reads W_hh, x reversed in
    time for no_dot (which reads x and b only), and the full kernel's output
    for empty (which reads nothing).
    `full` is also held against the forward half of lstm_scan_fused at the same
    weights, and timed beside cuDNN's unidirectional LSTM forward (time-major x,
    laid out once outside the timing); the split of a step (lstm_step_split).
    -> (rows, launches per wrapper and shape)."""
    from nvse_tpu_torch.ops import lstm as L
    from nvse_tpu_torch.ops import lstm_step as LS

    harness = _script("profile_torch_lstm_step")
    L._reset_counts(*_all_counters().values())     # this main path starts here
    timed = [r for dt in ("float32", "bfloat16")
             for r in harness.main(["--dtype", dt, "--iters", "10"])]
    counts = _shape_counts()                       # ... and ends here
    rows, split, full_out = [], {}, {}
    for r in timed:
        T, R, C, H, mode, dtype = r["T"], r["B"], r["C"], r["H"], r["variant"], getattr(torch, r["dtype"])
        x, w_ih, w_hh, b = harness.inputs(T, R, C, H, dtype, "cuda")
        ctl_args = {"no_dot": (x.flip(1).contiguous(), w_ih, w_hh, b),
                    "empty": None}.get(mode, (x, w_ih, w_hh.flip(0).contiguous(), b))
        lib = cudnn_lstm([(w_ih, w_hh, b)], dtype) if mode == "full" else None
        fused_err = library_ms = lib_err = None
        with torch.inference_mode(), no_weight_compaction():
            got = LS.lstm_step_variant(x, w_ih, w_hh, b, mode)
            ref, plain_ms = cuda_once(lambda: LS.lstm_step_variant_plain(x, w_ih, w_hh, b, mode))
            ctl = (full_out[r["shape"], r["dtype"]] if ctl_args is None
                   else LS.lstm_step_variant(*ctl_args, mode))
            if mode == "full":
                full_out[r["shape"], r["dtype"]] = got
                fused = L.lstm_scan_fused(x, w_ih, w_ih, b, b, w_hh, w_hh)[..., :H]
                fused_err = (got.float() - fused.float()).abs().max().item()
                x_tm = x.transpose(0, 1).contiguous()
                lib_err = (lib(x_tm)[0].transpose(0, 1).float() - ref.float()).abs().max().item()
                library_ms = cuda_ms(lambda: lib(x_tm), iters=10)
        scale = max(1.0, ref.float().abs().max().item())
        grows = mode == "no_vpu" and not scale <= ABLATION_GROW
        err = (got.float() - ref.float()).abs().max().item()
        rel, control = err / scale, (ctl.float() - ref.float()).abs().max().item() / scale
        bound, bound_by = _ablation_bound(mode, R, T, C, H, dtype)
        row = dict(name="lstm_step_variant", shape=r["shape"], mode=mode, rows=R, steps=T, C=C,
                   H=H, dtype=r["dtype"], source=f"nvse_tpu_torch/csrc/{LS._kernel_source(H)}.cu",
                   design=_design("lstm_step_variant", H, dtype, R=R, T=T, C=C),
                   max_abs_err=err, rel_err=rel, tol=TOL[dtype], control_rel_err=control,
                   ms=r["ms"], us_per_step=r["us_per_step"], plain_ms=plain_ms,
                   library_ms=library_ms, library_max_abs_err=lib_err,
                   **({"library": "cuDNN LSTM forward, projection included"} if lib else {}),
                   bound_ms=bound, bound_by=bound_by, full_vs_fused_max_abs_err=fused_err,
                   checked="finite only" if grows else "vs plain")
        say(phase="lstm_step_ablation", **row)
        what = f"lstm_step_variant {mode} {r['shape']} {r['dtype']}"
        if grows and not torch.isfinite(got).all():
            raise SystemExit(f"{what}: not finite")
        if not grows and not (rel <= TOL[dtype]):
            raise SystemExit(f"{what}: error {err} ({rel} relative) over tolerance {TOL[dtype]}")
        if not grows and not (control > TOL[dtype]):
            raise SystemExit(f"{what}: the control ({control} relative) passes the tolerance")
        if fused_err is not None and not (fused_err <= TOL[dtype]):
            raise SystemExit(f"{what}: {fused_err} from the forward half of lstm_scan_fused")
        split.setdefault((r["shape"], r["dtype"]), {})[mode] = r["us_per_step"]
        rows.append(row)
    for (shape, dt), us in split.items():
        full = us["full"]
        parts = {"input_dram": full - us["no_indma"], "products": full - us["no_dot"],
                 "nonlinearities": full - us["no_vpu"], "floor": us["empty"]}
        say(phase="lstm_step_split", shape=shape, dtype=dt, us_per_step=us,
            share_of_full={k: v / full for k, v in parts.items()})
    return rows, counts


# ---------------------------------------------------------------------------
# multi-GPU: the port's dry run, data- and sequence-parallel BSRNN-M training over
# torch.distributed, data-parallel serving (nvse_tpu_torch/parallel)
# ---------------------------------------------------------------------------

# the DP step against the one-process step (phase 5's config, weights and batch):
# float32 at phase 6's limits; bfloat16 trunks round each GEMM's output to 8 bits,
# and a GEMM over another row count may round an element apart, so bfloat16 has
# limits of its own, set from this comparison's readings on an H100: losses 3.6e-6
# to 5.7e-6 apart, moments 3.7e-3 to 4.6e-3 (relative L2, the worst tensor); a
# gradient left out of the all-reduce moves its moments by far more (PERF.md §6).
# Updated parameters: at most 1 % of the elements whose gradient is not float
# noise (|mu| >= 1e-4 of the largest) may move by lr / 10 apart
# (tests/test_torch_port_train.py assert_updates_close). dp x sp against DP: G and
# D at 1e-3 relative (__graft_entry__.py:181-182).
PAR_LIMITS = {"float32": (STEP_RTOL, MOMENT_REL), "bfloat16": (1e-4, 2e-2)}
SP_RTOL = 1e-3
PAR_ITERS = 2


def _rank_layout():
    """(backend, ranks, DP mesh shape, dp x sp mesh shape): one rank a card over
    NCCL on a machine of 2 or more cards (4 ranks where there are 4), else 2 ranks
    sharing cuda:0 over gloo (NCCL holds one rank a card)."""
    cards = torch.cuda.device_count()
    if cards >= 2:
        world = 4 if cards >= 4 else 2
        return "nccl", world, (world,), (world // 2, 2)
    return "gloo", 2, (2,), (1, 2)


def phase_dryrun():
    """python -m nvse_tpu_torch.parallel.dryrun --n 4 on the card(s): a DP step, a
    dp x sp step within 1e-3 of it, a rank-0 checkpoint restored on every rank and
    continued within 1e-5. -> the ranks' launches per wrapper and shape."""
    from nvse_tpu_torch.parallel.dryrun import merge_counts

    n, cards = 4, torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        counts = os.path.join(tmp, "counts.json")
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "nvse_tpu_torch.parallel.dryrun",
                               "--n", str(n), "--counts", counts], cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        lines = proc.stdout.splitlines()
        say(phase="dryrun", backend="nccl" if n <= cards else "gloo", world=n, cards=cards,
            rc=proc.returncode, seconds=time.time() - t0, lines=lines)
        if proc.returncode or not any("save/restore ok" in line for line in lines):
            raise SystemExit(f"dryrun failed (rc {proc.returncode}): {proc.stderr[-3000:]}")
        with open(counts) as f:
            return merge_counts([json.load(f)])


def _moment_rel(mu, ref):
    """Per-tensor relative L2 of AdamW first moments (phase 6's reading): worst
    (value, name)."""
    floor = 1e-4 * max(v.norm().item() for v in ref.values())
    errs = {k: (mu[k] - ref[k]).norm().item() / max(ref[k].norm().item(), floor) for k in ref}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _update_frac(update, ref_update, ref_mu, lr):
    """The largest share, over tensors, of elements whose gradient is not float
    noise and whose update differs from the reference's by more than lr / 10."""
    floor = 1e-4 * max(v.abs().max().item() for v in ref_mu.values())
    worst = 0.0
    for k, ref in ref_update.items():
        live = ref_mu[k].abs() >= floor
        if live.any():
            d = (update[k] - ref).abs()[live]
            worst = max(worst, (d > lr / 10).float().mean().item())
    return worst


def _named(tr):
    """(name, parameter) of the generator ("g.") and the discriminators ("d.")."""
    return [*(("g." + n, p) for n, p in tr.generator.named_parameters()),
            *(("d." + n, p) for n, p in tr.disc.named_parameters())]


def _step_reading(tr, before):
    """(AdamW first moments, updates since `before`) of every parameter that has
    an optimizer state, on the CPU."""
    mu, upd = {}, {}
    for opt, prefix, module in ((tr.opt_g, "g.", tr.generator), (tr.opt_d, "d.", tr.disc)):
        for n, p in module.named_parameters():
            if "exp_avg" in opt.state.get(p, {}):
                mu[prefix + n] = opt.state[p]["exp_avg"].detach().cpu()
                upd[prefix + n] = (p.detach() - before[prefix + n]).cpu()
    return mu, upd


def _parallel_rank(dev, jobs, tmp):
    """Rank worker of dp_train / sp_train: for each (phase, mesh shape, dtype), a
    GANTrainer over the mesh at BSRNN-M's full width, one step on the rank's rows
    of phase 5's batch (the compared step: rank 0 reads it against the one-process
    step, or against the DP step for sp_train), PAR_ITERS timed steps, one more
    under torch.profiler (this rank's busy time); the launch counts set to 0 when
    the job starts and read when it ends. Writes its readings as JSON; raises (and
    fails the run) on a check that fails."""
    import torch.distributed as dist

    from nvse_tpu_torch.ops.lstm import _reset_counts
    from nvse_tpu_torch.parallel import get_mesh, mesh_barrier, replicated, shard_batch
    from nvse_tpu_torch.parallel.dryrun import launch_counts, trainer_state
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    rank = dist.get_rank()
    counters = _all_counters()
    dp_losses = {}
    for phase, shape, dtype in jobs:
        mesh = get_mesh(math.prod(shape), shape[-1] if len(shape) > 1 else 1, dev)
        h = _config("bsrnn", compute_dtype=dtype)
        audio = shard_batch(_audio_batch(16, int(h.segment_size), h.sampling_rate, seed=0),
                            mesh).to(dev)
        _reset_counts(*counters.values())          # this main path starts here
        tr = GANTrainer(h, device=dev, steps_per_epoch=2, mesh=mesh)
        before = {n: p.detach().clone() for n, p in _named(tr)}
        torch.cuda.reset_peak_memory_stats(dev)
        losses = fetch_scalars(tr.step(audio))
        out = {"losses": losses, "rows": audio.shape[0]}
        fails = []
        if rank == 0 and phase == "dp_train":
            ref = torch.load(os.path.join(tmp, f"ref_{dtype}.pt"), weights_only=True)
            mu, upd = _step_reading(tr, before)
            loss_tol, mom_tol = PAR_LIMITS[dtype]
            loss_rel = max(abs(losses[k] - v) / max(abs(v), 1e-12)
                           for k, v in ref["losses"].items())
            mom_rel, worst = _moment_rel(mu, ref["mu"])
            frac = _update_frac(upd, ref["update"], ref["mu"], float(h.learning_rate))
            out.update(loss_rel=loss_rel, loss_rtol=loss_tol, moment_rel=mom_rel,
                       worst_moment=worst, moment_rel_tol=mom_tol, update_frac=frac)
            if not (loss_rel <= loss_tol and mom_rel <= mom_tol and frac <= 0.01):
                fails.append(f"DP step off the one-process step: {out}")
        if rank == 0 and phase == "dp_train":
            dp_losses[dtype] = losses
        if rank == 0 and phase == "sp_train":
            sp_rel = max(abs(losses[k] - dp_losses[dtype][k]) / abs(dp_losses[dtype][k])
                         for k in ("G", "D"))
            out.update(vs_dp_rel=sp_rel, vs_dp_rtol=SP_RTOL)
            if not sp_rel <= SP_RTOL:
                fails.append(f"dp x sp step {sp_rel} off the DP step")
        mesh_barrier(mesh, dev)                    # rank 0's reading above is not timed
        torch.cuda.synchronize(dev)
        t0 = time.time()
        for _ in range(PAR_ITERS):
            metrics = tr.step(audio)
        torch.cuda.synchronize(dev)
        ms = (time.time() - t0) / PAR_ITERS * 1e3
        nccl_ms, busy = _device_ms(lambda: tr.step(audio))
        steps = PAR_ITERS + 2
        per_step = {k: c.launches / steps for k, c in counters.items()}
        expect = {k: 0 for k in counters}
        expect.update(lstm_fwd_hc=32, lstm_bwd=32, lstm_bwd_dw=32)
        if per_step != expect:
            fails.append(f"launches per step {per_step}, expected {expect}")
        if not all(math.isfinite(v) for v in fetch_scalars(metrics).values()):
            fails.append("non-finite losses")
        if not replicated(trainer_state(tr), mesh):
            fails.append("parameters, buffers or optimizer states differ between ranks")
        out.update(ms_per_step=ms, device_busy_ms=busy or "not measured", nccl_ms=nccl_ms,
                   idle_share=1.0 - busy / ms if busy else "not measured",
                   peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                   launches_per_step={k: v for k, v in per_step.items() if v},
                   counts=launch_counts(), fails=fails)
        with open(os.path.join(tmp, f"{phase}_{dtype}.rank{rank}.json"), "w") as f:
            json.dump(out, f)
        if fails:
            raise AssertionError(f"{phase} {dtype} rank {rank}: " + "; ".join(fails))
        del tr, before, audio
        torch.cuda.empty_cache()


def phase_parallel_train():
    """dp_train and sp_train: BSRNN-M's GAN step at full width, batch 16 x 16384, in
    float32 and bfloat16, over the ranks of _rank_layout (a DP mesh, then a dp x sp
    mesh: BSRNN's trunk sequence-parallel, 34 bands and 65 frames split over 2 seq
    ranks). The one-process step of each dtype (phase 5's config, seeded weights and
    batch) is taken in this process first. -> {"dp_train": counts, "sp_train": counts},
    each the ranks' launches per wrapper and shape, summed."""
    from nvse_tpu_torch.parallel import spawn
    from nvse_tpu_torch.parallel.dryrun import merge_counts
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    backend, world, dp_shape, sp_shape = _rank_layout()
    dtypes = ("float32", "bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in dtypes:
            h = _config("bsrnn", compute_dtype=dtype)
            audio = _audio_batch(16, int(h.segment_size), h.sampling_rate, seed=0).to("cuda")
            tr = GANTrainer(h, device="cuda", steps_per_epoch=2)
            before = {n: p.detach().clone() for n, p in _named(tr)}
            losses = fetch_scalars(tr.step(audio))
            mu, upd = _step_reading(tr, before)
            torch.save({"losses": losses, "mu": mu, "update": upd},
                       os.path.join(tmp, f"ref_{dtype}.pt"))
            del tr, before, mu, upd
        torch.cuda.empty_cache()
        jobs = [("dp_train", dp_shape, dt) for dt in dtypes] + [
            ("sp_train", sp_shape, dt) for dt in dtypes]
        t0 = time.time()
        spawn(_parallel_rank, world, args=(jobs, tmp), device="cuda")
        seconds = time.time() - t0
        counts = {}
        for phase, shape, dtype in jobs:
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"{phase}_{dtype}.rank{r}.json")) as f:
                    ranks.append(json.load(f))
            r0 = ranks[0]
            extra = {k: r0[k] for k in ("loss_rel", "loss_rtol", "moment_rel", "worst_moment",
                                        "moment_rel_tol", "update_frac", "vs_dp_rel",
                                        "vs_dp_rtol") if k in r0}
            say(phase=phase, dtype=dtype, backend=backend, world=world,
                mesh=dict(zip(("data", "seq"), shape)), cards=torch.cuda.device_count(),
                batch=16, rows_per_rank=r0["rows"], segment=16384,
                ms_per_step=max(r["ms_per_step"] for r in ranks),
                ms_per_step_by_rank=[r["ms_per_step"] for r in ranks],
                device_busy_ms_by_rank=[r["device_busy_ms"] for r in ranks],
                nccl_ms_by_rank=[r["nccl_ms"] for r in ranks],
                idle_share_by_rank=[r["idle_share"] for r in ranks],
                peak_mem_gb_by_rank=[r["peak_mem_gb"] for r in ranks],
                launches_per_step=r0["launches_per_step"], losses=r0["losses"],
                spawn_seconds=seconds, **extra)
            counts.setdefault(phase, []).extend(r["counts"] for r in ranks)
    return {phase: merge_counts(c) for phase, c in counts.items()}


def phase_dp_serve():
    """The engine with infer_dp_devices -1 (one replica a card) decoding B = 8 x 1024
    mel frames of seeded BSRNN-M weights in float32, against the one-card decode of
    the same weights; RTF. On a one-card machine the engine gets two replicas on
    cuda:0, so that the padded, split, gathered and cropped decode runs all the
    same. -> launches per wrapper and shape."""
    import copy

    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.ops.lstm import _reset_counts

    h = _config("bsrnn")
    B, T, iters = 8, 1024, 5
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((B, h.num_mels, T))
                           .astype(np.float32) - 4.0).to("cuda")
    ref = InferenceEngine(h, device="cuda").forward(mel)
    _reset_counts(*_all_counters().values())       # this main path starts here
    lines = []
    eng = InferenceEngine(_config("bsrnn", infer_dp_devices=-1), device="cuda",
                          log_fn=lines.append)
    shared = len(eng.replicas) == 1                # one card: two replicas share it
    if shared:
        eng.devices = [eng.device] * 2
        eng.replicas = [eng.generator, copy.deepcopy(eng.generator)]
    wav = eng.forward(mel)                         # warmup
    for d in eng.devices:
        torch.cuda.synchronize(d)
    t0 = time.time()
    for _ in range(iters):
        wav = eng.forward(mel)
    for d in eng.devices:
        torch.cuda.synchronize(d)
    wall = (time.time() - t0) / iters
    counts = _shape_counts()                       # ... and ends here
    err = (wav - ref).abs()
    ok = bool((err <= MODEL_ATOL + MODEL_RTOL * ref.abs()).all())
    say(phase="dp_serve", dtype="float32", replicas=len(eng.replicas),
        devices=[str(d) for d in eng.devices], replicas_share_one_card=shared,
        backend="one process", batch=B, frames=T,
        wall_ms=wall * 1e3, rtf=B * (T - 1) * h.hop_size / h.sampling_rate / wall,
        max_abs_err_vs_one_card=err.max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL, ok=ok,
        log=lines, launches=_str_keys(counts))
    if not ok or wav.shape != ref.shape:
        raise SystemExit("dp_serve: the replicas' decode disagrees with the one-card decode")
    return counts


# C7: the shapes and the dtype no resident kernel takes. Rows held against their plain
# versions at H = 1024 (the step-wise kernels) and at H = 100 and (C, H) = (102, 102)
# (padded by the wrappers), as (label, rows, steps, C, H) at a few rows and steps
C7_HELD = (("c7_h1024", 4, 6, 1024, 1024), ("c7_h100", 37, 9, 102, 100),
           ("c7_c102", 16, 9, 102, 102))
C7_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# BSRNN at an odd width: its BiLSTMs at C = H = 102, padded to 104 on the card
C7_FEATURE_DIM = 102
F16_VS_BF16 = 1.25     # the float16 training kernels' time over bfloat16's, at most
C7_TCN = [(f"c7_decode_d{d}", TCN_B, TCN_T, TCN_H, TCN_BC, d, torch.float16)
          for d in TCN_DILATIONS]


def phase_c7_kernels():
    """Every LSTM wrapper against its plain version at C7_HELD's shapes in
    C7_DTYPES (the fused BiLSTM at its (C, H); the scans, the training kernels
    and the two-scan LSTMs at H), and the float16 TCN tail and gLN statistics
    at ConvTasNet's decode shape: rows held against their plain versions only
    (HELD_ONLY: no main path launches these shapes)."""
    rows = []
    for label, R, T, C, H in C7_HELD:
        for dt in C7_DTYPES:
            rows += phase_kernels([(label, R, T, C, H, dt)], phase="c7_kernels")
            if label == "c7_c102":            # the fused BiLSTM's (C, H) only
                continue
            rows += phase_scan_kernels([(n, label, R, T, H, dt)
                                        for n in ("lstm_scan", "lstm_scan_stateful")],
                                       phase="c7_kernels")
            rows += phase_train_kernels([(label, R, T, H)], phase="c7_kernels", dtypes=(dt,))
            rows += phase_bidir2_kernels([(label, T, R, H, dt)], phase="c7_kernels")
            rows += phase_bidir_kernels([(label, T, R, H, dt)], phase="c7_kernels")
    rows += phase_tcn_kernels(C7_TCN, phase="c7_kernels")
    rows += phase_gln_stats([("c7_decode", TCN_B, TCN_T, TCN_H, torch.float16)],
                            phase="c7_kernels", bound_limit=GLN_DECODE_BOUND)
    return rows + phase_f16_vs_bf16()


def phase_f16_vs_bf16():
    """The training kernels in float16 and bfloat16 at C7_F16_TRAIN's shapes (the
    paths' float16 training shapes): rows held against their plain versions, with
    a cuDNN float16 layer as library time, then the time ratios, read in turns
    (`_f16_vs_bf16_ms`). Fails where float16 takes the step-wise kernel, or where
    lstm_fwd_hc or lstm_bwd in float16 is slower than F16_VS_BF16 x bfloat16 in
    both readings past bfloat16's slower one."""
    f16 = phase_train_kernels(C7_F16_TRAIN, phase="c7_kernels",
                              dtypes=(torch.bfloat16, torch.float16), layer_library=True)
    by = {(r["name"], r["shape"], r["dtype"]): r for r in f16}
    turns = {label: _f16_vs_bf16_ms(R, T, H) for label, R, T, H in C7_F16_TRAIN}
    slow = []
    for name in ("lstm_fwd_hc", "lstm_bwd", "lstm_bwd_dw"):
        for label in C7_F16_LABELS:
            a, b = by[name, label, "float16"], by[name, label, "bfloat16"]
            f16_ms, bf16_ms = turns[label][name]
            held = name != "lstm_bwd_dw"           # the kernels float16 was instantiated for
            say(phase="c7_f16_vs_bf16", name=name, shape=label, f16_ms=a["ms"], bf16_ms=b["ms"],
                ratio=a["ms"] / b["ms"], f16_ms_in_turns=f16_ms, bf16_ms_in_turns=bf16_ms,
                ratio_in_turns=min(f16_ms) / min(bf16_ms), limit=F16_VS_BF16 if held else None,
                f16_source=a["source"], bf16_source=b["source"])
            if "lstm_stepwise" in a["source"]:
                raise SystemExit(f"{name} {label} float16 took the step-wise kernel")
            if held and min(f16_ms) > F16_VS_BF16 * max(bf16_ms):
                slow.append(f"{name} {label}: float16 {f16_ms} ms against bfloat16 {bf16_ms}")
    if slow:
        raise SystemExit(f"float16 over {F16_VS_BF16} x bfloat16's time: " + "; ".join(slow))
    return f16


def _f16_vs_bf16_ms(R, T, H):
    """{kernel: ([float16 ms] * 2, [bfloat16 ms] * 2)}: lstm_fwd_hc, the lstm_bwd
    recurrence and the dW_hh reduction at (R, T, H) on the same values in both
    dtypes, timed in turns (float16, bfloat16, bfloat16, float16; 20 calls a
    reading), so that the card's drift falls on both."""
    from nvse_tpu_torch.ops import lstm as L

    g = torch.Generator().manual_seed(R + T)
    b = 1.0 / math.sqrt(H)
    host = (0.5 * torch.randn(T, R, 4 * H, generator=g),
            torch.empty(H, 4 * H).uniform_(-b, b, generator=g), torch.randn(T, R, H, generator=g))
    runs = {}
    with torch.inference_mode():
        for dtype in (torch.float16, torch.bfloat16):
            xp, whh, dhs = (t.to("cuda", dtype) for t in host)
            hs, cs = L.lstm_fwd_hc(xp, whh)
            dx = L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh)
            runs[dtype] = {
                "lstm_fwd_hc": lambda xp=xp, whh=whh: L.lstm_fwd_hc(xp, whh),
                "lstm_bwd": lambda a=(xp, hs, cs, dhs, whh): L.lstm_bwd_recurrence(*a),
                "lstm_bwd_dw": lambda hs=hs, dx=dx: L.lstm_dw_hh(hs, dx)}
        ms = {name: ([], []) for name in runs[torch.float16]}
        for dtype in (torch.float16, torch.bfloat16, torch.bfloat16, torch.float16):
            for name, fn in runs[dtype].items():
                ms[name][dtype == torch.bfloat16].append(cuda_ms(fn, iters=20))
    return ms


def phase_c7_decode():
    """BSRNN at feature_dim C7_FEATURE_DIM, num_repeat 2, decoding 4 x 256 mel
    frames through InferenceEngine in float32 and bfloat16: the fused kernel
    at the padded (C, H), 4 launches a forward, a finite wave of the expected
    shape; the card's float32 decode against the CPU's plain path on 2 x 64
    frames at the model limits."""
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.ops.lstm import _kernel_source, _reset_counts, lstm_scan_fused

    h = _config("bsrnn", feature_dim=C7_FEATURE_DIM, num_repeat=2)
    kernel = _kernel_source("lstm_scan_fused", C7_FEATURE_DIM)
    B, T = 4, 256
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, h.num_mels, T)).astype(np.float32) - 4.0)
    _reset_counts(*_all_counters().values())       # main path starts here
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(_config("bsrnn", feature_dim=C7_FEATURE_DIM, num_repeat=2,
                                      compute_dtype=dtype), device="cuda")
        n0 = dict(lstm_scan_fused.launches_by_kernel)
        wav = eng.forward(mel.to("cuda"))
        torch.cuda.synchronize()
        launches = launch_delta(lstm_scan_fused.launches_by_kernel, n0)
        ok = (launches == {kernel: 4} and wav.shape == (B, (T - 1) * h.hop_size)
              and bool(torch.isfinite(wav).all()))
        say(phase="c7_decode", feature_dim=C7_FEATURE_DIM, num_repeat=2, dtype=dtype, batch=B,
            frames=T, launches=launches, shape=list(wav.shape), ok=ok)
        if not ok:
            raise SystemExit(f"feature_dim {C7_FEATURE_DIM} {dtype} decode: launches {launches}, "
                             f"shape {tuple(wav.shape)}, finite {bool(torch.isfinite(wav).all())}")
        del eng
    counts = _shape_counts()                       # main path ends here
    small = mel[:2, :, :64]
    cpu = InferenceEngine(h, device="cpu").forward(small)
    gpu = InferenceEngine(h, device="cuda").forward(small).cpu()
    err = (gpu - cpu).abs()
    ok = bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all())
    say(phase="c7_decode_vs_cpu_plain", feature_dim=C7_FEATURE_DIM, batch=2, frames=64,
        max_abs_err=err.max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL, ok=ok)
    if not ok:
        raise SystemExit(f"feature_dim {C7_FEATURE_DIM} decode on the card disagrees with the "
                         "CPU plain path")
    return counts


def phase_c7_train():
    """The GAN steps of C7, each on the card against the CPU's plain step, each
    counted as a main path: the feature_dim C7_FEATURE_DIM BSRNN in float32
    (phase 6's limits, or 3 x the CPU's own spread, and the TF32 control);
    BSRNN-M at its width (feature_dim 128, two BSNets) in float16 (the
    float16 instances of the resident training kernels, no step-wise launch, the
    float16 dW reduction); ConvTasNet at full
    width, one repeat of its 8 blocks (every tail shape of the model), in float16
    with the tail kernel under autograd (fused_tcn 1), at learning rate 0 as
    phase 6's."""
    return {
        # its encoder's LayerNorm over a band above fmax has a float-noise moment: the
        # CPU's own step moves it by 3.2e-3 under a 1e-7 change of the batch
        "c7_train": _train_vs_cpu_plain("bsrnn", None, phase="c7_train_vs_cpu_plain",
                                        perturbed=True, feature_dim=C7_FEATURE_DIM),
        "c7_f16_train": _f16_train_off_the_stepwise_kernel(),
        "c7_f16_convtasnet_train": _train_vs_cpu_plain(
            "convtasnet", None, phase="c7_f16_train_vs_cpu_plain", fused_tcn=1,
            compute_dtype="float16", R=1)}


def _f16_train_off_the_stepwise_kernel():
    """The float16 BSRNN-M step against the CPU's (the limits of phase 6's float16
    check), its recurrences on the resident training kernels: 0 launches of
    csrc/lstm_stepwise.cu."""
    from nvse_tpu_torch.ops import lstm as L

    counts = _train_vs_cpu_plain("bsrnn", None, phase="c7_f16_train_vs_cpu_plain",
                                 feature_dim=128, compute_dtype="float16")
    # the counts were set to 0 before the card's step, and the CPU's steps count nothing
    by_kernel = {f.__name__: dict(f.launches_by_kernel) for f in (L.lstm_fwd_hc, L.lstm_bwd)}
    stepwise = sum(d.get("lstm_stepwise", 0) for d in by_kernel.values())
    say(phase="c7_f16_train_kernels", launches_by_kernel=by_kernel, stepwise_launches=stepwise)
    if stepwise or not all(by_kernel.values()):
        raise SystemExit(f"float16 BSRNN-M step: launches by kernel {by_kernel}; expected the "
                         "resident training kernels and no step-wise launch")
    return counts


def phase_c7_train_rows(paths):
    """lstm_fwd_hc, lstm_bwd and the dW reduction against their plain versions
    at every shape and dtype the C7 steps launched."""
    rows = []
    for counts in paths.values():
        for T, R, H, dt in sorted(counts.get("lstm_fwd_hc", {})):
            rows += phase_train_kernels([("c7_train", R, T, H)], phase="c7_kernels",
                                        dtypes=(getattr(torch, dt),))
    return rows


def phase_parallel_rows(rows, paths, phase="parallel_kernels"):
    """Kernel-vs-plain rows for the training kernels' shapes that the ranks
    launched (their local batch and sp's band and frame slices), in the dtypes
    they ran in, then phase_rest for the rest."""
    by_dtype = {}
    for _p, k, key in _missing(rows, paths):
        if k == "lstm_fwd_hc":
            T, R, H, dt = key
            by_dtype.setdefault(dt, set()).add((f"{_p}_{R}x{T}", R, T, H))
    out = []
    for dt, shapes in sorted(by_dtype.items()):
        out += phase_train_kernels(sorted(shapes), phase, dtypes=(getattr(torch, dt),))
    return out + phase_rest(rows + out, paths, phase)


def _key(r):
    """A row's shape as its wrapper counts launches: (rows, steps, C, H, dtype)
    for the fused kernel, (steps, rows, C, H, mode, dtype) for the ablation
    variants, (steps, rows, H, dtype) for the others."""
    if r["name"] == "lstm_scan_fused":
        return (r["rows"], r["steps"], r["C"], r["H"], r["dtype"])
    if r["name"] == "tcn_block_tail":
        return (r["rows"], r["steps"], r["H"], r["Bc"], r["dilation"], r["dtype"])
    if r["name"] == "tcn_gln_stats":
        return (r["rows"], r["steps"], r["H"], r["dtype"])
    if r["name"] == "lstm_step_variant":
        return (r["steps"], r["rows"], r["C"], r["H"], r["mode"], r["dtype"])
    return (r["steps"], r["rows"], r["H"], r["dtype"])


def _missing(rows, paths):
    """(path, wrapper, shape) of every launch on the main paths that no row holds."""
    have = {(r["name"], _key(r)) for r in rows}
    return [(p, k, key) for p, counts in paths.items() for k, d in counts.items()
            for key in d if (k, key) not in have]


def phase_rest(rows, paths, phase="kernel_vs_plain"):
    """Rows for the inference kernels' launches on the main paths that no row
    holds yet, each at its shape and dtype, labelled <path>_<rows>x<steps>."""
    fused, scans, bidir2, bidir, tails, stats = {}, {}, {}, {}, {}, {}
    for p, k, key in _missing(rows, paths):
        dtype = getattr(torch, key[-1])
        if k == "lstm_scan_fused":
            R, T, C, H, _ = key
            fused.setdefault(key, (f"{p}_{R}x{T}", R, T, C, H, dtype))
        elif k in ("lstm_scan", "lstm_scan_stateful"):
            T, R, H, _ = key
            scans.setdefault((k, key), (k, f"{p}_{R}x{T}", R, T, H, dtype))
        elif k == "lstm_scan_bidir2":
            T, R, H, _ = key
            bidir2.setdefault(key, (f"{p}_{T}x{R}", T, R, H, dtype))
        elif k == "lstm_scan_bidir":
            T, R2, H, _ = key
            bidir.setdefault(key, (f"{p}_{T}x{R2}", T, R2 // 2, H, dtype))
        elif k == "tcn_block_tail":
            B, T, H, Bc, d, _ = key
            tails.setdefault(key, (f"{p}_{B}x{T}_d{d}", B, T, H, Bc, d, dtype))
        elif k == "tcn_gln_stats":
            B, T, H, _ = key
            stats.setdefault(key, (f"{p}_{B}x{T}", B, T, H, dtype))
    return (phase_kernels(fused.values(), phase) + phase_scan_kernels(scans.values(), phase)
            + phase_bidir2_kernels(bidir2.values(), phase)
            + phase_bidir_kernels(bidir.values(), phase)
            + phase_tcn_kernels(tails.values(), phase) + phase_gln_stats(stats.values(), phase))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        sys.exit(1)
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    from nvse_tpu_torch import resolve_device

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    global CARD
    CARD = smi
    say(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    phase_build()
    m_fused = [(label, R, T, 128, 128, dt) for label, R, T in FUSED_SHAPES for dt in DTYPES]
    m_fused += [(*FUSED_RAGGED, dt) for dt in DTYPES]
    m_scans = [(n, label, R, T, 128, dt) for n, label, R, T in SCAN_SHAPES for dt in DTYPES]
    rows = phase_kernels(m_fused) + phase_train_kernels() + phase_scan_kernels(m_scans)
    # the main paths, each with its launches per wrapper and shape
    paths = {"decode": phase_decode(), "serve": phase_serve(), "train": phase_train()}
    phase_train_vs_cpu_plain()
    paths["train_cli"] = phase_train_cli()
    # the loop's knobs: a trace of the first step, async saves, debug_nans
    paths["train_knobs"] = phase_train_knobs()
    # the joint denoise+vocoder BSRNN_24k (BSRNN-M's shapes at 24 kHz): both tasks; then
    # its enhancement evaluation from the g_ bundle its training CLI wrote
    paths["joint_train"] = phase_train("joint")
    phase_train_vs_cpu_plain("joint")
    with tempfile.TemporaryDirectory() as keep:
        g_joint = os.path.join(keep, "g_00000001")
        paths["joint_train_cli"] = phase_train_cli("joint", keep_g=g_joint)
        paths["joint_eval"] = phase_joint_eval(g_joint)
    paths["stream"] = phase_stream()
    paths["train_causal"] = phase_train(causal=True)
    rows += phase_bidir2_kernels([(label, T, R, H, dt) for label, T, R, H in BIDIR2_SHAPES
                                  for dt in DTYPES])
    paths["gcrn"] = phase_gcrn()
    phase_bidir2_grad()
    paths["gcrn_train"] = phase_train("gcrn")
    phase_train_vs_cpu_plain("gcrn")
    paths["gcrn_train_cli"] = phase_train_cli("gcrn")
    # BSRNN-L (H = 256): the wide inference kernels and the wide training kernels
    l_paths = {"decode": phase_decode("bsrnn_l"), "serve": phase_serve("bsrnn_l"),
               "stream": phase_stream("bsrnn_l"), "train": phase_train("bsrnn_l", validate=True)}
    phase_train_vs_cpu_plain("bsrnn_l")
    rows += phase_kernels([(label, R, T, 256, 256, dt) for label, R, T in FUSED_SHAPES
                           for dt in DTYPES], phase="bsrnn_l_kernels")
    rows += phase_train_kernels(L_TRAIN_SHAPES, phase="bsrnn_l_kernels")
    rows += phase_scan_kernels([(n, label, R, T, 256, dt) for n, label, R, T in SCAN_SHAPES
                                for dt in DTYPES], phase="bsrnn_l_kernels")
    # every other shape that a main path launched (serving's 128-frame bucket, the
    # validations, the offline decodes beside the streams), in the dtype it ran in
    rows += phase_rest(rows, paths) + phase_rest(rows, l_paths, phase="bsrnn_l_kernels")
    # ConvTasNet (the time domain): the tail kernel at the decode shape at each
    # dilation, the decode and serving main path, then the shapes serving launched
    rows += phase_tcn_kernels([(f"decode_d{d}", TCN_B, TCN_T, TCN_H, TCN_BC, d, dt)
                               for d in TCN_DILATIONS for dt in DTYPES])
    rows += phase_gln_stats([("decode", TCN_B, TCN_T, TCN_H, dt) for dt in DTYPES],
                            bound_limit=GLN_DECODE_BOUND)
    c_paths = {"convtasnet": phase_convtasnet()}
    rows += phase_rest(rows, c_paths, phase="tcn_kernels")
    # the two-direction scan (B7), its bench, lstm_scan_fused at HD-Demucs's bottleneck,
    # then the shapes the bench and HD-Demucs launched on the other kernels
    rows += phase_bidir_kernels([(label, T, B, H, dt) for label, T, B, H in BIDIR_SHAPES
                                 for dt in DTYPES])
    b_paths = {"bench_lstm_kernel": phase_bench_lstm_kernel(),
               "hddemucs_bottleneck": phase_hddemucs_bottleneck(), "hddemucs": phase_hddemucs()}
    rows += phase_rest(rows, b_paths, phase="lstm_scan_bidir_kernels")
    # the conv T-F vocoders: serving and T-F GAN training at their published widths,
    # on convolutions, GELU, LayerNorm and the iSTFT alone (no kernel of csrc/)
    v_paths = {}
    for name in TF_VOCODERS:
        v_paths[name] = phase_tf_vocoder(name)
        v_paths[f"{name}_train"] = phase_tf_vocoder_train(name)
        phase_train_vs_cpu_plain(name)
    # the time domain: HiFiGAN and iSTFTNet serving (no kernel of csrc/), the time
    # trainer (MPD + MSD) on them, on ConvTasNet (the TCN tail kernels) and on HD-Demucs
    # (the H = 768 training kernels), the training CLI with HiFiGAN; then the kernels
    # against their plain versions at the shapes those steps launched
    t_paths = {}
    for name in MRF_VOCODERS:
        t_paths[name] = phase_tf_vocoder(name)
    for name in TIME_TRAIN:
        t_paths[f"{name}_train"] = phase_time_train(name)
        phase_train_vs_cpu_plain(name)
    t_paths["hifigan_train_cli"] = phase_train_cli("hifigan")
    rows += phase_train_kernels(_train_shapes(t_paths["hddemucs_train"], "hddemucs"),
                                phase="time_kernels")
    rows += phase_rest(rows, t_paths, phase="time_kernels")
    # the CQT discriminator in BSRNN-M's T-F step (f32, bf16) and in small T-F and time
    # steps against the CPU; the evaluation path: UTMOS (its decoder BiLSTM on
    # lstm_scan_bidir2 at H = 512), CREPE, the metric CLI on served decodes; then rows
    # for the lstm_scan_bidir2 shapes UTMOS launched
    e_paths = {"cqtd_train": phase_train(cqtd=True)}
    for name in ("bsrnn", "hifigan"):
        phase_train_vs_cpu_plain(name, cqtd=True)
    e_paths["utmos"] = phase_utmos()
    phase_crepe()
    e_paths["eval_cli"] = phase_eval_cli()
    rows += phase_rest(rows, e_paths, phase="eval_kernels")
    # serving export: artifacts of BSRNN-M and of each kernel family decoding on the card
    # through the registered operators, then rows for the shapes they launched
    x_paths = {"export": phase_export()}
    rows += phase_rest(rows, x_paths, phase="export_kernels")
    # C7: every LSTM wrapper at H = 1024, at a padded shape and in float16, the float16
    # tail at the decode shape (held only); BSRNN at feature_dim 102 decoding and
    # training, float16 steps of BSRNN-M and ConvTasNet; then rows for their launches
    rows += phase_c7_kernels()
    c7_paths = {"c7_decode": phase_c7_decode(), **phase_c7_train()}
    rows += phase_c7_train_rows(c7_paths)
    rows += phase_rest(rows, c7_paths, phase="c7_kernels")
    # multi-GPU: the port's dry run, BSRNN-M's DP and dp x sp steps over ranks, DP
    # serving; then rows for the shapes the ranks launched (their local batch, sp's
    # band and frame slices) and the replicas served
    torch.cuda.empty_cache()
    p_paths = {"dryrun": phase_dryrun(), **phase_parallel_train(), "dp_serve": phase_dp_serve()}
    rows += phase_parallel_rows(rows, p_paths)
    # the per-step ablation harness (B8)
    ablation_rows, ablation_counts = phase_lstm_step_ablation()
    rows += ablation_rows
    all_paths = {**paths, **{f"bsrnn_l_{p}": c for p, c in l_paths.items()}, **c_paths,
                 **b_paths, **v_paths, **t_paths, **e_paths, **x_paths, **c7_paths, **p_paths,
                 "lstm_step_ablation": ablation_counts}
    missing = _missing(rows, all_paths)
    if missing:
        raise SystemExit(f"launches on a main path with no kernel-vs-plain row: {missing}")

    launched = {}                  # launches per wrapper and shape over every main path
    for counts in all_paths.values():
        for k, d in counts.items():
            for key, n in d.items():
                launched.setdefault(k, {})[key] = launched.get(k, {}).get(key, 0) + n
    fused_replaces = {"replaces": "nvse_tpu/ops/pallas_lstm.py:815",
                      "also_replaces": "nvse_tpu/ops/pallas_lstm.py:727"}
    replaces = {"lstm_fwd_hc": "nvse_tpu/ops/pallas_lstm_bwd.py:181",
                "lstm_bwd": "nvse_tpu/ops/pallas_lstm_bwd.py:339",
                "lstm_bwd_dw": "nvse_tpu/ops/pallas_lstm_bwd.py:339",
                "lstm_scan": "nvse_tpu/ops/pallas_lstm.py:212",
                "lstm_scan_stateful": "nvse_tpu/ops/pallas_lstm.py:297",
                "lstm_scan_bidir2": "nvse_tpu/ops/pallas_lstm.py:499",
                "tcn_block_tail": "nvse_tpu/ops/pallas_tcn.py:136",
                "tcn_gln_stats": "nvse_tpu/ops/pallas_tcn.py:175",
                "lstm_scan_bidir": "nvse_tpu/ops/pallas_lstm.py:427",
                "lstm_step_variant": "scripts/profile_lstm_step.py:99"}
    kernels = []
    for r in rows:
        if r["shape"] in HELD_ONLY.get(r["name"], ()):
            continue               # held against its plain version only: no path launches it
        src = {"source": r["source"], **(fused_replaces if r["name"] == "lstm_scan_fused"
                                         else {"replaces": replaces[r["name"]]})}
        kernels.append({
            "name": r["name"], "shape": r["shape"], "rows": r["rows"], "steps": r["steps"],
            "H": r["H"], **{k: r[k] for k in ("C", "mode", "Bc", "dilation", "library", "design")
                            if r.get(k) is not None},
            "dtype": r["dtype"], "route": "cuda", **src,
            "launches": launched.get(r["name"], {}).get(_key(r), 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    if any(k["launches"] == 0 for k in kernels):
        idle = [(k["name"], k["shape"], k["H"], k["dtype"]) for k in kernels if not k["launches"]]
        raise SystemExit(f"a kernel of a driven path was never launched: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
