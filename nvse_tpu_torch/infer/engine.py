"""Batch inference engine: mel->wav decoding with RTF accounting.

Counterpart of nvse_tpu/infer/engine.py for the generators the port has
(all ten: the BSRNN family, GCRN, APNet, APNet2, FreeV, Vocos, HiFiGAN,
iSTFTNet, ConvTasNet and HD-Demucs; a time-domain generator returns the
wave itself, hop * (T - 1) samples (HiFiGAN's and iSTFTNet's hop * T),
which synthesize_mel crops;
the joint BSRNN_24k's spectrum input is served by infer/joint.py):
  * length bucketing: utterances are padded to the next multiple of
    `bucket_frames` mel frames with log(1e-5) and the output is cropped
    back, so a batch of mixed lengths decodes at a few fixed shapes;
  * `compute_dtype: "bfloat16"` runs the trunk in bf16 (params and mel
    cast, as the JAX engine does); the DSP ends stay float32;
  * weight norm is folded at load (`fold_weight_norm`, default true; the
    transposed convs of HiFiGAN / iSTFTNet too), the reference's
    remove_weight_norm before decoding;
  * RTF = generated-audio-seconds / wall-seconds, each bucket warmed up
    outside the timed region;
  * chunked streaming decode at one window shape whatever the length:
    `synthesize_streaming` recomputes a context on each side of every
    chunk (any generator), `synthesize_streaming_stateful` carries the
    time LSTMs' state and the overlap-add tail from chunk to chunk (exact
    for a causal config; the BSRNN family only: GCRN, ConvTasNet,
    HD-Demucs, HiFiGAN, iSTFTNet and the conv T-F vocoders have no
    `supports_stream_state` and
    raise there, and run_inference streams them by context recompute), batch rows being
    independent streams;
  * multi-device serving (`infer_dp_devices`: N replicas, -1 for every
    card; nvse_tpu/infer/engine.py:69-88, 122-176, 270-290): one replica of
    the generator per card, cuda:0 ... cuda:N-1 (no more than there are),
    in this process; a batch is padded with log(1e-5) rows to a multiple of
    the replicas, split, decoded on every card at once, gathered on the
    first and cropped (synthesize_mel, synthesize_streaming, warmup). The
    state-carrying stream decodes on the first card alone. On the CPU the
    replicas are N copies on the CPU.
An Orbax bundle of the JAX package raises here, naming
scripts/convert_jax_checkpoint.py, which converts it into a g_ bundle;
infer/export.py writes the decode as one torch.export artifact.
"""
from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import load_wav, write_wav
from ..models import build_generator, model_input_bins
from ..models.bsrnn import band_plan
from ..models.layers import fold_weight_norm
from ..ops.spectral import (StreamingOLA, hann_window, istft_frames, mel_spectrogram,
                            mel_spectrogram_np)
from ..parallel import local_devices

_PAD = float(np.log(1e-5))


def _bucket(n: int, step: int) -> int:
    return max(step, ((n + step - 1) // step) * step)


class InferenceEngine:
    """Holds one generator on `device` and decodes mel batches to waves.

    params: a port state_dict (e.g. from utils.params_from_jax); when
    None, weights load from h.checkpoint_file_load if that file exists
    (a g_ bundle {"generator": state_dict} written by the port's training
    or by utils.torch_import from a reference g_ checkpoint, or a bare
    state_dict), else they are random from a torch.Generator seeded with
    h.seed. Weight-norm pairs (v, g) are then folded into plain kernels
    unless h.fold_weight_norm is false (nvse_tpu/infer/engine.py:60-68).
    h.infer_dp_devices (N, or -1 for every card) serves from N replicas on
    `devices`, the first of which is `device` and holds `generator`.
    """

    def __init__(self, h, params: dict | None = None, device: str = "cuda",
                 bucket_frames: int = 64, log_fn=print):
        self.h = h
        self.device = resolve_device(device)
        self.bucket_frames = bucket_frames
        n_dp = int(h.get("infer_dp_devices", 1) or 1)
        self.devices = [self.device] if n_dp == 1 else local_devices(self.device, n_dp)
        if n_dp != 1:
            self.device = self.devices[0]
            log_fn(f"serving on {len(self.devices)} replica(s) ({self.device.type}; "
                   f"infer_dp_devices={n_dp})")
        self.generator, _domain = build_generator(h)
        if params is None:
            ckpt = h.get("checkpoint_file_load")
            if ckpt and os.path.isdir(ckpt):
                raise NotImplementedError(
                    f"{ckpt} is an Orbax bundle of the JAX package: convert it with "
                    "python scripts/convert_jax_checkpoint.py --cfg_filename <cfg> "
                    f"--jax_ckpt {ckpt} --out <g_ bundle> and serve that")
            if ckpt and os.path.isfile(ckpt):
                params = torch.load(ckpt, map_location="cpu", weights_only=True)
                if "generator" in params:   # a g_ bundle written by training
                    params = params["generator"]
        if params is not None:
            self.generator.load_state_dict(params)
        if bool(h.get("fold_weight_norm", True)):
            sd = self.generator.state_dict()
            folded = fold_weight_norm(sd)
            if folded.keys() != sd.keys():
                self.generator.load_state_dict(folded)
        self.generator.eval()
        if str(h.get("compute_dtype")) == "bfloat16":
            self.dtype = torch.bfloat16
            self.generator.to(torch.bfloat16)
        else:
            self.dtype = torch.float32
        self.generator.to(self.device)
        self.replicas = [self.generator] + [copy.deepcopy(self.generator).to(d)
                                            for d in self.devices[1:]]
        self._warmed: set = set()

    @torch.inference_mode()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, M, T) -> float32 wav (B, L) on the engine's device. With
        several replicas the rows are padded to a multiple of them, each
        replica decodes its share on its device (the launches of one do not
        wait for another's), and the outputs are gathered and cropped."""
        n = len(self.replicas)
        if n == 1:
            out = self.generator(mel.to(self.device, self.dtype))
            return (out[-1] if isinstance(out, tuple) else out).float()
        B = mel.shape[0]
        mel = torch.nn.functional.pad(mel, (0, 0, 0, 0, 0, _bucket(B, n) - B), value=_PAD)
        outs = []
        for rep, dev, rows in zip(self.replicas, self.devices, mel.chunk(n)):
            out = rep(rows.to(dev, self.dtype, non_blocking=True))
            outs.append(out[-1] if isinstance(out, tuple) else out)
        return torch.cat([o.to(self.device).float() for o in outs])[:B]

    def mel_of(self, audio: np.ndarray) -> torch.Tensor:
        h = self.h
        return mel_spectrogram(torch.from_numpy(np.asarray(audio, np.float32)[None, :]).to(self.device),
                               h.n_fft, h.num_mels, h.sampling_rate, h.hop_size,
                               h.win_size, h.fmin, h.fmax)

    def synthesize_mel(self, mel, out_len: int | None = None) -> np.ndarray:
        """mel (B, M, T) -> wav (B, L) numpy; pads T to a bucket, crops output."""
        mel = torch.as_tensor(mel)
        T = mel.shape[-1]
        Tb = _bucket(T, self.bucket_frames)
        melp = torch.nn.functional.pad(mel.to(self.device), (0, Tb - T), value=_PAD)
        wav = self.forward(melp).cpu().numpy()
        if out_len is None:
            out_len = T * self.h.hop_size
        return wav[..., :out_len]

    def synthesize_streaming(self, mel, out_len: int | None = None, chunk_frames: int = 64,
                             context_frames: int = 16) -> np.ndarray:
        """Chunked decode by context recompute: mel (B, M, T) -> wav (B, L).

        The mel is cut into windows of `chunk_frames` with `context_frames`
        on each side; each window is decoded on its own and only its centre
        chunk_frames * hop samples are kept. One window shape whatever the
        length, constant memory. For a causal model the left context
        rebuilds the recurrent state nearly exactly; for a non-causal one
        it bounds the lookahead error.
        """
        mel = torch.as_tensor(mel)
        T = mel.shape[-1]
        c, ctx, hop = chunk_frames, context_frames, self.h.hop_size
        n_chunks = (T + c - 1) // c
        # pad so that every window [i*c - ctx, (i+1)*c + ctx) is in range
        melp = torch.nn.functional.pad(mel.to(self.device), (ctx, n_chunks * c - T + ctx),
                                       value=_PAD)
        pieces = []
        for i in range(n_chunks):
            wav = self.forward(melp[..., i * c : i * c + c + 2 * ctx])
            pieces.append(wav[..., ctx * hop : (ctx + c) * hop].cpu().numpy())
        out = np.concatenate(pieces, axis=-1)
        return out[..., : T * hop if out_len is None else out_len]

    def _stream_state_zeros(self, B: int):
        """Zero recurrent state of a BSRNN-family model: num_repeat pairs
        (h, c) of the time LSTM's forward direction, each float32
        (B, nband, feature_dim): the state an offline decode starts from,
        so the first chunk is exact."""
        h = self.h
        nband = len(band_plan(h.sampling_rate, h.n_fft))
        z = torch.zeros(B, nband, int(h.feature_dim), device=self.device)
        return tuple((z, z) for _ in range(int(h.num_repeat)))

    @torch.inference_mode()
    def _stream_step(self, states, mel_win: torch.Tensor, c: int):
        """One chunk: (float32 states, mel window (B, M, c + lookahead)) ->
        (windowed synthesis frames (B, c, n_fft) float32, float32 states
        after c frames). The states enter the trunk in the compute dtype."""
        h = self.h
        states = tuple(tuple(s.to(self.dtype) for s in st) for st in states)
        outs, new_states = self.generator(mel_win.to(self.device, self.dtype),
                                          stream_state=states, return_state=True, carry_idx=c)
        frames = istft_frames(outs[2][..., :c].float(), outs[3][..., :c].float(), h.n_fft,
                              h.win_size, window=hann_window(h.win_size))
        return frames, tuple(tuple(s.float() for s in st) for st in new_states)

    def synthesize_streaming_stateful(self, mel, out_len: int | None = None,
                                      chunk_frames: int = 64,
                                      lookahead_frames: int = 16) -> np.ndarray:
        """Chunked decode that carries the recurrent state across chunks:
        mel (B, M, T) -> wav (B, L), for generators with
        `supports_stream_state` (the BSRNN family).

        Against the context-recompute decoder: for a causal config it is
        exact (the time LSTM's state at each chunk boundary is the true
        one, no left context is recomputed, and StreamingOLA's carried
        tail reproduces the offline iSTFT); for a non-causal config the
        forward direction is exact and only the backward direction sees a
        bounded `lookahead_frames` of future, so a window is c + la frames
        instead of c + 2 * ctx. Batch rows are independent streams.
        """
        if not getattr(type(self.generator), "supports_stream_state", False):
            raise ValueError(f"{self.h.model_name} has no stream_state support; use "
                             "synthesize_streaming (context recompute)")
        h = self.h
        mel = torch.as_tensor(mel)
        B, _, T = mel.shape
        c, la, hop = chunk_frames, lookahead_frames, h.hop_size
        n_chunks = (T + c - 1) // c
        melp = torch.nn.functional.pad(mel.to(self.device), (0, n_chunks * c - T + la),
                                       value=_PAD)
        states = self._stream_state_zeros(B)
        ola = StreamingOLA(h.n_fft, hop, h.win_size, window=hann_window(h.win_size))
        pieces = []
        for i in range(n_chunks):
            frames, states = self._stream_step(states, melp[..., i * c : i * c + c + la], c)
            pieces.append(ola.push(frames.cpu().numpy()))
        pieces.append(ola.flush())
        y = np.concatenate(pieces, axis=-1)[:, h.n_fft // 2 :]
        return y[:, : T * hop if out_len is None else out_len]

    def warmup(self, T: int, exact: bool = False, batch: int | None = None) -> None:
        """Run the T-frame bucket at this batch once, outside any timer;
        exact=True runs T itself (a streaming window is no bucket multiple)."""
        Tb = T if exact else _bucket(T, self.bucket_frames)
        B = batch or 1
        if (Tb, B) in self._warmed:
            return
        self.forward(torch.full((B, model_input_bins(self.h), Tb), _PAD, device=self.device))
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._warmed.add((Tb, B))


def resolve_filelist(h) -> list[str]:
    """Reference filelist semantics (infers/inference_bsrnn.py:47-55)."""
    src = h.test_input_wavs_dir
    if os.path.isfile(src):
        with open(src) as f:
            names = [l.strip().split("/")[1].split("|")[0] for l in f if l.strip()]
        return [os.path.join(h.raw_wavfile_path, n) for n in names]
    return [os.path.join(src, n) for n in sorted(os.listdir(src)) if n.endswith(".wav")]


def run_inference(h, limit: int | None = None, log_fn=print, stream: bool = False,
                  batch: int | None = None, device: str = "cuda") -> dict:
    """Decode the test set, write PCM16 wavs, print + return RTF stats.

    batch (default h.infer_batch, else 8) groups files into fixed-size
    batches per length bucket, with mels from the host numpy mel; batch=1
    (or test_mel_load) decodes file by file.

    stream=True (or h.stream) decodes file by file in chunks of
    h.stream_chunk_frames (64) with h.stream_context_frames (16) of
    context: by context recompute, or with h.stream_mode == "stateful"
    carrying the recurrent state, the context then being the lookahead.
    """
    stream = stream or bool(h.get("stream"))
    chunk = int(h.get("stream_chunk_frames", 64))
    ctx = int(h.get("stream_context_frames", 16))
    engine = InferenceEngine(h, device=device, log_fn=log_fn)
    if model_input_bins(h) != h.num_mels and not h.get("test_mel_load"):
        raise ValueError(
            f"model expects {model_input_bins(h)} input bins but run_inference feeds "
            f"{h.num_mels}-mel features; serve spectrum-input models (BSRNN_24k) with "
            "python -m nvse_tpu_torch.infer --processing_mode denoise|vocoder "
            "(infer/joint.py: run_joint_inference)")
    files = resolve_filelist(h)
    if limit:
        files = files[:limit]
    os.makedirs(h.test_output_dir, exist_ok=True)
    if batch is None:
        batch = int(h.get("infer_batch") or 8)

    total_audio_sec = 0.0
    total_wall = 0.0

    if batch > 1 and not stream and not h.get("test_mel_load"):
        M = model_input_bins(h)
        items = []  # (path, mel (M, T), audio_len)
        for path in files:
            audio = load_wav(path, h.sampling_rate)
            mel = mel_spectrogram_np(audio[None, :], h.n_fft, h.num_mels, h.sampling_rate,
                                     h.hop_size, h.win_size, h.fmin, h.fmax)[0]
            items.append((path, mel, len(audio)))
        groups: dict[int, list[int]] = {}
        for i, (_p, mel, _a) in enumerate(items):
            groups.setdefault(_bucket(mel.shape[-1], engine.bucket_frames), []).append(i)
        for Tb in sorted(groups):
            idxs = groups[Tb]
            for s in range(0, len(idxs), batch):
                grp = idxs[s : s + batch]
                melb = np.full((batch, M, Tb), _PAD, np.float32)
                for r, i in enumerate(grp):
                    m = items[i][1]
                    melb[r, :, : m.shape[-1]] = m
                engine.warmup(Tb, batch=batch)
                t0 = time.time()
                wavs = engine.synthesize_mel(torch.from_numpy(melb))
                total_wall += time.time() - t0
                for r, i in enumerate(grp):
                    path, _mel, alen = items[i]
                    total_audio_sec += alen / h.sampling_rate
                    write_wav(os.path.join(h.test_output_dir, os.path.basename(path)),
                              wavs[r, :alen], h.sampling_rate)
    else:
        stateful = (stream and str(h.get("stream_mode", "")) == "stateful"
                    and getattr(type(engine.generator), "supports_stream_state", False))
        for path in files:
            if h.get("test_mel_load"):
                mel = torch.from_numpy(np.load(path)[None, ...])
                audio_len = mel.shape[-1] * h.hop_size
            else:
                audio = load_wav(path, h.sampling_rate)
                mel = engine.mel_of(audio)
                audio_len = len(audio)
            if stream and not stateful:
                engine.warmup(chunk + 2 * ctx, exact=True)
            elif not stream:
                engine.warmup(mel.shape[-1])
            t0 = time.time()
            if stateful:
                wav = engine.synthesize_streaming_stateful(
                    mel, out_len=audio_len, chunk_frames=chunk, lookahead_frames=ctx)
            elif stream:
                wav = engine.synthesize_streaming(mel, out_len=audio_len, chunk_frames=chunk,
                                                  context_frames=ctx)
            else:
                wav = engine.synthesize_mel(mel, out_len=audio_len)
            total_wall += time.time() - t0
            total_audio_sec += audio_len / h.sampling_rate
            write_wav(os.path.join(h.test_output_dir, os.path.basename(path)),
                      wav[0], h.sampling_rate)

    rtf = total_audio_sec / max(total_wall, 1e-9)
    log_fn(f"decoded {len(files)} files | wall {total_wall:.2f}s | "
           f"audio {total_audio_sec:.2f}s | RTF {rtf:.2f}x realtime")
    return {"files": len(files), "wall_sec": total_wall,
            "audio_sec": total_audio_sec, "rtf": rtf}
