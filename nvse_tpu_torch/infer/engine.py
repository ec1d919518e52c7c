"""Batch inference engine: mel->wav decoding with RTF accounting.

Counterpart of nvse_tpu/infer/engine.py for the BSRNN family:
  * length bucketing: utterances are padded to the next multiple of
    `bucket_frames` mel frames with log(1e-5) and the output is cropped
    back, so a batch of mixed lengths decodes at a few fixed shapes;
  * `compute_dtype: "bfloat16"` runs the trunk in bf16 (params and mel
    cast, as the JAX engine does); the DSP ends stay float32;
  * RTF = generated-audio-seconds / wall-seconds, each bucket warmed up
    outside the timed region.
Multi-device serving, streaming decode and Orbax checkpoints belong to
later slices of the port and raise here.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import load_wav, write_wav
from ..models import build_generator, model_input_bins
from ..ops.spectral import mel_spectrogram, mel_spectrogram_np

_PAD = float(np.log(1e-5))


def _bucket(n: int, step: int) -> int:
    return max(step, ((n + step - 1) // step) * step)


class InferenceEngine:
    """Holds one generator on `device` and decodes mel batches to waves.

    params: a port state_dict (e.g. from utils.params_from_jax); when
    None, weights load from h.checkpoint_file_load if that file exists
    (a g_ bundle {"generator": state_dict} written by the port's
    training, or a bare state_dict), else they are random from a
    torch.Generator seeded with h.seed.
    """

    def __init__(self, h, params: dict | None = None, device: str = "cuda",
                 bucket_frames: int = 64):
        self.h = h
        self.device = resolve_device(device)
        self.bucket_frames = bucket_frames
        if int(h.get("infer_dp_devices", 1) or 1) != 1:
            raise NotImplementedError("multi-GPU serving (infer_dp_devices) is not ported yet")
        self.generator, _domain = build_generator(h)
        if params is None:
            ckpt = h.get("checkpoint_file_load")
            if ckpt and os.path.isdir(ckpt):
                raise NotImplementedError(
                    f"{ckpt} is an Orbax bundle of the JAX package; loading those is "
                    "not ported yet (convert with utils.params_from_jax)")
            if ckpt and os.path.isfile(ckpt):
                params = torch.load(ckpt, map_location="cpu", weights_only=True)
                if "generator" in params:   # a g_ bundle written by training
                    params = params["generator"]
        if params is not None:
            self.generator.load_state_dict(params)
        self.generator.eval()
        if str(h.get("compute_dtype")) == "bfloat16":
            self.dtype = torch.bfloat16
            self.generator.to(torch.bfloat16)
        else:
            self.dtype = torch.float32
        self.generator.to(self.device)
        self._warmed: set = set()

    @torch.inference_mode()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, M, T) on the engine's device -> float32 wav (B, L)."""
        out = self.generator(mel.to(self.device, self.dtype))
        out = out[-1] if isinstance(out, tuple) else out
        return out.float()

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

    def warmup(self, T: int, batch: int | None = None) -> None:
        """Run the T-frame bucket at this batch once, outside any timer."""
        Tb = _bucket(T, self.bucket_frames)
        B = batch or 1
        if (Tb, B) in self._warmed:
            return
        self.forward(torch.full((B, model_input_bins(self.h), Tb), _PAD, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
    """
    if stream or h.get("stream"):
        raise NotImplementedError("streaming decode (--stream) is not ported yet")
    engine = InferenceEngine(h, device=device)
    if model_input_bins(h) != h.num_mels and not h.get("test_mel_load"):
        raise ValueError(
            f"model expects {model_input_bins(h)} input bins but run_inference feeds "
            f"{h.num_mels}-mel features; spectrum-input models need the joint "
            "inference path, not ported yet")
    files = resolve_filelist(h)
    if limit:
        files = files[:limit]
    os.makedirs(h.test_output_dir, exist_ok=True)
    if batch is None:
        batch = int(h.get("infer_batch") or 8)

    total_audio_sec = 0.0
    total_wall = 0.0

    if batch > 1 and not h.get("test_mel_load"):
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
        for path in files:
            if h.get("test_mel_load"):
                mel = torch.from_numpy(np.load(path)[None, ...])
                audio_len = mel.shape[-1] * h.hop_size
            else:
                audio = load_wav(path, h.sampling_rate)
                mel = engine.mel_of(audio)
                audio_len = len(audio)
            engine.warmup(mel.shape[-1])
            t0 = time.time()
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
