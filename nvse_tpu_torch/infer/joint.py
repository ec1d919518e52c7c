"""Joint denoise+vocoder serving (BSRNN_24k).

Counterpart of infers/inference_joint_denoise_vocoder_bsrnn.py, run as

    python -m nvse_tpu_torch.infer --processing_mode denoise|vocoder [--cfg_filename ...]

Each file of the configured test filelist is read at the model's rate; its
input spectrum is ops.spectral.joint_input for the mode ("denoise": the log
amplitude of the (noisy) wave; "vocoder": the log pseudo-inverse mel of its
mel), computed on the engine's device outside the timed region. Every
length bucket is warmed up outside the timed region too; the engine decodes
the padded bucket (InferenceEngine.synthesize_mel) and crops to the input's
length. Writes PCM16 wavs to h.test_output_dir and prints the RTF line.
"""
from __future__ import annotations

import os
import time

import torch

from ..data import load_wav, write_wav
from ..ops.spectral import JOINT_TASKS, joint_input
from .engine import InferenceEngine, resolve_filelist


def run_joint_inference(h, mode: str, limit: int | None = None, log_fn=print,
                        device: str = "cuda") -> dict:
    """Decode the test set in `mode` file by file; returns the RTF stats."""
    if mode not in JOINT_TASKS:
        raise ValueError(f"processing_mode {mode!r}: expected one of {JOINT_TASKS}")
    engine = InferenceEngine(h, device=device, log_fn=log_fn)
    files = resolve_filelist(h)
    if limit:
        files = files[:limit]
    os.makedirs(h.test_output_dir, exist_ok=True)
    total_audio, total_wall = 0.0, 0.0
    for path in files:
        audio = load_wav(path, h.sampling_rate)
        wave = torch.from_numpy(audio[None, :]).to(engine.device)
        spec = joint_input(wave, mode, h)
        engine.warmup(spec.shape[-1])
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        t0 = time.time()
        out = engine.synthesize_mel(spec, out_len=len(audio))
        total_wall += time.time() - t0
        total_audio += len(audio) / h.sampling_rate
        write_wav(os.path.join(h.test_output_dir, os.path.basename(path)), out[0],
                  h.sampling_rate)
    rtf = total_audio / max(total_wall, 1e-9)
    log_fn(f"decoded {len(files)} files | wall {total_wall:.2f}s | "
           f"audio {total_audio:.2f}s | RTF {rtf:.2f}x realtime")
    return {"files": len(files), "wall_sec": total_wall, "audio_sec": total_audio, "rtf": rtf}
