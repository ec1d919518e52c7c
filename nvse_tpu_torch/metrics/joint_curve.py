"""DNSMOS / PESQ / ESTOI training curve of the joint denoise+vocoder model
(counterpart of scripts/joint_curve_eval.py).

    python -m nvse_tpu_torch.metrics.joint_curve --cfg_filename <joint cfg> \\
        --steps 5000,10000,15000 [--snr 5] [--out QUALITY_r5.json] [--jb 6] \\
        [--voc_dnsmos_all] [--model_dir <DNSMOS dir>] [--work_dir File_Decodes/joint_curve] \\
        [--limit N] [--device cpu]

The in-env counterpart of the paper's joint-training curves (reference
figure/Joint_metrics.png): the test split is mixed once with held-out noise
at --snr (enhance.mix_at_snr; clean and noisy written under --work_dir),
then for each --steps checkpoint g_{step:08d} under h.checkpoint_path (a g_
bundle of the port's training; a missing one is skipped) both paths decode
the whole split in one batch each, padded to the longest file
(`batched_decode`, on the card unless --device cpu): denoise from the noisy
log amplitude, vocoder from joint_input(clean, "vocoder"). Each signal gets
one record: DNSMOS SIG / BAK / OVRL / P.808 (metrics/dnsmos.score_dir with
--jb processes; the vocoded signal at the last step only unless
--voc_dnsmos_all) and PESQ-WB, ESTOI and LSD against the clean reference.
DNSMOS needs sig_bak_ovr.onnx and / or model_v8.onnx under --model_dir, as
the JAX script does: without them the first record raises
FileNotFoundError, before any decode.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import dnsmos
from .enhance import mix_at_snr, noise_files

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_mixes(h, files: list[str], snr_db: float, work_dir: str):
    """Mix each file at snr_db and write clean and noisy under work_dir once.
    -> (clean_dir, noisy_dir, {name: clean}, {name: noisy})."""
    from ..data.audio_io import load_wav, write_wav

    sr = h.sampling_rate
    noises = noise_files(h)
    clean_dir = os.path.join(work_dir, "clean")
    noisy_dir = os.path.join(work_dir, f"noisy_snr{snr_db:g}")
    os.makedirs(clean_dir, exist_ok=True)
    os.makedirs(noisy_dir, exist_ok=True)
    cleans, noisys = {}, {}
    for i, path in enumerate(files):
        name = os.path.basename(path)
        noisy, clean = mix_at_snr(load_wav(path, sr), load_wav(noises[i % len(noises)], sr),
                                  snr_db)
        cleans[name], noisys[name] = clean, noisy
        write_wav(os.path.join(clean_dir, name), clean, sr)
        write_wav(os.path.join(noisy_dir, name), noisy, sr)
    return clean_dir, noisy_dir, cleans, noisys


def batched_decode(engine, h, cleans: dict, noisys: dict):
    """One batched decode per mode of every file, zero-padded to the longest
    (the engine pads the frames with log 1e-5): -> (enhanced, vocoded),
    numpy (files, longest) in the order of `cleans`."""
    import torch

    from ..ops.spectral import joint_input

    names = list(cleans)
    longest = max(len(cleans[n]) for n in names)
    noisy_b = np.zeros((len(names), longest), np.float32)
    clean_b = np.zeros((len(names), longest), np.float32)
    for r, n in enumerate(names):
        noisy_b[r, : len(noisys[n])] = noisys[n]
        clean_b[r, : len(cleans[n])] = cleans[n]
    out = []
    for wave, mode in ((noisy_b, "denoise"), (clean_b, "vocoder")):
        spec = joint_input(torch.from_numpy(wave).to(engine.device), mode, h)
        out.append(engine.synthesize_mel(spec, out_len=longest))
    return tuple(out)


def intrusive_of(deg_dir: str, cleans: dict, sr: int) -> dict:
    """Mean PESQ-WB, ESTOI and LSD of the wavs of deg_dir against cleans."""
    from ..data.audio_io import load_wav
    from . import estoi, lsd, pesq_wb

    ps, es, ls = [], [], []
    for name, clean in cleans.items():
        deg = load_wav(os.path.join(deg_dir, name), sr)
        n = min(len(clean), len(deg))
        c, g = clean[:n], deg[:n]
        ps.append(pesq_wb(c, g, sr))
        es.append(estoi(c, g, sr))
        ls.append(lsd(c, g, sr))
    return {"pesq": round(float(np.mean(ps)), 4), "estoi": round(float(np.mean(es)), 4),
            "lsd": round(float(np.mean(ls)), 4)}


def dnsmos_of(deg_dir: str, model_dir: str, jobs: int) -> dict:
    """Mean DNSMOS SIG / BAK / OVRL / P.808 of the wavs of deg_dir."""
    rows = dnsmos.score_dir(deg_dir, model_dir, jobs=jobs)
    out = {}
    for k, tag in (("SIG", "dnsmos_sig"), ("BAK", "dnsmos_bak"), ("OVRL", "dnsmos_ovr"),
                   ("P808_MOS", "dnsmos_p808")):
        vals = [r[k] for r in rows if k in r]
        if vals:
            out[tag] = round(float(np.mean(vals)), 4)
    return out


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.metrics.joint_curve")
    p.add_argument("--cfg_filename", required=True)
    p.add_argument("--steps", required=True,
                   help="comma list of checkpoint steps (g_<8digit> under h.checkpoint_path)")
    p.add_argument("--snr", type=float, default=5.0)
    p.add_argument("--label", default="joint_curve")
    p.add_argument("--out", default="QUALITY_r5.json")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--jb", type=int, default=6, help="DNSMOS worker processes")
    p.add_argument("--voc_dnsmos_all", action="store_true",
                   help="DNSMOS-score the vocoded dir at every step (default: the last only)")
    p.add_argument("--model_dir", default=os.environ.get(
        "NVSE_DNSMOS_DIR", os.path.join(_REPO, "Metrics", "DNSMOS")))
    p.add_argument("--work_dir", default="File_Decodes/joint_curve")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from .. import resolve_device
    from ..data.audio_io import write_wav
    from ..infer.engine import InferenceEngine, resolve_filelist
    from ..utils import AttrDict, load_config

    resolve_device(args.device)          # no card: raise before any work
    h = load_config(args.cfg_filename)
    sr = h.sampling_rate
    files = resolve_filelist(h)
    if args.limit:
        files = files[: args.limit]
    clean_dir, noisy_dir, cleans, noisys = write_mixes(h, files, args.snr, args.work_dir)
    records = []

    def emit(rec):
        rec.update(label=args.label, mix_snr_db=args.snr, files=len(files),
                   timestamp=time.strftime("%Y-%m-%d %H:%M:%S"))
        print(json.dumps(rec))
        records.append(rec)

    emit({"signal": "clean", **dnsmos_of(clean_dir, args.model_dir, args.jb)})
    emit({"signal": "noisy", **dnsmos_of(noisy_dir, args.model_dir, args.jb),
          **intrusive_of(noisy_dir, cleans, sr)})

    steps = [int(s) for s in args.steps.split(",")]
    for step in steps:
        ck = os.path.join(h.checkpoint_path, f"g_{step:08d}")
        if not os.path.isfile(ck):
            print(f"!! missing checkpoint {ck}; skipping", file=sys.stderr)
            continue
        h2 = AttrDict(dict(h))
        h2["checkpoint_file_load"] = ck
        enh, voc = batched_decode(InferenceEngine(h2, device=args.device), h, cleans, noisys)
        den_dir = os.path.join(args.work_dir, f"denoised_{step:08d}")
        voc_dir = os.path.join(args.work_dir, f"vocoded_{step:08d}")
        os.makedirs(den_dir, exist_ok=True)
        os.makedirs(voc_dir, exist_ok=True)
        for r, n in enumerate(cleans):
            write_wav(os.path.join(den_dir, n), enh[r, : len(noisys[n])], sr)
            write_wav(os.path.join(voc_dir, n), voc[r, : len(cleans[n])], sr)
        emit({"signal": "denoised", "step": step, **dnsmos_of(den_dir, args.model_dir, args.jb),
              **intrusive_of(den_dir, cleans, sr)})
        voc_scores = intrusive_of(voc_dir, cleans, sr)
        if args.voc_dnsmos_all or step == steps[-1]:
            voc_scores.update(dnsmos_of(voc_dir, args.model_dir, args.jb))
        emit({"signal": "vocoded", "step": step, **voc_scores})

    if args.out:
        rows = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                rows = json.load(f)
        rows.extend(records)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"appended {len(records)} records -> {args.out}")
    return records


if __name__ == "__main__":
    main()
