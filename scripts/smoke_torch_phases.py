#!/usr/bin/env python3
"""Phases of chip_smoke.py alone, from this checkout or another one.

    python3 scripts/smoke_torch_phases.py --phases build,decode [--repo DIR]
    python3 scripts/smoke_torch_phases.py --phases build,export
    python3 scripts/smoke_torch_phases.py --phases build,rank_shapes
    python3 scripts/smoke_torch_phases.py --phases build,dryrun,parallel_train,dp_serve
    python3 scripts/smoke_torch_phases.py --phases build,train_knobs,joint_eval
    python3 scripts/smoke_torch_phases.py --phases gln_shapes [--repo DIR]
    python3 scripts/smoke_torch_phases.py --phases f16_vs_bf16 [--repo DIR]

Each name runs chip_smoke.py's phase_<name>() of the checkout at --repo (default:
this one), which prints its JSON lines; `build` first, as every phase needs the
kernels. The last line is the launches per wrapper and shape that each phase's
main paths made. The multi-GPU phases (dryrun, parallel_train, dp_serve) use every
card of the machine: 4 NCCL ranks on 4 cards, 2 gloo ranks sharing one card
otherwise; on a machine of four cards they are the phases to run, since the
single-card ones would teach nothing new there. `joint_eval` runs the joint
training CLI first, for the g_ bundle it evaluates. `rank_shapes` is this script's:
the kernels against their plain versions
(chip_smoke.py's kernel phases: ms, plain ms, bound, library ms, error) at the
shapes a rank launches on four cards, which a one-card smoke never launches:
DP over 4 ranks (4 rows of 16 a rank: time 136 x 65, band 260 x 34), dp x sp 2 x 2
(8 rows, the 65 frames split 33 / 32: band 264 and 256 x 34, time 136 x 65) and
DP serving with a replica a card (2 of 8 rows: fused 68 x 1024 and 2048 x 34).
`gln_shapes` is this script's too: the gLN statistics kernel against `_fold` and
torch.var_mean (chip_smoke.py's phase_gln_stats, with torch.profiler's device time
of both, read whole in this process) at every shape ConvTasNet's paths
launch it (serving's 128-frame bucket, the GAN step, the float16 step) and at the
decode shape; it builds only csrc/tcn_tail.cu, so it needs no `build` first.
Two checkouts compared on one card: run each in turn in one call (parent,
change, change, parent), e.g. --repo chip_tree/parent. The first line is the
card's name and power limit. Exits nonzero without a CUDA GPU or when a phase fails.
"""
import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, rows, steps, H) of the training kernels and (label, rows, steps, C, H) of the
# fused BiLSTM at BSRNN-M's four-card rank shapes
RANK_TRAIN = (("dp4_time", 136, 65, 128), ("dp4_band", 260, 34, 128),
              ("sp2_band33", 264, 34, 128), ("sp2_band32", 256, 34, 128))
RANK_FUSED = (("dp4_serve_time", 68, 1024, 128, 128), ("dp4_serve_band", 2048, 34, 128, 128))
# (label, B, T, H, dtype name) of the gLN statistics at ConvTasNet's shapes: serving's
# 128-frame bucket (8 x 4063 encoder frames), the GAN step (16 x 2047), the float16
# step of two rows (2 x 511) and the B = 8 x 1024 decode (8 x 32,735)
GLN_SHAPES = tuple((label, B, T, 512, dt) for label, B, T, dts in (
    ("serve_8x4063", 8, 4063, ("float32", "bfloat16")),
    ("step_16x2047", 16, 2047, ("float32", "bfloat16")),
    ("f16_step_2x511", 2, 511, ("float16",)),
    ("decode_8x32735", 8, 32735, ("float32", "bfloat16"))) for dt in dts)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--phases", required=True, help="comma list: build, decode, export, "
                   "rank_shapes, ... (chip_smoke.py's phase_<name> that take no argument)")
    p.add_argument("--repo", default=HERE, help="the checkout whose chip_smoke.py runs")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("smoke_torch_phases: no CUDA GPU visible")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    os.chdir(repo)
    import chip_smoke as cs
    from nvse_tpu_torch import resolve_device

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if hasattr(cs, "CARD"):
        cs.CARD = smi
    cs.say(phase="repo", repo=repo)
    launches = {}
    for name in args.phases.split(","):
        if name == "joint_eval":         # from the g_ bundle of the joint training CLI
            with tempfile.TemporaryDirectory() as keep:
                g = os.path.join(keep, "g_00000001")
                cs.phase_train_cli("joint", keep_g=g)
                launches[name] = _str_keys(cs.phase_joint_eval(g))
        elif name == "gln_shapes":      # device time too, where the checkout reads it
            device = ({"device_time": True} if "device_time"
                      in inspect.signature(cs.phase_gln_stats).parameters else {})
            cs.phase_gln_stats([(label, B, T, H, getattr(torch, dt)) for label, B, T, H, dt
                                in GLN_SHAPES], phase="gln_shapes", **device)
        elif name == "rank_shapes":
            cs.phase_train_kernels(RANK_TRAIN, phase="rank_shapes")
            cs.phase_kernels([(*s, dt) for s in RANK_FUSED for dt in cs.DTYPES],
                             phase="rank_shapes")
        else:
            out = getattr(cs, f"phase_{name}")()
            if isinstance(out, dict):
                launches[name] = _str_keys(out)
    print(json.dumps({"launches": launches}), flush=True)


def _str_keys(d):
    """A phase's launch counts (nested dicts keyed by shape tuples) for a JSON line."""
    return {str(k): _str_keys(v) if isinstance(v, dict) else v for k, v in d.items()}


if __name__ == "__main__":
    main()
