#!/usr/bin/env python3
"""The multi-GPU phases of chip_smoke.py alone, on the cards of this machine.

    python3 scripts/smoke_torch_parallel.py

Builds the kernels, then runs chip_smoke.py's dryrun, dp_train, sp_train and
dp_serve (its header's item 20), each phase a JSON line: on a machine of 4
cards the ranks are 4 over NCCL (DP 4, dp x sp 2 x 2) and serving takes a
replica a card; on one card 2 ranks share it over gloo. The first line is the
cards' name and power limit; the last, the ranks' launches per wrapper and
shape on each path. No kernel-vs-plain phase runs here (the full smoke has
them). Exits nonzero without a CUDA GPU or when a phase fails.

chip_smoke.py takes no arguments and always runs every phase, about 13 minutes
on one H100, most of them single-card. This script is the multi-GPU phases
alone, which is what a machine of four cards is for: there every second costs
four cards' time, and the single-card phases would teach nothing new.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("smoke_torch_parallel: no CUDA GPU visible")
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import chip_smoke as cs
    from nvse_tpu_torch import resolve_device

    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout,
          flush=True)
    cs.phase_build()
    paths = {"dryrun": cs.phase_dryrun(), **cs.phase_parallel_train(),
             "dp_serve": cs.phase_dp_serve()}
    print(json.dumps({k: cs._str_keys(v) for k, v in paths.items()}), flush=True)


if __name__ == "__main__":
    main()
