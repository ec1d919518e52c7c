"""GAN training CLI on the port (counterpart of train_tf_wi_inv.py,
train_time_wi_inv.py and, with --joint, of
train_tf_wi_inv_joint_denoise_vocoder.py).

    python -m nvse_tpu_torch.train --cfg_filename nvse_tpu_torch/configs/bsrnn_config.json
    python -m nvse_tpu_torch.train --cfg_filename nvse_tpu_torch/configs/hifigan_v1_config.json
    python -m nvse_tpu_torch.train --joint
Trains the configured generator in its registry domain, MPD + MRD for a
T-F model, MPD + MSD for a time-domain one (HiFiGAN, iSTFTNet, ConvTasNet,
HD-Demucs), writing g_/do_ bundles to h.checkpoint_path and resuming from
the newest pair there. --joint
trains the joint denoise+vocoder BSRNN_24k (train/loop_joint.py; default
config nvse_tpu_torch/configs/bsrnn_joint_denoise_vocoder_config.json),
a task drawn per batch. Runs on the GPU unless --device cpu is given.
"""
import argparse
import os

from ..utils import load_config
from .loop import train
from .loop_joint import train_joint

_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def main() -> None:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.train")
    p.add_argument("--cfg_filename", default=None,
                   help="default: configs/bsrnn_config.json, with --joint "
                        "configs/bsrnn_joint_denoise_vocoder_config.json")
    p.add_argument("--joint", action="store_true",
                   help="the joint denoise+vocoder trainer (BSRNN_24k)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    cfg = args.cfg_filename or os.path.join(
        _CONFIGS, "bsrnn_joint_denoise_vocoder_config.json" if args.joint else "bsrnn_config.json")
    (train_joint if args.joint else train)(load_config(cfg), device=args.device)


if __name__ == "__main__":
    main()
