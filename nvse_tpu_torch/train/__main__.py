"""T-F domain GAN training CLI on the port (counterpart of train_tf_wi_inv.py).

    python -m nvse_tpu_torch.train --cfg_filename nvse_tpu_torch/configs/bsrnn_config.json
Trains the configured generator with MPD + MRD, writing g_/do_ bundles
to h.checkpoint_path and resuming from the newest pair there. Runs on
the GPU unless --device cpu is given.
"""
import argparse
import os

from ..utils import load_config
from .loop import train


def main() -> None:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.train")
    p.add_argument("--cfg_filename", default=os.path.join(
        os.path.dirname(__file__), "..", "configs", "bsrnn_config.json"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    train(load_config(args.cfg_filename), device=args.device)


if __name__ == "__main__":
    main()
