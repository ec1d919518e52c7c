"""Inference CLI of the port for the BSRNN family, GCRN and ConvTasNet
(counterpart of infers/inference_bsrnn.py, infers/inference_gcrn.py and
infers/inference_convtasnet.py).

    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/bsrnn_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/gcrn_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/convtasnet_config.json
Decodes the configured test filelist to h.test_output_dir and prints the
RTF (generated-audio-seconds / wall-seconds). Runs on the GPU unless
--device cpu is given. --stream decodes in chunks (config keys
stream_chunk_frames, stream_context_frames; stream_mode "stateful"
carries the recurrent state instead of recomputing a context, for the
BSRNN family; GCRN and ConvTasNet stream by context recompute). ConvTasNet's
config leaves fused_tcn off, as the reference; a copy with "fused_tcn": 1
runs every TCN block tail through the kernel of csrc/tcn_tail.cu.
"""
import argparse
import os

from ..utils import load_config
from .engine import run_inference


def main() -> None:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.infer")
    p.add_argument("--cfg_filename", default=os.path.join(
        os.path.dirname(__file__), "..", "configs", "bsrnn_config.json"))
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--stream", action="store_true",
                   help="chunked streaming decode, one window shape for any length")
    args = p.parse_args()
    h = load_config(args.cfg_filename)
    run_inference(h, limit=args.limit, stream=args.stream, device=args.device)


if __name__ == "__main__":
    main()
