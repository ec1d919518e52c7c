"""Inference CLI of the port for the BSRNN family, GCRN, APNet, APNet2, FreeV,
Vocos, ConvTasNet and HD-Demucs (counterpart of infers/inference_bsrnn.py,
inference_gcrn.py, inference_apnet.py, inference_apnet2.py,
inference_freev.py, inference_vocos.py, inference_convtasnet.py and
inference_hddemucas.py) and, with
--processing_mode, for the joint denoise+vocoder BSRNN_24k (counterpart of
infers/inference_joint_denoise_vocoder_bsrnn.py).

    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/bsrnn_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/gcrn_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/apnet_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/apnet2_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/freeV_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/vocos_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/convtasnet_config.json
    python -m nvse_tpu_torch.infer --cfg_filename nvse_tpu_torch/configs/hddemucas_config.json
    python -m nvse_tpu_torch.infer --processing_mode denoise|vocoder
Decodes the configured test filelist to h.test_output_dir and prints the
RTF (generated-audio-seconds / wall-seconds). Runs on the GPU unless
--device cpu is given. --stream decodes in chunks (config keys
stream_chunk_frames, stream_context_frames; stream_mode "stateful"
carries the recurrent state instead of recomputing a context, for the
BSRNN family; the other models stream by context recompute). Weights come
from h.checkpoint_file_load when that file exists: a g_ bundle of the
port's training, or a reference g_ checkpoint converted by
python -m nvse_tpu_torch.utils.torch_import; else they are random from
h.seed. Weight norm (APNet) is folded at load unless h.fold_weight_norm is
false.
ConvTasNet's config leaves fused_tcn off, as the reference; a copy with
"fused_tcn": 1 runs every TCN block tail through the kernel of
csrc/tcn_tail.cu. --processing_mode (default config
configs/bsrnn_joint_denoise_vocoder_config.json) feeds the joint model the
noisy wave's log spectrum (denoise) or the log pseudo-inverse mel of the
wave (vocoder), file by file (infer/joint.py).
"""
import argparse
import os

from ..utils import load_config
from ..ops.spectral import JOINT_TASKS
from .engine import run_inference
from .joint import run_joint_inference

_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def main() -> None:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.infer")
    p.add_argument("--cfg_filename", default=None,
                   help="a config of configs/ (bsrnn, bsrnn_l, gcrn, apnet, apnet2, freeV, "
                        "vocos, convtasnet, hddemucas) or a copy; default: "
                        "configs/bsrnn_config.json, with --processing_mode "
                        "configs/bsrnn_joint_denoise_vocoder_config.json")
    p.add_argument("--processing_mode", choices=JOINT_TASKS, default=None,
                   help="serve the joint denoise+vocoder model in this mode")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--stream", action="store_true",
                   help="chunked streaming decode, one window shape for any length")
    args = p.parse_args()
    joint = args.processing_mode is not None
    h = load_config(args.cfg_filename or os.path.join(
        _CONFIGS, "bsrnn_joint_denoise_vocoder_config.json" if joint else "bsrnn_config.json"))
    if joint:
        if args.stream:
            p.error("--stream does not apply to --processing_mode")
        run_joint_inference(h, args.processing_mode, limit=args.limit, device=args.device)
    else:
        run_inference(h, limit=args.limit, stream=args.stream, device=args.device)


if __name__ == "__main__":
    main()
