"""Serving export: the decoder as one `torch.export` artifact.

Counterpart of nvse_tpu/infer/export.py. The decode (mel -> wave, the
engine's forward) is traced once with the weights in it and saved as a
`torch.export` program. The hand-written kernels are registered operators
(ops/library.py): each is one node of the graph, which on a CUDA tensor
launches the kernel, its route and launch plan picked on the card that
serves, and on a CPU tensor runs the plain version. A serving host then needs
torch, `nvse_tpu_torch.ops` and its kernel sources under `csrc/` (built at
first use, as for the live engine), and the artifact: no model code, no
config and no checkpoint machinery.

    python -m nvse_tpu_torch.infer.export --cfg_filename <cfg.json> \\
        [--checkpoint_file_load <g_ bundle>] --out model.nvsx \\
        [--batch 1] [--frames 1024 | --frames -1] [--device cuda] [--no_check]

Artifact layout (one zip file):
    meta.json     - format version, model name, sample rate, hop, input bins,
                    batch, frames, compute dtype, the device type and name it
                    was exported on, the torch version, the kernel operators
                    of the graph
    exported.pt2  - torch.export.save of the program

What is exported is InferenceEngine's forward on one replica: the generator
with weight norm folded (unless fold_weight_norm is false), the trunk in
bfloat16 under compute_dtype "bfloat16" with the DSP ends in float32, the
wave out in float32. It is traced under torch.no_grad.

Shape policy (as nvse_tpu/infer/export.py):
  * frames=N     - static time axis (the engine's bucketing: pad on the
                   caller's side); required for the recurrent families;
  * frames=None  - a symbolic time axis (torch.export.Dim): one artifact
                   decodes any length. The conv families (HiFiGAN, iSTFTNet,
                   APNet, APNet2, FreeV, Vocos) take it; the recurrent ones
                   (the BSRNN family, GCRN, HD-Demucs, ConvTasNet) raise
                   ValueError asking for frames=<bucket>.

Device policy: the artifact holds its weights on the device it was exported
on. load_decoder refuses an artifact whose device this host lacks, so a card
artifact never runs on the CPU in its place. The CLI checks the loaded
artifact against the live engine on random mel (max |diff| <= 1e-4).
"""
from __future__ import annotations

import argparse
import io
import json
import os
import zipfile
from collections import Counter

import numpy as np
import torch

from .. import resolve_device
from ..models import model_input_bins
from ..ops import library
from ..utils import AttrDict
from .engine import InferenceEngine

__all__ = ["ServingDecoder", "export_decoder", "graph_ops", "load_decoder"]

_FORMAT_VERSION = 1
# families whose time axis must be static (nvse_tpu/infer/export.py:18-26)
_STATIC_ONLY = ("BSRNN", "BSRNN_24k", "GCRN", "HDDemucas", "ConvTasNet")
# the symbolic time axis's range of mel frames
_MIN_FRAMES, _MAX_FRAMES = 2, 1 << 20
_ROUND_TRIP_TOL = 1e-4


class _Decode(torch.nn.Module):
    """InferenceEngine.forward on one replica: mel (B, M, T) -> float32 wave."""

    def __init__(self, generator: torch.nn.Module, dtype: torch.dtype):
        super().__init__()
        self.generator, self.dtype = generator, dtype

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        out = self.generator(mel.to(self.dtype))
        return (out[-1] if isinstance(out, tuple) else out).float()


def graph_ops(program: torch.export.ExportedProgram) -> dict[str, int]:
    """The kernel operators (namespace nvse_torch) in an exported graph, by
    name, with the nodes of each."""
    prefix = f"{library.NAMESPACE}."
    names = (str(n.target) for n in program.graph.nodes if n.op == "call_function")
    return dict(Counter(s[len(prefix):].split(".")[0] for s in names if s.startswith(prefix)))


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def export_decoder(h, params: dict | None, path: str, batch: int = 1,
                   frames: int | None = None, device: str = "cuda") -> dict:
    """Trace the decoder of config h with `params` (a port state_dict, folded
    or not; None: resolved as InferenceEngine does) on `device` and write the
    artifact to `path`. -> the metadata written into it."""
    if frames is None and h.model_name in _STATIC_ONLY:
        raise ValueError(
            f"{h.model_name}: a symbolic time axis is not exported for the recurrent "
            "families (BSRNN/GCRN/HD-Demucs/ConvTasNet); re-export with frames=<bucket>")
    eng = InferenceEngine(AttrDict({**h, "infer_dp_devices": 1}), params=params,
                          device=device, log_fn=lambda *_: None)
    bins = model_input_bins(h)
    example = torch.full((batch, bins, 64 if frames is None else int(frames)), -4.0,
                         device=eng.device)
    dynamic = None
    if frames is None:
        dynamic = ({2: torch.export.Dim("frames", min=_MIN_FRAMES, max=_MAX_FRAMES)},)
    decode = _Decode(eng.generator, eng.dtype).eval()
    with torch.no_grad():
        # one decode first: the device constants it caches (windows, mel bases, the
        # iSTFT envelope, a front end's seeded initial phase) enter the trace as they are
        decode(example)
        program = torch.export.export(decode, (example,), dynamic_shapes=dynamic)
    meta = {
        "format_version": _FORMAT_VERSION,
        "model_name": str(h.model_name),
        "sampling_rate": int(h.sampling_rate),
        "hop_size": int(h.hop_size),
        "input_bins": int(bins),
        "batch": int(batch),
        "frames": None if frames is None else int(frames),
        "compute_dtype": str(h.get("compute_dtype") or "float32"),
        "device": eng.device.type,
        "device_name": _device_name(eng.device),
        "torch": torch.__version__,
        "ops": graph_ops(program),
    }
    blob = io.BytesIO()
    torch.export.save(program, blob)
    # stored, not deflated: the weights do not compress
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=2))
        z.writestr("exported.pt2", blob.getvalue())
    return meta


class ServingDecoder:
    """A loaded artifact: `wav = dec(mel)` with no model code.

    `mel` (batch, input_bins, frames), any float array or tensor, goes to the
    artifact's device in float32; a static-frames artifact takes exactly its
    export shape (pad to the bucket on the caller's side, as the engine
    does). Returns the float32 wave on that device.
    """

    def __init__(self, path: str):
        with zipfile.ZipFile(path) as z:
            self.meta = json.loads(z.read("meta.json"))
            blob = z.read("exported.pt2")
        if self.meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"artifact format {self.meta.get('format_version')} != "
                             f"supported {_FORMAT_VERSION}")
        device = self.meta.get("device")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{path} was exported on {self.meta.get('device_name')} (cuda) and this host "
                "has no CUDA GPU: export it again with device='cpu' to serve on the CPU")
        self.device = resolve_device(device)
        self.program = torch.export.load(io.BytesIO(blob))
        self._module = self.program.module()

    def __call__(self, mel) -> torch.Tensor:
        mel = torch.as_tensor(np.asarray(mel) if not torch.is_tensor(mel) else mel)
        with torch.inference_mode():
            return self._module(mel.to(self.device, torch.float32))


def load_decoder(path: str) -> ServingDecoder:
    """Load an artifact written by export_decoder (the kernel operators are
    registered by this module's import of nvse_tpu_torch.ops)."""
    return ServingDecoder(path)


def main(argv: list[str] | None = None) -> dict:
    """The export CLI (counterpart of scripts/export_model.py); -> the meta."""
    from ..utils import load_config

    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.infer.export")
    p.add_argument("--cfg_filename", required=True)
    p.add_argument("--checkpoint_file_load", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--frames", type=int, default=1024,
                   help="-1 = a symbolic time axis (the conv families)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--no_check", action="store_true")
    args = p.parse_args(argv)

    h = load_config(args.cfg_filename)
    if args.checkpoint_file_load:
        h["checkpoint_file_load"] = args.checkpoint_file_load
    h["infer_dp_devices"] = 1
    engine = InferenceEngine(h, device=args.device)      # resolves the weights
    frames = None if args.frames < 0 else args.frames
    meta = export_decoder(h, engine.generator.state_dict(), args.out, batch=args.batch,
                          frames=frames, device=args.device)
    print(f"exported {meta['model_name']} -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB, device={meta['device']}, "
          f"batch={meta['batch']}, frames={meta['frames']}, ops={meta['ops']})")
    if not args.no_check:
        dec = load_decoder(args.out)
        T = meta["frames"] or 64
        rng = np.random.default_rng(0)
        mel = rng.standard_normal((meta["batch"], meta["input_bins"], T)).astype(np.float32) - 4.0
        got = dec(mel).cpu()
        want = engine.forward(torch.from_numpy(mel)).cpu()
        err = float((got - want).abs().max())
        print(f"round-trip check: max|artifact - live| = {err:.3e}")
        if not np.isfinite(err) or err > _ROUND_TRIP_TOL:
            raise SystemExit(f"round-trip mismatch: {err}")
    return meta


if __name__ == "__main__":
    main()
