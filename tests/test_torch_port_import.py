"""The port's importer of the reference's `g_*` torch checkpoints
(nvse_tpu_torch/utils/torch_import.py), on the CPU.

For each of the eight families, a reference-layout torch oracle of
tests/test_torch_parity.py (independent of both packages) is randomised and
its state_dict imported:
  * the port's output on the imported weights against the oracle's output:
    spectra and waves at rtol 2e-3 / atol 2e-4, phase as the wrapped
    difference at atol 5e-3;
  * the imported tensors equal, bit for bit, to the JAX importer
    (nvse_tpu/utils/torch_import.py) followed by params_from_jax on the same
    state_dict (the JAX trees' shapes from jax.eval_shape);
  * a missing, a surplus and a misshapen tensor raise, each named;
  * the CLI round trip: an oracle's state_dict saved as a g_ file, converted
    by the main() of `python -m nvse_tpu_torch.utils.torch_import` and decoded
    by `python -m nvse_tpu_torch.infer --device cpu`.
Narrowed: BSRNN at feature_dim 8 with two BSNets (and a causal one), GCRN as
published (it has no width knobs), ConvTasNet and HD-Demucs as in
test_torch_parity.py, APNet at 16 channels, APNet2 and FreeV at their fixed
dim 512 with the eight ConvNeXt blocks the JAX importer maps at width 16,
Vocos at dim 32.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nvse_tpu.utils.torch_import as jax_import
from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.infer import InferenceEngine
from nvse_tpu_torch.models import apnet as papnet
from nvse_tpu_torch.models import build_generator
from nvse_tpu_torch.ops.spectral import inverse_mel
from nvse_tpu_torch.utils import params_from_jax
from nvse_tpu_torch.utils import torch_import as port_import

import test_torch_parity as oracles
from test_torch_port_bsrnn import assert_tf_outputs_close
from test_torch_port_joint import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(num_mels=80, n_fft=1024, hop_size=256, win_size=1024, sampling_rate=22050,
            fmin=0, fmax=8000, segment_size=2048)
APNET = dict(ASP_channel=16, ASP_resblock_kernel_sizes=[3, 5],
             ASP_resblock_dilation_sizes=[[1, 3], [1, 3]], ASP_input_conv_kernel_size=7,
             ASP_output_conv_kernel_size=7, PSP_channel=16, PSP_resblock_kernel_sizes=[3, 5],
             PSP_resblock_dilation_sizes=[[1, 3], [1, 3]], PSP_input_conv_kernel_size=7,
             PSP_output_R_conv_kernel_size=7, PSP_output_I_conv_kernel_size=7)
CONVNEXT = dict(ASP_input_conv_kernel_size=7, ASP_output_conv_kernel_size=7,
                PSP_input_conv_kernel_size=7, PSP_output_R_conv_kernel_size=7,
                PSP_output_I_conv_kernel_size=7, PSP_channel=512)
# the JAX importer maps eight ConvNeXt blocks a branch (torch_import.py:264, 287)
MID = 16

FAMILIES = {
    "BSRNN": dict(model_name="BSRNN", feature_dim=8, num_repeat=2, dropout=0.0, causal=False),
    "BSRNN-causal": dict(model_name="BSRNN", feature_dim=8, num_repeat=1, dropout=0.0,
                         causal=True),
    "GCRN": dict(model_name="GCRN"),
    "ConvTasNet": dict(model_name="ConvTasNet", N=16, L=16, B=8, H=16, P=3, X=2, R=2,
                       norm="gln", num_spks=1, activate="relu", causal=False, skip_con=True,
                       init_phase="zero"),
    "HDDemucas": dict(model_name="HDDemucas", chin=1, chout=1, hidden=8, depth=2,
                      kernel_size=8, stride=4, causal=False, resample=4, growth=2,
                      max_hidden=10000, normalize=False, glu=True, rescale=0.1, floor=1e-3,
                      init_phase="zero"),
    "APNet": dict(model_name="APNet", **APNET),
    "APNet2": dict(model_name="APNet2", ASP_channel=512, **CONVNEXT),
    "FreeV": dict(model_name="FreeV", ASP_channel=513, **CONVNEXT),
    "Vocos": dict(model_name="Vocos", vocos_dim=32, vocos_num_layers=2,
                  vocos_intermediate_dim=48),
}
# families whose generator takes the pseudo-inverse-mel amplitude as a second input
AMP_INPUT = ("GCRN", "ConvTasNet", "HDDemucas", "FreeV")


def _h(family):
    return AttrDict({**BASE, **FAMILIES[family]})


def _oracle(family, h):
    torch.manual_seed(sorted(FAMILIES).index(family))
    name = h.model_name
    if name == "APNet2":
        o = oracles.OracleAPNet2(h, mid=MID)
    elif name == "FreeV":
        o = oracles.OracleFreeV(h, mid=MID)
    else:
        o = getattr(oracles, f"Oracle{name}")(h)
    with torch.no_grad():   # spread the weights (GRN's gamma / beta start at zero)
        for p in o.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return o.eval()


def _port(h, sd):
    """The port's generator on imported weights (APNet2 / FreeV at the
    oracle's ConvNeXt width)."""
    gen = torch.Generator().manual_seed(0)
    if h.model_name in ("APNet2", "FreeV"):
        model = getattr(papnet, h.model_name)(h, gen, intermediate_dim=MID)
    else:
        model = build_generator(h, gen)[0]
    model.load_state_dict(sd)
    return model.eval()


def _import(h, sd):
    tmpl = None
    if h.model_name in ("APNet2", "FreeV"):
        tmpl = getattr(papnet, h.model_name)(h, torch.Generator(), intermediate_dim=MID
                                             ).state_dict()
    return port_import.import_generator(sd, h, tmpl)


def _inputs(h, family):
    rng = np.random.default_rng(sorted(FAMILIES).index(family))
    mel = (rng.standard_normal((2, 80, 9)) - 4.0).astype(np.float32)
    amp = np.exp(0.5 * rng.standard_normal((2, 513, 9)) - 2.0).astype(np.float32)
    return mel, amp


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_reproduces_the_reference_oracle(family):
    h = _h(family)
    o = _oracle(family, h)
    sd = {k: v.detach().numpy() for k, v in o.state_dict().items()}
    model = _port(h, _import(h, sd))
    mel, amp = _inputs(h, family)
    with torch.no_grad():
        if h.model_name == "BSRNN":
            # the oracle takes the log pseudo-inverse-mel spectrum the model makes
            inv = inverse_mel(torch.from_numpy(mel), *(h.n_fft, h.num_mels, h.sampling_rate,
                                                       h.hop_size, h.win_size, h.fmin, h.fmax))
            theirs = o(torch.log(torch.clamp(torch.abs(inv), min=1e-5)))
            ours = model(torch.from_numpy(mel))
        elif h.model_name in AMP_INPUT:
            theirs = (o(torch.from_numpy(mel), torch.from_numpy(amp)) if h.model_name == "FreeV"
                      else o(torch.from_numpy(amp)))
            ours = model(torch.from_numpy(mel), torch.from_numpy(amp))
        else:
            theirs, ours = o(torch.from_numpy(mel)), model(torch.from_numpy(mel))
    if isinstance(ours, tuple):
        assert_tf_outputs_close([a.numpy() for a in ours], [b.numpy() for b in theirs])
    else:
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=2e-3, atol=2e-4)


_JAX_IMPORTERS = {"BSRNN": jax_import.import_bsrnn, "GCRN": jax_import.import_gcrn,
                  "ConvTasNet": jax_import.import_convtasnet,
                  "HDDemucas": jax_import.import_hddemucas, "APNet": jax_import.import_apnet,
                  "APNet2": jax_import.import_apnet2, "FreeV": jax_import.import_freev,
                  "Vocos": jax_import.import_vocos}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_equals_the_jax_importer_then_params_from_jax(family):
    h = _h(family)
    sd = {k: v.detach().numpy() for k, v in _oracle(family, h).state_dict().items()}
    got = _import(h, sd)
    jgen, _ = jax_build(h)
    if h.model_name in ("APNet2", "FreeV"):
        jgen = jgen.clone(intermediate_dim=MID)
    args = [jnp.zeros((1, 80, 8))]
    if h.model_name in AMP_INPUT:
        args.append(jnp.ones((1, 513, 8)))
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), *args)["params"]
    template = jax.tree.map(lambda s: np.full(s.shape, np.nan, np.float32), shapes)
    ref = params_from_jax(_JAX_IMPORTERS[h.model_name](sd, template, h), h)
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k].shape == got[k].shape, k
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("family", ["APNet", "ConvTasNet", "BSRNN"])
def test_import_raises_on_missing_surplus_and_misshapen_tensors(family):
    h = _h(family)
    sd = {k: v.detach().numpy() for k, v in _oracle(family, h).state_dict().items()}
    name = sorted(k for k in sd if k.endswith("weight") or k.endswith("weight_v"))[0]
    with pytest.raises(ValueError, match=f"no checkpoint tensor {name}"):
        _import(h, {k: v for k, v in sd.items() if k != name})
    with pytest.raises(ValueError, match="checkpoint tensor extra.weight unused"):
        _import(h, {**sd, "extra.weight": np.zeros(3, np.float32)})
    bad = {**sd, name: np.zeros(sd[name].shape + (2,), np.float32)}
    with pytest.raises(ValueError, match="imported shape"):
        _import(h, bad)
    if family == "ConvTasNet":   # the reference's built-but-unused PReLU_2 / norm_2
        assert any(".PReLU_2." in k for k in sd) and any(".norm_2." in k for k in sd)


def test_import_reads_parametrized_weight_norm_names():
    """torch.nn.utils.parametrizations.weight_norm stores g / v as
    parametrizations.weight.original0 / original1."""
    h = _h("APNet")
    sd = {k: v.detach().numpy() for k, v in _oracle("APNet", h).state_dict().items()}
    renamed = {k.replace("weight_g", "parametrizations.weight.original0")
                .replace("weight_v", "parametrizations.weight.original1"): v
               for k, v in sd.items()}
    a, b = _import(h, sd), _import(h, renamed)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_cli_round_trip_decodes_through_the_infer_cli(tmp_path, monkeypatch):
    """oracle state_dict -> g_ file -> .pt (the import CLI's main) ->
    InferenceEngine and python -m nvse_tpu_torch.infer. (That the CLI's module
    imports nothing of JAX: test_torch_port_engine.py's import walk and
    test_torch_port_apnet.py's static check.)"""
    h = _h("APNet")
    o = _oracle("APNet", h)
    g_file, pt = tmp_path / "g_00000042", tmp_path / "g_00000042.pt"
    torch.save({"generator": o.state_dict()}, g_file)
    cfg = dict(h, checkpoint_file_load=str(pt), test_output_dir=str(tmp_path / "out"),
               test_input_wavs_dir="DatasetsScp/synth/test_filelist.txt",
               raw_wavfile_path="DatasetsScp/synth/wavs", infer_batch=2)
    cfg_file = tmp_path / "apnet.json"
    cfg_file.write_text(json.dumps(cfg))
    lines = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: lines.append(" ".join(map(str, a))))
    port_import.main(["--cfg_filename", str(cfg_file), "--torch_ckpt", str(g_file),
                      "--out", str(pt)])
    monkeypatch.undo()
    assert lines and lines[-1].startswith("imported APNet")
    assert set(torch.load(pt, weights_only=True)) == {"generator"}

    from nvse_tpu_torch.utils import load_config
    eng = InferenceEngine(load_config(str(cfg_file)), device="cpu", bucket_frames=16)
    mel = (np.random.default_rng(9).standard_normal((1, 80, 16)) - 4.0).astype(np.float32)
    with torch.no_grad():
        theirs = o(torch.from_numpy(mel))[-1].numpy()
    ours = eng.synthesize_mel(torch.from_numpy(mel), out_len=theirs.shape[-1])
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-4)

    import nvse_tpu_torch.infer.__main__ as infer_cli
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", ["nvse_tpu_torch.infer", "--cfg_filename", str(cfg_file),
                                      "--device", "cpu", "--limit", "2"])
    infer_cli.main()
    assert len(os.listdir(tmp_path / "out")) == 2
