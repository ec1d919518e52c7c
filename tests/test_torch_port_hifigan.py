"""Port parity: the MRF family (HiFiGAN, iSTFTNet) against the JAX package, on
the CPU.

Compared on seeded numpy weights in the JAX trees' shapes (jax.eval_shape, no
JAX init; every weight-norm g drawn apart from ||v||), mapped onto the port by
params_from_jax:
  * HiFiGAN and iSTFTNet forwards, ResBlock1 and ResBlock2, against the JAX
    modules (jitted): waves at rtol 2e-3 / atol 2e-4;
  * WNConvTranspose1d against the JAX ConvTranspose1d with weight norm, with
    g != ||v||: the norm is over every axis but the input channel, and the
    other choice (the output channel) is refused by the same limit; folded
    against unfolded, and the JAX fold bridged;
  * the importer of reference g_ checkpoints (import_mrf_generator) on the
    torch oracles tests/test_torch_import.py:TorchMRFGen and
    tests/test_torch_parity.py:OracleISTFTNet, the outputs at the same limits,
    the tensors equal bit for bit to the JAX importer + params_from_jax, and
    missing / surplus / misshapen tensors raising;
  * the published configs (hifigan_v1_config.json, istftnet_config.json) copied
    from the JAX package and built with its parameter counts;
  * serving on DatasetsScp/synth: per file, in batches and streamed by context
    recompute, the engine folding the transposed convs at load.
Narrowed: upsample_initial_channel 32, two resblock kernels of two dilations,
rates (4, 4) or (8, 8, 2, 2); 12 frames.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nvse_tpu.utils.torch_import as jax_import
from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.models.layers import ConvTranspose1d as JConvTranspose1d
from nvse_tpu.models.layers import fold_weight_norm as jax_fold
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.infer import InferenceEngine, run_inference
from nvse_tpu_torch.models import build_generator
from nvse_tpu_torch.models.layers import WNConv1d, WNConvTranspose1d, fold_weight_norm
from nvse_tpu_torch.utils import load_config, params_from_jax
from nvse_tpu_torch.utils import torch_import as port_import

import test_torch_parity as oracles
from test_torch_import import TorchMRFGen
from test_torch_port_bsrnn import jax_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-3, 2e-4
# (model, resblock, upsample rates, their kernels): HiFiGAN's two block kinds at two
# pyramids, iSTFTNet's (8, 8) trunk
CASES = {"HiFiGAN-1": ("HiFiGAN", "1", (4, 4), (8, 8)),
         "HiFiGAN-2": ("HiFiGAN", "2", (8, 8, 2, 2), (16, 16, 4, 4)),
         "iSTFTNet-1": ("iSTFTNet", "1", (8, 8), (16, 16)),
         "iSTFTNet-2": ("iSTFTNet", "2", (8, 8), (16, 16))}


def small_h(case: str, **kw) -> AttrDict:
    name, rb, rates, kernels = CASES[case]
    h = dict(model_name=name, resblock=rb, upsample_rates=list(rates),
             upsample_kernel_sizes=list(kernels), upsample_initial_channel=32,
             resblock_kernel_sizes=[3, 5],
             resblock_dilation_sizes=[[1, 3], [1, 3]] if rb == "1" else [[1, 2], [2, 6]],
             gen_istft_n_fft=16, gen_istft_hop_size=4, num_mels=80, n_fft=1024, hop_size=256,
             win_size=1024, sampling_rate=22050, fmin=0, fmax=8000, segment_size=2048,
             seed=1234)
    h.update(kw)
    return AttrDict(h)


def _mel(b=2, t=12, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, 80, t)) - 4.0).astype(np.float32)


def _pair(case, seed=1):
    """(JAX module, port module with the same weights, JAX params, h)."""
    h = small_h(case)
    jm, _ = jax_build(h)
    pm, domain = build_generator(h)
    assert domain == "time"
    gp = jax_params(jm, _mel(), seed=seed)
    pm.load_state_dict(params_from_jax(gp, h))
    return jm, pm, gp, h


# ---------------------------------------------------------------------------
# forwards and layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jm, pm, gp, h = _pair(case)
    mel = _mel()
    ref = np.asarray(jax.jit(lambda p, m: jm.apply({"params": p}, m))(gp, jnp.asarray(mel)))
    with torch.no_grad():
        got = pm(torch.from_numpy(mel)).numpy()
    hop = int(np.prod(h.upsample_rates)) * (h.gen_istft_hop_size
                                            if h.model_name == "iSTFTNet" else 1)
    assert got.shape == ref.shape == (2, 12 * hop)
    assert np.isfinite(got).all() and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _wn_transpose_pair(seed=3):
    """A JAX weight-norm ConvTranspose1d and its port, with g != ||v||:
    (JAX module, params, port module, x (B, T, C))."""
    cin, cout, k, s = 6, 4, 8, 4
    jm = JConvTranspose1d(cin, cout, k, stride=s, padding=(k - s) // 2, use_weight_norm=True)
    rng = np.random.default_rng(seed)
    p = {"v": rng.uniform(-0.3, 0.3, (k, cin, cout)).astype(np.float32),
         "g": rng.uniform(0.5, 2.0, (1, cin, 1)).astype(np.float32),
         "bias": rng.uniform(-0.3, 0.3, (cout,)).astype(np.float32)}
    pm = WNConvTranspose1d(cin, cout, k, stride=s, padding=(k - s) // 2)
    pm.load_state_dict({"v": torch.from_numpy(p["v"].transpose(1, 2, 0).copy()),
                        "g": torch.from_numpy(p["g"].reshape(cin, 1, 1).copy()),
                        "bias": torch.from_numpy(p["bias"])})
    x = rng.standard_normal((2, 7, cin)).astype(np.float32)
    return jm, p, pm, x


def test_wn_conv_transpose1d_normalises_over_the_input_channel_as_jax():
    jm, p, pm, x = _wn_transpose_pair()
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 28, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # the control: the norm over every axis but the output channel, with the same g
    # broadcast per input channel, is another layer, which the limit refuses
    v, g = pm.v.detach(), pm.g.detach()
    w_out = g * v / v.transpose(0, 1).flatten(1).norm(dim=1).reshape(1, -1, 1)
    with torch.no_grad():
        other = torch.nn.functional.conv_transpose1d(
            torch.from_numpy(x).transpose(1, 2), w_out, pm.bias, 4, 2).transpose(1, 2).numpy()
    assert not np.allclose(other, ref, rtol=RTOL, atol=ATOL)


def test_wn_conv_transpose1d_folded_matches_unfolded_and_the_jax_fold():
    jm, p, pm, x = _wn_transpose_pair(seed=4)
    folded = fold_weight_norm({f"up.{k}": v for k, v in pm.state_dict().items()})
    assert set(folded) == {"up.kernel", "up.bias"}
    jf = jax_fold({"up": p})["up"]
    np.testing.assert_allclose(folded["up.kernel"].numpy(),
                               np.asarray(jf["kernel"]).transpose(1, 2, 0), rtol=1e-6,
                               atol=1e-7)
    fm = WNConvTranspose1d(6, 4, 8, stride=4, padding=2)
    fm.load_state_dict({"kernel": folded["up.kernel"], "bias": folded["up.bias"]})
    assert fm.folded and not pm.folded
    with torch.no_grad():
        a, b = pm(torch.from_numpy(x)), fm(torch.from_numpy(x))
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["HiFiGAN-2", "iSTFTNet-1"])
def test_engine_folds_every_weight_norm_conv_at_load(case):
    _, pm, _, h = _pair(case)
    mel = torch.from_numpy(_mel(b=1, t=16))
    outs = {}
    for fold in (True, False):
        h.update(fold_weight_norm=fold)
        eng = InferenceEngine(h, params=pm.state_dict(), device="cpu", bucket_frames=16)
        wn = [m for m in eng.generator.modules() if isinstance(m, WNConv1d)]
        ups = [m for m in wn if isinstance(m, WNConvTranspose1d)]
        assert len(ups) == len(h.upsample_rates) and all(m.folded == fold for m in wn)
        outs[fold] = eng.synthesize_mel(mel)
    assert outs[True].shape == (1, 16 * 256)
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the importer of reference g_ checkpoints
# ---------------------------------------------------------------------------

# the oracles' topology: HiFiGAN at rates (8, 2), iSTFTNet at its (8, 2) with hop 4
ORACLE_H = dict(resblock="1", upsample_rates=[8, 2], upsample_kernel_sizes=[16, 4],
                upsample_initial_channel=32, resblock_kernel_sizes=[3, 5],
                resblock_dilation_sizes=[[1, 3], [1, 3]], gen_istft_n_fft=16,
                gen_istft_hop_size=4, num_mels=80, sampling_rate=22050, n_fft=1024,
                hop_size=256, win_size=1024, fmin=0, fmax=8000, segment_size=2048)


def _oracle(name):
    h = AttrDict(dict(ORACLE_H, model_name=name))
    torch.manual_seed(7 if name == "HiFiGAN" else 8)
    o = TorchMRFGen(h) if name == "HiFiGAN" else oracles.OracleISTFTNet(h)
    with torch.no_grad():   # g apart from ||v||
        for n, p in o.named_parameters():
            if n.endswith("weight_g"):
                p.mul_(torch.empty_like(p).uniform_(0.5, 1.5))
    return o.eval(), h


@pytest.mark.parametrize("name", ["HiFiGAN", "iSTFTNet"])
def test_import_mrf_generator_reproduces_the_oracle(name):
    o, h = _oracle(name)
    sd = {k: v.detach().numpy() for k, v in o.state_dict().items()}
    model = build_generator(h)[0]
    model.load_state_dict(port_import.import_generator(sd, h))
    mel = torch.from_numpy(_mel(t=17, seed=2))
    with torch.no_grad():
        ours, theirs = model.eval()(mel), o(mel)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["HiFiGAN", "iSTFTNet"])
def test_import_mrf_generator_equals_the_jax_importer_then_params_from_jax(name):
    o, h = _oracle(name)
    sd = {k: v.detach().numpy() for k, v in o.state_dict().items()}
    got = port_import.import_mrf_generator(sd, h)
    jgen, _ = jax_build(h)
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.zeros((1, 80, 8)))["params"]
    template = jax.tree.map(lambda s: np.full(s.shape, np.nan, np.float32), shapes)
    ref = params_from_jax(jax_import.import_mrf_generator(sd, template, h), h)
    assert ref.keys() == got.keys()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)


def test_import_mrf_generator_raises_on_missing_surplus_and_misshapen_tensors():
    o, h = _oracle("HiFiGAN")
    sd = {k: v.detach().numpy() for k, v in o.state_dict().items()}
    name = "ups.1.weight_v"
    with pytest.raises(ValueError, match=f"no checkpoint tensor {name}"):
        port_import.import_mrf_generator({k: v for k, v in sd.items() if k != name}, h)
    with pytest.raises(ValueError, match="checkpoint tensor extra.weight unused"):
        port_import.import_mrf_generator({**sd, "extra.weight": np.zeros(3, np.float32)}, h)
    with pytest.raises(ValueError, match="imported shape"):
        port_import.import_mrf_generator({**sd, name: sd[name][:, :, :-1]}, h)


# ---------------------------------------------------------------------------
# registry, configs, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", ["hifigan_v1_config.json", "istftnet_config.json"])
def test_published_config_builds_with_the_jax_parameter_count(cfg):
    with open(os.path.join(REPO, "nvse_tpu_torch", "configs", cfg)) as f:
        ours = json.load(f)
    with open(os.path.join(REPO, "nvse_tpu", "configs", cfg)) as f:
        assert ours == json.load(f)
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", cfg))
    gen, domain = build_generator(h)
    jgen, jdomain = jax_build(h)
    assert domain == jdomain == "time"
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.zeros((1, 80, 8)))["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in gen.parameters()) == n_jax
    ups = [m for m in gen.modules() if isinstance(m, WNConvTranspose1d)]
    assert len(ups) == len(h.upsample_rates)


@pytest.mark.parametrize("mode", ["batch", "file", "stream"])
def test_run_inference_on_the_synth_set(tmp_path, monkeypatch, mode):
    monkeypatch.chdir(REPO)
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "hifigan_v1_config.json"))
    h.update(upsample_initial_channel=32, resblock_kernel_sizes=[3, 5],
             resblock_dilation_sizes=[[1, 3], [1, 3]], test_output_dir=str(tmp_path / mode),
             stream_chunk_frames=16, stream_context_frames=4,
             infer_batch=1 if mode == "file" else 2)
    assert not os.path.exists(h.checkpoint_file_load)
    lines = []
    stats = run_inference(h, limit=2, log_fn=lines.append, stream=mode == "stream",
                          device="cpu")
    assert stats["files"] == 2 and stats["rtf"] > 0
    assert lines[-1].startswith("decoded 2 files")
    from nvse_tpu_torch.data import read_wav

    for name in sorted(os.listdir(tmp_path / mode)):
        y, sr = read_wav(str(tmp_path / mode / name))
        src, _ = read_wav(os.path.join(REPO, "DatasetsScp", "synth", "wavs", name))
        assert sr == 22050 and len(y) == len(src) and np.isfinite(y).all()
        assert np.abs(y).max() > 0
