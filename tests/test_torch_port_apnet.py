"""Port parity: the conv T-F vocoders APNet, APNet2, FreeV and Vocos against
the JAX package, on the CPU.

Compared on seeded numpy weights in the JAX trees' shapes (jax.eval_shape,
no JAX init), mapped onto the port by params_from_jax:
  * each family's forward against the JAX module (jitted), FreeV also with
    its inv_mel_amp argument: spectra and waves at rtol 2e-3 / atol 2e-4,
    phase as the wrapped difference at atol 5e-3;
  * weight norm folded against unfolded (the port's fold_weight_norm, and the
    JAX fold bridged), and the engine folding at load;
  * GRN's gradient at a channel that is zero at every frame: 0, not NaN, as
    jax.grad of the JAX GRN;
  * one T-F GAN step (MPD with one period + MRD) against make_train_step for
    APNet (weight norm in training: AdamW steps v and g) and FreeV (ConvNeXt,
    GRN and the pseudo-inverse-mel branch): every metric at rtol 1e-3, the
    AdamW first moments per tensor at a relative L2 of 2e-3;
  * the registry and configs (the published widths built, parameter counts
    equal to the JAX trees'), serving per file, in batches and streamed by
    context recompute, and the jax-free imports of the new modules.
Narrowed: APNet at 16 channels with two resblocks of two dilations, APNet2
and FreeV at their fixed dim 512 with one ConvNeXt block of width 32, Vocos
at dim 32 with two blocks; 12 frames, one 2048-sample segment.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import apnet as japnet
from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.models.layers import fold_weight_norm as jax_fold
from nvse_tpu.models.vocos import Vocos as JVocos
from nvse_tpu.train.trainer import DiscState, GenState
from nvse_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvse_tpu.train.trainer import make_train_step
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.infer import InferenceEngine, run_inference
from nvse_tpu_torch.models import apnet as papnet
from nvse_tpu_torch.models import build_generator
from nvse_tpu_torch.models.layers import WNConv1d, fold_weight_norm
from nvse_tpu_torch.models.vocos import Vocos
from nvse_tpu_torch.train import GANTrainer
from nvse_tpu_torch.train.trainer import make_optimizer
from nvse_tpu_torch.utils import disc_params_from_jax, load_config, params_from_jax

from test_torch_port_bsrnn import assert_tf_outputs_close, jax_params
from test_torch_port_disc import disc_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401
from test_torch_port_train import KEYS, LR, _adam_mu, _np, _port_moments, assert_moments_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("apnet_config.json", "apnet2_config.json", "freeV_config.json", "vocos_config.json")
# the fixed widths of APNet2 / FreeV narrowed to one ConvNeXt block of width 32
SMALL_CONVNEXT = dict(num_layers=1, intermediate_dim=32)


def _h(model_name, **kw):
    base = dict(model_name=model_name, num_mels=80, n_fft=1024, hop_size=256, win_size=1024,
                sampling_rate=22050, fmin=0, fmax=8000, meloss=None, segment_size=2048,
                batch_size=1, learning_rate=LR, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999,
                mrd_weight=0.1, mpd_reshapes=[2], seed=1234)
    if model_name == "APNet":
        for b in ("ASP", "PSP"):
            base.update({f"{b}_channel": 16, f"{b}_resblock_kernel_sizes": [3, 5],
                         f"{b}_resblock_dilation_sizes": [[1, 3], [1, 3]],
                         f"{b}_input_conv_kernel_size": 7})
        base.update(ASP_output_conv_kernel_size=7, PSP_output_R_conv_kernel_size=7,
                    PSP_output_I_conv_kernel_size=7)
    elif model_name in ("APNet2", "FreeV"):
        base.update(ASP_channel=512 if model_name == "APNet2" else 513, PSP_channel=512,
                    ASP_input_conv_kernel_size=7, ASP_output_conv_kernel_size=7,
                    PSP_input_conv_kernel_size=7, PSP_output_R_conv_kernel_size=7,
                    PSP_output_I_conv_kernel_size=7)
    else:
        base.update(vocos_dim=32, vocos_num_layers=2, vocos_intermediate_dim=48)
    base.update(kw)
    return AttrDict(base)


def small_models(name: str, seed: int = 0):
    """(JAX module, port module, h) of a narrowed family member."""
    h = _h(name)
    if name in ("APNet2", "FreeV"):
        jm = getattr(japnet, name).from_config(h).clone(**SMALL_CONVNEXT)
        pm = getattr(papnet, name)(h, torch.Generator().manual_seed(seed), **SMALL_CONVNEXT)
    elif name == "APNet":
        jm, pm = japnet.APNet.from_config(h), papnet.APNet(h, torch.Generator().manual_seed(seed))
    else:
        jm, pm = JVocos.from_config(h), Vocos(h, torch.Generator().manual_seed(seed))
    return jm, pm, h


def _mel(b=2, t=12, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, 80, t)) - 4.0).astype(np.float32)


def _inv_amp(b=2, t=12, seed=1):
    return np.exp(0.5 * np.random.default_rng(seed).standard_normal((b, 513, t)) - 2.0
                  ).astype(np.float32)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["APNet", "APNet2", "FreeV", "FreeV+inv_mel_amp", "Vocos"])
def test_forward_matches_jax(name):
    family, aux = name.split("+")[0], "+" in name
    jm, pm, h = small_models(family)
    mel = _mel()
    gp = jax_params(jm, mel, seed=1)
    pm.load_state_dict(params_from_jax(gp, h))
    args = (mel, _inv_amp()) if aux else (mel,)
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(gp, *map(jnp.asarray, args))
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, args))
    assert got[-1].shape == (2, 11 * 256)
    assert_tf_outputs_close([g.numpy() for g in got], ref)


def test_folded_weight_norm_matches_unfolded_and_the_jax_fold():
    jm, pm, h = small_models("APNet")
    mel = _mel(b=1)
    gp = jax_params(jm, mel, seed=2)
    sd = params_from_jax(gp, h)
    pm.load_state_dict(sd)
    folded = fold_weight_norm(sd)
    assert not any(k.endswith((".v", ".g")) for k in folded)
    assert sum(k.endswith(".kernel") for k in folded) == sum(k.endswith(".v") for k in sd)
    # the JAX fold (nvse_tpu/models/layers.py:78-124), bridged: the same kernels
    jf = params_from_jax(jax.tree.map(np.asarray, jax_fold(gp)), h)
    assert jf.keys() == folded.keys()
    for k in folded:
        np.testing.assert_allclose(folded[k].numpy(), jf[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    _, fm, _ = small_models("APNet", seed=5)
    fm.load_state_dict(folded)
    assert all(m.folded for m in fm.modules() if isinstance(m, WNConv1d))
    with torch.no_grad():
        a, b = pm(torch.from_numpy(mel)), fm(torch.from_numpy(mel))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=1e-5)
    # an unfolded state_dict turns the layers back
    fm.load_state_dict(sd)
    assert not any(m.folded for m in fm.modules() if isinstance(m, WNConv1d))


def test_engine_folds_weight_norm_at_load_unless_told_not_to():
    _, pm, h = small_models("APNet")
    sd = pm.state_dict()
    mel = torch.from_numpy(_mel(b=1, t=16))
    outs = {}
    for fold in (True, False):
        h.update(fold_weight_norm=fold, model_name="APNet")
        eng = InferenceEngine(h, params=sd, device="cpu", bucket_frames=16)
        wn = [m for m in eng.generator.modules() if isinstance(m, WNConv1d)]
        assert wn and all(m.folded == fold for m in wn)
        outs[fold] = eng.synthesize_mel(mel)
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-5, atol=1e-6)


def test_grn_gradient_at_a_dead_channel_is_zero_not_nan():
    """A channel zero at every frame: sum(x^2) = 0, where d sqrt / dx is 0/0.
    The port takes torch.norm's subgradient 0, as the JAX GRN's double where."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    x[:, :, 2] = 0.0
    gamma = rng.standard_normal((1, 1, 8)).astype(np.float32)
    beta = rng.standard_normal((1, 1, 8)).astype(np.float32)
    w = rng.standard_normal((2, 6, 8)).astype(np.float32)

    grn = papnet.GRN(8)
    grn.load_state_dict({"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)})
    xt = torch.from_numpy(x).requires_grad_(True)
    (grn(xt) * torch.from_numpy(w)).sum().backward()
    got = xt.grad.numpy()

    jg = japnet.GRN(8)
    ref = jax.jit(jax.grad(
        lambda v: jnp.sum(jg.apply({"params": {"gamma": gamma, "beta": beta}}, v) * w)))(
        jnp.asarray(x))
    assert np.isfinite(got).all() and np.isfinite(grn.gamma.grad.numpy()).all()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    # at the dead channel only the residual path and beta's broadcast remain
    np.testing.assert_allclose(got[:, :, 2], w[:, :, 2], rtol=1e-6)


# ---------------------------------------------------------------------------
# one T-F GAN step against the JAX step
# ---------------------------------------------------------------------------

def _audio(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)[None] + 0.05 * rng.standard_normal((1, n))
            ).astype(np.float32)


@pytest.fixture(scope="module", params=["APNet", "FreeV"])
def one_step(request):
    jm, pm, h = small_models(request.param)
    audio = _audio()
    gp = jax_params(jm, np.zeros((1, 80, 9), np.float32), seed=4)
    dp = disc_params(segment=h.segment_size, periods=h.mpd_reshapes)
    spe = 10
    gen_state = GenState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, spe))
    disc_state = DiscState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, dp),
                                  tx=jax_make_optimizer(h, spe), spectral=None)
    fns = make_train_step(h, jm, "tf")
    gen_state, disc_state, jm_metrics = fns.train_step(gen_state, disc_state,
                                                       jnp.asarray(audio), None)

    tr = GANTrainer(h, device="cpu", steps_per_epoch=spe)
    pm.load_state_dict(params_from_jax(gp, h))
    tr.generator, tr.opt_g = pm, make_optimizer(pm, h, spe)
    mpd_sd, mrd_sd = disc_params_from_jax(dp)
    tr.disc["mpd"].load_state_dict(mpd_sd)
    tr.disc["mrd"].load_state_dict(mrd_sd)
    g0 = {k: v.clone() for k, v in pm.state_dict().items()}
    pmetrics = tr.step(torch.from_numpy(audio))
    d_mu = disc_params_from_jax(_np(_adam_mu(disc_state.opt_state)))
    return dict(
        name=request.param, h=h, g0=g0, generator=pm,
        jax={k: float(jm_metrics[k]) for k in KEYS}, port={k: float(pmetrics[k]) for k in KEYS},
        g_mu_jax=params_from_jax(_np(_adam_mu(gen_state.opt_state)), h),
        g_mu_port=_port_moments(tr.opt_g, pm),
        d_mu_jax={**{f"mpd.{k}": v for k, v in d_mu[0].items()},
                  **{f"mrd.{k}": v for k, v in d_mu[1].items()}},
        d_mu_port=_port_moments(tr.opt_d, tr.disc))


def test_tf_step_metrics_match_jax(one_step):
    for k in KEYS:
        assert np.isfinite(one_step["port"][k]), k
        np.testing.assert_allclose(one_step["port"][k], one_step["jax"][k], rtol=1e-3, err_msg=k)


def test_tf_step_moments_match_jax(one_step):
    r = one_step
    assert_moments_close(r["g_mu_port"], r["g_mu_jax"], rel=2e-3)
    assert_moments_close(r["d_mu_port"], r["d_mu_jax"], rel=2e-3)
    # the trained leaves: APNet's v and g (weight norm is not folded in
    # training), FreeV's GRN gamma / beta; every one moved
    want = (".v", ".g") if r["name"] == "APNet" else (".gamma", ".beta")
    names = [k for k in r["g_mu_port"] if k.endswith(want)]
    assert names
    for k in names:
        assert torch.isfinite(r["g_mu_port"][k]).all() and r["g_mu_port"][k].abs().sum() > 0, k
    new = r["generator"].state_dict()
    assert all(not torch.equal(new[k], r["g0"][k]) for k in names)


def test_bf16_step_is_finite_and_freev_takes_aux_input():
    """compute_dtype bfloat16 on the CPU (convs in float32 of the bf16 values),
    and FreeV's inv_mel_amp through the step's aux_input."""
    _, pm, h = small_models("FreeV")
    h.update(compute_dtype="bfloat16")
    tr = GANTrainer(h, device="cpu")
    tr.generator, tr.opt_g = pm, make_optimizer(pm, h, 1)
    audio = torch.from_numpy(_audio())
    seen = []
    pm.register_forward_hook(lambda m, args, out: seen.append(len(args)))
    m1 = tr.step(audio)
    m2 = tr.step(audio, torch.from_numpy(_inv_amp(b=1, t=9)))
    assert seen == [1, 2]
    assert all(np.isfinite(float(m[k])) for m in (m1, m2) for k in KEYS)


# ---------------------------------------------------------------------------
# registry, configs, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", CONFIGS)
def test_published_config_builds_with_the_jax_parameter_count(cfg):
    with open(os.path.join(REPO, "nvse_tpu_torch", "configs", cfg)) as f:
        ours = json.load(f)
    with open(os.path.join(REPO, "nvse_tpu", "configs", cfg)) as f:
        assert ours == json.load(f)
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", cfg))
    gen, domain = build_generator(h)
    jgen, jdomain = jax_build(h)
    assert domain == jdomain == "tf"
    args = [jnp.zeros((1, 80, 8))] + ([jnp.ones((1, 513, 8))] if h.model_name == "FreeV" else [])
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), *args)["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in gen.parameters()) == n_jax


@pytest.mark.parametrize("mode", ["batch", "file", "stream"])
def test_run_inference_on_the_synth_set(tmp_path, monkeypatch, mode):
    monkeypatch.chdir(REPO)
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "vocos_config.json"))
    h.update(vocos_dim=32, vocos_num_layers=1, vocos_intermediate_dim=48,
             test_output_dir=str(tmp_path / mode), stream_chunk_frames=16,
             stream_context_frames=4, infer_batch=1 if mode == "file" else 2)
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


NEW_MODULES = ["models/apnet.py", "models/hifigan.py", "models/vocos.py", "models/layers.py",
               "models/__init__.py", "utils/torch_import.py", "utils/jax_params.py",
               "infer/engine.py", "infer/__main__.py", "train/trainer.py",
               "models/istftnet.py", "models/discriminators.py", "ops/spectral.py",
               "train/checkpoint.py", "train/loop.py", "train/__main__.py"]
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|flax|nvse_tpu)(\.|\s|$)", re.M)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_port_modules_import_nothing_of_jax(module):
    with open(os.path.join(REPO, "nvse_tpu_torch", module)) as f:
        assert not _IMPORT.search(f.read()), module
