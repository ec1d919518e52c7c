"""Port parity: ConvTasNet (nvse_tpu_torch/models/convtasnet.py) and its 1-D
conv layers against the JAX package, on the CPU.

Both packages get the same seeded numpy weights (in the JAX tree's shapes,
mapped by params_from_jax) and the same numpy mel. ConvTasNet is narrowed
(N = 64, B = 128, H = 128, X = 3, R = 1: three TCN blocks at dilations 1,
2, 4) and runs 16 mel frames. The "rand" and "griffin_lim" initial phases
get the JAX package's jax.random.PRNGKey(0) draw passed in as theta: the
port's own default draw comes from a torch generator and differs.
Tolerances: the conv layers at 1e-5 (the same sums in another order); the
whole model at rtol 2e-3 / atol 2e-4, as the other models' parity tests
(with Griffin-Lim in front, 32 iterations of the classic loop against the
JAX frame-domain loop: tests/test_torch_port_tcn.py bounds that drift).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import convtasnet as jax_ctn
from nvse_tpu.models import layers as jax_layers
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.data import read_wav
from nvse_tpu_torch.infer import InferenceEngine, run_inference
from nvse_tpu_torch.models import build_generator, convtasnet
from nvse_tpu_torch.models.layers import Conv1d, ConvTranspose1d
from nvse_tpu_torch.ops import random_phase
from nvse_tpu_torch.utils import load_config, params_from_jax
from nvse_tpu_torch.utils.jax_params import _conv1d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
B, FRAMES = 2, 16


def _h(**kw):
    d = dict(model_name="ConvTasNet", sampling_rate=22050, n_fft=1024, hop_size=256,
             win_size=1024, num_mels=80, fmin=0, fmax=8000, N=64, L=16, B=128, H=128, P=3,
             X=3, R=1, num_spks=1, skip_con=True, init_phase="griffin_lim", causal=False,
             norm="gln", seed=1234)
    d.update(kw)
    return AttrDict(d)


def _seeded(module, *xs, seed=0):
    """Seeded numpy values in the shapes of a flax module's parameter tree
    (eval_shape: no JAX init), kernels at U(+-1/sqrt(fan-in))."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *xs)["params"]

    def leaf(s):
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 0.3
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree.map(leaf, shapes)


def _mel(T=FRAMES, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, 80, T)) - 4.0).astype(np.float32)


def _jax_theta(shape):
    return np.array(jax.random.uniform(jax.random.PRNGKey(0), shape, minval=-jnp.pi,
                                       maxval=jnp.pi))


def _pair(h, seed=3):
    """(JAX module, its numpy params, the port generator with the same weights)."""
    jm = jax_ctn.ConvTasNet.from_config(h)
    jp = _seeded(jm, jnp.asarray(_mel()[:1, :, :8]), seed=seed)
    gen, domain = build_generator(h)
    assert domain == "time"
    gen.load_state_dict(params_from_jax(jp, h))
    return jm, jp, gen


# ---------------------------------------------------------------------------
# the 1-D conv layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,k,stride,padding,dilation,groups", [
    (1, 8, 16, 8, 0, 1, 1),      # the encoder
    (6, 10, 1, 1, 0, 1, 1),      # a 1x1 (a matrix product)
    (8, 8, 3, 1, 4, 4, 8),       # a dilated depthwise conv
    (6, 4, 3, 2, 1, 1, 2)])
def test_conv1d_matches_jax(cin, cout, k, stride, padding, dilation, groups):
    x = np.random.default_rng(1).standard_normal((2, 40, cin)).astype(np.float32)
    jmod = jax_layers.Conv1d(cin, cout, k, stride=stride, padding=padding, dilation=dilation,
                             groups=groups)
    jp = _seeded(jmod, jnp.asarray(x), seed=2)
    ref = np.asarray(jmod.apply({"params": jp}, jnp.asarray(x)))
    ours = Conv1d(cin, cout, k, stride, padding, dilation, groups)
    sd = {}
    _conv1d(jp, "m", sd)
    ours.load_state_dict({k.split(".")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("cin,cout,k,stride", [(8, 1, 16, 8), (4, 3, 5, 2), (3, 2, 3, 1)])
def test_conv_transpose1d_matches_jax(cin, cout, k, stride):
    x = np.random.default_rng(3).standard_normal((2, 17, cin)).astype(np.float32)
    jmod = jax_layers.ConvTranspose1d(cin, cout, k, stride=stride)
    jp = _seeded(jmod, jnp.asarray(x), seed=4)
    ref = np.asarray(jmod.apply({"params": jp}, jnp.asarray(x)))
    ours = ConvTranspose1d(cin, cout, k, stride)
    sd = {}
    _conv1d(jp, "m", sd, transposed=True)
    ours.load_state_dict({k.split(".")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, (17 - 1) * stride + k, cout)
    np.testing.assert_allclose(got, ref, **TOL)


def test_conv_init_bounds_follow_torch_fan_in():
    gen = torch.Generator().manual_seed(0)
    dw = Conv1d(32, 32, 3, groups=32, gen=gen)
    ct = ConvTranspose1d(8, 2, 16, stride=8, gen=gen)
    assert dw.kernel.shape == (32, 1, 3) and dw.kernel.abs().max() <= 1 / np.sqrt(3)
    assert ct.kernel.shape == (8, 2, 16) and ct.kernel.abs().max() <= 1 / np.sqrt(32)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

MODEL_CASES = [
    dict(init_phase="zero", fused_tcn=False),
    dict(init_phase="zero", fused_tcn=True),
    dict(init_phase="griffin_lim", fused_tcn=False),
    dict(init_phase="griffin_lim", fused_tcn=True),
    dict(init_phase="rand", fused_tcn=True),
    dict(init_phase="zero", causal=True, fused_tcn=True),     # causal: the unfused path
    dict(init_phase="zero", norm="cln", fused_tcn=True),      # cLN: the unfused path
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_convtasnet_matches_jax(case):
    h = _h(**case)
    jm, jp, gen = _pair(h)
    mel = _mel()
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(mel)))
    theta = torch.from_numpy(_jax_theta((B, 513, FRAMES)))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel), theta=theta).numpy()
    assert got.shape == ref.shape == (B, 256 * (FRAMES - 1))
    fused = [blk.fused for blk in gen.blocks]
    assert fused == [case["fused_tcn"] and not case.get("causal")
                     and case.get("norm", "gln") == "gln"] * 3
    np.testing.assert_allclose(got, ref, **MODEL_TOL)


def test_fused_blocks_run_the_tail_op(monkeypatch):
    calls = []
    orig = convtasnet.tcn_block_tail
    monkeypatch.setattr(convtasnet, "tcn_block_tail",
                        lambda *a, **k: calls.append(a[-1]) or orig(*a, **k))
    gen, _ = build_generator(_h(fused_tcn=True, X=4, R=2))
    with torch.no_grad():
        gen(torch.from_numpy(_mel()))
    assert calls == [1, 2, 4, 8] * 2


def test_fused_and_unfused_gradients_agree():
    """The fused tail under autograd (its recompute backward) gives the
    unfused module path's gradients, on the same weights and phase."""
    grads = {}
    for fused in (False, True):
        gen, _ = build_generator(_h(fused_tcn=fused))
        out = gen(torch.from_numpy(_mel()))
        out.square().sum().backward()
        # the last block's residual output feeds nothing (the skips do): no
        # gradient on the unfused path, zeros through the fused op
        grads[fused] = {n: torch.zeros_like(p) if p.grad is None else p.grad
                        for n, p in gen.named_parameters()}
    assert set(grads[True]) == set(grads[False])
    for name, g in grads[False].items():
        assert torch.isfinite(grads[True][name]).all(), name
        scale = g.abs().max().item()
        assert (grads[True][name] - g).abs().max().item() <= 1e-4 * max(scale, 1e-6), name


def test_default_phase_is_the_seed_0_draw_and_survives_inference_mode():
    gen, _ = build_generator(_h(fused_tcn=True))
    mel = torch.from_numpy(_mel())
    with torch.inference_mode():
        first = gen(mel)          # caches the phase under inference mode
    theta = random_phase((B, 513, FRAMES), torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(gen(mel, theta=theta), first, rtol=0, atol=0)
    # the cached phase feeds a differentiable forward afterwards
    gen(mel).sum().backward()
    assert torch.isfinite(gen.blocks[0].norm.weight.grad).all()
    assert gen.blocks[0].norm.weight.grad.abs().sum() > 0


def test_bfloat16_trunk_keeps_the_dsp_front_in_float32():
    """A bfloat16 mel into bfloat16 params: Griffin-Lim's wave reaches the
    encoder in float32 (cast there to the params' type), the output is
    bfloat16 and within 0.1 relative L2 of the float32 decode (measured
    0.053: 8-bit mantissas through three blocks and the decoder)."""
    gen, _ = build_generator(_h(fused_tcn=True))
    mel = torch.from_numpy(_mel())
    seen = []
    gen.encoder.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    with torch.no_grad():
        ref = gen(mel)
        gen.to(torch.bfloat16)
        got = gen(mel.to(torch.bfloat16))
    assert seen == [torch.float32, torch.float32]
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    rel = ((got.float() - ref).norm() / ref.norm()).item()
    assert rel < 0.1


def test_full_config_builds_with_the_jax_parameter_count():
    """The shipped config at full width (N = 512, H = 512, 24 blocks),
    built and not run: its parameter count equals the JAX init's."""
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "convtasnet_config.json"))
    gen, domain = build_generator(h)
    n_ours = sum(p.numel() for p in gen.parameters())
    shapes = jax.eval_shape(jax_ctn.ConvTasNet.from_config(h).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 80, 8)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert domain == "time" and len(gen.blocks) == 24 and n_ours == n_jax == 4_960_409
    assert not any(blk.fused for blk in gen.blocks)     # fused_tcn off, as the reference
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert set(params_from_jax(zeros, h)) == set(gen.state_dict())


def test_config_is_a_copy_of_the_jax_packages():
    with open(os.path.join(REPO, "nvse_tpu_torch", "configs", "convtasnet_config.json")) as f:
        ours = json.load(f)
    with open(os.path.join(REPO, "nvse_tpu", "configs", "convtasnet_config.json")) as f:
        assert ours == json.load(f)


def test_time_domain_training_is_not_ported():
    from nvse_tpu_torch.train.trainer import _check_supported

    with pytest.raises(NotImplementedError, match="time domain"):
        _check_supported(_h(), "time")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_engine_matches_jax_engine_with_bucket_padding():
    # zero phase (no random draw on either side); T = 9 pads to the 16-frame
    # bucket with log(1e-5) and the output is cropped back
    from nvse_tpu.infer.engine import InferenceEngine as JaxEngine

    h = _h(init_phase="zero", fused_tcn=True)
    _, jp, _ = _pair(h)
    mel = _mel(T=9)
    ref = JaxEngine(h, params=jax.tree.map(jnp.asarray, jp), bucket_frames=16
                    ).synthesize_mel(jnp.asarray(mel), out_len=2000)
    eng = InferenceEngine(h, params=params_from_jax(jp, h), device="cpu", bucket_frames=16)
    got = eng.synthesize_mel(torch.from_numpy(mel), out_len=2000)
    assert got.shape == np.asarray(ref).shape == (B, 2000)
    np.testing.assert_allclose(got, np.asarray(ref), **MODEL_TOL)
    # the bucket's hop * (16 - 1) samples, cropped to T * hop
    assert eng.synthesize_mel(torch.from_numpy(mel)).shape == (B, 256 * 9)
    with pytest.raises(ValueError, match="stream_state"):
        eng.synthesize_streaming_stateful(torch.from_numpy(mel))
    wav = eng.synthesize_streaming(torch.from_numpy(mel), chunk_frames=4, context_frames=2)
    assert wav.shape == (B, 9 * 256) and np.isfinite(wav).all()


def test_run_inference_on_the_synth_set(tmp_path, monkeypatch):
    """A narrowed ConvTasNet with fused_tcn on through run_inference on the
    CPU: the batched path, then streaming with stream_mode "stateful", which
    decodes by context recompute, as the JAX engine, since the model has no
    stream state."""
    monkeypatch.chdir(REPO)
    cfg = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "convtasnet_config.json"))
    cfg.update(N=64, H=128, X=2, R=1, fused_tcn=1, infer_batch=2,
               test_output_dir=str(tmp_path / "out"))
    assert not os.path.exists(cfg.checkpoint_file_load)
    lines = []
    stats = run_inference(cfg, limit=3, log_fn=lines.append, device="cpu")
    assert stats["files"] == 3 and stats["rtf"] > 0
    assert lines[-1].startswith("decoded 3 files | wall ")
    written = sorted(os.listdir(tmp_path / "out"))
    assert written == ["SY0036.wav", "SY0037.wav", "SY0038.wav"]
    for name in written:
        y, sr = read_wav(str(tmp_path / "out" / name))
        src, _ = read_wav(os.path.join(REPO, "DatasetsScp", "synth", "wavs", name))
        # hop * (T - 1) samples decoded: the last hop of the source is not
        n = len(src) - len(src) % 256
        assert sr == 22050 and n <= y.shape[0] <= len(src)
        assert np.isfinite(y).all() and np.abs(y).max() > 0
    cfg.update(test_output_dir=str(tmp_path / "out2"), stream_mode="stateful",
               stream_chunk_frames=16, stream_context_frames=4)
    stats = run_inference(cfg, limit=1, stream=True, log_fn=lines.append, device="cpu")
    assert stats["files"] == 1 and os.listdir(tmp_path / "out2") == ["SY0036.wav"]
