"""Multi-replica serving and the multi-rank tools of the port, on the CPU:
serving with infer_dp_devices (CPU replicas) against the one-device decode and
the JAX engine's data-parallel decode on the virtual devices of
tests/conftest.py, SegmentDataset's sharding against the JAX dataset's, the
port's dry run (python -m nvse_tpu_torch.parallel.dryrun --n 4 --device cpu)
and spawn's rule that ranks run on the card unless the CPU is asked for.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.data import SegmentDataset as JaxSegments
from nvse_tpu.infer.engine import InferenceEngine as JaxEngine
from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.utils import AttrDict as JaxAttrDict
from nvse_tpu_torch.data import SegmentDataset
from nvse_tpu_torch.infer import InferenceEngine
from nvse_tpu_torch.parallel import spawn
from nvse_tpu_torch.utils import AttrDict, params_from_jax

from test_torch_port_bsrnn import jax_params
from test_torch_port_parallel import REPO
from torch_parallel_ranks import run_jobs
from test_torch_port_joint import _one_torch_thread  # noqa: F401


def _engine_h(**kw):
    """tests/test_inference.py's HiFiGAN (the JAX DP engine's test model)."""
    return dict(model_name="HiFiGAN", resblock="2", upsample_rates=[8, 8, 2, 2],
                upsample_kernel_sizes=[16, 16, 4, 4], upsample_initial_channel=32,
                resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
                sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
                fmin=0, fmax=8000, segment_size=2048, seed=1234, **kw)


def test_engine_dp_replicas_match_one_device_and_the_jax_dp_engine():
    """infer_dp_devices 2 (CPU replicas) on a batch of 5 (padded to 6, split
    3 + 3) against the one-device decode, and against the JAX engine with
    infer_dp_devices 8 (padded to 8) from the same weights, as
    tests/test_inference.py:236-260 holds the JAX engine (its model, bucket
    and shapes); streaming windows and warmup too."""
    mel = np.random.default_rng(0).standard_normal((5, 80, 20)).astype(np.float32) - 4.0
    jgen, _ = jax_build(JaxAttrDict(_engine_h()))
    jp = jax_params(jgen, mel)
    sd = params_from_jax(jp, AttrDict(_engine_h()))
    lines = []
    one = InferenceEngine(AttrDict(_engine_h()), params=sd, device="cpu", bucket_frames=32)
    dp = InferenceEngine(AttrDict(_engine_h(infer_dp_devices=2)), params=sd, device="cpu",
                         bucket_frames=32, log_fn=lines.append)
    assert len(dp.replicas) == 2 and lines == ["serving on 2 replica(s) (cpu; infer_dp_devices=2)"]
    assert dp.replicas[1] is not dp.generator
    ref = one.synthesize_mel(torch.from_numpy(mel), out_len=5000)
    got = dp.synthesize_mel(torch.from_numpy(mel), out_len=5000)
    assert got.shape == (5, 5000)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    jeng = JaxEngine(JaxAttrDict(_engine_h(infer_dp_devices=8)),
                     params=jax.tree.map(jnp.asarray, jp), bucket_frames=32)
    assert jeng.mesh is not None and jeng.mesh.devices.size == 8
    np.testing.assert_allclose(got, jeng.synthesize_mel(jnp.asarray(mel), out_len=5000),
                               rtol=2e-4, atol=2e-5)
    s_ref = one.synthesize_streaming(torch.from_numpy(mel[:3]), chunk_frames=8, context_frames=4)
    s_got = dp.synthesize_streaming(torch.from_numpy(mel[:3]), chunk_frames=8, context_frames=4)
    np.testing.assert_allclose(s_got, s_ref, rtol=1e-5, atol=1e-6)
    dp.warmup(20, batch=3)
    assert (32, 3) in dp._warmed


@pytest.mark.parametrize("model", ["ConvTasNet", "HDDemucas"])
def test_engine_dp_replicas_draw_their_rows_of_one_initial_phase(model):
    """A generator that draws its initial phase (init_phase "griffin_lim" and
    "rand") served by 2 CPU replicas on a batch of 5 (padded to 6, split 3 + 3):
    each replica takes its rows of the whole batch's draw, so the decode is the
    one-device decode (a replica drawing for its own rows alone starts the
    second one's rows from the first one's phase)."""
    from nvse_tpu_torch.ops import default_phase

    h = (dict(model_name="ConvTasNet", N=16, L=16, B=8, H=16, P=3, X=2, R=1, num_spks=1,
              skip_con=True, causal=False, norm="gln", fused_tcn=True)
         if model == "ConvTasNet" else
         dict(model_name="HDDemucas", chin=1, chout=1, hidden=4, depth=3, kernel_size=8,
              stride=4, causal=False, resample=4, growth=2, max_hidden=10000, normalize=False,
              glu=True, rescale=0.1, floor=0.001))
    h.update(sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
             fmin=0, fmax=8000, seed=1234)
    mel = torch.from_numpy(
        np.random.default_rng(1).standard_normal((5, 80, 12)).astype(np.float32) - 4.0)
    theta = default_phase((6, 513, 12), torch.device("cpu"))
    assert torch.equal(default_phase((3, 513, 12), torch.device("cpu"), 3), theta[3:])
    for init_phase in ("griffin_lim", "rand"):
        one = InferenceEngine(AttrDict(dict(h, init_phase=init_phase)), device="cpu")
        dp = InferenceEngine(AttrDict(dict(h, init_phase=init_phase, infer_dp_devices=2)),
                             device="cpu", log_fn=lambda line: None)
        ref = one.forward(mel)
        torch.testing.assert_close(dp.forward(mel), ref, rtol=1e-5, atol=1e-6)
        # the second replica's rows differ from its own draw's
        with torch.inference_mode():
            alone = dp.replicas[1](torch.nn.functional.pad(mel[3:], (0, 0, 0, 0, 0, 1), value=-11.5))
        assert (alone[:2] - ref[3:]).abs().max() > 1e-3


def test_segment_dataset_shards_as_the_jax_dataset():
    files = [f"f{i}.wav" for i in range(11)]
    for shard in range(3):
        ours = SegmentDataset(files, 2048, 22050, seed=7, shard_id=shard, num_shards=3)
        theirs = JaxSegments(files, 2048, 22050, seed=7, shard_id=shard, num_shards=3)
        assert ours.files == theirs.files and len(ours) == len(theirs)
        assert ours.rng.random() == theirs.rng.random()
    assert SegmentDataset(files, 2048, 22050, seed=7).files == \
        JaxSegments(files, 2048, 22050, seed=7).files


def test_dryrun_cli_on_four_cpu_ranks():
    out = subprocess.run([sys.executable, "-m", "nvse_tpu_torch.parallel.dryrun", "--n", "4",
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any("one DP GAN step ok" in l for l in lines)
    assert any("dp x sp (=2x2) GAN step ok" in l and "(matches DP)" in l for l in lines)
    assert any("checkpoint save/restore ok" in l for l in lines)


def test_spawn_runs_on_the_card_unless_asked_and_starts_nothing_without_one(monkeypatch):
    """spawn's ranks run on the card by default: where no card is visible a call
    without `device` raises the port's no-card message before any process
    starts (no CPU job in its place)."""
    import torch.multiprocessing as mp

    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mp, "start_processes", lambda *a, **kw: started.append(a))
    with pytest.raises(RuntimeError, match="no CUDA GPU is visible"):
        spawn(run_jobs, 2, args=([],))
    assert not started
    spawn(run_jobs, 2, args=([],), device="cpu")          # asked for: the CPU job starts
    assert len(started) == 1
