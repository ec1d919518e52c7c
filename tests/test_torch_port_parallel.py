"""Multi-rank training and multi-replica serving of the port, on the CPU.

Ranks are processes started by nvse_tpu_torch.parallel.spawn (gloo, a
file:// rendezvous in a temporary directory, one intra-op thread each, a
120 s collective timeout). One job of four ranks runs every training step
of the file and the training loop (torch_parallel_ranks.run_jobs), each step on
its own mesh:
  * a 2-rank data-parallel step of BSRNN (T-F, LS-GAN), of the joint
    BSRNN_24k (denoise) and of ConvTasNet (time domain, init_phase "rand",
    hinge losses, the MSD's spectral norm), each against one process's step
    on the whole batch: losses within 1e-5 relative; the updated parameters
    and buffers (the MSD's u) within 1e-6 absolute where the gradient is not
    float noise around an exact zero (|mu| >= 1e-4 of the largest, the rule
    of tests/test_torch_port_train.py), and within 2 lr (one Adam step on
    each side, whose signs such noise picks) where it is; AdamW's moments
    per tensor at a relative L2 of 1e-3 (floored as there): the ranks sum
    the batch in another split, which moves moments by float32 rounding
    (4.2e-4 at most, BSRNN's dec_pha LayerNorm scale, and 7.2e-5 at most
    for every other tensor, on this file's inputs), where a gradient left
    out of the all-reduce moves them by tenths (0.38 in BSRNN-M's DP step);
  * BSRNN over a (2, 2) dp x sp mesh (9 frames over 2 seq ranks: 5 / 4)
    and over a (1, 4) mesh (34 bands: 9 / 9 / 8 / 8; 9 frames: 3 / 2 / 2 /
    2), against the one-process step at the same limits, and the (2, 2)
    step against the JAX package's step over get_mesh(4, n_seq=2) on the
    virtual devices of tests/conftest.py, from the same weights, at the
    limits of tests/test_torch_port_train.py;
every job also checks that parameters, buffers and optimizer states end
equal on every rank. Then the training loop on the four ranks. Serving with
infer_dp_devices, the datasets' shards, the dry run and spawn's device rule
are in tests/test_torch_port_parallel_cli.py (its own file so that the two
halves run on different test workers).
"""
import datetime
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.parallel import get_mesh as jax_get_mesh
from nvse_tpu.train.trainer import DiscState, GenState
from nvse_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvse_tpu.train.trainer import make_train_step
from nvse_tpu.utils import AttrDict as JaxAttrDict
from nvse_tpu_torch.parallel import spawn, split_sizes
from nvse_tpu_torch.train import GANTrainer, fetch_scalars, restore_checkpoint
from nvse_tpu_torch.utils import AttrDict, disc_params_from_jax, load_config, params_from_jax

from test_torch_port_bsrnn import jax_params
from test_torch_port_disc import disc_params
from test_torch_port_joint import torch_threads
from test_torch_port_train import (_adam_mu, _bridge_gen, _np, assert_moments_close,
                                   assert_updates_close)
from torch_parallel_ranks import run_jobs, run_training, step_on_mesh, trainer_result

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = 2048                      # 9 frames at hop 256
TF_KEYS = ("A", "IP", "GD", "PTD", "C", "R", "I", "Mel", "GAN", "FM", "G", "D")
LR = 2e-4
TRAIN = dict(learning_rate=LR, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, seed=1234,
             meloss=None, segment_size=SEG, batch_size=2)
BSRNN = dict(model_name="BSRNN", feature_dim=8, num_repeat=1, dropout=0.0, causal=False,
             sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
             fmin=0, fmax=8000, mrd_weight=0.1, mpd_reshapes=[2], **TRAIN)
JOINT = dict(BSRNN, model_name="BSRNN_24k", sampling_rate=24000, num_mels=100, fmax=12000,
             num_repeat=1, snr_range=[-5, 15], task_dict=["denoise", "vocoder"])
CONVTASNET = dict(model_name="ConvTasNet", N=16, L=16, B=8, H=16, P=3, X=2, R=1, num_spks=1,
                  skip_con=True, init_phase="rand", causal=False, norm="gln", fused_tcn=True,
                  num_mels=80, n_fft=1024, hop_size=256, win_size=1024, sampling_rate=22050,
                  fmin=0, fmax=8000, mpd_reshapes=[2], **TRAIN)


def _waves(sr, seed=0, b=2, n=SEG):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    clean = 0.3 * np.sin(2 * np.pi * 220 * t)[None, :] + 0.02 * rng.standard_normal((b, n))
    return clean.astype(np.float32), (clean + 0.1 * rng.standard_normal((b, n))).astype(np.float32)


def _jax_weights(h):
    """Seeded numpy weights in the JAX trees' shapes: (generator, discriminators)."""
    jgen, _ = jax_build(JaxAttrDict(h))
    gp = jax_params(jgen, np.zeros((1, h["num_mels"], 9), np.float32), seed=0)
    return gp, disc_params(segment=h["segment_size"], periods=h["mpd_reshapes"])


def _port_state(gp, dp, h):
    mpd, mrd = disc_params_from_jax(dp)
    return {"generator": params_from_jax(gp, AttrDict(h)),
            "disc": {**{f"mpd.{k}": v for k, v in mpd.items()},
                     **{f"mrd.{k}": v for k, v in mrd.items()}}}


def one_process(h, batch, state=None, joint=False, task=None):
    """One step of one process on the whole batch -> trainer_result."""
    tr = GANTrainer(AttrDict(h), device="cpu", steps_per_epoch=10, joint=joint)
    if state is not None:
        tr.generator.load_state_dict(state["generator"])
        tr.disc.load_state_dict(state["disc"])
    args = (*[torch.from_numpy(b) for b in batch], task) if joint else (torch.from_numpy(batch),)
    return trainer_result(tr, fetch_scalars(tr.step(*args)))


def _loop_config(tmp):
    """A tiny BSRNN training config on 4 synthetic files, batch 2, with
    sp_devices 2: on 4 ranks the loop's mesh is (2, 2)."""
    cfg = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "bsrnn_config.json"))
    lists = os.path.join(REPO, "DatasetsScp", "synth")
    (tmp / "train.txt").write_text(
        "\n".join(open(os.path.join(lists, "train_filelist.txt")).read().splitlines()[:4]) + "\n")
    (tmp / "val.txt").write_text(
        open(os.path.join(lists, "val_filelist.txt")).read().splitlines()[0] + "\n")
    cfg.update(feature_dim=8, num_repeat=1, segment_size=2048, batch_size=2, sp_devices=2,
               mpd_reshapes=[2], training_steps=1, stdout_interval=1, checkpoint_interval=1,
               validation_interval=1000, validation_cap=1, num_workers=1,
               checkpoint_path=str(tmp / "ckpt"), input_training_wav_list=str(tmp / "train.txt"),
               input_validation_wav_list=str(tmp / "val.txt"),
               raw_wavfile_path=os.path.join(lists, "wavs"), config_path=str(tmp / "cfg.json"))
    (tmp / "cfg.json").write_text(json.dumps(dict(cfg)))
    return dict(cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank run of the file, in one job of four ranks: the steps
    with their results and one-process references, and the training loop."""
    tmp = tmp_path_factory.mktemp("parallel")
    bsrnn_w = _port_state(*_jax_weights(BSRNN), BSRNN)
    torch.save(bsrnn_w, tmp / "bsrnn.pt")
    audio = _waves(22050)[0]
    clean24, noisy24 = _waves(24000, seed=1)
    steps = {
        "dp_bsrnn": dict(h=BSRNN, shape=(2,), batch=audio, ranks=[0, 1]),
        "dp_joint": dict(h=JOINT, shape=(2,), batch=(clean24, noisy24), joint=True,
                         task="denoise", ranks=[0, 1]),
        "dp_convtasnet": dict(h=CONVTASNET, shape=(2,), batch=audio, ranks=[0, 1]),
        "dpsp_bsrnn": dict(h=BSRNN, shape=(2, 2), batch=audio, state=str(tmp / "bsrnn.pt")),
        "sp4_bsrnn": dict(h=BSRNN, shape=(1, 4), batch=audio, state=str(tmp / "bsrnn.pt")),
    }
    for name, job in steps.items():
        job["out"] = str(tmp / f"{name}.pt")
    loop = _loop_config(tmp)
    spawn(run_jobs, 4, device="cpu", timeout=datetime.timedelta(seconds=120),
          args=([(step_on_mesh, job) for job in steps.values()] + [(run_training, dict(h=loop))],))
    got = {name: torch.load(job["out"], weights_only=True) for name, job in steps.items()}
    with torch_threads(1):                      # as each rank
        ref = {"dp_bsrnn": one_process(BSRNN, audio),
               "dp_joint": one_process(JOINT, (clean24, noisy24), joint=True, task="denoise"),
               "dp_convtasnet": one_process(CONVTASNET, audio),
               "dpsp_bsrnn": one_process(BSRNN, audio, state=bsrnn_w)}
    ref["sp4_bsrnn"] = ref["dpsp_bsrnn"]
    return {"got": got, "ref": ref, "loop": loop}


def _assert_steps_equal(got, ref):
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for part in ("mu_g", "mu_d", "nu_g", "nu_d"):
        assert_moments_close(got[part], ref[part], rel=1e-3)
    for part, mu in (("generator", "mu_g"), ("disc", "mu_d")):
        assert got[part].keys() == ref[part].keys(), part
        floor = 1e-4 * max(v.abs().max().item() for v in ref[mu].values())
        for k, v in ref[part].items():
            d = (got[part][k] - v).abs()
            live = ref[mu][k].abs() >= floor if k in ref[mu] else torch.ones_like(d, dtype=bool)
            assert d[live].max().item() <= 1e-6 if live.any() else True, (part, k)
            assert d.max().item() <= 2 * LR, (part, k, d.max().item())


@pytest.mark.parametrize("job", ["dp_bsrnn", "dp_joint", "dp_convtasnet", "dpsp_bsrnn",
                                 "sp4_bsrnn"])
def test_multi_rank_step_equals_one_process_step(runs, job):
    _assert_steps_equal(runs["got"][job], runs["ref"][job])


def test_convtasnet_rand_phase_hinge_and_spectral_norm_over_ranks(runs):
    """The rand phase is the global draw's rows (the losses above agree only
    so); the hinge losses' exact zeros survive the all-reduce; every u moved
    and equals the one-process u."""
    g, r = runs["got"]["dp_convtasnet"], runs["ref"]["dp_convtasnet"]
    us = [k for k in r["disc"] if k.endswith(".u")]
    assert len(us) == 8
    fresh = GANTrainer(AttrDict(CONVTASNET), device="cpu").disc.state_dict()
    for k in us:
        assert not torch.equal(fresh[k], r["disc"][k]), k
        assert torch.equal(g["disc"][k], r["disc"][k]), k
    zeros = [k for k, v in r["mu_d"].items() if not v.any()]
    assert zeros and all(not g["mu_d"][k].any() for k in zeros)


def test_splits_leave_a_remainder():
    assert split_sizes(34, 4) == [9, 9, 8, 8] and split_sizes(33, 2) == [17, 16]
    frames = SEG // 256 + 1
    assert split_sizes(frames, 2) == [5, 4] and split_sizes(frames, 4) == [3, 2, 2, 2]


def test_dp_sp_step_matches_the_jax_mesh_step(runs):
    """The port's (2, 2) step against make_train_step over the JAX package's
    get_mesh(4, n_seq=2) (sp_axis "seq"), from the same weights and batch."""
    h = JaxAttrDict(dict(BSRNN, sp_axis="seq"))
    jgen, domain = jax_build(h)
    gp, dp = _jax_weights(BSRNN)
    gen_state = GenState.create(apply_fn=jgen.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, 10)
                                ).replace(step=jnp.asarray(0, jnp.int32))
    disc_state = DiscState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, dp),
                                  tx=jax_make_optimizer(h, 10), spectral=None
                                  ).replace(step=jnp.asarray(0, jnp.int32))
    g0 = _port_state(gp, dp, BSRNN)
    fns = make_train_step(h, jgen, domain, mesh=jax_get_mesh(4, n_seq=2))
    gen_state, disc_state, jm = fns.train_step(gen_state, disc_state,
                                               jnp.asarray(_waves(22050)[0]), None)
    port = runs["got"]["dpsp_bsrnn"]
    for k in TF_KEYS:
        np.testing.assert_allclose(port["metrics"][k], float(jm[k]), rtol=1e-3, err_msg=k)
    mu_g = _bridge_gen(_adam_mu(gen_state.opt_state), h, half_bias=True)
    assert_moments_close(port["mu_g"], mu_g, rel=2e-3)
    d_mu = _port_state(gp, _np(_adam_mu(disc_state.opt_state)), BSRNN)["disc"]
    assert_moments_close(port["mu_d"], d_mu, rel=2e-3)
    assert_updates_close(port["generator"], _bridge_gen(gen_state.params, h, half_bias=False),
                         g0["generator"], mu_g)
    d_new = _port_state(gp, _np(disc_state.params), BSRNN)["disc"]
    assert_updates_close(port["disc"], d_new, g0["disc"], d_mu)


def test_training_loop_on_four_ranks_with_sequence_parallelism(runs):
    """The training loop (train/loop.py train, as torchrun runs it on each
    rank) on the 4 ranks with sp_devices 2 and batch 2: a (2, 2) dp x sp
    mesh; rank 0 alone writes the config copy and the g_ / do_ bundles and
    validates (the others wait at the barrier); the bundle restores into one
    process's trainer at the next step."""
    cfg = runs["loop"]
    ckpt = cfg["checkpoint_path"]
    assert sorted(os.listdir(ckpt)) == ["checkpoint_d", "checkpoint_g", "config.json",
                                        "do_00000001", "g_00000001", "logs"]
    fresh = GANTrainer(AttrDict(cfg), device="cpu", steps_per_epoch=2)
    assert restore_checkpoint(ckpt, fresh) == (2, 0)
    assert all(torch.isfinite(p).all() for p in fresh.generator.parameters())
