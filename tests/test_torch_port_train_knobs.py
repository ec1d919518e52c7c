"""The training loops' knobs for numerics, tracing and checkpoints, on the CPU.

nvse_tpu/train/loop.py honours debug_nans, profile_dir / profile_steps and
async_checkpoint (:48-80, 287, 305-330); nvse_tpu/train/loop_joint.py
honours async_checkpoint alone (:176-196). The port's loops must do the same:
  * profile_dir: a torch.profiler trace under profile_dir holding the
    profiled steps' backward calls of the hand-written LSTM kernels'
    autograd.Function (two BiLSTMs a step here), also for a run shorter than
    profile_steps;
  * debug_nans: anomaly mode for the run and off again after it; a NaN
    planted in a backward raises a RuntimeError naming the function that
    returned it, for every kernel's autograd.Function;
  * async_checkpoint: an asynchronous save equals a synchronous one bit for
    bit, although the trainer steps (parameters and AdamW moments changed in
    place) while the write is held back; a writer's error is raised at the
    next wait; a restore waits for the write in flight; the loops save in the
    background between the synchronous final saves and leave no write in
    flight when they return or raise.
BSRNN is narrowed to feature_dim 8 and one BSNet at segment 2048 and batch 2
on DatasetsScp/synth, torch on one thread.
"""
import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

from nvse_tpu_torch.ops import lstm as port_lstm
from nvse_tpu_torch.ops import tcn as port_tcn
from nvse_tpu_torch.train import GANTrainer, train, train_joint
from nvse_tpu_torch.train import checkpoint as ckpt
from nvse_tpu_torch.train import loop, loop_joint
from nvse_tpu_torch.utils import AttrDict

from test_torch_port_joint import _loop_config, _one_torch_thread, joint_files  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "DatasetsScp", "synth")
# the backward of lstm_scan_fused's training route, one per BiLSTM call
FUSED_BACKWARD = "_BiLSTMSavingBackward"


@pytest.fixture(autouse=True)
def _no_write_in_flight():
    yield
    ckpt.wait_for_checkpoints()
    assert not torch.is_anomaly_enabled()


def _h(tmp_path, **kw):
    """A tiny BSRNN on 4 training files (2 steps an epoch), no validation."""
    lines = open(os.path.join(SYNTH, "train_filelist.txt")).read().splitlines()
    (tmp_path / "train.txt").write_text("\n".join(lines[:4]) + "\n")
    (tmp_path / "val.txt").write_text(
        open(os.path.join(SYNTH, "val_filelist.txt")).read().splitlines()[0] + "\n")
    d = dict(model_name="BSRNN", feature_dim=8, num_repeat=1, dropout=0.0, causal=False,
             sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
             fmin=0, fmax=8000, meloss=None, segment_size=2048, batch_size=2,
             learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, mrd_weight=0.1,
             mpd_reshapes=[2], seed=1234, training_steps=1, training_epochs=10,
             stdout_interval=1, summary_interval=1000, checkpoint_interval=1000,
             validation_interval=1000, skip_step0_validation=True, max_to_keep=5,
             num_workers=1, input_training_wav_list=str(tmp_path / "train.txt"),
             input_validation_wav_list=str(tmp_path / "val.txt"),
             raw_wavfile_path=os.path.join(SYNTH, "wavs"),
             checkpoint_path=str(tmp_path / "ckpt"))
    d.update(kw)
    return AttrDict(d)


def _spy(mp, record):
    """Spies on the loops' saves and the trainer's steps: record gets
    ("save", step, async_save) and ("step", anomaly mode on)."""
    for module in (loop, loop_joint):
        real = module.save_checkpoint

        def save(path, step, epoch, trainer, max_to_keep=5, async_save=False, _real=real):
            record.append(("save", step, async_save))
            _real(path, step, epoch, trainer, max_to_keep=max_to_keep, async_save=async_save)

        mp.setattr(module, "save_checkpoint", save)
    real_step = GANTrainer.step

    def step(self, *a, **kw):
        record.append(("step", torch.is_anomaly_enabled()))
        return real_step(self, *a, **kw)

    mp.setattr(GANTrainer, "step", step)


def _run(tmp_path, nan_from_step=None, **kw):
    """train() on the tiny config (2 steps, a save at each): -> (h, log lines,
    spy record, pending writes at the end, trace event names or None, the
    exception it raised or None). nan_from_step: lstm_bwd (the training
    kernel's backward recurrence) returns NaN in dx from that step on (0 the
    first), so _BiLSTMSaving's backward returns NaN; the background writes
    are held back until shortly after the first NaN."""
    h = _h(tmp_path, checkpoint_interval=1, **kw)
    logs, record, raised = [], [], None
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, record)
        if nan_from_step is not None:
            real = port_lstm.lstm_bwd
            gate = _held_writer(mp)

            def bwd(*args):
                dx, dw = real(*args)
                if sum(r[0] == "step" for r in record) <= nan_from_step:
                    return dx, dw
                if not gate.is_set():
                    threading.Timer(0.3, gate.set).start()
                return dx * float("nan"), dw

            mp.setattr(port_lstm, "lstm_bwd", bwd)
        try:
            train(h, device="cpu", log_fn=logs.append)
        except RuntimeError as e:
            raised = e
    traces = glob.glob(os.path.join(str(tmp_path / "prof"), "*.pt.trace.json"))
    names = None
    if traces:
        assert len(traces) == 1, traces
        with open(traces[0]) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    return dict(h=h, logs=logs, record=record, pending=list(ckpt._PENDING), names=names,
                raised=raised, anomaly_after=torch.is_anomaly_enabled())


@pytest.fixture(scope="module")
def knobs_on(tmp_path_factory):
    """debug_nans, profile_dir with profile_steps 5 (more than the run's 2),
    async saves (the default)."""
    tmp = tmp_path_factory.mktemp("knobs_on")
    return _run(tmp, debug_nans=True, profile_dir=str(tmp / "prof"), profile_steps=5)


@pytest.fixture(scope="module")
def knobs_off(tmp_path_factory):
    """profile_steps 1 and synchronous saves, debug_nans off."""
    tmp = tmp_path_factory.mktemp("knobs_off")
    return _run(tmp, profile_dir=str(tmp / "prof"), profile_steps=1, async_checkpoint=False)


@pytest.fixture(scope="module")
def nan_run(tmp_path_factory):
    """debug_nans, async saves, 3 steps with a NaN in the LSTM backward of
    the third, after the save of step 1."""
    return _run(tmp_path_factory.mktemp("nan_run"), nan_from_step=2, debug_nans=True,
                training_steps=2)


def _fused_backward_calls(names):
    return sum(n.endswith(FUSED_BACKWARD) and "evaluate_function" in n for n in names)


# ---------------------------------------------------------------------------
# profile_dir / profile_steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run,profiled", [("knobs_off", 1), ("knobs_on", 2)])
def test_profile_dir_traces_the_first_steps(request, run, profiled):
    """Two steps run. profile_steps 1: the trace stops as step 2 starts and
    holds one step; profile_steps 5: the run ends first, and the trace, still
    running, is stopped and written at the end with both steps."""
    r = request.getfixturevalue(run)
    prof = os.path.join(os.path.dirname(r["h"].checkpoint_path), "prof")
    assert r["names"] is not None, "no trace under profile_dir"
    assert _fused_backward_calls(r["names"]) == 2 * profiled   # a time and a band BiLSTM a step
    assert r["logs"].count(f"profiler trace started -> {prof}") == 1
    assert r["logs"].count("profiler trace stopped") == 1


def test_no_trace_without_profile_dir(nan_run):
    r = nan_run
    assert r["names"] is None
    assert not any("profiler" in l for l in r["logs"])


# ---------------------------------------------------------------------------
# debug_nans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run,on", [("knobs_on", True), ("knobs_off", False)])
def test_debug_nans_turns_on_anomaly_mode_for_the_run(request, run, on):
    r = request.getfixturevalue(run)
    assert [v for k, v, *_ in r["record"] if k == "step"] == [on, on]
    assert sum("anomaly detection" in l and l.endswith("enabled") for l in r["logs"]) == on
    assert "training finished (step budget reached)" in r["logs"]
    assert r["raised"] is None and not r["anomaly_after"]


def test_a_nan_in_the_lstm_backward_raises_naming_its_function(nan_run):
    r = nan_run
    assert isinstance(r["raised"], RuntimeError)
    assert f"Function '{FUSED_BACKWARD}' returned nan" in str(r["raised"])
    assert not r["anomaly_after"]


def _kernel_calls():
    """name -> (autograd.Function, a call of its wrapper on CPU tensors that
    require grad), at tiny shapes: T 5, rows 3, C 4, H 8."""
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return (0.3 * torch.randn(*s, generator=g)).requires_grad_()

    T, R, C, H = 5, 3, 4, 8
    tail = [r(2, 6, H), r(2, 6, 4), r(1, H), r(1, H), r(3, H), r(1, H), r(H, 8), r(1, 8)]
    return {
        "lstm_scan_fused": (port_lstm._BiLSTMSaving, lambda: port_lstm.lstm_scan_fused(
            r(R, T, C), r(C, 4 * H), r(C, 4 * H), r(4 * H), r(4 * H), r(H, 4 * H), r(H, 4 * H))),
        "lstm_scan": (port_lstm._ScanSaving,
                      lambda: port_lstm.lstm_scan(r(T, R, 4 * H), r(H, 4 * H))),
        "lstm_scan_bidir2": (port_lstm._Bidir2Saving, lambda: port_lstm.lstm_scan_bidir2(
            r(T, R, 4 * H), r(T, R, 4 * H), r(H, 4 * H), r(H, 4 * H))),
        "lstm_scan_bidir": (port_lstm._BidirRecompute,
                            lambda: port_lstm.lstm_scan_bidir(r(T, 2 * R, 4 * H), r(2 * H, 4 * H))),
        "tcn_block_tail": (port_tcn._TailRecompute,
                           lambda: port_tcn.tcn_block_tail(*tail, dilation=2)),
    }


@pytest.mark.parametrize("wrapper", sorted(_kernel_calls()))
def test_anomaly_mode_names_each_kernel_function_whose_backward_returns_nan(monkeypatch,
                                                                            wrapper):
    fn, call = _kernel_calls()[wrapper]
    real = fn.backward

    def nan_backward(ctx, *grads):
        return tuple(None if d is None else d * float("nan") for d in real(ctx, *grads))

    monkeypatch.setattr(fn, "backward", staticmethod(nan_backward))

    def loss():
        out = call()
        return sum(o.sum() for o in (out if isinstance(out, tuple) else (out,)))

    with torch.autograd.set_detect_anomaly(True):
        with pytest.raises(RuntimeError, match=f"Function '{fn.__name__}Backward' returned nan"):
            loss().backward()
    loss().backward()                                 # anomaly mode off: no check


# ---------------------------------------------------------------------------
# async_checkpoint
# ---------------------------------------------------------------------------

def _audio(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.1 * rng.standard_normal((2, 2048))).astype(np.float32))


def _assert_trees_equal(a, b, path="bundle"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _held_writer(monkeypatch):
    """Hold the background write until the returned event is set."""
    gate = threading.Event()
    real = ckpt._write

    def held(*args):
        assert gate.wait(60)
        real(*args)

    monkeypatch.setattr(ckpt, "_write", held)
    return gate


def test_async_save_equals_a_sync_save_after_in_place_updates(tmp_path, monkeypatch):
    """The trainer steps while the write is held back: the step changes every
    parameter and AdamW moment in place (the CPU tensors that a save without
    copies would serialise); the bundles written after it hold the state at
    the save."""
    tr = GANTrainer(_h(tmp_path), device="cpu", steps_per_epoch=4)
    tr.step(_audio(0))
    ckpt.save_checkpoint(str(tmp_path / "sync"), 1, 0, tr, max_to_keep=2)
    gate = _held_writer(monkeypatch)
    ckpt.save_checkpoint(str(tmp_path / "async"), 1, 0, tr, max_to_keep=2, async_save=True)
    assert not os.path.exists(tmp_path / "async" / "g_00000001")       # still in flight
    before = next(tr.generator.parameters()).clone()
    tr.step(_audio(1))
    assert not torch.equal(before, next(tr.generator.parameters()))
    gate.set()
    ckpt.wait_for_checkpoints()
    assert sorted(os.listdir(tmp_path / "async")) == sorted(os.listdir(tmp_path / "sync"))
    for name in ("g_00000001", "do_00000001"):
        _assert_trees_equal(torch.load(tmp_path / "async" / name, weights_only=True),
                            torch.load(tmp_path / "sync" / name, weights_only=True), name)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    return GANTrainer(_h(tmp_path_factory.mktemp("trainer")), device="cpu", steps_per_epoch=4)


def test_async_rotation_runs_with_the_write(tmp_path, trainer):
    tr = trainer
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path / "ck"), step, 0, tr, max_to_keep=2, async_save=True)
    ckpt.wait_for_checkpoints()
    assert sorted(os.listdir(tmp_path / "ck")) == ["checkpoint_d", "checkpoint_g", "do_00000002",
                                            "do_00000003", "g_00000002", "g_00000003"]


def test_a_writer_error_is_raised_at_the_next_wait(tmp_path, monkeypatch, trainer):
    def full(obj, dst):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt, "_save", full)
    tr = trainer
    ckpt.save_checkpoint(str(tmp_path), 1, 0, tr, async_save=True)       # returns
    with pytest.raises(OSError, match="No space left"):
        ckpt.wait_for_checkpoints()
    ckpt.wait_for_checkpoints()                        # raised once, then nothing in flight
    with pytest.raises(OSError, match="No space left"):
        ckpt.save_checkpoint(str(tmp_path), 2, 0, tr)  # a synchronous save raises itself


def test_restore_waits_for_the_write_in_flight(tmp_path, monkeypatch, trainer):
    gate = _held_writer(monkeypatch)
    ckpt.save_checkpoint(str(tmp_path), 3, 1, trainer, async_save=True)
    threading.Timer(0.3, gate.set).start()
    assert ckpt.restore_checkpoint(str(tmp_path), trainer) == (4, 1)


@pytest.mark.parametrize("run,async_save", [("knobs_on", True), ("knobs_off", False)])
def test_loop_saves_in_the_background_and_the_final_save_synchronously(request, run,
                                                                      async_save):
    r = request.getfixturevalue(run)
    assert [x for x in r["record"] if x[0] == "save"] == [("save", 1, async_save),
                                                          ("save", 1, False)]
    assert not r["pending"]
    assert {"g_00000001", "do_00000001"} <= set(os.listdir(r["h"].checkpoint_path))


def test_loop_that_raises_leaves_its_save_on_disk(nan_run):
    """The NaN step follows the asynchronous save of step 1, whose write is
    still held back: train waits for it before it passes the error on."""
    r = nan_run
    assert [x for x in r["record"] if x[0] == "save"] == [("save", 1, True)]
    assert not r["pending"]
    assert {"g_00000001", "do_00000001"} <= set(os.listdir(r["h"].checkpoint_path))


def test_joint_loop_saves_async_and_reads_neither_other_knob(tmp_path, joint_files,
                                                            monkeypatch):
    """As nvse_tpu/train/loop_joint.py: async_checkpoint only. debug_nans and
    profile_dir set: no anomaly mode in its steps, no trace."""
    record = []
    _spy(monkeypatch, record)
    h = _loop_config(tmp_path, joint_files, checkpoint_interval=1, skip_step0_validation=True,
                     debug_nans=True, profile_dir=str(tmp_path / "prof"), profile_steps=1)
    logs = []
    train_joint(h, device="cpu", log_fn=logs.append)
    assert record == [("step", False), ("step", False), ("save", 1, True), ("save", 1, False)]
    assert not os.path.exists(tmp_path / "prof")
    assert not any("anomaly" in l or "profiler" in l for l in logs)
    assert not ckpt._PENDING
