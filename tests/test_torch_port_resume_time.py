"""Port parity: a JAX training run resumed in the port, for a narrowed HiFiGAN
(time trainer, MPD + MSD with its spectral-norm u), with the harness and limits
of tests/test_torch_port_resume.py (its own file so that the resumed runs
spread over two test workers); and the converter's step choice and its refusal
of a do_ whose b_ih and b_hh moments differ, naming the port's parameter.
"""
import json
import os
import shutil

import pytest

import jax

from nvse_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from test_torch_port_joint import _one_torch_thread  # noqa: F401
from test_torch_port_resume import (_converter, _jax_run, check_next_metrics,
                                    check_next_moments_and_updates, check_restored_state,
                                    resume_case)


@pytest.fixture
def bundles(tmp_path):
    """A directory for JAX and port bundles, removed after the test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", params=["HiFiGAN"])
def resumed(request, tmp_path_factory):
    return resume_case(request.param, tmp_path_factory)


def test_restored_state_is_the_jax_state_after_its_step(resumed):
    check_restored_state(resumed)


def test_next_step_metrics_match_jax(resumed):
    check_next_metrics(resumed)


def test_next_step_moments_and_updates_match_jax(resumed):
    check_next_moments_and_updates(resumed)


def test_converter_raises_where_the_two_bias_moments_differ(bundles):
    """A do_ whose first moment of one b_hh leaf is moved off its b_ih's: the
    converter names the port's summed bias and writes nothing. (The JAX states
    before any step: no step to compile; the unmoved bundles convert in the
    `resumed` fixture.)"""
    h, _, _, gen_state, disc_state, _ = _jax_run("BSRNN")
    moved = []

    def move(path, x):
        name = jax.tree_util.keystr(path)
        if ".mu" in name and "b_hh_" in name and not moved:
            moved.append(name)
            return x + 1e-3
        return x

    opt = jax.tree_util.tree_map_with_path(move, gen_state.opt_state)
    assert moved
    bad = str(bundles / "jax")
    jax_save_checkpoint(bad, 0, 0, gen_state.replace(opt_state=opt), disc_state)
    cfg = str(bundles / "config.json")
    with open(cfg, "w") as f:
        json.dump(dict(h), f)
    out = str(bundles / "port")
    with pytest.raises(ValueError, match=r"\.b_(fwd|bwd): the JAX moments of b_ih and b_hh"):
        _converter().convert_run(cfg, bad, out)
    assert not os.path.exists(out)


def test_converter_takes_a_given_step_and_refuses_a_missing_one(bundles):
    """Of two saved pairs the converter takes the one asked for (the fixture
    takes the newest), and a step with no pair raises before any work."""
    h, _, _, gen_state, disc_state, _ = _jax_run("HiFiGAN")
    jax_dir = str(bundles / "jax")
    for step in (3, 5):
        jax_save_checkpoint(jax_dir, step, 0, gen_state, disc_state, max_to_keep=0)
    cfg = str(bundles / "config.json")
    with open(cfg, "w") as f:
        json.dump(dict(h), f)
    conv, out = _converter(), str(bundles / "port")
    assert conv.convert_run(cfg, jax_dir, out, step=3) == 3
    assert sorted(os.listdir(out)) == ["do_00000003", "g_00000003"]
    with pytest.raises(FileNotFoundError, match="step 4"):
        conv.convert_run(cfg, jax_dir, out, step=4)
