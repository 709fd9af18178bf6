"""The reader of the program's ``crowdsim.graphed_steps`` counter
(``graphed_step_share``) against the store that a tiny CPU rollout under
``torch.profiler`` leaves, with the reader's context built by hand; and
through the harness's traced run of the streams cell at a tiny size."""

import types

import pytest
import torch

from benchmark.metrics import graphed_step_share
from benchmark.tests.tiny import run
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.utils import profiling

STEPS = 6


@pytest.fixture(autouse=True)
def clean_store():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _ctx(steps=STEPS):
    return types.SimpleNamespace(trace=types.SimpleNamespace(steps=steps))


def _traced_rollout():
    rollout, params, state = scenes.build_streams(1024, 1280, 16,
                                                  device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rollout(params, state, 1.0 / 60.0, STEPS)


def _count_graphed(n):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("crowdsim.graphed_steps", n)


def test_graphed_step_share_reads_the_counter():
    """None after a CPU rollout, whose steps are all eager; the counter
    over the steps where the program counted graphed steps."""
    _traced_rollout()
    assert graphed_step_share.read(_ctx()) is None
    _count_graphed(4)
    assert graphed_step_share.read(_ctx()) == pytest.approx(4 / STEPS)
    assert graphed_step_share.read(
        types.SimpleNamespace(trace=None)) is None


def test_graphed_step_share_none_after_reset():
    _count_graphed(STEPS)
    assert graphed_step_share.read(_ctx()) == pytest.approx(1.0)
    profiling.reset()
    assert graphed_step_share.read(_ctx()) is None


def test_graphed_step_share_none_without_the_store(monkeypatch):
    """A program that keeps no counters (the store's function absent),
    as the parent of the graphed step does."""
    _count_graphed(STEPS)
    monkeypatch.delattr(profiling, "counters")
    assert graphed_step_share.read(_ctx()) is None


def test_traced_harness_run_leaves_the_share_out_on_the_cpu():
    """The CPU rollout stays eager, so the traced line has no share."""
    rec, out = run("crowd_1m.streams", trace=True)
    assert out["correct"], out["checks"]
    assert "graphed_step_share" not in out["metrics"]
