"""The readers of the program's own spans and counter (``gate_device_ms``,
``read_wait_ms``, ``post_read_host_ms``, ``resorts_per_step``) against
the store that a tiny CPU rollout under ``torch.profiler`` leaves, with
the readers' context built by hand; and through the harness's traced run
of the streams cell at a tiny size."""

import types

import pytest
import torch

from benchmark.metrics import (gate_device_ms, post_read_host_ms,
                               read_wait_ms, resorts_per_step)
from benchmark.tests.tiny import run
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.utils import profiling

STEPS = 6
READERS = (gate_device_ms, read_wait_ms, post_read_host_ms,
           resorts_per_step)


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


def test_readers_read_what_the_store_holds():
    _traced_rollout()
    recs = profiling.records()
    reads = [r for r in recs if r.name == "crowdsim.step.read"]
    ends = {r.step: r.t1_ns for r in recs
            if r.name == "crowdsim.rollout.record"}
    assert len(reads) == len(ends) == STEPS
    assert read_wait_ms.read(_ctx()) == pytest.approx(
        sum(r.host_ms for r in reads) / STEPS)
    assert post_read_host_ms.read(_ctx()) == pytest.approx(
        sum(ends[r.step] - r.t1_ns for r in reads) * 1e-6 / STEPS)
    assert post_read_host_ms.read(_ctx()) > 0
    assert resorts_per_step.read(_ctx()) == pytest.approx(
        profiling.counters()["crowdsim.resorts"] / STEPS)
    # The CPU records no CUDA event.
    assert gate_device_ms.read(_ctx()) is None
    assert all(m.read(types.SimpleNamespace(trace=None)) is None
               for m in READERS)


def test_gate_device_ms_sums_the_gate_events(monkeypatch):
    _traced_rollout()
    recs = profiling.records()
    gates = [r for r in recs if r.name == "crowdsim.step.spawn_gate"]
    assert len(gates) == STEPS
    for i, r in enumerate(gates):
        r.device_ms = 0.5 + i
    monkeypatch.setattr(profiling, "records", lambda: recs)
    assert gate_device_ms.read(_ctx()) == pytest.approx(
        sum(0.5 + i for i in range(STEPS)) / STEPS)


def test_readers_return_none_after_reset():
    _traced_rollout()
    assert read_wait_ms.read(_ctx()) is not None
    profiling.reset()
    assert all(m.read(_ctx()) is None for m in READERS)


def test_readers_return_none_for_a_program_without_the_store(monkeypatch):
    """A program that records no spans (the store's functions absent)."""
    _traced_rollout()
    monkeypatch.delattr(profiling, "records")
    monkeypatch.delattr(profiling, "counters")
    assert all(m.read(_ctx()) is None for m in READERS)


def test_traced_harness_run_reports_the_span_metrics():
    rec, out = run("crowd_1m.streams", trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert {"read_wait_ms", "post_read_host_ms",
            "resorts_per_step"} <= set(got)
    assert "gate_device_ms" not in got          # no CUDA event on the CPU
    assert 0 < got["resorts_per_step"]["value"] <= 1
    assert got["resorts_per_step"]["unit"] == "resorts/step"
