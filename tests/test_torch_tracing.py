"""The port's spans and counter (``utils/profiling.py``) inside the step,
the rollout and the session: on exactly while a ``torch.profiler`` session
is active, nested as the step runs its phases, in the profiler's own
events, and with no effect on what the program computes or on the
operations it runs.  The store: only a span opened with ``device=True``
records timing events, ``trace`` clears it as it starts, and it holds
at most ``MAX_RECORDS`` spans.

The scene: ``scenes.build_streams`` at 1,024 agents with 16 sources on
``grid_pallas``, stepped 6 times on the CPU.
"""

import contextlib
import dataclasses

import pytest
import torch

import rmf_crowdsim_tpu_torch as T
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.core import step as step_mod
from rmf_crowdsim_tpu_torch.core.step import build_step, empty_skin
from rmf_crowdsim_tpu_torch.utils import profiling

N_AGENTS = 1024
CAPACITY = N_AGENTS + 256
N_SOURCES = 16
STEPS = 6
DT = 1.0 / 60.0
# A step's spans in the order they open: (name, name of the enclosing
# span or None at the top).
STEP_SPANS = (
    ("crowdsim.step", None),
    ("crowdsim.step.spawn", "crowdsim.step"),
    ("crowdsim.step.spawn_gate", "crowdsim.step.spawn"),
    ("crowdsim.step.read", "crowdsim.step"),
    ("crowdsim.step.sort", "crowdsim.step"),
    ("crowdsim.step.high_level", "crowdsim.step"),
    ("crowdsim.step.force_pass", "crowdsim.step"),
    ("crowdsim.step.finish", "crowdsim.step"),
    ("crowdsim.rollout.record", None),
)


@pytest.fixture(autouse=True)
def one_thread_and_a_clean_store():
    """One intra-op thread a test (the suite's workers share the cores)
    and an empty span store before and after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _streams():
    return scenes.build_streams(N_AGENTS, CAPACITY, N_SOURCES,
                                device="cpu")


def _rollout():
    rollout, params, state = _streams()
    return rollout(params, state, DT, STEPS)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _flat(x):
    """The tensors of a state or record dataclass, by field name."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": t for k, t in _flat(v).items()})
    return out


def test_off_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _rollout()
    assert entered == []
    assert profiling.records() == []
    assert profiling.counters() == {}
    # The null context is one shared object.
    assert profiling.span("a") is profiling.span("b")


def test_each_step_nests_its_phases_in_order():
    prof, _ = _profiled(_rollout)
    recs = profiling.records()
    assert all(r.t1_ns >= r.t0_ns > 0 for r in recs)
    assert all(r.device_ms is None for r in recs)     # no CUDA here
    steps = [r for r in recs if r.name == "crowdsim.step"]
    assert len(steps) == STEPS
    for k in range(STEPS):
        mine = [r for r in recs if r.step == k]
        got = [(r.name, recs[r.parent].name if r.parent >= 0 else None)
               for r in mine]
        assert got == list(STEP_SPANS)
        # Children lie inside their parent's host interval.
        for r in mine:
            if r.parent >= 0:
                p = recs[r.parent]
                assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns


def test_profiler_events_hold_every_span():
    prof, _ = _profiled(_rollout)
    names = {e.name for e in prof.events()}
    assert {n for n, _ in STEP_SPANS} <= names


def test_resorts_count_the_skin_carry():
    config = scenes.stream_config(N_AGENTS, CAPACITY)
    src = scenes.stream_sources(N_SOURCES, config.grid.width)
    hl, lp = scenes.stream_planners(
        scenes.stream_routes(src, config.tdtype, "cpu"))
    step = build_step(config, hl, lp, skin_mode=True)
    _, params, state = _streams()

    def run():
        skin = empty_skin(config, "cpu")
        resorted = 0
        st = state
        for _ in range(STEPS):
            st, _, skin = step(params, st, DT, skin)
            resorted += skin["resorted"]
        return resorted

    _, resorted = _profiled(run)
    # The first step sorts (its carry starts invalid).
    assert 1 <= resorted <= STEPS
    assert profiling.counters() == {"crowdsim.resorts": resorted}


def test_tracing_changes_nothing_computed():
    st_off, rec_off = _rollout()
    _, (st_on, rec_on) = _profiled(_rollout)
    for a, b in ((st_off, st_on), (rec_off, rec_on)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k


def test_spans_add_no_operation(monkeypatch):
    def aten_ops():
        prof, _ = _profiled(_rollout)
        return sum(1 for e in prof.events() if e.name.startswith("aten::"))

    with_spans = aten_ops()
    assert any(r.name == "crowdsim.step" for r in profiling.records())
    monkeypatch.setattr(step_mod, "span",
                        lambda *a, **k: contextlib.nullcontext())
    assert aten_ops() == with_spans


def test_session_step_stores_one_read():
    sim = T.Simulation(T.SimConfig(capacity=8), device="cpu")
    sim.add_agents([(0.0, 0.0)], T.ConstantVelocity((1.0, 0.0)),
                   T.NoLocalPlan(), 1.0)
    sim.add_event_listener(T.EventListener())
    _profiled(lambda: sim.step(0.1))
    names = [r.name for r in profiling.records()]
    assert names.count("crowdsim.session.read") == 1
    assert names.count("crowdsim.step") == 1


class _Event:
    """A stand-in for ``torch.cuda.Event``: counts its records."""

    def __init__(self, enable_timing=False):
        self.recorded = 0

    def record(self, stream=None):
        self.recorded += 1


def test_only_device_spans_record_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)

    def run():
        with profiling.span("host"):
            pass
        with profiling.span("dev", device=True):
            pass

    _profiled(run)
    host, dev = profiling._store.records
    assert host.events is None
    assert [e.recorded for e in dev.events] == [1, 1]


def test_trace_keeps_only_its_own_block(tmp_path):
    def block():
        _rollout()
        return [r.step for r in profiling.records()
                if r.name == "crowdsim.step"]

    with profiling.trace(str(tmp_path / "a")):
        first = block()
    with profiling.trace(str(tmp_path / "b")):
        second = block()
    assert first == list(range(STEPS))
    assert second == list(range(STEPS))
    assert len(profiling.records()) == STEPS * len(STEP_SPANS)


def test_store_holds_at_most_its_bound(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(profiling, "MAX_RECORDS", 4)

    def run():
        for i in range(6):
            with profiling.span(f"s{i}"):
                with profiling.span(f"t{i}"):
                    pass

    _profiled(run)
    recs = profiling.records()
    assert [r.name for r in recs] == ["s0", "t0", "s1", "t1"]
    assert [r.parent for r in recs] == [-1, 0, -1, 2]
    assert all(r.t1_ns for r in recs)
    assert profiling.counters() == {profiling.DROPPED: 8}
    # Every span past the bound is still the profiler's event.
    assert len(entered) == 12
