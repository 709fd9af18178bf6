"""The step split at its read, and the rollout replayed as CUDA graphs
(``core/graphs.py``).

On the CPU: ``build_step``'s ``pre``, ``read`` and ``post`` composed by
hand are its step bit for bit, on a step that spawns and re-sorts, one
that carries its binning, and Poisson sources drawing from the state's
generator.  ``StepGraphs``' bookkeeping (its buffers, the records written
at the device-side step index, the copies out, the keys, the warm-up
before each capture and the counts) runs with each capture replaced by
a stand-in that re-runs the half and writes its outputs over the first
ones, as a graph's replay does: the rollout is then its eager rollout bit
for bit, over two calls, and a call leaves what an earlier one returned
untouched.  ``build_rollout`` on CPU states takes the eager path and
counts no graphed step; the ``custom`` backend builds no graphs.

On a card (marker ``card``; skips without one) the graphs are captured
for real: the graphed rollout against the eager one, field by field and
records too (a streams scene of 120 steps, all re-sort; a crowd without
sources, which carries; Poisson sources; an event stream), the wrappers'
launch counts under replay, the keys, the profiler's view of replayed
kernels and of the gate's device span, and a step that reads the host,
which stays eager.  Run there with ``python -m pytest --noconftest -m
card tests/test_torch_step_graphs.py``.  No JAX: the card has none.
"""

import dataclasses

import pytest
import torch

from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.core import graphs as graphs_mod
from rmf_crowdsim_tpu_torch.core.config import SimConfig
from rmf_crowdsim_tpu_torch.core.state import STATE_TENSOR_FIELDS
from rmf_crowdsim_tpu_torch.core.step import build_rollout
from rmf_crowdsim_tpu_torch.models.highlevel import ParityVelocity
from rmf_crowdsim_tpu_torch.models.source_sink import GEN_POISSON
from rmf_crowdsim_tpu_torch.ops import pack, spawn_gate, spill
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
from rmf_crowdsim_tpu_torch.utils import profiling

DT = 1.0 / 60.0
N = 1024
CAP = N + 256
SOURCES = 16


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


def _scene(kind, dev="cpu", n=N, cap=CAP, sources=SOURCES, k=0):
    """(rollout, params, state): ``streams`` (sources spawn every step,
    so every step re-sorts), ``crowd`` (no sources: the binning carries
    after the first step) or ``poisson`` (the streams' sources drawing
    Poisson(rate * dt) from the state's generator)."""
    if kind == "crowd":
        return scenes.build_bench(n, device=dev)
    rollout, params, st = scenes.build_streams(n, cap, sources, device=dev,
                                               event_capacity=k)
    if kind == "poisson":
        sp = params.sources
        params = dataclasses.replace(params, sources=sp.replace(
            gen_kind=torch.full_like(sp.gen_kind, GEN_POISSON)))
    return rollout, params, st


def _fork(st):
    """A copy of the state with a generator of its own in the same state."""
    gen = None
    if st.generator is not None:
        gen = torch.Generator(device=st.device)
        gen.set_state(st.generator.get_state())
    return st.replace(**{f: getattr(st, f).clone()
                         for f in STATE_TENSOR_FIELDS}, generator=gen)


def _tensors(x):
    """The tensors of a state, record, dict or tuple, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    return []


def _assert_bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _snapshot(x):
    return [t.clone() for t in _tensors(x)]


# --- the step split at its read ---------------------------------------------


@pytest.mark.parametrize("kind", ["streams", "crowd", "poisson"])
def test_pre_read_post_is_the_step(kind):
    """Four steps of ``build_step``'s step against its halves composed
    by hand from the same state and skin: states, events, skin carries
    and the generators' states bit for bit; the branch each took."""
    rollout, params, st = _scene(kind)
    step = rollout.graphs.step
    skin_a = rollout.graphs.empty_skin(st.device)
    skin_b = dict(skin_a)
    a, b = _fork(st), _fork(st)
    branches = []
    for _ in range(4):
        a, ev_a, skin_a = step(params, a, DT, skin_a)
        mid = step.pre(params, b, DT, skin_b)
        resort = step.read(mid[3])
        branches.append(resort)
        b, ev_b, skin_b = step.post(params, *mid[:3], DT, skin_b, resort)
        _assert_bitwise((a, ev_a, skin_a), (b, ev_b, skin_b))
        assert skin_a["resorted"] == skin_b["resorted"] == resort
        if a.generator is not None:
            assert torch.equal(a.generator.get_state(),
                               b.generator.get_state())
    assert branches[0]
    if kind == "crowd":
        assert branches == [True, False, False, False]


# --- the graphed rollout, its captures stood in for on the CPU --------------


def _copy_into(dst, src):
    for x, y in zip(_tensors(dst), _tensors(src)):
        x.copy_(y)


class EagerGraph:
    """A captured half on the CPU: each replay runs the half again, its
    spans and counters off as in a graph, and writes its outputs over the
    first replay's, as a graph's replay rewrites its output tensors in
    place."""

    spans = ()

    def __init__(self, body):
        self.body = body
        self.out = None

    def __call__(self):
        on = profiling._profiling
        profiling._profiling = lambda: False
        try:
            new = self.body()
        finally:
            profiling._profiling = on
        if self.out is None:
            self.out = new
        else:
            _copy_into(self.out, new)
        return self.out


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs engage on CPU states, each capture an :class:`EagerGraph`;
    yields the generators registered, a capture each."""
    captured = []

    def capture(body, owner, generator=None):
        captured.append(generator)
        return EagerGraph(body)

    monkeypatch.setattr(graphs_mod, "capture", capture)
    monkeypatch.setattr(graphs_mod.StepGraphs, "engages",
                        staticmethod(lambda state: True))
    return captured


class Rule:
    """The capture rule, kept by hand for one key: a half runs eagerly the
    first time it runs, is captured the next time (a ``post`` branch only
    once ``pre`` is) and is replayed from then on; a step is graphed when
    both its halves are replayed."""

    def __init__(self):
        self.warm, self.graphs = set(), set()
        self.captures = self.graphed = 0

    def step(self, resort: bool) -> None:
        graphed = True
        for half in ("pre", resort):
            if half not in self.graphs:
                if half in self.warm and (half == "pre"
                                          or "pre" in self.graphs):
                    self.graphs.add(half)
                    self.captures += 1
                else:
                    self.warm.add(half)
                    graphed = False
        self.graphed += graphed


def _branches(rollout):
    """The branches the graphed rollout takes, in order, as it takes them."""
    step, seen = rollout.graphs.step, []
    read = step.read

    def recorded(need):
        seen.append(read(need))
        return seen[-1]

    step.read = recorded
    return seen


@pytest.mark.parametrize("kind,k", [("streams", 0), ("streams", 8),
                                    ("crowd", 0), ("poisson", 8)])
def test_graphed_rollout_is_eager(stand_in, kind, k):
    """Two calls of 5 and 4 steps, the second from the first's state:
    states, generators and records bit for bit the eager rollout's; the
    first call's results untouched by the second; the captures and the
    graphed steps those of the rule (the crowd re-sorts its first step
    and carries after it); a generator registered with ``pre`` alone,
    where the scene has sources."""
    rollout, params, st = _scene(kind, k=k)
    g = rollout.graphs
    e1, r1 = rollout.eager(params, _fork(st), DT, 5)
    e2, r2 = rollout.eager(params, _fork(e1), DT, 4)
    seen = _branches(rollout)

    s1, q1 = rollout(params, _fork(st), DT, 5)
    kept = _snapshot((s1, q1))
    _assert_bitwise((s1, q1), (e1, r1))
    s2, q2 = rollout(params, _fork(s1), DT, 4)
    _assert_bitwise((s2, q2), (e2, r2))
    for x, y in zip(_tensors((s1, q1)), kept):
        assert torch.equal(x, y)
    if kind == "crowd":
        assert seen[:6] == [True, False, False, False, False, True]
    rule = Rule()
    for resort in seen:
        rule.step(resort)
    assert (g.captures, g.graphed_steps) == (rule.captures, rule.graphed)
    assert g.captures >= 2 and g.failure is None
    if kind == "poisson":
        assert torch.equal(s2.generator.get_state(), e2.generator.get_state())
    assert (stand_in[0] is None) == (kind == "crowd")
    assert stand_in[1:] == [None] * (g.captures - 1)


def test_keys_and_record_capacity(stand_in, monkeypatch):
    """A new episode (a fresh copy of the start state) captures only as
    the rule goes on for its key; new parameter tensors, another ``dt``
    and more steps than the records hold each replace the set, captured
    anew; every result is the eager one."""
    monkeypatch.setattr(graphs_mod, "MIN_STEPS", 4)
    rollout, params, st = _scene("streams")
    g = rollout.graphs
    seen = _branches(rollout)
    rules = {}

    def both(p, n, key, dt=DT):
        got = rollout(p, _fork(st), dt, n)
        _assert_bitwise(got, rollout.eager(p, _fork(st), dt, n))
        rule = rules.setdefault(key, Rule())
        for resort in seen:
            rule.step(resort)
        seen.clear()
        assert g.captures == sum(r.captures for r in rules.values())

    both(params, 3, "first")
    both(params, 3, "first")
    both(params, 2, "first")
    fresh = dataclasses.replace(params, lp=tuple(
        dataclasses.replace(p, agent_scale=p.agent_scale.clone())
        for p in params.lp))
    both(fresh, 3, "fresh")
    both(fresh, 3, "half dt", dt=DT / 2)
    both(fresh, 5, "8 rows")            # past the 4 rows the set holds
    both(fresh, 5, "8 rows")
    assert all(r.captures >= 2 for r in rules.values())
    assert g.failure is None


def test_failed_capture_stays_eager(monkeypatch):
    """A capture that raises (a step that reads the host) leaves the key
    eager: the call goes on eagerly, its result and every later call's
    the eager rollout's, and nothing is counted as graphed."""
    def capture(body, owner, generator=None):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs_mod, "capture", capture)
    monkeypatch.setattr(graphs_mod.StepGraphs, "engages",
                        staticmethod(lambda state: True))
    rollout, params, st = _scene("streams")
    for n in (4, 3):
        _assert_bitwise(rollout(params, _fork(st), DT, n),
                        rollout.eager(params, _fork(st), DT, n))
    g = rollout.graphs
    assert isinstance(g.failure, RuntimeError)
    assert g.captures == 0 and g.graphed_steps == 0


def test_graphed_steps_spans_and_counters(stand_in):
    """Under the profiler, the crowd (re-sort, then carries): every step
    keeps its ``crowdsim.step``, ``crowdsim.step.read`` and
    ``crowdsim.rollout.record`` spans and its ``crowdsim.resorts`` count;
    the phases inside a half record only where it runs eagerly (``pre``
    in step 0, the re-sort in step 0, the carry in step 1);
    ``crowdsim.graphed_steps`` counts the steps replayed whole and
    ``crowdsim.graph_captures`` the captures (``pre`` in step 1, the
    carry in step 2)."""
    rollout, params, st = _scene("crowd")
    seen = _branches(rollout)
    n = 4
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rollout(params, st, DT, n)
    assert seen == [True, False, False, False]
    recs = profiling.records()
    names = [r.name for r in recs]
    for name in ("crowdsim.step", "crowdsim.step.read",
                 "crowdsim.rollout.record"):
        assert names.count(name) == n
    assert [r.step for r in recs if r.name == "crowdsim.step.spawn"] == [0]
    assert "crowdsim.step.spawn_gate" not in names
    for name in ("crowdsim.step.sort", "crowdsim.step.high_level",
                 "crowdsim.step.force_pass", "crowdsim.step.finish"):
        assert [r.step for r in recs if r.name == name] == [0, 1]
    assert all(r.device_ms is None for r in recs)
    assert profiling.counters() == {"crowdsim.resorts": 1,
                                    "crowdsim.graphed_steps": n - 2,
                                    "crowdsim.graph_captures": 2}


def test_capturing_turns_spans_off():
    """Inside ``profiling.capturing`` a span is the null context and a
    counter counts nothing, under the profiler too; after it both record
    again."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.capturing() as spans:
            with profiling.span("crowdsim.step", new_step=True):
                profiling.count("crowdsim.resorts")
        assert spans == []
        with profiling.span("crowdsim.step", new_step=True):
            profiling.count("crowdsim.resorts")
    assert [r.name for r in profiling.records()] == ["crowdsim.step"]
    assert profiling.counters() == {"crowdsim.resorts": 1}


def test_cpu_rollout_stays_eager():
    """On CPU states ``build_rollout`` engages no graph: its result is
    the eager rollout's bit for bit, and no graphed step or capture is
    counted, under the profiler or off it."""
    rollout, params, st = _scene("streams", k=8)
    assert not rollout.graphs.engages(st)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = rollout(params, _fork(st), DT, 3)
    _assert_bitwise(got, rollout.eager(params, _fork(st), DT, 3))
    assert rollout.graphs.graphed_steps == rollout.graphs.captures == 0
    assert "crowdsim.graphed_steps" not in profiling.counters()
    assert rollout.graphs.set is None


def test_custom_backend_builds_no_graphs():
    """A user's ``neighbor_fn`` may read the host: ``custom`` stays eager."""
    config = SimConfig(capacity=8, neighbor_backend="custom")
    rollout = build_rollout(config, [], [], neighbor_fn=lambda st: None)
    assert rollout.graphs is None
    assert build_rollout(SimConfig(capacity=8), [], []).graphs is not None


# --- on the card ------------------------------------------------------------

CARD_N = 65_536
CARD_CAP = CARD_N + 4096
CARD_SOURCES = 256
COUNTED = {"pack_rows": pack.pack_rows, "spawn_blocked":
           spawn_gate.spawn_blocked, "spill_window": spill.spill_window,
           "zanlungo_bucketed": zb.zanlungo_forces_bucketed}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _launches():
    return {k: fn.launches for k, fn in COUNTED.items()}


@pytest.mark.card
@pytest.mark.parametrize("kind,k,steps,n", [
    ("streams", 0, 120, 1_000_000), ("crowd", 0, 40, CARD_N),
    ("poisson", 0, 30, CARD_N), ("streams", 64, 30, CARD_N)])
def test_graphed_equals_eager_on_the_card(kind, k, steps, n):
    """The graphed rollout against the eager one on the card, each from
    the same state and generator state: two calls, field by field and
    records too; the second call leaves the first's results untouched;
    the wrappers' launches under replay equal the eager ones; the
    captures and graphed steps those of the rule.  The 1M streams scene
    (1,024 sources) re-sorts every step, so it never captures the carry."""
    dev = _card()
    if n == 1_000_000:
        rollout, params, st = scenes.build_streams(n, 1_048_576, 1024,
                                                   device=dev)
    else:
        rollout, params, st = _scene(kind, dev, n, n + 4096, CARD_SOURCES,
                                     k)
    g = rollout.graphs
    n0 = _launches()
    e1, r1 = rollout.eager(params, _fork(st), DT, steps)
    e2, r2 = rollout.eager(params, _fork(e1), DT, steps // 2)
    n1 = _launches()
    seen = _branches(rollout)
    s1, q1 = rollout(params, _fork(st), DT, steps)
    kept = _snapshot((s1, q1))
    s2, q2 = rollout(params, _fork(s1), DT, steps // 2)
    n2 = _launches()
    torch.cuda.synchronize()
    assert g.failure is None
    rule = Rule()
    for resort in seen:
        rule.step(resort)
    assert (g.captures, g.graphed_steps) == (rule.captures, rule.graphed)
    if n == 1_000_000:
        assert all(seen) and g.captures == 2
    _assert_bitwise((s1, q1), (e1, r1))
    _assert_bitwise((s2, q2), (e2, r2))
    for x, y in zip(_tensors((s1, q1)), kept):
        assert torch.equal(x, y)
    assert {f: n2[f] - n1[f] for f in COUNTED} == {
        f: n1[f] - n0[f] for f in COUNTED}
    assert n2["zanlungo_bucketed"] - n1["zanlungo_bucketed"] == (
        steps + steps // 2)
    assert (n2["spawn_blocked"] - n1["spawn_blocked"]) == (
        0 if kind == "crowd" else steps + steps // 2)
    if kind == "poisson":
        assert torch.equal(s2.generator.get_state(), e2.generator.get_state())
    if kind == "crowd":
        assert int(q1.n_alive.min()) == n


@pytest.mark.card
@pytest.mark.parametrize("name", ["wide[grid_dense 7]", "wide[grid_pallas 1]"])
def test_generator_behind_a_busy_device(name, monkeypatch):
    """A capture begins while the eager warm-up step still runs on the
    device: ``brute``'s [N, N] tables at 4,096 slots, Poisson and
    monotonic sources (phase 10b's wide cases in ``run()``).  The
    graphed run is the eager run bit for bit: counters, state and
    generator."""
    dev = _card()
    (case,) = [c for c in scenes.wide_cases() if c.name == name]
    assert case.mode == "run"
    graphed = scenes.build_fuzz_session(case, "brute", dev)
    eager = scenes.build_fuzz_session(case, "brute", dev)
    got = graphed.run(case.n_steps, case.dt)
    monkeypatch.setattr(graphs_mod.StepGraphs, "engages",
                        staticmethod(lambda state: False))
    want = eager.run(case.n_steps, case.dt)
    (rollout,) = graphed._rollouts.values()
    assert rollout.graphs.graphed_steps == case.n_steps - 1
    _assert_bitwise((got, graphed.state), (want, eager.state))
    assert torch.equal(graphed.state.generator.get_state(),
                       eager.state.generator.get_state())


@pytest.mark.card
def test_keys_on_the_card():
    """A new episode captures nothing; new parameter tensors capture
    ``pre`` and the re-sort again (``crowdsim.graph_captures``), and the
    result is the eager one."""
    dev = _card()
    rollout, params, st = _scene("streams", dev, CARD_N, CARD_CAP,
                                 CARD_SOURCES)
    rollout(params, _fork(st), DT, 4)

    def captures(p):
        profiling.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = rollout(p, _fork(st), DT, 4)
            torch.cuda.synchronize()
        _assert_bitwise(got, rollout.eager(p, _fork(st), DT, 4))
        return profiling.counters().get("crowdsim.graph_captures", 0)

    assert captures(params) == 0
    fresh = dataclasses.replace(params, lp=tuple(
        dataclasses.replace(p, agent_scale=p.agent_scale.clone())
        for p in params.lp))
    assert captures(fresh) == 2
    assert captures(fresh) == 0


@pytest.mark.card
def test_profiler_sees_replayed_graphs():
    """A ``torch.profiler`` session over a graphed rollout (captured
    before the session) records K1's kernel once a step, the gate's
    device span a step with its time, and every step as graphed."""
    from benchmark.trace import K1_KERNEL

    dev = _card()
    rollout, params, st = _scene("streams", dev, CARD_N, CARD_CAP,
                                 CARD_SOURCES)
    rollout(params, _fork(st), DT, 4)
    n = 6
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        rollout(params, _fork(st), DT, n)
        torch.cuda.synchronize()
    k1 = [e for e in prof.profiler.kineto_results.events()
          if K1_KERNEL in e.name()]
    assert len(k1) == n
    gates = [r for r in profiling.records()
             if r.name == "crowdsim.step.spawn_gate"]
    assert [r.step for r in gates] == list(range(n))
    assert all(0 < r.device_ms < 50 for r in gates)
    assert profiling.counters()["crowdsim.graphed_steps"] == n


class HostReading(ParityVelocity):
    """A planner that reads the host in its step."""

    def plan(self, params, state):
        if float(state.sim_time) < 0:
            raise AssertionError("negative time")
        return super().plan(params, state)


@pytest.mark.card
def test_host_read_stays_eager_on_the_card():
    """A step that reads the host fails its capture: the rollout goes on
    eagerly, bit for bit the eager rollout, and counts no graphed step."""
    dev = _card()
    _, params, st = _scene("crowd", dev, 4096)
    config = scenes.bench_config(4096)
    rollout = build_rollout(config, [HostReading((1.0, 0.0))],
                            [scenes.bench_zanlungo()])
    got = rollout(params, _fork(st), DT, 4)
    _assert_bitwise(got, rollout.eager(params, _fork(st), DT, 4))
    assert rollout.graphs.failure is not None
    assert rollout.graphs.graphed_steps == 0
    _assert_bitwise(rollout(params, _fork(st), DT, 3),
                    rollout.eager(params, _fork(st), DT, 3))
