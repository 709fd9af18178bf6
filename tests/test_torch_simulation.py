"""The port's ``Simulation`` session against the JAX package's.

Every scenario of tests/test_simulation.py runs once through
``rmf_crowdsim_tpu.Simulation`` and once through
``rmf_crowdsim_tpu_torch.Simulation(..., device="cpu")``, written once
against either package.  Each returns what it observed (live agents by
uid, listener sequences, counts, query results, errors), and the two
observations must agree: exactly in the ``NoLocalPlan`` scenes, where both
packages do the same float operations, and to rtol = atol = 2e-4 where
Zanlungo forces are summed (the JAX package's kernel tolerance).  Listener
sequences are compared exactly.  Then the session's error paths, the
tiered nearest-neighbour query, custom generators, the default device,
and one ``grid_pallas`` session (JAX in interpret mode) that reaches the
plain versions of K1, K2 and K3.  The port delivers each kind of event in
uid order and the JAX session in slot order; the two agree wherever a
step's events of one kind lie in uid order by slot, as in every scenario
here without a presort; the ``grid_pallas`` case compares each step's
events as sorted by uid.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
import rmf_crowdsim_tpu_torch as T
from rmf_crowdsim_tpu.utils import validate as jvalidate
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.ops import pack, spill
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.utils import validate as tvalidate

GRID = dict(width=1000.0, height=1000.0, cell_size=20.0,
            offset=(-500.0, -500.0))
TOL = 2e-4
VALIDATE = {J: jvalidate, T: tvalidate}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: at these sizes it is about as fast as
    many, and far faster when the suite's parallel workers share the
    cores (each worker's thread pool would otherwise claim them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def new_sim(pkg, cfg, **kw):
    if pkg is T:
        kw["device"] = "cpu"
    return pkg.Simulation(cfg, **kw)


def make_sim(pkg, backend="brute", capacity=64, **kw):
    cfg = pkg.SimConfig(capacity=capacity, grid=pkg.GridConfig(**GRID),
                        neighbor_backend=backend, max_eyesight=100.0, **kw)
    return new_sim(pkg, cfg)


def tensor(pkg, value, dtype):
    if pkg is J:
        return jnp.asarray(value, dtype)
    return torch.as_tensor(np.asarray(value, dtype))


def log_listener(pkg):
    """A listener of ``pkg`` that records every event, in order: (kind,
    uid, position as floats)."""

    class Log(pkg.EventListener):
        def __init__(self):
            self.events = []

        def agent_spawned(self, position, agent_id):
            self.events.append(("spawn", agent_id,
                                tuple(float(p) for p in position)))

        def agent_destroyed(self, agent_id):
            self.events.append(("destroy", agent_id))

        def waypoint_reached(self, position, agent_id):
            self.events.append(("waypoint", agent_id,
                                tuple(float(p) for p in position)))

        def of(self, kind):
            return [e[1] for e in self.events if e[0] == kind]

    return Log()


def stream(pkg, source=(0.0, 0.0), waypoints=((20.0, 0.0),), rate=1.0,
           hl=None, lp=None, **kw):
    """The event_listeners_test.rs SourceSink (source, sink at (20, 0),
    radius 1, MonotonicCrowd(1), ConstantVelocity((1, 0)))."""
    return pkg.SourceSink(
        source=source, waypoints=list(waypoints), radius_sink=1.0,
        crowd_generator=pkg.MonotonicCrowd(rate),
        high_level_planner=hl or pkg.ConstantVelocity((1.0, 0.0)),
        local_planner=lp or pkg.NoLocalPlan(), agent_eyesight_range=5.0,
        **kw)


def snapshot(sim):
    """Live agents by uid: (position, velocity, preferred velocity, next
    waypoint, eyesight) as floats."""
    return {k: (tuple(map(float, v.position)), tuple(map(float, v.velocity)),
                tuple(map(float, v.preferred_vel)), v.next_waypoint,
                float(v.eyesight_range))
            for k, v in sim.agents.items()}


def raises(fn, exc, match=None):
    """The name of the error that ``fn()`` raises, after pytest has checked
    it against ``exc`` and ``match``."""
    with pytest.raises(exc, match=match) as e:
        fn()
    return type(e.value).__name__


# --- the scenarios of tests/test_simulation.py, once for either package ---


def sc_step_integration(pkg):
    sim = make_sim(pkg)
    ids = sim.add_agents([(0.0, 0.0)], pkg.ConstantVelocity((1.0, 0.0)),
                         pkg.NoLocalPlan(), agent_eyesight_range=100.0)
    before = sim.num_agents
    sim.step(1.0)
    pos = np.asarray(sim.agents[0].position)
    assert np.linalg.norm(pos - np.array([1.0, 0.0])) < 1e-5
    return dict(ids=ids, before=before, after=snapshot(sim))


def _listener_api(pkg, backend):
    sim = make_sim(pkg, backend=backend)
    log = log_listener(pkg)
    sim.add_event_listener(log)
    sim.add_source_sink(stream(pkg))
    pop = []
    for _ in range(40):
        pop.append((sim.num_agents, len(log.of("spawn")),
                    len(log.of("destroy"))))
        sim.step(1.0)
    assert pop[:20] == [(s, s, 0) for s in range(20)]
    assert pop[20:] == [(20, s, s - 20) for s in range(20, 40)]
    return dict(pop=pop, events=log.events, agents=snapshot(sim))


def sc_event_listener_source_sink_api_brute(pkg):
    return _listener_api(pkg, "brute")


def sc_event_listener_source_sink_api_grid(pkg):
    return _listener_api(pkg, "grid")


def sc_spawn_clearance_blocks(pkg):
    sim = make_sim(pkg)
    hl = pkg.ConstantVelocity((0.0, 0.0))
    lp = pkg.NoLocalPlan()
    sim.add_agents([(0.0, 0.0)], hl, lp, 5.0)
    sim.add_source_sink(stream(pkg, hl=hl, lp=lp))
    sim.step(1.0)
    assert sim.num_agents == 1
    return dict(n=sim.num_agents,
                dropped=int(sim.last_events.spawn_dropped))


def sc_many_sources_chunked_clearance(pkg):
    sim = make_sim(pkg, capacity=256)
    log = log_listener(pkg)
    sim.add_event_listener(log)
    hl = pkg.ConstantVelocity((0.0, 0.0))
    lp = pkg.NoLocalPlan()
    sim.add_agents([(x, 0.0) for x in (0.0, 10.0, 20.0)], hl, lp, 5.0)
    for i in range(70):
        sim.add_source_sink(stream(pkg, source=(i * 10.0, 0.0),
                                   waypoints=[(i * 10.0, 400.0)], hl=hl,
                                   lp=lp))
    sim.step(1.0)
    assert sim.num_agents == 70
    return dict(n=sim.num_agents, dropped=int(sim.last_events.spawn_dropped),
                events=log.events, agents=snapshot(sim))


def sc_loop_forever_wraps(pkg):
    sim = make_sim(pkg)
    sim.add_source_sink(stream(pkg, waypoints=[(3.0, 0.0)],
                               loop_forever=True))
    for _ in range(10):
        sim.step(1.0)
    agents = snapshot(sim)
    assert len(agents) > 1 and all(a[3] == 0 for a in agents.values())
    return dict(agents=agents)


def sc_remove_agents_and_events(pkg):
    sim = make_sim(pkg)
    log = log_listener(pkg)
    sim.add_event_listener(log)
    ids = sim.add_agents([(0.0, 0.0), (5.0, 0.0)],
                         pkg.ConstantVelocity((1.0, 0.0)), pkg.NoLocalPlan(),
                         5.0)
    sim.remove_agents(ids[0])
    err = raises(lambda: sim.remove_agents(ids[0]), KeyError)
    return dict(ids=ids, events=log.events, n=sim.num_agents, err=err)


def sc_agent_ids_never_reused(pkg):
    sim = make_sim(pkg, capacity=2)
    hl = pkg.ConstantVelocity((0.0, 0.0))
    lp = pkg.NoLocalPlan()
    a = sim.add_agents([(0.0, 0.0)], hl, lp, 5.0)[0]
    sim.remove_agents(a)
    b = sim.add_agents([(1.0, 0.0)], hl, lp, 5.0)[0]
    assert b == a + 1
    return dict(a=a, b=b, agents=snapshot(sim))


def sc_sim_time_advances(pkg):
    sim = make_sim(pkg)
    sim.add_agents([(0.0, 0.0)], pkg.ConstantVelocity((0.0, 0.0)),
                   pkg.NoLocalPlan(), 5.0)
    sim.step(0.5)
    sim.step(0.25)
    assert abs(sim.sim_time - 0.75) < 1e-6
    return dict(t=sim.sim_time)


def sc_public_spatial_queries(pkg):
    sim = make_sim(pkg)
    ids = sim.add_agents([(0.0, 0.0), (1.0, 0.0), (3.0, 0.0)],
                         pkg.ConstantVelocity((0.0, 0.0)), pkg.NoLocalPlan(),
                         5.0)
    near = sim.get_neighbours_in_radius(2.0, (0.0, 0.0))
    knn = sim.get_nearest_neighbours(2, (0.9, 0.0))
    assert set(near) == {ids[0], ids[1]} and knn == [ids[1], ids[0]]
    return dict(near=near, knn=knn)


def sc_state_invariants_clean_and_violations(pkg):
    v = VALIDATE[pkg]
    sim = make_sim(pkg)
    sim.add_agents([(0.0, 0.0), (1.0, 0.0)], pkg.ConstantVelocity((1.0, 0.0)),
                   pkg.NoLocalPlan(), 5.0)
    sim.step(0.5)
    v.check_state(sim.state)
    st = sim.state
    pos = np.asarray(st.position).copy()
    uid = np.asarray(st.uid).copy()
    pos[0, 0] = np.nan
    uid[1] = uid[0]
    bad = st.replace(position=tensor(pkg, pos, pos.dtype),
                     uid=tensor(pkg, uid, uid.dtype))
    report = {k: int(x) for k, x in v.validate_state(bad).items()}
    assert report["nonfinite_position"] == 1
    assert report["duplicate_live_uid"] == 1
    return dict(clean={k: int(x) for k, x in
                       v.validate_state(sim.state).items()},
                report=report,
                err=raises(lambda: v.check_state(bad), ValueError))


def sc_remove_source_sink_stops_spawning(pkg):
    sim = make_sim(pkg)
    sid = sim.add_source_sink(stream(pkg))
    pop = []
    for i in range(25):
        if i == 5:
            sim.remove_source_sink(sid)
        sim.step(1.0)
        pop.append(sim.num_agents)
    assert pop[4] == 5 and pop[9] == 5 and pop[-1] == 0
    return dict(pop=pop)


def sc_remove_one_of_equal_source_sinks(pkg):
    sim = make_sim(pkg)
    hl = pkg.ConstantVelocity((1.0, 0.0))
    lp = pkg.NoLocalPlan()
    gen = pkg.MonotonicCrowd(1.0)
    ss_a = pkg.SourceSink(source=(0.0, 0.0), waypoints=[(20.0, 0.0)],
                          radius_sink=1.0, crowd_generator=gen,
                          high_level_planner=hl, local_planner=lp,
                          agent_eyesight_range=5.0)
    ss_b = dataclasses.replace(ss_a)
    assert ss_a == ss_b
    sim.add_source_sink(ss_a)
    sid_b = sim.add_source_sink(ss_b)
    sim.remove_source_sink(sid_b)
    assert sim._inactive_sources == {1}
    pop = []
    for _ in range(4):
        sim.step(1.0)
        pop.append(sim.num_agents)
    assert pop[-1] > 0
    return dict(pop=pop, agents=snapshot(sim))


def sc_remove_event_listener(pkg):
    sim = make_sim(pkg)
    log = log_listener(pkg)
    lid = sim.add_event_listener(log)
    hl = pkg.ConstantVelocity((0.0, 0.0))
    sim.add_agents([(0.0, 0.0)], hl, pkg.NoLocalPlan(), 5.0)
    sim.remove_event_listener(lid)
    sim.add_agents([(1.0, 0.0)], hl, pkg.NoLocalPlan(), 5.0)
    assert len(log.events) == 1
    return dict(events=log.events)


def sc_set_priority_integer_guard(pkg):
    sim = make_sim(pkg, integer_priorities=True)
    ids = sim.add_agents([(0.0, 0.0)], pkg.ConstantVelocity((1.0, 0.0)),
                         pkg.NoLocalPlan(), agent_eyesight_range=1.0)
    sim.set_priority(ids[0], 5.0)
    errs = [raises(lambda: sim.set_priority(ids[0], p), ValueError,
                   match="integer_priorities")
            for p in (0.5, math.inf, -math.inf, math.nan)]
    return dict(errs=errs, priority=float(np.asarray(sim.state.priority)[0]))


def sc_set_priority_changes_right_of_way(pkg):
    def run(prio_a, prio_b):
        cfg = pkg.SimConfig(capacity=4, neighbor_backend="brute",
                            dtype="float64")
        sim = new_sim(pkg, cfg)
        z = pkg.Zanlungo(1.0, 1.0, 0.0, 2.0, 2.0, 0.3)
        ids = sim.add_agents([(0.0, 0.0), (1.0, 0.0)],
                             pkg.ConstantVelocity((0.0, 0.0)), z, 5.0)
        sim.state = sim.state.replace(velocity=tensor(
            pkg, [[1.0, 0.0], [-1.0, 0.0], [0, 0], [0, 0]], np.float64))
        sim.set_priority(ids[0], prio_a)
        sim.set_priority(ids[1], prio_b)
        sim.step(0.01)
        return {k: v[1] for k, v in snapshot(sim).items()}

    va, vb = run(0.0, 1.0), run(1.0, 0.0)
    assert va[0] != vb[0] or va[1] != vb[1]
    return dict(va=va, vb=vb)


def sc_run_matches_stepping(pkg):
    def build():
        sim = make_sim(pkg)
        sim.add_source_sink(stream(pkg))
        return sim

    a = build()
    for _ in range(25):
        a.step(1.0)
    b = build()
    counters = b.run(25, 1.0)
    assert snapshot(a) == snapshot(b)
    n_alive = np.asarray(counters.n_alive)
    assert n_alive[-1] == a.num_agents
    return dict(agents=snapshot(b), n_alive=n_alive.tolist())


def sc_out_of_bounds_event_flag(pkg):
    sim = make_sim(pkg)
    sim.add_agents([(400.0, 0.0)], pkg.ConstantVelocity((1000.0, 0.0)),
                   pkg.NoLocalPlan(), 5.0)
    sim.step(1.0)
    n_oob = int(np.asarray(sim.last_events.out_of_bounds).sum())
    assert n_oob == 1 and sim.num_agents == 1
    return dict(n_oob=n_oob, agents=snapshot(sim))


def sc_out_of_bounds_raise_mode(pkg):
    far = pkg.ConstantVelocity((1000.0, 0.0))
    errs = []
    for call in (lambda s: s.step(1.0), lambda s: s.run(3, 1.0)):
        sim = make_sim(pkg, on_out_of_bounds="raise")
        sim.add_agents([(400.0, 0.0)], far, pkg.NoLocalPlan(), 5.0)
        errs.append(raises(lambda: call(sim), pkg.OutOfBoundsError))
    sim = make_sim(pkg, on_out_of_bounds="raise")
    sim.add_agents([(0.0, 0.0)], pkg.ConstantVelocity((1.0, 0.0)),
                   pkg.NoLocalPlan(), 5.0)
    sim.step(1.0)
    sim.run(3, 1.0)
    assert sim.num_agents == 1
    errs.append(raises(lambda: make_sim(pkg, on_out_of_bounds="explode"),
                       ValueError))
    return dict(errs=errs, agents=snapshot(sim))


def sc_colocated_sources_presnapshot_clearance(pkg):
    pops = []
    for sources in ([(0.0, 0.0), (0.2, 0.0)], [(0.0, 0.0), (10.0, 0.0)]):
        sim = make_sim(pkg)
        for src in sources:
            sim.add_source_sink(stream(pkg, source=src,
                                       waypoints=[(50.0, 0.0)]))
        sim.step(1.0)
        pops.append((sim.num_agents, int(sim.last_events.spawn_dropped)))
        sim.step(1.0)
        pops.append(sim.num_agents)
    assert pops == [(2, 0), 4, (2, 0), 4]
    return dict(pops=pops)


def _streaming_sim(pkg, **cfg_kw):
    sim = make_sim(pkg, **cfg_kw)
    log = log_listener(pkg)
    sim.add_event_listener(log)
    sim.add_source_sink(stream(pkg))
    return sim, log


def sc_run_delivers_exact_event_stream(pkg):
    sim_a, log_a = _streaming_sim(pkg)
    for _ in range(45):
        sim_a.step(1.0)
    sim_b, log_b = _streaming_sim(pkg)
    counters = sim_b.run(45, 1.0)
    assert np.asarray(counters.n_alive).shape == (45,)
    assert log_b.events == log_a.events
    assert len(log_b.of("spawn")) == 45
    assert log_b.of("destroy")[:3] == [0, 1, 2]
    assert sim_a.agents.keys() == sim_b.agents.keys()
    return dict(events=log_b.events, agents=snapshot(sim_b))


def sc_run_event_stream_overflow_raises(pkg):
    sim = make_sim(pkg, event_stream_capacity=1)
    log = log_listener(pkg)
    sim.add_event_listener(log)
    for y in (0.0, 100.0):
        sim.add_source_sink(stream(pkg, source=(0.0, y),
                                   waypoints=[(20.0, y)]))
    err = raises(lambda: sim.run(5, 1.0), RuntimeError,
                 match="event_stream_capacity")
    return dict(err=err, events=log.events)


# Scenario -> tolerance of its float observations (None: exact).
SCENARIOS = {
    "step_integration": None,
    "event_listener_source_sink_api_brute": None,
    "event_listener_source_sink_api_grid": None,
    "spawn_clearance_blocks": None,
    "many_sources_chunked_clearance": None,
    "loop_forever_wraps": None,
    "remove_agents_and_events": None,
    "agent_ids_never_reused": None,
    "sim_time_advances": None,
    "public_spatial_queries": None,
    "state_invariants_clean_and_violations": None,
    "remove_source_sink_stops_spawning": None,
    "remove_one_of_equal_source_sinks": None,
    "remove_event_listener": None,
    "set_priority_integer_guard": None,
    "set_priority_changes_right_of_way": TOL,
    "run_matches_stepping": None,
    "out_of_bounds_event_flag": None,
    "out_of_bounds_raise_mode": None,
    "colocated_sources_presnapshot_clearance": None,
    "run_delivers_exact_event_stream": None,
    "run_event_stream_overflow_raises": None,
}


def assert_same(a, b, tol, where="obs"):
    """``a`` (JAX) equals ``b`` (port): containers item by item, floats
    exactly or within ``tol``, everything else exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], tol, f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, tol, f"{where}[{i}]")
    elif isinstance(a, float) and tol is not None:
        assert math.isclose(a, b, rel_tol=tol, abs_tol=tol), (where, a, b)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    scenario = globals()[f"sc_{name}"]
    assert_same(scenario(J), scenario(T), SCENARIOS[name])


# --- the session's error paths and the rest of its surface ---------------


def _crowded(pkg, **kw):
    """Five parked agents in one cell of a grid that holds two a cell."""
    sim = make_sim(pkg, backend="grid", max_per_cell=2, **kw)
    sim.add_agents([(float(i), 0.0) for i in range(5)],
                   pkg.ConstantVelocity((0.0, 0.0)),
                   pkg.Zanlungo(1.0, 1.0, 0.0, 2.0, 2.0, 0.3), 5.0)
    return sim


ERRORS = {
    "capacity_exceeded": (lambda pkg: make_sim(pkg, capacity=2).add_agents(
        [(0.0, 0.0)] * 3, pkg.ConstantVelocity((0.0, 0.0)),
        pkg.NoLocalPlan(), 5.0), ValueError, "capacity exceeded"),
    "custom_without_neighbor_fn": (lambda pkg: make_sim(
        pkg, backend="custom"), ValueError, "neighbor_fn"),
    "truncation_step": (lambda pkg: _crowded(pkg).step(0.1),
                        "NeighborTruncationError", "lost neighbor"),
    "truncation_run": (lambda pkg: _crowded(pkg).run(2, 0.1),
                       "NeighborTruncationError", "lost neighbor"),
    "set_priority_unknown_id": (lambda pkg: make_sim(pkg).set_priority(
        7, 1.0), KeyError, None),
    "set_target_unknown_id": (lambda pkg: make_sim(pkg).set_target(
        7, (0.0, 0.0)), KeyError, None),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_path_matches_jax(name):
    """Each package raises the same error, with the same message."""
    call, exc, match = ERRORS[name]
    messages = []
    for pkg in (J, T):
        e_type = getattr(pkg, exc) if isinstance(exc, str) else exc
        with pytest.raises(e_type, match=match) as e:
            call(pkg)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_truncation_ignored_keeps_stepping():
    """on_truncation='ignore' steps on and reports the count instead."""
    counts = []
    for pkg in (J, T):
        sim = _crowded(pkg, on_truncation="ignore")
        sim.step(0.1)
        counts.append(int(sim.last_events.neighbor_truncated))
    assert counts[0] == counts[1] > 0


def test_tiered_nearest_neighbours_match_jax():
    """Above ``knn_grid_threshold`` both packages answer from the cached
    grid binning through the ring ladder; the answers equal the JAX
    package's and the brute ones, before and after a step."""
    pos = np.random.default_rng(5).uniform(-40.0, 40.0, (200, 2))
    points = [(0.0, 0.0), (35.0, -39.0), (-60.0, 10.0), (12.3, 4.5)]
    out = {}
    for pkg in (J, T):
        cfg = pkg.SimConfig(capacity=256, grid=pkg.GridConfig(
            100.0, 100.0, 4.0, (-50.0, -50.0)), neighbor_backend="grid",
            max_per_cell=32, max_eyesight=4.0, knn_grid_threshold=64)
        sim = new_sim(pkg, cfg)
        sim.add_agents([tuple(p) for p in pos],
                       pkg.ConstantVelocity((0.5, 0.0)), pkg.NoLocalPlan(),
                       4.0)
        res = []
        for _ in range(2):
            res += [sim.get_nearest_neighbours(k, p) for p in points
                    for k in (1, 8, 40)]
            res += [sim.get_neighbours_in_radius(r, p) for p in points
                    for r in (3.0, 11.0)]
            sim.step(1.0)
        out[pkg] = res
    assert out[J] == out[T]
    d = np.linalg.norm(pos - np.asarray(points[3]), axis=1)
    assert out[T][11] == list(np.argsort(d, kind="stable")[:40])


class CountDown:
    """A host crowd generator (the reference's CrowdGenerator trait): asks
    for one agent on each of its first ``n`` calls."""

    def __init__(self, n):
        self.n = n

    def get_number_to_spawn(self, dt):
        self.n -= 1
        return int(self.n >= 0)


def test_custom_generator_run_steps_one_at_a_time():
    """With a host generator ``run()`` steps one at a time; its counters
    equal the JAX package's, also for zero steps."""
    out = {}
    for pkg in (J, T):
        sim = make_sim(pkg)
        log = log_listener(pkg)
        sim.add_event_listener(log)
        sim.add_source_sink(dataclasses.replace(
            stream(pkg), crowd_generator=CountDown(3)))
        empty = sim.run(0, 1.0)
        c = sim.run(6, 1.0)
        out[pkg] = dict(
            empty=[np.asarray(getattr(empty, f)).shape
                   for f in ("n_alive", "neighbor_truncated")],
            counters={f.name: np.asarray(getattr(c, f.name)).tolist()
                      for f in dataclasses.fields(c)},
            events=log.events, agents=snapshot(sim))
    assert out[T]["counters"]["n_spawned"] == [1, 1, 1, 0, 0, 0]
    assert_same(out[J], out[T], None)


def test_simulation_defaults_to_the_card():
    """``Simulation()`` with no device puts its state on the card; without
    one it raises, as torch does."""
    cfg = T.SimConfig(capacity=4)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            T.Simulation(cfg)
    else:
        assert T.Simulation(cfg).state.position.device.type == "cuda"


# --- grid_pallas: the session through the plain K1, K2 and K3 -----------

N_PALLAS = 256
HOTSPOT = (1.0, 1.0)   # inside one 5.3 m tile of the 256-agent world


def _pallas_session(pkg, config):
    """The 256-agent bench crowd with its 48-agent hotspot (buckets
    overflow, so spills reach K2) and four SourceSinks whose agents reach
    their waypoints within a few steps of dt = 0.1."""
    sim = new_sim(pkg, config)
    log = log_listener(pkg)
    sim.add_event_listener(log)
    pos = scenes.bench_positions(N_PALLAS, config.grid.width, hotspot=True,
                                 hotspot_origin=HOTSPOT)
    lp = pkg.Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=20.0)
    sim.add_agents([tuple(p) for p in pos], pkg.ParityVelocity((1.0, 0.0)),
                   lp, 2.0)
    hl = pkg.ConstantVelocity((1.0, 0.0))
    for x, y in ((-8.0, -8.0), (-8.0, 6.0), (6.0, -8.0), (7.0, 7.0)):
        sim.add_source_sink(pkg.SourceSink(
            source=(x, y), waypoints=[(x + 0.3, y), (x + 1.25, y)],
            radius_sink=1.0, crowd_generator=pkg.MonotonicCrowd(60.0),
            high_level_planner=hl, local_planner=lp,
            agent_eyesight_range=2.0))
    return sim, log


def _by_uid(sim):
    st = sim.state
    alive = np.asarray(st.alive)
    uid = np.asarray(st.uid)[alive]
    order = np.argsort(uid)
    return uid[order], np.asarray(st.position)[alive][order]


def test_grid_pallas_session_matches_jax(monkeypatch):
    calls = {"K1": 0, "K2": 0, "K3": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tzb, "forces_bucketed_plain",
                        counted("K1", tzb.forces_bucketed_plain))
    monkeypatch.setattr(spill, "spill_window_plain",
                        counted("K2", spill.spill_window_plain))
    monkeypatch.setattr(pack, "pack_rows_plain",
                        counted("K3", pack.pack_rows_plain))
    tcfg = scenes.bench_config(N_PALLAS)
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    fields["grid"] = J.GridConfig(**dataclasses.asdict(tcfg.grid))
    fields["pallas_interpret"] = True
    jcfg = J.SimConfig(**fields)
    tcfg = dataclasses.replace(tcfg, capacity=N_PALLAS + 16)
    jcfg = dataclasses.replace(jcfg, capacity=N_PALLAS + 16)

    out = {}
    for pkg, cfg in ((J, jcfg), (T, tcfg)):
        sim, log = _pallas_session(pkg, cfg)
        for _ in range(3):
            sim.step(0.1)
        steps = list(log.events)
        sim2, log2 = _pallas_session(pkg, cfg)
        c = sim2.run(3, 0.1)
        out[pkg] = (sim, steps, sim2, log2.events,
                    int(np.asarray(c.n_waypoint_reached).sum()))
    j_sim, j_ev, j_sim2, j_ev2, _ = out[J]
    t_sim, t_ev, t_sim2, t_ev2, t_reached = out[T]
    assert min(calls.values()) > 0, calls
    assert t_reached > 0
    # The port's step() and run() deliver the same sequence (uid order
    # within a kind); the JAX session's orders follow its slots.
    assert t_ev == t_ev2
    spawned = N_PALLAS
    for j, t in ((j_ev, t_ev), (j_ev2, t_ev2)):
        assert j[:spawned] == t[:spawned]          # add_agents, in order
        assert sorted(e[:2] for e in j[spawned:]) == sorted(
            e[:2] for e in t[spawned:])
    for a, b in ((j_sim, t_sim), (j_sim2, t_sim2), (t_sim, t_sim2)):
        ua, pa = _by_uid(a)
        ub, pb = _by_uid(b)
        np.testing.assert_array_equal(ua, ub)
        np.testing.assert_allclose(pa, pb, rtol=TOL, atol=TOL)
