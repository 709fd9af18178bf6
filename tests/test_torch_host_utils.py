"""The port's host utilities and examples against the JAX package's.

``utils/validate.py`` against the JAX ``validate_state`` on clean and
violated states; ``utils/profiling.py`` (``StepTimer.summary`` against the
JAX timer's on the same times, ``trace`` writing a Chrome trace on the
CPU, the program's spans inside it); ``utils/registry.py`` against the JAX
``Registry``; and each example of ``rmf_crowdsim_tpu_torch/examples`` —
its ``build()`` stepped against the JAX example of ``examples/`` (loaded
with ``importlib``) to rtol = atol = 2e-4 by uid, and its ``main`` run
headless on the CPU.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
import rmf_crowdsim_tpu_torch as T
from rmf_crowdsim_tpu.utils import profiling as jprofiling
from rmf_crowdsim_tpu.utils import registry as jregistry
from rmf_crowdsim_tpu.utils import validate as jvalidate
from rmf_crowdsim_tpu_torch.examples import multi_room, threes_a_crowd
from rmf_crowdsim_tpu_torch.utils import convert
from rmf_crowdsim_tpu_torch.utils import profiling as tprofiling
from rmf_crowdsim_tpu_torch.utils import registry as tregistry
from rmf_crowdsim_tpu_torch.utils import validate as tvalidate

TOL = 2e-4
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "examples")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: at these sizes it is about as fast as
    many, and far faster when the suite's parallel workers share the
    cores (each worker's thread pool would otherwise claim them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(n=64, seed=0):
    """A numpy state of ``n`` slots, 40 of them live, from numpy seed
    ``seed``."""
    rng = np.random.default_rng(seed)
    st = convert.state_to_numpy(T.make_state(T.SimConfig(capacity=n),
                                             device="cpu"))
    st["alive"][:40] = True
    st["uid"][:40] = rng.permutation(40)
    st["next_uid"] = np.int32(40)
    st["position"][:] = rng.uniform(-5.0, 5.0, (n, 2))
    st["velocity"][:] = rng.uniform(-1.0, 1.0, (n, 2))
    return st


def _violate(st, kind):
    if kind == "nonfinite_position":
        st["position"][[3, 50]] = np.inf          # 50 is dead: not counted
    elif kind == "nonfinite_velocity":
        st["velocity"][[1, 2], 1] = np.nan
    elif kind == "negative_live_uid":
        st["uid"][4] = -2
    elif kind == "duplicate_live_uid":
        st["uid"][[5, 6, 7]] = st["uid"][8]
    elif kind == "uid_above_allocator":
        st["uid"][9] = 41
    elif kind == "waypoint_negative":
        st["next_waypoint"][[10, 60]] = -1
    return st


KINDS = ("clean", "nonfinite_position", "nonfinite_velocity",
         "negative_live_uid", "duplicate_live_uid", "uid_above_allocator",
         "waypoint_negative")


@pytest.mark.parametrize("kind", KINDS)
def test_validate_state_matches_jax(kind):
    st = _violate(_state(), kind)
    jst = J.core.state.SimState(
        **st, rng_key=np.zeros((2,), np.uint32))
    j = {k: int(v) for k, v in jvalidate.validate_state(jst).items()}
    t_state = convert.state_from_numpy(st, device="cpu")
    t = {k: int(v) for k, v in tvalidate.validate_state(t_state).items()}
    assert t == j
    assert (sum(t.values()) == 0) == (kind == "clean")
    if kind == "clean":
        tvalidate.check_state(t_state)
    else:
        assert t[kind] > 0
        with pytest.raises(ValueError, match=kind):
            tvalidate.check_state(t_state)


def test_step_timer_summary_matches_jax():
    times = [0.010, 0.002, 0.030, 0.004, 0.005]
    jt, tt = jprofiling.StepTimer(), tprofiling.StepTimer()
    assert tt.summary() == jt.summary() == {"steps": 0}
    for s in times:
        jt.record(s)
        tt.record(s)
    assert tt.count == 5
    assert tt.summary() == jt.summary()
    x = torch.ones(3)
    with tt.step(sync_leaf=x):
        x = x * 2
    assert tt.count == 6 and tt.summary()["steps"] == 6
    tt.reset()
    assert tt.summary() == {"steps": 0}


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` writes ``trace.json`` under ``log_dir`` on the CPU, with
    the spans that ``span`` and the session's step named inside it."""
    sim = T.Simulation(T.SimConfig(capacity=8), device="cpu")
    sim.add_agents([(0.0, 0.0)], T.ConstantVelocity((1.0, 0.0)),
                   T.NoLocalPlan(), 1.0)
    log_dir = str(tmp_path / "trace")
    with tprofiling.trace(log_dir):
        with tprofiling.span("crowd_step"):
            sim.step(0.1)
    path = os.path.join(log_dir, tprofiling.TRACE_FILE)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"crowd_step", "crowdsim.step", "crowdsim.step.finish"} <= names
    tprofiling.reset()


def test_registry_matches_jax():
    log = []
    for mod in (jregistry, tregistry):
        r = mod.Registry()
        ids = [r.add_new_item(x) for x in "abc"]
        r.remove(1)
        r.remove(7)
        ids.append(r.add_new_item("d"))
        log.append((ids, len(r), list(r.values()), list(r.items()),
                    dict(r.registry)))
    assert log[0] == log[1]
    assert log[1][0] == [0, 1, 2, 3]


def _load_example(name):
    """The JAX package's example ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_uid(sim):
    st = sim.state
    alive = np.asarray(st.alive)
    uid = np.asarray(st.uid)[alive]
    order = np.argsort(uid)
    return uid[order], np.asarray(st.position)[alive][order]


def _assert_same_crowd(jsim, tsim):
    ju, jp = _by_uid(jsim)
    tu, tp = _by_uid(tsim)
    np.testing.assert_array_equal(ju, tu)
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)


def test_threes_a_crowd_matches_jax_example():
    jsim = _load_example("threes_a_crowd").build(False)
    tsim = threes_a_crowd.build(False, device="cpu")
    for _ in range(120):
        jsim.step(1.0 / 60.0)
        tsim.step(1.0 / 60.0)
    _assert_same_crowd(jsim, tsim)
    assert tsim.num_agents == 3


def _jax_multi_room(rate):
    """The session of ``examples/multi_room.py``'s ``main`` (which has no
    ``build``), with ``MonotonicCrowd(rate)`` sources: Poisson draws differ
    between the packages."""
    pytest.importorskip("yaml")
    mod = _load_example("multi_room")
    planner = J.RMFPlanner.from_yaml(mod.BUILDING_YAML, inflation=0.0,
                                     scale=0.5, agent_radius=0.3,
                                     arrival_tolerance=0.4)
    lp = J.Zanlungo(agent_scale=2.0, obstacle_scale=1.0, reaction_time=0.0,
                    force_distance=1.0, agent_mass=2.0, agent_radius=0.3,
                    force_cap=6.0)
    sim = J.Simulation(J.SimConfig(
        capacity=256, grid=J.GridConfig(width=48.0, height=28.0,
                                        cell_size=2.0, offset=(-4.0, -4.0)),
        neighbor_backend="grid", max_per_cell=32, max_eyesight=2.0))
    for source, waypoints in (((4.0, 4.0), [(20.0, 10.0), (36.0, 16.0)]),
                              ((36.0, 4.0), [(20.0, 10.0), (4.0, 16.0)])):
        sim.add_source_sink(J.SourceSink(
            source=source, waypoints=waypoints, radius_sink=1.0,
            crowd_generator=J.MonotonicCrowd(rate),
            high_level_planner=planner, local_planner=lp,
            agent_eyesight_range=2.0))
    return sim, planner, mod


class Count(T.EventListener):
    def __init__(self):
        self.events = []

    def agent_spawned(self, position, agent_id):
        self.events.append(("spawn", agent_id))

    def agent_destroyed(self, agent_id):
        self.events.append(("destroy", agent_id))

    def waypoint_reached(self, position, agent_id):
        self.events.append(("waypoint", agent_id))


class JCount(Count, J.EventListener):
    pass


def test_multi_room_matches_jax_example():
    """The port's building lists are the JAX example's YAML; the two
    sessions, one spawn request a step per source, route the same agents
    through the doors to 2e-4 by uid and deliver the same events.  They
    are bitwise equal for 69 steps; then the crowd at the first door
    amplifies a last-bit difference of the force sums about threefold a
    step, so the comparison stops at 72 steps, after the first waypoints
    are reached."""
    rate = 4.0   # rate * dt = 1: one request a step
    jsim, jplanner, mod = _jax_multi_room(rate)
    import yaml

    level = yaml.safe_load(mod.BUILDING_YAML)["levels"]["L1"]
    assert [tuple(v) for v in level["vertices"]] == multi_room.VERTICES
    assert [tuple(w) for w in level["walls"]] == multi_room.WALLS
    tplanner = multi_room.make_planner()
    tsim = multi_room.build(rate, device="cpu", planner=tplanner,
                            crowd=T.MonotonicCrowd)
    jc, tc = JCount(), Count()
    jsim.add_event_listener(jc)
    tsim.add_event_listener(tc)
    for _ in range(72):
        jsim.step(0.25)
        tsim.step(0.25)
    _assert_same_crowd(jsim, tsim)
    assert tc.events == jc.events
    assert {k for k, _ in tc.events} == {"spawn", "waypoint"}
    assert tplanner.n_routes == jplanner.n_routes == 4
    for r in range(4):
        assert tplanner.route(r) == jplanner.route(r)


@pytest.mark.parametrize("example,argv,expect", [
    (threes_a_crowd, ["--frames", "30"], "final positions:"),
    (multi_room, ["--steps", "20"], "routes planned"),
])
def test_example_main_runs_headless_on_the_cpu(monkeypatch, capsys, example,
                                               argv, expect):
    """Each example's ``main`` runs on the CPU without matplotlib or
    yaml, which only its picture options import."""
    monkeypatch.setattr(sys, "argv", ["example", "--device", "cpu", *argv])
    for name in ("matplotlib", "yaml"):
        monkeypatch.setitem(sys.modules, name, None)
    example.main()
    assert expect in capsys.readouterr().out
