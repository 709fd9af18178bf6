"""The port's route planners and ``RMFPlanner`` against the JAX package's.

The thirteen scenarios of tests/test_rmf.py and the four of
tests/test_route_quality.py, each run through the port
(``rmf_crowdsim_tpu_torch.native``, ``models/rmf.py`` and its
``Simulation`` on the CPU) and held against the JAX package's planners on
the same inputs: the routes of the port's numpy and native planners equal
the JAX package's numpy and native planners' waypoint for waypoint (the
same code on the same C++ source), route ids and cache behaviour are the
same, the visibility planners are exact against
tests/visibility_oracle.py, and the float64 ``NoLocalPlan`` sessions
equal the JAX package's exactly.  The native cases need a C++ toolchain
(``g++``), decided inside each test; the YAML cases need ``yaml``.
"""

import math
import textwrap

import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
import rmf_crowdsim_tpu_torch as T
from rmf_crowdsim_tpu import native as jnative
from rmf_crowdsim_tpu.models.rmf import RMFPlanner as JRMFPlanner
from rmf_crowdsim_tpu_torch import native as tnative
from rmf_crowdsim_tpu_torch.models.rmf import RMFPlanner as TRMFPlanner
from tests.visibility_oracle import VisibilityOracle, path_cost

ROOM_VERTS = [
    (0.0, 0.0), (20.0, 0.0), (20.0, 10.0), (0.0, 10.0),  # outer box
    (10.0, 0.0), (10.0, 7.0),  # internal wall
]
ROOM_WALLS = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5)]
NATIVE = {J: jnative, T: tnative}
RMF = {J: JRMFPlanner, T: TRMFPlanner}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: at these sizes it is about as fast as
    many, and far faster when the suite's parallel workers share the
    cores (each worker's thread pool would otherwise claim them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def need_native():
    if not (jnative.native_available() and tnative.native_available()):
        pytest.skip("no C++ toolchain")


def path_length(route):
    return sum(math.dist(route[i], route[i + 1])
               for i in range(len(route) - 1))


def both(make, *args, **kw):
    """(JAX result, port result) of ``make(module)(*args, **kw)``."""
    return tuple(make(NATIVE[pkg])(*args, **kw) for pkg in (J, T))


def numpy_planner(native):
    return native.NumpyRoutePlanner


def native_planner(native):
    return native.NativeRoutePlanner


# --- tests/test_rmf.py ----------------------------------------------------


def test_straight_shot_is_two_points():
    pj, pt = both(numpy_planner, ROOM_VERTS, ROOM_WALLS, 0.5, 0.3)
    r = pt.plan((2.0, 2.0), (8.0, 2.0))
    assert r == [(2.0, 2.0), (8.0, 2.0)] == pj.plan((2.0, 2.0), (8.0, 2.0))


def test_route_goes_around_wall():
    pj, pt = both(numpy_planner, ROOM_VERTS, ROOM_WALLS, 0.5, 0.3)
    r = pt.plan((5.0, 2.0), (15.0, 2.0))
    assert r is not None and len(r) > 2
    assert max(y for _, y in r) > 7.0
    assert all(not pt.occupied(x, y) for x, y in r[1:-1])
    assert r == pj.plan((5.0, 2.0), (15.0, 2.0))


def test_impossible_route_returns_none():
    verts = [(4.0, 4.0), (6.0, 4.0), (6.0, 6.0), (4.0, 6.0)]
    walls = [(0, 1), (1, 2), (2, 3), (3, 0)]
    pj, pt = both(numpy_planner, verts, walls, 0.25, 0.2)
    assert pt.plan((0.0, 0.0), (5.0, 5.0)) is None
    assert pj.plan((0.0, 0.0), (5.0, 5.0)) is None


def test_native_matches_fallback_and_jax():
    """The port's native planner equals the JAX package's waypoint for
    waypoint, and agrees with the port's numpy planner on reachability
    and (near-)optimal cost, as the JAX test demands of its pair."""
    need_native()
    nj, nt = both(native_planner, ROOM_VERTS, ROOM_WALLS, 0.5, 0.3)
    fj, ft = both(numpy_planner, ROOM_VERTS, ROOM_WALLS, 0.5, 0.3)
    rng = np.random.default_rng(0)
    checked = 0
    for _ in range(25):
        s = tuple(rng.uniform([0.8, 0.8], [19.2, 9.2]))
        g = tuple(rng.uniform([0.8, 0.8], [19.2, 9.2]))
        if ft.occupied(*s) or ft.occupied(*g):
            continue
        rn, rf = nt.plan(s, g), ft.plan(s, g)
        assert rn == nj.plan(s, g) and rf == fj.plan(s, g), (s, g)
        assert (rn is None) == (rf is None), (s, g)
        if rn is not None:
            ln, lf = path_length(rn), path_length(rf)
            assert ln <= lf * 1.15 + 0.5 and lf <= ln * 1.15 + 0.5
            checked += 1
    assert checked >= 10


BUILDING = textwrap.dedent(
    """
    levels:
      L1:
        vertices:
          - [0.0, 0.0]
          - [20.0, 0.0]
          - [20.0, 10.0]
          - [0.0, 10.0]
          - [10.0, 0.0]
          - [10.0, 7.0]
        walls:
          - [0, 1]
          - [1, 2]
          - [2, 3]
          - [3, 0]
          - [4, 5]
    """
)


def test_rmf_from_yaml():
    pytest.importorskip("yaml")
    routes = []
    for pkg in (J, T):
        planner = RMF[pkg].from_yaml(BUILDING, inflation=0.0, scale=0.5,
                                     agent_radius=0.3)
        rid = planner.plan_route_cached((5.0, 2.0), (15.0, 2.0))
        assert rid is not None
        routes.append(planner.route(rid))
    assert max(y for _, y in routes[1]) > 7.0
    assert routes[0] == routes[1]


def test_route_cache_hits():
    ids = []
    for pkg in (J, T):
        planner = RMF[pkg](ROOM_VERTS, ROOM_WALLS, scale=0.5, radius=0.3)
        a = planner.plan_route_cached((5.0, 2.0), (15.0, 2.0))
        b = planner.plan_route_cached((5.1, 2.1), (15.1, 2.1))
        n1 = planner.n_routes
        c = planner.plan_route_cached((2.0, 8.0), (15.0, 2.0))
        ids.append((a, b, n1, c, planner.n_routes))
    assert ids[1] == (0, 0, 1, 1, 2) == ids[0]


def _session(pkg, **cfg):
    kw = dict(device="cpu") if pkg is T else {}
    config = pkg.SimConfig(dtype="float64", neighbor_backend="brute", **cfg)
    return pkg.Simulation(config, **kw)


def _planner(pkg, **kw):
    return RMF[pkg](ROOM_VERTS, ROOM_WALLS, scale=0.5, radius=0.3,
                    arrival_tolerance=0.3, dtype="float64", **kw)


def _positions(sim):
    return {k: tuple(map(float, v.position)) for k, v in sim.agents.items()}


def test_rmf_planner_drives_simulation():
    """A SourceSink's agents follow the planned route around the wall to
    the sink; every step's positions and despawns equal the JAX
    session's exactly (float64, NoLocalPlan)."""
    runs = []
    for pkg in (J, T):
        planner = _planner(pkg)
        sim = _session(pkg, capacity=16, max_eyesight=5.0,
                       grid=pkg.GridConfig(width=30.0, height=20.0,
                                           cell_size=2.0,
                                           offset=(-5.0, -5.0)))
        sim.add_source_sink(pkg.SourceSink(
            source=(5.0, 2.0), waypoints=[(15.0, 2.0)], radius_sink=0.5,
            crowd_generator=pkg.MonotonicCrowd(4.0),
            high_level_planner=planner, local_planner=pkg.NoLocalPlan(),
            agent_eyesight_range=5.0))
        trace = []
        for _ in range(120):
            sim.step(0.25)
            trace.append((_positions(sim),
                          int(np.asarray(sim.last_events.destroyed).sum())))
        runs.append((trace, planner.n_routes, planner.route(0)))
    assert sum(d for _, d in runs[1][0]) >= 1
    assert runs[1][1] == 1
    assert max(y for _, y in runs[1][2]) > 7.0
    assert runs[0] == runs[1]


def test_set_target_api():
    out = []
    for pkg in (J, T):
        planner = _planner(pkg)
        sim = _session(pkg, capacity=4)
        (aid,) = sim.add_agents([(5.0, 2.0)], planner, pkg.NoLocalPlan(),
                                5.0)
        sim.set_target(aid, (15.0, 2.0))
        trace = []
        for _ in range(40):
            sim.step(0.5)
            trace.append(_positions(sim))
        assert math.dist(trace[-1][aid], (15.0, 2.0)) < 1.0
        out.append(trace)
    assert out[0] == out[1]


def test_empty_world_is_all_free():
    pj, pt = both(numpy_planner, [], [], 0.5, 0.3)
    r = pt.plan((0.0, 0.0), (10.0, 10.0))
    assert r == [(0.0, 0.0), (10.0, 10.0)] == pj.plan((0.0, 0.0),
                                                      (10.0, 10.0))


def test_out_of_range_wall_indices_ignored():
    pj, pt = both(numpy_planner, [(0.0, 0.0), (4.0, 0.0)], [(0, 9)], 0.5,
                  0.2)
    r = pt.plan((1.0, 1.0), (3.0, 1.0))
    assert r == [(1.0, 1.0), (3.0, 1.0)] == pj.plan((1.0, 1.0), (3.0, 1.0))


def test_native_route_buffer_overflow_raises():
    need_native()
    for native in (jnative, tnative):
        planner = native.NativeRoutePlanner(ROOM_VERTS, ROOM_WALLS, 0.5, 0.3,
                                            max_waypoints=2)
        with pytest.raises(RuntimeError, match="max_waypoints"):
            planner.plan((5.0, 2.0), (15.0, 2.0))


@pytest.mark.parametrize("kind", ["numpy", "native"])
def test_far_outside_straight_shot_is_two_points(kind):
    if kind == "native":
        need_native()
    make = numpy_planner if kind == "numpy" else native_planner
    pj, pt = both(make, ROOM_VERTS, ROOM_WALLS, 0.5, 0.3)
    route = pt.plan((-200.0, 300.0), (400.0, 305.0))
    assert route is not None and len(route) == 2
    assert route == pj.plan((-200.0, 300.0), (400.0, 305.0))


def test_no_route_result_is_cached():
    verts = [(0.0, 0.0), (4.0, 0.0), (4.0, 4.0), (0.0, 4.0),
             (0.0, 2.0), (4.0, 2.0)]
    walls = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5)]
    for pkg in (J, T):
        planner = RMF[pkg](verts, walls, scale=0.25, radius=0.2)
        assert planner.plan_route_cached((1.0, 1.0), (1.0, 3.5)) is None
        calls = []
        orig = planner._backend.plan
        planner._backend.plan = lambda *a, _o=orig, **k: (
            calls.append(1), _o(*a, **k))[1]
        assert planner.plan_route_cached((1.0, 1.0), (1.0, 3.5)) is None
        assert calls == []


@pytest.mark.parametrize("which", ["route table full", "max_route_len"])
def test_route_table_limits_raise(which):
    """A full route table and a route longer than ``max_route_len`` raise
    the JAX package's errors."""
    kw = (dict(max_routes=1) if which == "route table full"
          else dict(max_route_len=2))
    messages = []
    for pkg in (J, T):
        planner = RMF[pkg](ROOM_VERTS, ROOM_WALLS, scale=0.5, radius=0.3,
                           prefer_native=False, **kw)
        with pytest.raises(RuntimeError, match=which) as e:
            planner.plan_route_cached((2.0, 2.0), (8.0, 2.0))
            planner.plan_route_cached((5.0, 2.0), (15.0, 2.0))
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_init_params_follow_the_host_routes():
    """``init_params`` builds the route table from the host store each
    call: its shape stays ``(max_routes, max_route_len)``, and routes
    planned between calls appear, equal to the JAX package's."""
    j = _planner(J, max_routes=4, max_route_len=8)
    t = _planner(T, max_routes=4, max_route_len=8)
    before = t.init_params("cpu")
    for p in (j, t):
        p.plan_route_cached((5.0, 2.0), (15.0, 2.0))
    after = t.init_params("cpu")
    jp = j.init_params()
    assert tuple(before["routes"].points.shape) == (4, 8, 2)
    assert int(before["routes"].lengths.sum()) == 0
    np.testing.assert_array_equal(after["routes"].points.numpy(),
                                  np.asarray(jp["routes"].points))
    np.testing.assert_array_equal(after["routes"].lengths.numpy(),
                                  np.asarray(jp["routes"].lengths))
    assert float(after["tol"]) == float(jp["tol"])


# --- tests/test_route_quality.py --------------------------------------------

EPS_GRID = 0.12
EXACT_TOL = 1e-6
CELL = 1.0
INFLATION = 0.7


def random_room(seed):
    """tests/test_route_quality.py's room: a bounded box with random
    axis-aligned interior walls."""
    rng = np.random.default_rng(seed)
    size = 30.0
    verts = [(0.0, 0.0), (size, 0.0), (size, size), (0.0, size)]
    walls = [(0, 1), (1, 2), (2, 3), (3, 0)]
    for _ in range(int(rng.integers(4, 8))):
        horiz = rng.random() < 0.5
        a = rng.uniform(4.0, size - 4.0)
        lo = rng.uniform(2.0, 10.0)
        hi = rng.uniform(size - 10.0, size - 2.0)
        i = len(verts)
        verts += [(lo, a), (hi, a)] if horiz else [(a, lo), (a, hi)]
        walls.append((i, i + 1))
    return verts, walls


def free_point(world, rng, size=30.0):
    for _ in range(200):
        p = rng.uniform(2.0, size - 2.0, 2)
        if not world.occupied(p[0], p[1]):
            return float(p[0]), float(p[1])
    raise AssertionError("no free point found")


def _ratios(make, seeds, **kw):
    """Route cost over the oracle's optimum for four reachable pairs a
    room, the port's planner ``make`` held route for route against the JAX
    package's."""
    ratios = []
    for seed in seeds:
        verts, walls = random_room(seed)
        world = tnative.NumpyRoutePlanner(verts, walls, CELL, INFLATION)
        pj, pt = both(make, verts, walls, CELL, INFLATION, **kw)
        oracle = VisibilityOracle(world)
        rng = np.random.default_rng(1000 + seed)
        tried = 0
        while tried < 4:
            s, g = free_point(world, rng), free_point(world, rng)
            if math.dist(s, g) < 8.0:
                continue
            opt = oracle.shortest_cost(s, g)
            if opt is None:
                continue
            tried += 1
            path = pt.plan(s, g)
            assert path is not None and path == pj.plan(s, g), (seed, s, g)
            ratios.append(path_cost(path) / opt)
    return ratios


def test_numpy_visibility_planner_is_exact():
    r = _ratios(numpy_planner, range(12))
    assert 1.0 - EXACT_TOL <= min(r) and max(r) <= 1.0 + EXACT_TOL


def test_native_visibility_planner_is_exact():
    need_native()
    r = _ratios(native_planner, range(6))
    assert 1.0 - EXACT_TOL <= min(r) and max(r) <= 1.0 + EXACT_TOL


def test_grid_mode_within_eps_of_visibility_optimum():
    r = sorted(_ratios(numpy_planner, range(12), mode="grid"))
    assert r[-1] <= 1.0 + EPS_GRID
    assert r[len(r) // 2] <= 1.05


def test_native_numpy_visibility_cost_parity():
    need_native()
    for seed in range(6):
        verts, walls = random_room(seed)
        world = tnative.NumpyRoutePlanner(verts, walls, CELL, INFLATION)
        nat = tnative.make_route_planner(verts, walls, CELL, INFLATION,
                                         prefer_native=True)
        assert isinstance(nat, tnative.NativeRoutePlanner)
        jnat = jnative.make_route_planner(verts, walls, CELL, INFLATION,
                                          prefer_native=True)
        rng = np.random.default_rng(2000 + seed)
        tried = 0
        while tried < 4:
            s, g = free_point(world, rng), free_point(world, rng)
            rn, rf = nat.plan(s, g), world.plan(s, g)
            assert rn == jnat.plan(s, g)
            assert (rn is None) == (rf is None), (seed, s, g)
            if rn is None:
                continue
            tried += 1
            assert abs(path_cost(rn) - path_cost(rf)) < 1e-9, (seed, s, g)


def test_the_port_builds_its_own_native_library():
    """The port's native library is built into its own ``_build/``, not
    into the JAX package's ``native/`` file."""
    need_native()
    assert tnative._SO_PATH != jnative._SO_PATH
    assert "rmf_crowdsim_tpu_torch" in tnative._SO_PATH
    assert tnative._lib._name == tnative._SO_PATH


def test_session_scene_steps_as_the_streaming_rollout():
    """``scenes.build_session`` (the streaming scene as a session whose
    RMFPlanner plans the sources' legs) equals ``scenes.build_streams``
    (a rollout over ``stream_routes``): the planned legs are the stream
    routes, and 20 steps of ``run()`` and of ``step()`` give the
    rollout's agents bit for bit, with events under way."""
    from rmf_crowdsim_tpu_torch import scenes

    n, cap, s, dt = 1024, 1280, 16, 1.0 / 60.0
    rollout, params, st = scenes.build_streams(n, cap, s, backend="grid",
                                               device="cpu")
    st, c = rollout(params, st, dt, 20)
    assert int(c.n_waypoint_reached.sum()) > 0
    routes = params.hl[1]["routes"]
    for via_run in (True, False):
        sim, planner, sources = scenes.build_session(
            n, cap, s, backend="grid", device="cpu")
        assert [planner.plan_source_legs(ss) for ss in sources] == [
            [2 * i, 2 * i + 1] for i in range(s)]
        table = planner.init_params("cpu")["routes"]
        assert torch.equal(table.points[:2 * s, :2], routes.points)
        assert torch.equal(table.lengths[:2 * s], routes.lengths)
        if via_run:
            sc = sim.run(20, dt)
            assert torch.equal(sc.n_alive, c.n_alive)
        else:
            for _ in range(20):
                sim.step(dt)
        for name in ("uid", "alive", "position", "velocity", "route_id",
                     "route_wp", "next_waypoint"):
            assert torch.equal(getattr(sim.state, name), getattr(st, name))
