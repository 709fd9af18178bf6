"""Every cell's traffic builds and runs at a tiny size on the CPU with the
plain versions; the session's trips are drawn from the seed as its file
states; every kind a traffic file names is a module found by name."""


import numpy as np
import pytest

from benchmark import drivers, harness, scene
from benchmark.generators import staggered
from benchmark.layouts import rooms
from benchmark.planners import rmf
from benchmark.tests.tiny import CELLS, run, tiny


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_tiny_and_is_correct(workload):
    rec, out = run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert rec["agent_steps"] > 0 and rec["steps"] > 0
    assert set(out["metrics"]) == {
        m["name"] for m in harness.metrics_of(harness.manifest(), workload,
                                              "end_to_end")}


def _hall():
    return scene.load("configs", "rmf_hall"), scene.load("traffic", "session")


def _trips(plan):
    return sorted(zip(map(tuple, plan.pos), map(tuple, plan.waypoints)))


def test_same_seed_same_trips_other_seed_other_trips():
    cfg, traffic = _hall()
    a = scene.source_plan(traffic, cfg, 2**33 + 5)
    b = scene.source_plan(traffic, cfg, 2**33 + 5)
    c = scene.source_plan(traffic, cfg, 2**33 + 6)
    assert np.array_equal(a.pos, b.pos) and a.waypoints == b.waypoints
    assert np.array_equal(a.phase, b.phase)
    assert _trips(a) != _trips(c)
    assert sorted(map(tuple, a.pos)) == sorted(map(tuple, c.pos))


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 4_000_000_000_123])
def test_rooms_lattice_and_trips(seed):
    cfg, traffic = _hall()
    layout = traffic["sources"]["layout"]
    plan = scene.source_plan(traffic, cfg, seed)
    assert plan.pos.shape == (240, 2)
    assert np.all(plan.pos % 2.0 == 0)
    walls = np.asarray(layout["x_walls"])
    room = np.searchsorted(walls, plan.pos[:, 0]) - 1
    sink = np.asarray([w[0] for w in plan.waypoints])
    sroom = np.searchsorted(walls, sink[:, 0]) - 1
    same = room == sroom
    d = np.linalg.norm(plan.pos - sink, axis=1)
    assert np.all(d[same] >= layout["min_distance"])
    assert np.all(np.abs(room - sroom) <= 1)
    # Every door carries the same trips, in each direction, on every seed.
    for a in range(len(walls) - 2):
        for x, y in ((a, a + 1), (a + 1, a)):
            assert np.sum((room == x) & (sroom == y)) == \
                layout["cross_per_door"]
    assert np.all((plan.phase >= 0) & (plan.phase < 1))


def test_every_lattice_point_routes_to_its_room_and_the_next():
    """Any trip that a seed can draw has a route: each lattice point
    reaches its room's first point, and each room's first point the next
    room's."""
    cfg, traffic = _hall()
    pts = rooms.lattices(traffic["sources"]["layout"])
    planner = rmf.rmf_planner(cfg)
    for r, room in enumerate(pts):
        hub = tuple(room[0])
        for p in room[1:]:
            assert planner.plan_route_cached(tuple(p), hub) is not None
        if r + 1 < len(pts):
            assert planner.plan_route_cached(hub, tuple(pts[r + 1][0])) \
                is not None


def test_staggered_generator_rate():
    g = staggered.StaggeredCrowd(1.2, 0.37)
    counts = [g.get_number_to_spawn(0.25) for _ in range(400)]
    assert set(counts) <= {0, 1} and sum(counts) == 120


def test_uniform_placement_fills_an_offset_world():
    cfg = scene.load("configs", "crowd_1m")
    cfg["sim"]["grid"] = {"width": 60.0, "height": 20.0, "cell_size": 2.0,
                          "offset": [100.0, -50.0]}
    config = scene.sim_config(cfg)
    crowd = {"agents": 5000, "placement": {"kind": "uniform", "margin": 1.0}}
    pos = scene.crowd_state(config, cfg, crowd, 3, "cpu").position[:5000]
    lo, hi = pos.min(0).values, pos.max(0).values
    assert lo[0] >= 101 and hi[0] <= 159 and lo[1] >= -49 and hi[1] <= -31
    assert hi[0] - lo[0] > 55 and hi[1] - lo[1] > 15


@pytest.mark.parametrize("where,kind", [
    (("driver",), "replay"),
    (("crowd", "placement", "kind"), "hotspots"),
    (("crowd", "planner", "kind"), "../harness"),
    (("sources", "layout", "kind"), "ring"),
    (("sources", "generator", "kind"), "poisson"),
    (("sources", "loop"), "all"),
])
def test_unknown_kind_raises(where, kind):
    man, cfg, traffic = tiny("crowd_1m.streams")
    node = traffic
    for key in where[:-1]:
        node = node[key]
    node[where[-1]] = kind
    with pytest.raises(ValueError):
        drivers.make(cfg, traffic, 5, "cpu")
