"""The reference agrees with the program's plain path step by step, and
its pieces do what their semantics say."""

import math

import numpy as np
import torch

from benchmark import drivers, scene
from benchmark.reference import compare, crowd, routes
from benchmark.tests.tiny import tiny


def test_reference_follows_each_step_of_the_plain_rollout():
    _, cfg, traffic = tiny("crowd_1m.streams")
    d = drivers.make(cfg, traffic, 77, "cpu")
    st = d.start
    for k in range(6):
        nxt = d._episode(k + 1)[0]
        v = drivers.compare_step(d.world, scene.fields(st),
                                 scene.fields(nxt), k)
        assert v.agents_off == 0, (k, v.off_uids)
        assert v.compared >= traffic["crowd"]["agents"]
        st = nxt


def test_reference_follows_the_session_and_its_events():
    _, cfg, traffic = tiny("rmf_hall.session")
    d = drivers.make(cfg, traffic, 91, "cpu")
    d.warm_up()
    world, off, _ = d.reference_world()
    assert off == 0
    n_events = 0
    for _ in range(4):
        pre, k = d.sim.state, d.calls
        d._step()
        ev = d.listener.of_step(k)
        n_events += sum(len(x) for x in ev.values())
        v = drivers.compare_step(world, scene.fields(pre),
                                 scene.fields(d.sim.state), k, ev)
        assert v.agents_off == 0 and v.events_off == 0
    assert n_events > 0


def test_time_to_collision_cases():
    rv = torch.tensor([[1.0, 0.0], [0.0, 0.0], [1.0, 0.0], [-1.0, 0.0]])
    rp = torch.tensor([[-2.0, 0.0], [1.0, 0.0], [0.1, 0.0], [2.0, 5.0]])
    t = crowd.time_to_collision(rv, rp, torch.tensor(0.5))
    assert math.isclose(float(t[0]), 1.5, rel_tol=1e-6)   # closing in
    assert math.isinf(float(t[1]))                        # no motion
    assert float(t[2]) == 0.0                             # overlapping
    assert math.isinf(float(t[3]))                        # passing wide


def test_neighbours_are_exact_and_strict():
    g = torch.Generator().manual_seed(4)
    pos = torch.rand((400, 2), generator=g) * 20
    eye = torch.full((400,), 2.0)
    q = torch.arange(400)
    idx, valid = crowd.neighbours(pos, eye, q, 2.0)
    got = torch.zeros((400, 400), dtype=torch.bool)
    rows = q[:, None].expand_as(idx)
    got[rows[valid], idx[valid]] = True
    d = torch.linalg.vector_norm(pos[:, None] - pos[None], dim=-1)
    want = (d < 2.0) & ~torch.eye(400, dtype=torch.bool)
    assert torch.equal(got, want)


def test_route_judge():
    walls = routes.wall_segments([[0, 0], [10, 0], [10, 10], [0, 10],
                                  [5, 0], [5, 4]],
                                 [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5]])
    start, goal = (2.0, 2.0), (8.0, 2.0)
    best = routes.shortest(start, goal, walls)
    assert math.isclose(best, 2 * math.hypot(3, 2), rel_tol=1e-9)
    ok, _ = routes.judge(np.asarray([start, (5, 4.5), goal]), start, goal,
                         walls)
    assert ok
    assert not routes.judge(np.asarray([start, goal]), start, goal,
                            walls)[0]                     # through the wall
    assert not routes.judge(np.asarray([start, (5, 9.5), goal]), start,
                            goal, walls)[0]               # too long


def test_hall_routes_past_door_corners_pass_and_detours_fail():
    """The planner's routes of the trips that read longest against the
    zero-width shortest path pass the judge; the same routes walked
    there, back and there again do not."""
    from benchmark.planners import rmf

    cfg = scene.load("configs", "rmf_hall")
    r = cfg["rmf"]
    walls = routes.wall_segments(r["vertices"], r["walls"])
    planner = rmf.rmf_planner(cfg)
    for a, b in [((156.0, 70.0), (164.0, 70.0)),
                 ((116.0, 44.0), (124.0, 44.0)),
                 ((36.0, 56.0), (44.0, 56.0)),
                 ((116.0, 44.0), (130.0, 44.0))]:
        pts = np.asarray(planner.route(planner.plan_route_cached(a, b)))
        ok, ratio = routes.judge(pts, a, b, walls)
        assert ok and ratio > 1.25, (a, b, ratio)
        thrice = np.concatenate([pts, pts[::-1][1:], pts[1:]])
        assert not routes.judge(thrice, a, b, walls)[0]


def test_events_off_counts_each_side():
    ev = crowd.Events(spawned_uid=torch.tensor([3, 4]),
                      spawned_pos=torch.tensor([[1.0, 2.0], [3.0, 4.0]]),
                      reached_uid=torch.tensor([], dtype=torch.long),
                      reached_pos=torch.zeros((0, 2)),
                      destroyed_uid=torch.tensor([9]))
    got = {"spawned": [(3, 1.0, 2.0), (5, 3.0, 4.0)], "reached": [],
           "destroyed": [9]}
    assert compare.events_off(ev, got) == 2
