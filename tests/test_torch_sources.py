"""SourceSink streaming in the port against the JAX package.

The reference lifecycle (event_listeners_test.rs:64-111, as
tests/test_simulation.py:70-100 runs it) through both packages'
``build_rollout``; the blocked spawn, the chunked clearance gate and a
capacity shortfall through one step of each; the spawn requests, the sink
phase and ``WaypointFollow`` against the JAX functions on the same
numpy-seeded inputs; and ``PoissonCrowd``'s requests by their mean (the
two packages draw different numbers, so those are not compared).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
from rmf_crowdsim_tpu.core import step as jstep
from rmf_crowdsim_tpu.models import source_sink as jss
from rmf_crowdsim_tpu_torch import (
    ConstantVelocity,
    GridConfig,
    MonotonicCrowd,
    NoLocalPlan,
    PoissonCrowd,
    RouteTable,
    SimConfig,
    SimParams,
    SourceSink,
    WaypointFollow,
    build_rollout,
    make_state,
    stack_source_params,
)
from rmf_crowdsim_tpu_torch.core import step as tstep
from rmf_crowdsim_tpu_torch.models import source_sink as tss
from rmf_crowdsim_tpu_torch.utils import convert

GRID = dict(width=1000.0, height=1000.0, cell_size=20.0,
            offset=(-500.0, -500.0))
COUNTERS = ("n_alive", "n_spawned", "n_destroyed", "n_waypoint_reached",
            "spawn_dropped", "out_of_bounds", "max_cell_occupancy",
            "neighbor_truncated")


def configs(backend="brute", capacity=64, **kw):
    """(JAX SimConfig, port SimConfig) of one spec."""
    t = SimConfig(capacity=capacity, grid=GridConfig(**GRID),
                  neighbor_backend=backend, max_eyesight=100.0, **kw)
    fields = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    fields["grid"] = J.GridConfig(**GRID)
    return J.SimConfig(**fields), t


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def sources_both(specs, hl_idx=0, lp_idx=0, legs=None):
    """(JAX SourceParams, port SourceParams) from host descriptions
    ``specs``: dicts of SourceSink fields, generator included."""
    jsrc = [J.SourceSink(high_level_planner=None, local_planner=None, **s)
            for s in specs]
    tsrc = [SourceSink(high_level_planner=None, local_planner=None, **s)
            for s in specs]
    n = len(specs)
    legs = legs or [[-1] for _ in specs]
    jp = jss.stack_source_params(jsrc, [hl_idx] * n, [lp_idx] * n, legs,
                                 jnp.float32)
    tp = stack_source_params(tsrc, [hl_idx] * n, [lp_idx] * n, legs,
                             torch.float32, device="cpu")
    return jp, tp


def jax_state(config, agents, next_uid=None):
    """A JAX state with ``agents`` [(x, y)] parked in the first slots
    (planner 0, eyesight 5)."""
    st = J.make_state(config)
    k = len(agents)
    if not k:
        return st
    f = jnp.float32
    i32 = jnp.int32
    return st.replace(
        position=st.position.at[:k].set(jnp.asarray(agents, f)),
        eyesight=st.eyesight.at[:k].set(5.0),
        alive=st.alive.at[:k].set(True),
        uid=st.uid.at[:k].set(jnp.arange(k, dtype=i32)),
        hl_idx=st.hl_idx.at[:k].set(0),
        lp_idx=st.lp_idx.at[:k].set(0),
        priority=st.priority.at[:k].set(jnp.arange(k, dtype=f)),
        next_uid=jnp.asarray(k if next_uid is None else next_uid, i32),
    )


def run_both(backend, capacity, specs, agents, steps, hl_vel=(1.0, 0.0)):
    """Both packages' rollouts of one scene: (JAX final state and
    counters, port final state and counters), all numpy."""
    jc, tc = configs(backend, capacity)
    jp, tp = sources_both(specs)
    jst = jax_state(jc, agents)
    jhl, jlp = J.ConstantVelocity(hl_vel), J.NoLocalPlan()
    jparams = J.SimParams(hl=(jhl.init_params(),), lp=(jlp.init_params(),),
                          sources=jp)
    jro = jstep.build_rollout(jc, [jhl], [jlp])
    j_final, jc_out = jax.jit(jro, static_argnums=(3,))(jparams, jst, 1.0,
                                                        steps)
    thl, tlp = ConstantVelocity(hl_vel), NoLocalPlan()
    tparams = SimParams(hl=(thl.init_params("cpu"),),
                        lp=(tlp.init_params("cpu"),), sources=tp)
    tst = convert.state_from_numpy(to_np(jst), device="cpu")
    t_final, tc_out = build_rollout(tc, [thl], [tlp])(tparams, tst, 1.0,
                                                       steps)
    return ((to_np(j_final), to_np(jc_out)),
            (convert.state_to_numpy(t_final),
             {k: getattr(tc_out, k).numpy() for k in COUNTERS}))


def assert_counters_equal(jc, tc):
    for name in COUNTERS:
        np.testing.assert_array_equal(tc[name], getattr(jc, name),
                                      err_msg=name)


def assert_states_equal(js, ts, fields=("alive", "uid", "source_id",
                                        "next_waypoint", "hl_idx", "lp_idx",
                                        "route_id", "route_wp", "next_uid")):
    for name in fields:
        np.testing.assert_array_equal(ts[name], getattr(js, name),
                                      err_msg=name)
    for name in ("position", "priority", "eyesight"):
        np.testing.assert_allclose(ts[name], getattr(js, name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


LIFECYCLE = dict(source=(0.0, 0.0), waypoints=[(20.0, 0.0)], radius_sink=1.0,
                 crowd_generator=None, agent_eyesight_range=5.0,
                 loop_forever=False)


@pytest.mark.parametrize("backend", ["brute", "grid"])
def test_reference_lifecycle_matches_jax(backend):
    """MonotonicCrowd(1/s) into a sink 20 m away, dt 1 s, 40 steps: the
    population grows one a step for 20 steps, then holds at 20 with one
    spawn and one despawn a step; counters equal JAX's step for step."""
    spec = dict(LIFECYCLE, crowd_generator=MonotonicCrowd(1.0))
    (js, jc), (ts, tc) = run_both(backend, 64, [spec], [], 40)
    assert_counters_equal(jc, tc)
    assert_states_equal(js, ts)
    np.testing.assert_array_equal(tc["n_alive"],
                                  np.minimum(np.arange(1, 41), 20))
    np.testing.assert_array_equal(tc["n_spawned"], np.ones(40))
    np.testing.assert_array_equal(tc["n_destroyed"],
                                  (np.arange(40) >= 20).astype(int))


def test_blocked_spawn_matches_jax():
    """lib.rs:208-218: a parked agent on the source blocks the spawn."""
    spec = dict(LIFECYCLE, crowd_generator=MonotonicCrowd(1.0))
    (js, jc), (ts, tc) = run_both("brute", 64, [spec], [(0.0, 0.0)], 2,
                                  hl_vel=(0.0, 0.0))
    assert_counters_equal(jc, tc)
    assert_states_equal(js, ts)
    assert list(tc["n_alive"]) == [1, 1]
    assert list(tc["spawn_dropped"]) == [1, 1]


def test_chunked_clearance_matches_jax():
    """70 sources (two passes of 64) with agents parked on three of
    them: 67 spawn, 3 drop, as JAX decides."""
    specs = [dict(LIFECYCLE, source=(i * 10.0, 0.0),
                  waypoints=[(i * 10.0, 400.0)],
                  crowd_generator=MonotonicCrowd(1.0)) for i in range(70)]
    parked = [(0.0, 0.0), (10.0, 0.0), (200.0, 0.0)]
    (js, jc), (ts, tc) = run_both("brute", 256, specs, parked, 1,
                                  hl_vel=(0.0, 0.0))
    assert_counters_equal(jc, tc)
    assert_states_equal(js, ts)
    assert int(tc["n_alive"][0]) == 70 and int(tc["spawn_dropped"][0]) == 3


def test_capacity_shortfall_matches_jax():
    """More wanting sources than free slots: the k-th spawning source
    takes the k-th free slot, uids are ``next_uid + rank``, and
    ``next_uid`` and ``spawn_dropped`` follow JAX's."""
    specs = [dict(LIFECYCLE, source=(i * 10.0, 50.0),
                  waypoints=[(i * 10.0, 400.0)],
                  crowd_generator=MonotonicCrowd(2.0)) for i in range(10)]
    # Parked agents in slots 0, 1, 2 block sources 1 and 4; 5 slots free.
    parked = [(10.0, 50.0), (-300.0, 0.0), (40.0, 50.0)]
    (js, jc), (ts, tc) = run_both("brute", 8, specs, parked, 2,
                                  hl_vel=(0.0, 0.0))
    assert_counters_equal(jc, tc)
    assert_states_equal(js, ts)
    assert int(tc["n_alive"][0]) == 8
    # 10 sources ask for 2 each: 20 requested, 5 spawned.
    assert int(tc["spawn_dropped"][0]) == 15
    assert int(ts["next_uid"]) == 3 + 5


class Counter:
    """A host generator (the reference's CrowdGenerator trait)."""

    def get_number_to_spawn(self, dt):
        return 1


def test_stack_source_params_matches_jax():
    gens = [MonotonicCrowd(2.5), PoissonCrowd(0.5), Counter()]
    jgens = [J.MonotonicCrowd(2.5), J.PoissonCrowd(0.5), Counter()]
    specs = [dict(source=(1.0 * i, -2.0), waypoints=[(3.0, 4.0)] * (i + 1),
                  radius_sink=0.5 + i, agent_eyesight_range=2.0 + i,
                  loop_forever=bool(i % 2)) for i in range(3)]
    legs = [[7], [8, 9], [-1, 10, 11]]
    jp = jss.stack_source_params(
        [J.SourceSink(crowd_generator=g, high_level_planner=None,
                      local_planner=None, **s) for g, s in zip(jgens, specs)],
        [1, 0, 1], [0, 0, 1], legs, jnp.float32)
    tp = stack_source_params(
        [SourceSink(crowd_generator=g, high_level_planner=None,
                    local_planner=None, **s) for g, s in zip(gens, specs)],
        [1, 0, 1], [0, 0, 1], legs, torch.float32, device="cpu")
    for f in dataclasses.fields(tp):
        got = getattr(tp, f.name).numpy()
        want = np.asarray(getattr(jp, f.name))
        np.testing.assert_array_equal(got, want, err_msg=f.name)
        assert got.dtype == want.dtype, f.name
    assert tp.gen_kind.tolist() == [tss.GEN_MONOTONIC, tss.GEN_POISSON,
                                    tss.GEN_CUSTOM]
    # The port's converter carries the JAX table over unchanged.
    back = convert.source_params_from_numpy(to_np(jp), device="cpu")
    for f in dataclasses.fields(tp):
        assert torch.equal(getattr(back, f.name), getattr(tp, f.name))
    with pytest.raises(TypeError, match="get_number_to_spawn"):
        stack_source_params([SourceSink(crowd_generator=object(),
                                        high_level_planner=None,
                                        local_planner=None, **specs[0])],
                            [0], [0], [[-1]], torch.float32, device="cpu")
    assert stack_source_params([], [], [], [], torch.float32) is None


def test_spawn_requests_match_jax():
    """MonotonicCrowd's ``floor(rate*dt + 0.5)`` in the config dtype,
    GEN_CUSTOM's host counts and inactive sources, through one spawn
    phase of each package on the same state."""
    rates = [0.5, 1.49, 2.5, 59.999, 0.0, 3.0, 7.0]
    specs = [dict(LIFECYCLE, source=(30.0 * i, 0.0),
                  crowd_generator=MonotonicCrowd(r))
             for i, r in enumerate(rates)]
    jp, tp = sources_both(specs)
    kind = np.array([0, 0, 0, 0, 0, 2, 2], np.int32)
    custom = np.array([0, 0, 0, 0, 0, 4, 0], np.int32)
    active = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    jp = jp.replace(gen_kind=jnp.asarray(kind),
                    custom_count=jnp.asarray(custom),
                    active=jnp.asarray(active))
    tp = tp.replace(gen_kind=torch.as_tensor(kind),
                    custom_count=torch.as_tensor(custom),
                    active=torch.as_tensor(active))
    jc, tc = configs(capacity=16)
    jst = jax_state(jc, [(30.0, 0.0)])  # blocks source 1
    for dt in (1.0, 1.0 / 60.0, 0.7):
        js, jspawned, jdrop = jstep._spawn_phase(jc, jp, jst, dt,
                                                 jax.random.PRNGKey(0))
        ts, tspawned, tdrop = tstep._spawn_phase(
            tc, tp, convert.state_from_numpy(to_np(jst), device="cpu"), dt)
        assert int(tdrop) == int(jdrop), dt
        np.testing.assert_array_equal(tspawned.numpy(), np.asarray(jspawned))
        assert_states_equal(js, convert.state_to_numpy(ts))


def test_poisson_requests_mean():
    """2,000 PoissonCrowd draws average within 4 standard errors of
    rate*dt, and the state's generator moves on between steps."""
    n, rate, dt = 2000, 3.0, 0.5
    specs = [dict(LIFECYCLE, source=(0.0, 0.0),
                  crowd_generator=PoissonCrowd(rate))] * n
    tp = stack_source_params(
        [SourceSink(high_level_planner=None, local_planner=None, **s)
         for s in specs], [0] * n, [0] * n, [[-1]] * n, torch.float32,
        device="cpu")
    st = make_state(SimConfig(capacity=4), seed=3, device="cpu")
    draws = [tstep.spawn_requests(tp, dt, st.generator) for _ in range(2)]
    lam = rate * dt
    for d in draws:
        assert d.dtype == torch.int32 and (d >= 0).all()
        assert abs(d.double().mean().item() - lam) < 4 * np.sqrt(lam / n)
    assert not torch.equal(draws[0], draws[1])


def test_sink_phase_matches_jax():
    """``_sink_phase`` field for field on a random scene: rogue agents,
    advances (a new route leg for the route-following planner only),
    wraps (no new leg) and despawns, against the pre-move position."""
    rng = np.random.default_rng(11)
    s, w, n = 6, 3, 256
    wp = rng.uniform(-5, 5, (s, w, 2))
    nwp = np.array([1, 2, 3, 3, 2, 1], np.int32)
    specs = [dict(source=(0.0, 0.0), waypoints=[tuple(p) for p in wp[i,
                                                                   :nwp[i]]],
                  radius_sink=1.0 + 0.1 * i, agent_eyesight_range=2.0,
                  loop_forever=bool(i % 2),
                  crowd_generator=MonotonicCrowd(1.0)) for i in range(s)]
    legs = [list(range(10 * i, 10 * i + nwp[i])) for i in range(s)]
    jp, tp = sources_both(specs, legs=legs)
    jc, tc = configs(capacity=n)
    src = rng.integers(-1, s, n).astype(np.int32)
    nxt = rng.integers(0, w + 1, n).astype(np.int32)
    near = wp[np.clip(src, 0, s - 1), np.clip(nxt, 0, w - 1)]
    pos = near + rng.normal(0, 0.8, (n, 2))
    st = jax_state(jc, []).replace(
        position=jnp.asarray(pos, jnp.float32),
        alive=jnp.asarray(rng.random(n) < 0.9),
        source_id=jnp.asarray(src), next_waypoint=jnp.asarray(nxt),
        hl_idx=jnp.asarray(rng.integers(0, 2, n).astype(np.int32)),
        route_id=jnp.asarray(rng.integers(-1, 50, n).astype(np.int32)),
        route_wp=jnp.asarray(rng.integers(0, 3, n).astype(np.int32)),
    )
    routes = J.RouteTable.empty(64, 2, jnp.float32)
    jhl = [J.ConstantVelocity((1.0, 0.0)), J.WaypointFollow(routes)]
    thl = [ConstantVelocity((1.0, 0.0)),
           WaypointFollow(RouteTable.empty(64, 2, torch.float32, "cpu"))]
    jparams = J.SimParams(hl=(), lp=(), sources=jp)
    tparams = SimParams(hl=(), lp=(), sources=tp)
    js, jdes, jrea = jstep._sink_phase(jc, jhl, jparams, st)
    ts, tdes, trea = tstep._sink_phase(
        tc, thl, tparams, convert.state_from_numpy(to_np(st), device="cpu"))
    np.testing.assert_array_equal(tdes.numpy(), np.asarray(jdes))
    np.testing.assert_array_equal(trea.numpy(), np.asarray(jrea))
    assert_states_equal(js, convert.state_to_numpy(ts))
    # Every branch ran.
    has = np.asarray(st.alive) & (src >= 0)
    wlen = nwp[np.clip(src, 0, s - 1)]
    reached = np.asarray(jrea)
    at_last = nxt == wlen - 1
    loop = np.clip(src, 0, s - 1) % 2 == 1
    assert (has & (nxt >= wlen)).any()                      # rogue
    assert (reached & at_last & loop).any()                 # wrap
    assert (reached & at_last & ~loop).any()                # despawn
    adv = reached & ~at_last
    assert (adv & (np.asarray(st.hl_idx) == 1)).any()       # new leg
    assert (adv & (np.asarray(st.hl_idx) == 0)).any()       # leg kept
    moved = np.asarray(js.route_id) != np.asarray(st.route_id)
    assert moved.any() and not (moved & ~adv).any()


def test_waypoint_follow_matches_jax():
    """``WaypointFollow.plan`` on a random route table: advances within
    the tolerance, agents without a route, and an agent exactly on its
    last waypoint (zero velocity, not NaN)."""
    rng = np.random.default_rng(5)
    r, length, n = 8, 4, 128
    pts = rng.uniform(-3, 3, (r, length, 2)).astype(np.float32)
    lens = rng.integers(1, length + 1, r).astype(np.int32)
    rid = rng.integers(-1, r, n).astype(np.int32)
    rwp = rng.integers(0, length, n).astype(np.int32)
    tgt = pts[np.clip(rid, 0, r - 1), rwp]
    pos = (tgt + rng.normal(0, 0.1, (n, 2))).astype(np.float32)
    # Agent 0 sits exactly on the last waypoint of route 0.
    rid[0], rwp[0] = 0, lens[0] - 1
    pos[0] = pts[0, lens[0] - 1]
    jroutes = J.RouteTable(points=jnp.asarray(pts),
                           lengths=jnp.asarray(lens))
    jc, _ = configs(capacity=n)
    st = jax_state(jc, []).replace(
        position=jnp.asarray(pos), route_id=jnp.asarray(rid),
        route_wp=jnp.asarray(rwp))
    jplanner = J.WaypointFollow(jroutes)
    jres = jplanner.plan(jplanner.init_params(), st)
    tparams = convert.hl_params_from_numpy(to_np(jplanner.init_params()),
                                           device="cpu")
    assert isinstance(tparams["routes"], RouteTable)
    tplanner = WaypointFollow(convert.route_table_from_numpy(
        to_np(jroutes), device="cpu"))
    tres = tplanner.plan(tparams,
                         convert.state_from_numpy(to_np(st), device="cpu"))
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(tres.route_wp.numpy(),
                                  np.asarray(jres.route_wp))
    np.testing.assert_allclose(tres.vel.numpy(), np.asarray(jres.vel),
                               rtol=1e-6, atol=1e-6)
    assert tres.vel[0].tolist() == [0.0, 0.0]
    advanced = tres.route_wp.numpy() != rwp
    assert advanced.any() and (~tres.valid.numpy()).any()
    # The port's own init_params gives the same plan.
    own = tplanner.plan(tplanner.init_params("cpu"),
                        convert.state_from_numpy(to_np(st), device="cpu"))
    assert torch.equal(own.vel, tres.vel)
