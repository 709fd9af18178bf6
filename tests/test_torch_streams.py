"""The streaming scene through the port's kernel paths against the JAX
package.

``scenes.build_streams`` at 1,024 agents with the 48-agent hotspot inside
one tile, capacity 1,280 and 16 sources, pre-rolled 13 steps by the JAX
package (``brute``) so that the next steps spawn, reach waypoints, despawn
and loop; the pre-roll scatters the hotspot, so its agents are put back at
rest where they started, and buckets overflow again.  Then 6 steps at
dt = 1/60 with ``event_capacity`` 64 through the port's ``build_rollout``
on ``grid_pallas``, ``grid_pallas`` with fused spills, ``grid_dense`` and
``brute``, each against the JAX package's on the same backend (the fused
path against JAX's spill patch, which the JAX package holds equal to its
fused path; the kernels in interpret mode): positions by uid to 2e-4,
counters equal, and each step's event records equal as sets of uids (slot
order differs after the unstable presort) with positions matched by uid.
Then, in the port alone from the pre-rolled state, steps whose sinks fire
under the carried binning (nothing spawns, the skin keeps the sort)
against re-sorting every step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
from rmf_crowdsim_tpu.core.step import build_rollout as jax_build_rollout
from rmf_crowdsim_tpu.models.source_sink import SourceParams as JSourceParams
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.core.step import build_step, empty_skin
from rmf_crowdsim_tpu_torch.utils import convert

N, CAP, S = 1024, 1280, 16
HOTSPOT = (6.0, 6.0)   # inside tile (5, 5) of the 1,024-agent world
PRE, STEPS, K = 13, 6, 64
DT = 1.0 / 60.0
BACKENDS = {"grid_pallas": dict(backend="grid_pallas"),
            "fused_spills": dict(backend="grid_pallas", fused_spills=True),
            "grid_dense": dict(backend="grid_dense"),
            "brute": dict(backend="brute")}
# The JAX run each port path is held against.
REFERENCE = {"grid_pallas": "grid_pallas", "fused_spills": "grid_pallas",
             "grid_dense": "grid_dense", "brute": "brute"}
COUNTERS = ("n_alive", "n_spawned", "n_destroyed", "n_waypoint_reached",
            "spawn_dropped", "out_of_bounds", "max_cell_occupancy",
            "neighbor_truncated")
KINDS = (("spawned_uid", "spawned_pos", "n_spawned"),
         ("destroyed_uid", None, "n_destroyed"),
         ("reached_uid", "reached_pos", "n_waypoint_reached"))


def streams(device="cpu", **kw):
    return scenes.build_streams(N, CAP, S, device=device, hotspot=True,
                                hotspot_origin=HOTSPOT, **kw)


def jax_config(**kw):
    c = scenes.stream_config(N, CAP, **kw)
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    fields["grid"] = J.GridConfig(**dataclasses.asdict(c.grid))
    fields["pallas_interpret"] = True
    return J.SimConfig(**fields)


def jax_scene(tparams):
    """The JAX planners and parameters of the port's streaming scene."""
    routes = tparams.hl[1]["routes"]
    jroutes = J.RouteTable(points=jnp.asarray(routes.points.numpy()),
                           lengths=jnp.asarray(routes.lengths.numpy()))
    hl = [J.ParityVelocity((1.0, 0.0)), J.WaypointFollow(jroutes)]
    lp = [J.Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=20.0)]
    sp = JSourceParams(**{
        f.name: jnp.asarray(getattr(tparams.sources, f.name).numpy())
        for f in dataclasses.fields(JSourceParams)})
    params = J.SimParams(hl=tuple(h.init_params() for h in hl),
                         lp=(lp[0].init_params(),), sources=sp)
    return hl, lp, params


def repack_hotspot(state):
    """``state`` (numpy fields) with the hotspot agents (uids 0..47) back
    at their first positions, at rest."""
    side = scenes.bench_config(N).grid.width
    first = scenes.bench_positions(N, side, hotspot=True,
                                   hotspot_origin=HOTSPOT)
    uid = np.asarray(state.uid)
    slots = np.flatnonzero((uid >= 0) & (uid < scenes.HOTSPOT_AGENTS)
                           & np.asarray(state.alive))
    assert slots.size == scenes.HOTSPOT_AGENTS
    pos, vel, pref = (np.array(state.position), np.array(state.velocity),
                      np.array(state.preferred_vel))
    pos[slots] = first[uid[slots]]
    vel[slots] = 0.0
    pref[slots] = 0.0
    return state.replace(position=pos, velocity=vel, preferred_vel=pref)


def by_uid(position, uid, alive):
    uid, alive = np.asarray(uid), np.asarray(alive)
    keep = np.flatnonzero(alive)
    order = keep[np.argsort(uid[keep])]
    return uid[order], np.asarray(position)[order]


@pytest.fixture(scope="module")
def runs():
    _, tparams, tstate = streams(backend="brute")
    hl, lp, jparams = jax_scene(tparams)
    jstate = J.make_state(jax_config(backend="brute")).replace(**{
        k: jnp.asarray(v) for k, v in convert.state_to_numpy(tstate).items()})
    pre = jax_build_rollout(jax_config(backend="brute"), hl, lp)
    jstate, _ = jax.jit(pre, static_argnums=(3,))(jparams, jstate, DT, PRE)
    rolled = jax.tree.map(np.asarray, jstate)
    start = repack_hotspot(rolled)
    jstate = jax.tree.map(jnp.asarray, start)
    out = {"rolled": rolled, "start": start}
    for name in sorted(set(REFERENCE.values())):
        ro = jax_build_rollout(jax_config(**BACKENDS[name]), hl, lp,
                               event_capacity=K)
        st, ev = jax.jit(ro, static_argnums=(3,))(jparams, jstate, DT, STEPS)
        out["jax", name] = (jax.tree.map(np.asarray, st),
                            jax.tree.map(np.asarray, ev))
    for name, kw in BACKENDS.items():
        t_ro, t_params, _ = streams(event_capacity=K, **kw)
        t_st = convert.state_from_numpy(start, device="cpu")
        st, ev = t_ro(t_params, t_st, DT, STEPS)
        out["torch", name] = (convert.state_to_numpy(st), ev)
    return out


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_streams_match_jax_by_uid(runs, backend):
    js, jev = runs["jax", REFERENCE[backend]]
    ts, tev = runs["torch", backend]
    j_uid, j_pos = by_uid(js.position, js.uid, js.alive)
    t_uid, t_pos = by_uid(ts["position"], ts["uid"], ts["alive"])
    np.testing.assert_array_equal(t_uid, j_uid)
    assert np.isfinite(t_pos).all()
    np.testing.assert_allclose(t_pos, j_pos, rtol=2e-4, atol=2e-4)
    assert int(ts["next_uid"]) == int(js.next_uid)
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(tev.counters, name).numpy(),
                                      getattr(jev.counters, name),
                                      err_msg=name)
    c = jev.counters
    # The window streams: agents spawn, reach waypoints and despawn.
    assert c.n_spawned.sum() > 0 and c.n_destroyed.sum() > 0
    assert c.n_waypoint_reached.sum() > 0 and c.spawn_dropped.sum() > 0
    assert (c.neighbor_truncated == 0).all()
    if backend in ("grid_pallas", "fused_spills"):
        assert (c.max_cell_occupancy > scenes.bench_config(N)
                .bucket_capacity).all()


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_event_records_match_jax(runs, backend):
    """Per step and kind, the valid uids equal JAX's as sets and their
    count equals the counter; spawn and waypoint positions by uid to
    2e-4; spawned uids are at least ``next_uid`` before the step."""
    _, jev = runs["jax", REFERENCE[backend]]
    _, tev = runs["torch", backend]
    assert (tev.overflow.numpy() == 0).all() and (jev.overflow == 0).all()
    next_uid = int(runs["start"].next_uid)
    for t in range(STEPS):
        for uid_f, pos_f, counter in KINDS:
            tu = getattr(tev, uid_f)[t].numpy()
            ju = getattr(jev, uid_f)[t]
            assert set(tu[tu >= 0]) == set(ju[ju >= 0]), (t, uid_f)
            assert (tu >= 0).sum() == int(
                getattr(tev.counters, counter)[t]), (t, uid_f)
            if pos_f is None:
                continue
            tp = getattr(tev, pos_f)[t].numpy()
            jp = getattr(jev, pos_f)[t]
            tk, jk = tu >= 0, ju >= 0
            np.testing.assert_allclose(
                tp[tk][np.argsort(tu[tk])], jp[jk][np.argsort(ju[jk])],
                rtol=2e-4, atol=2e-4, err_msg=f"{t} {pos_f}")
        spawned = tev.spawned_uid[t].numpy()
        assert (spawned[spawned >= 0] >= next_uid).all()
        next_uid += int(tev.counters.n_spawned[t])


@pytest.mark.parametrize("backend", ["grid_pallas", "fused_spills",
                                     "grid_dense"])
def test_fresh_dead_rows_under_carried_binning(runs, backend):
    """Every source off, so nothing spawns: the skin re-sorts only when an
    agent outruns its margin, and sinks despawn agents whose rows then
    stay in the carried binning, dead, for the next step.  The result
    equals re-sorting every step, by uid to 2e-4, with the same agents
    alive."""
    kw = BACKENDS[backend]
    config = scenes.stream_config(N, CAP, **kw)
    _, params, _ = streams(**kw)
    params = params.replace(sources=params.sources.replace(
        active=torch.zeros(S, dtype=torch.bool)))
    hl, lp = scenes.stream_planners(params.hl[1]["routes"])
    skin_step = build_step(config, hl, lp, skin_mode=True)
    plain_step = build_step(config, hl, lp)
    assert skin_step.skin_mode
    skin = empty_skin(config, "cpu")
    carried = convert.state_from_numpy(runs["rolled"], device="cpu")
    fresh = carried
    resorted, died = [], []
    for _ in range(STEPS):
        carried, ev, skin = skin_step(params, carried, DT, skin)
        fresh, ev_f = plain_step(params, fresh, DT)
        resorted.append(skin["resorted"])
        died.append(int(ev.destroyed.sum()))
        assert int(ev.spawned.sum()) == 0
        assert torch.equal(ev.destroyed.sum(), ev_f.destroyed.sum())
    assert resorted[0] and not all(resorted)
    # Rows that died on one step sat in the binning carried into the next.
    assert any(died[t] and not resorted[t + 1] for t in range(STEPS - 1))
    c_uid, c_pos = by_uid(carried.position, carried.uid, carried.alive)
    f_uid, f_pos = by_uid(fresh.position, fresh.uid, fresh.alive)
    np.testing.assert_array_equal(c_uid, f_uid)
    np.testing.assert_allclose(c_pos, f_pos, rtol=2e-4, atol=2e-4)
