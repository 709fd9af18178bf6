"""One step of the crowd, written plainly from the reference's semantics.

This is the benchmark's reference: plain PyTorch, in the dtype it is
given, over the live agents as compact rows (no slots, no tiles, no
buckets).  It follows rmf_crowdsim's ``Simulation::step`` (lib.rs:195-383):

1. SourceSinks (lib.rs:199-254): each source asks its generator for a
   count; a source with a request and no live agent strictly within the
   spawn clearance spawns one agent at its position, while free slots
   last; uids go by the rank of the sources that want to spawn.
2. High-level planners (lib.rs:263-273): ``parity`` (even uids walk
   ``-v``, odd ``+v``; rmf_crowdsim_viz/src/main.rs:20-41) and ``routes``
   (chase the route's waypoint, advance within the arrival tolerance;
   rmf/mod.rs:197-215).
3. The Zanlungo local planner (zanlungo.rs:49-218) over every live agent
   strictly within the query's eyesight, found by an exact cell list.
4. Euler integration (lib.rs:295-297) and the sink bookkeeping against
   the position before the move (lib.rs:304-336): an agent strictly
   inside its waypoint's disc advances (taking the next route leg), wraps
   or, at the last waypoint, is destroyed.

Distances are Euclidean norms (``torch.linalg.vector_norm``) compared
strictly, as the reference's spatial index does (location_hash_2d.rs:251).
It imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

FIELDS = ("pos", "vel", "pref", "nwp", "eye", "uid", "src", "hl", "lp",
          "rid", "rwp", "prio")


@dataclasses.dataclass
class Agents:
    """Live agents as rows; integer fields are int64."""

    pos: torch.Tensor
    vel: torch.Tensor
    pref: torch.Tensor
    nwp: torch.Tensor
    eye: torch.Tensor
    uid: torch.Tensor
    src: torch.Tensor
    hl: torch.Tensor
    lp: torch.Tensor
    rid: torch.Tensor
    rwp: torch.Tensor
    prio: torch.Tensor
    next_uid: int

    def take(self, keep: torch.Tensor) -> "Agents":
        return Agents(**{f: getattr(self, f)[keep] for f in FIELDS},
                      next_uid=self.next_uid)

    def to(self, dtype: torch.dtype) -> "Agents":
        cast = {f: getattr(self, f).to(dtype) for f in ("pos", "vel", "pref",
                                                          "eye", "prio")}
        return dataclasses.replace(self, **cast)


@dataclasses.dataclass(frozen=True)
class Zanlungo:
    agent_scale: float
    obstacle_scale: float
    reaction_time: float
    force_distance: float
    agent_mass: float
    agent_radius: float
    force_cap: float


@dataclasses.dataclass(frozen=True)
class Routes:
    """A route planner's table: ``points`` [R, L, 2], ``lengths`` [R]."""

    points: torch.Tensor
    lengths: torch.Tensor
    tol: float


@dataclasses.dataclass(frozen=True)
class Sources:
    """The SourceSinks in the order the session holds them."""

    pos: torch.Tensor         # [S, 2]
    waypoints: torch.Tensor   # [S, W, 2]
    n_wp: torch.Tensor        # [S]
    radius: torch.Tensor      # [S]
    loop: torch.Tensor        # [S] bool
    eye: torch.Tensor         # [S]
    hl: torch.Tensor          # [S]
    lp: torch.Tensor          # [S]
    legs: torch.Tensor        # [S, W] route ids, -1 without
    rate: torch.Tensor        # [S] agents/s of a monotonic source
    requests: Optional[Callable[[int], torch.Tensor]] = None
    # requests(step) -> [S] int64: the counts of a host generator


@dataclasses.dataclass(frozen=True)
class World:
    dt: float
    capacity: int
    clearance: float
    commit_pref: bool
    zanlungo: Zanlungo
    planners: tuple      # per hl index: ("parity", (vx, vy)) | ("routes", Routes)
    sources: Optional[Sources] = None


@dataclasses.dataclass
class Events:
    spawned_uid: torch.Tensor
    spawned_pos: torch.Tensor
    reached_uid: torch.Tensor
    reached_pos: torch.Tensor
    destroyed_uid: torch.Tensor


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


# ---------------------------------------------------------------------------
# Neighbours: an exact cell list
# ---------------------------------------------------------------------------


def neighbours(pos: torch.Tensor, eye: torch.Tensor, queries: torch.Tensor,
               cell: float):
    """Candidate table of ``queries`` (row indices): every other row in the
    3x3 cells of side ``cell`` (>= every eyesight) around each query, and
    whether it lies strictly within the query's eyesight.  Returns (idx
    [Q, K] long, valid [Q, K] bool)."""
    dev = pos.device
    lo = pos.min(0).values
    c = torch.floor((pos - lo) / cell).long()
    ny = int(c[:, 1].max()) + 3
    key = (c[:, 0] + 1) * ny + (c[:, 1] + 1)
    skey, order = torch.sort(key)
    uniq, counts = torch.unique_consecutive(skey, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    k = int(counts.max())
    qk = key[queries]
    offs = torch.tensor([dx * ny + dy for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                        device=dev)
    ck = qk[:, None] + offs[None, :]                              # [Q, 9]
    at = torch.searchsorted(uniq, ck).clamp(max=uniq.shape[0] - 1)
    hit = uniq[at] == ck
    s0 = torch.where(hit, start[at], 0)
    n = torch.where(hit, counts[at], 0)
    lane = torch.arange(k, device=dev)
    ok = lane[None, None, :] < n[:, :, None]                      # [Q, 9, k]
    idx = order[(s0[:, :, None] + lane).clamp(max=pos.shape[0] - 1)]
    idx = idx.reshape(queries.shape[0], 9 * k)
    ok = ok.reshape(queries.shape[0], 9 * k) & (idx != queries[:, None])
    d = norm(pos[idx] - pos[queries][:, None, :])
    return idx, ok & (d < eye[queries][:, None])


# ---------------------------------------------------------------------------
# Zanlungo (zanlungo.rs)
# ---------------------------------------------------------------------------


def _dot(a, b):
    return (a * b).sum(-1)


def time_to_collision(rel_vel, rel_pos, radius):
    """|rel_pos + t rel_vel| = radius (zanlungo.rs:49-74): no real root or
    no relative motion -> inf; roots of opposite sign -> 0; else the
    smallest positive root, inf if none."""
    a = _dot(rel_vel, rel_vel)
    b = 2.0 * _dot(rel_vel, rel_pos)
    c = _dot(rel_pos, rel_pos) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    two_a = 2.0 * torch.where(a > 0, a, torch.ones_like(a))
    t0 = (-b - sq) / two_a
    t1 = (-b + sq) / two_a
    inf = torch.full_like(a, float("inf"))
    res = torch.where(((t0 < 0) & (t1 > 0)) | ((t1 < 0) & (t0 > 0)),
                      torch.zeros_like(a),
                      torch.where((t0 < t1) & (t0 > 0), t0,
                                  torch.where(t1 > 0, t1, inf)))
    return torch.where((disc < 0) | (a <= 0), inf, res)


def zanlungo(z: Zanlungo, pos, vel, my_pref, prio, opos, ovel, opref, oprio,
             valid, rec):
    """Desired velocity of queries (rows ``pos`` [Q, 2] ...) against their
    candidates (``opos`` [Q, K, 2] ...) where ``valid`` (zanlungo.rs:201-218,
    compute_tti :76-91, right_of_way_vel :173-198, compute_agent_force
    :93-170)."""
    dt = pos.dtype
    radius = torch.tensor(z.agent_radius, dtype=dt, device=pos.device)
    zero = torch.zeros((), dtype=dt, device=pos.device)
    inf = torch.full((), float("inf"), dtype=dt, device=pos.device)
    p, v, mp = pos[:, None, :], vel[:, None, :], my_pref[:, None, :]

    t_i = torch.where(valid, time_to_collision(ovel - v, opos - p, radius),
                      inf).amin(-1)
    row = torch.clamp(prio[:, None] - oprio, -1.0, 1.0)
    r2n = torch.sqrt(torch.clamp(-row, min=0.0))
    r2p = torch.sqrt(torch.clamp(row, min=0.0))
    w = torch.where(row < 0, -r2n, torch.where(row > 0, r2p, zero))
    my_vel = torch.where((row > 0)[..., None], v + r2p[..., None] * (mp - v),
                         v)
    other_vel = torch.where((row < 0)[..., None],
                            ovel + r2n[..., None] * (opref - ovel), ovel)
    weight = 1.0 - w
    t = t_i[:, None, None]
    d_ij = (p + my_vel * t) - (opos + other_vel * t)
    dist = norm(d_ij)

    stationary = norm(opref) < 1e-4
    curr = p - opos
    perp_s = torch.stack([-curr[..., 1], curr[..., 0]], -1)
    perp_s = torch.where((_dot(perp_s, v) < 0)[..., None], -perp_s, perp_s)
    perp_m = torch.stack([-opref[..., 1], opref[..., 0]], -1)
    perp_m = torch.where((_dot(perp_m, d_ij) < 0)[..., None], -perp_m, perp_m)
    interpolate = stationary | (_dot(opref, d_ij) > 0)
    perp = torch.where(stationary[..., None], perp_s, perp_m)
    sin_t = torch.clamp(torch.abs(perp[..., 0] * d_ij[..., 1]
                                  - perp[..., 1] * d_ij[..., 0]), max=1.0)
    # slerp(weight - 1, d_ij, perp) (zanlungo.rs:23-28)
    s = weight - 1.0
    theta = torch.asin(sin_t)
    safe = torch.where(sin_t > 0, sin_t, torch.ones_like(sin_t))
    slerped = (d_ij * (torch.sin((1.0 - s) * theta) / safe)[..., None]
               + perp * (torch.sin(s * theta) / safe)[..., None])
    slerped = torch.where((sin_t > 0)[..., None], slerped, d_ij)
    d_ij = torch.where(((weight > 1.0) & interpolate)[..., None], slerped,
                       d_ij)
    d_norm = norm(d_ij)
    d_unit = torch.where((d_norm > 0)[..., None],
                         d_ij / torch.where(d_norm > 0, d_norm,
                                            torch.ones_like(d_norm))[..., None],
                         zero)
    speed_diff = norm(my_vel - other_vel)
    safe_t = torch.where(t_i > 0, t_i, torch.ones_like(t_i))[:, None]
    mag = weight * z.agent_scale * speed_diff / safe_t
    mag = torch.where((t_i == 0)[:, None] & (speed_diff * weight > 0), inf,
                      mag)
    mag = torch.clamp(mag, max=z.force_cap)
    falloff = torch.exp(-(dist - 2.0 * radius) / z.force_distance)
    force = torch.where(valid[..., None], d_unit * (mag * falloff)[..., None],
                        zero)
    total = torch.where(torch.isfinite(t_i)[:, None], force.sum(1), zero)
    return rec + total / z.agent_mass


def local_velocity(z: Zanlungo, a: Agents, my_pref, rec, rows, idx, valid):
    """Zanlungo's velocity of agents ``rows`` against candidates ``idx``."""
    return zanlungo(z, a.pos[rows], a.vel[rows], my_pref[rows], a.prio[rows],
                    a.pos[idx], a.vel[idx], a.pref[idx], a.prio[idx], valid,
                    rec[rows])


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _spawn(world: World, a: Agents, step: int):
    src = world.sources
    dt = a.pos.dtype
    dev = a.pos.device
    s = src.pos.shape[0]
    if src.requests is not None:
        req = src.requests(step).to(dev)
    else:
        req = torch.floor(src.rate.to(dt) * world.dt + 0.5).long()
    blocked = torch.zeros((s,), dtype=torch.bool, device=dev)
    spos = src.pos.to(dt)
    for lo in range(0, s, 64):
        d = norm(a.pos[None, :, :] - spos[lo:lo + 64, None, :])
        blocked[lo:lo + 64] = (d < world.clearance).any(1)
    want = (req > 0) & ~blocked
    rank = torch.cumsum(want.long(), 0) - 1
    can = want & (rank < world.capacity - a.pos.shape[0])
    sid = torch.nonzero(can).flatten()
    uid = a.next_uid + rank[sid]
    m = sid.shape[0]
    z2 = torch.zeros((m, 2), dtype=dt, device=dev)
    new = dict(pos=spos[sid], vel=z2, pref=z2, nwp=torch.zeros_like(sid),
               eye=src.eye[sid].to(dt), uid=uid, src=sid, hl=src.hl[sid],
               lp=src.lp[sid], rid=src.legs[sid, 0],
               rwp=torch.zeros_like(sid), prio=uid.to(dt))
    joined = Agents(**{f: torch.cat([getattr(a, f), new[f]]) for f in FIELDS},
                    next_uid=a.next_uid + m)
    return joined, uid, spos[sid]


def _high_level(world: World, a: Agents):
    dt = a.pos.dtype
    vel = torch.zeros_like(a.pos)
    my_pref = a.pref.clone()
    rwp = a.rwp.clone()
    for i, (kind, arg) in enumerate(world.planners):
        sel = a.hl == i
        if kind == "parity":
            v = torch.tensor(arg, dtype=dt, device=a.pos.device)
            sign = torch.where(a.uid % 2 == 0, -1.0, 1.0).to(dt)
            vel = torch.where(sel[:, None], sign[:, None] * v, vel)
            my_pref = torch.where(sel[:, None], sign[:, None] * v, my_pref)
            continue
        r: Routes = arg
        pts = r.points.to(dt)
        has = sel & (a.rid >= 0)
        rid = a.rid.clamp(0, pts.shape[0] - 1)
        wp = a.rwp.clamp(0, pts.shape[1] - 1)
        d = norm(a.pos - pts[rid, wp])
        wp2 = torch.where((d < r.tol) & (wp + 1 < r.lengths[rid]), wp + 1, wp)
        to_go = pts[rid, wp2] - a.pos
        dist = norm(to_go)[:, None]
        unit = torch.where(dist > 0, to_go / torch.where(dist > 0, dist,
                                                         torch.ones_like(dist)),
                           torch.zeros_like(to_go))
        vel = torch.where(has[:, None], unit, vel)
        my_pref = torch.where(has[:, None], unit, my_pref)
        rwp = torch.where(has, wp2, rwp)
    return vel, my_pref, rwp


def _sinks(world: World, a: Agents):
    """(next waypoint, route id, route cursor, reached, destroyed)."""
    src = world.sources
    none = torch.zeros_like(a.uid, dtype=torch.bool)
    if src is None:
        return a.nwp, a.rid, a.rwp, none, none
    s = src.pos.shape[0]
    w = src.waypoints.shape[1]
    has = a.src >= 0
    si = a.src.clamp(0, s - 1)
    wlen = src.n_wp[si]
    rogue = has & (a.nwp >= wlen)
    target = src.waypoints.to(a.pos.dtype)[si, a.nwp.clamp(0, w - 1)]
    reached = has & ~rogue & (norm(a.pos - target)
                              < src.radius.to(a.pos.dtype)[si])
    at_last = a.nwp == wlen - 1
    loop = src.loop[si]
    advance = reached & ~at_last
    nwp = torch.where(reached & at_last & loop, 0,
                      torch.where(advance, a.nwp + 1, a.nwp))
    nwp = torch.where(has, nwp, a.nwp)
    routed = torch.tensor([k == "routes" for k, _ in world.planners],
                          device=a.uid.device)[a.hl]
    take = advance & routed
    rid = torch.where(take, src.legs[si, nwp.clamp(0, w - 1)], a.rid)
    rwp = torch.where(take, 0, a.rwp)
    return nwp, rid, rwp, reached, (reached & at_last & ~loop) | rogue


def step(world: World, a: Agents, step_index: int = 0,
         block: int = 1 << 15, only: Optional[torch.Tensor] = None):
    """One step from ``a`` (live agents, in the reference's dtype).
    ``only``: uids whose local planner runs (the others keep their
    high-level velocity; for a sampled comparison).  Returns (live agents
    after the step, its events, (rec, my_pref, post-spawn agents))."""
    dev = a.pos.device
    if world.sources is not None:
        a, s_uid, s_pos = _spawn(world, a, step_index)
    else:
        s_uid = torch.zeros((0,), dtype=torch.long, device=dev)
        s_pos = a.pos[:0]
    rec, my_pref, rwp = _high_level(world, a)
    a = dataclasses.replace(a, rwp=rwp)
    vel = rec.clone()
    sel = a.lp == 0
    if only is not None:
        sel &= torch.isin(a.uid, only)
    moving = torch.nonzero(sel).flatten()
    cell = float(max(float(a.eye.max()) if a.eye.numel() else 0.0, 1e-3))
    for lo in range(0, moving.shape[0], block):
        rows = moving[lo:lo + block]
        idx, valid = neighbours(a.pos, a.eye, rows, cell)
        vel[rows] = local_velocity(world.zanlungo, a, my_pref, rec, rows,
                                   idx, valid)
    nwp, rid, rwp, reached, destroyed = _sinks(world, a)
    post = dataclasses.replace(
        a, pos=a.pos + vel * world.dt, vel=vel, nwp=nwp, rid=rid, rwp=rwp,
        pref=my_pref if world.commit_pref else a.pref)
    events = Events(spawned_uid=s_uid, spawned_pos=s_pos,
                    reached_uid=a.uid[reached], reached_pos=a.pos[reached],
                    destroyed_uid=a.uid[destroyed])
    return post.take(~destroyed), events, (rec, my_pref, a)
