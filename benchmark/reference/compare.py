"""The comparison that decides ``correct``: one step of the program against
one step of the reference from the same state, agent by agent by uid.

An agent is off when it is alive on one side only, when its waypoint
index, route or route cursor differ, or when its velocity differs by more
than ``RTOL * |v| + ATOL`` in a component, ``|v|`` the norm of the
reference's velocity (the repo's kernel-against-oracle tolerance, taken
against the vector: the kernels sum the forces in another order and take
the time to collision in another f32 form, so a component's error scales
with the forces, not with that component), or its position by more than
``dt`` times that plus two float32 ulps.

An agent that is off only because one neighbour lies within a few ulps of
its eyesight radius is a tie, not a fault: the kernels test ``d^2 <
eye^2`` and the reference ``|d| < eye``, which round apart there (ROADMAP
F4).  Such an agent is recomputed with each subset of its edge neighbours
toggled; if one subset gives the program's answer it is listed under
``ties`` with the neighbours' uids, and not counted.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from . import crowd

RTOL = 2e-4
ATOL = 2e-4
EDGE_ULPS = 4        # edge neighbours: | |d| - eye | within this many ulps
MAX_EDGE = 4         # more edge neighbours than this are not searched


def agents(fields: dict, next_uid: int) -> crowd.Agents:
    """Live rows of a slot state given as tensors by field name
    (``position``, ``velocity``, ... as ``SimState`` names them)."""
    alive = fields["alive"]
    names = dict(pos="position", vel="velocity", pref="preferred_vel",
                 nwp="next_waypoint", eye="eyesight", uid="uid",
                 src="source_id", hl="hl_idx", lp="lp_idx", rid="route_id",
                 rwp="route_wp", prio="priority")
    rows = {}
    for f, name in names.items():
        t = fields[name][alive]
        rows[f] = t.long() if not t.is_floating_point() else t
    return crowd.Agents(**rows, next_uid=int(next_uid))


def _order(a: crowd.Agents) -> crowd.Agents:
    return a.take(torch.argsort(a.uid))


def _close_vel(got, ref):
    tol = ATOL + RTOL * torch.linalg.vector_norm(ref, dim=-1, keepdim=True)
    return ((got - ref).abs() <= tol).all(-1)


def _close_pos(got, ref, vref, dt):
    ulp = torch.nextafter(ref.abs(), torch.full_like(ref, float("inf"))) \
        - ref.abs()
    vtol = ATOL + RTOL * torch.linalg.vector_norm(vref, dim=-1, keepdim=True)
    return ((got - ref).abs() <= dt * vtol + 2 * ulp).all(-1)


@dataclasses.dataclass
class Verdict:
    agents_off: int = 0
    events_off: int = 0
    compared: int = 0
    ties: list = dataclasses.field(default_factory=list)
    worst_vel: float = 0.0
    off_uids: list = dataclasses.field(default_factory=list)

    def add(self, other: "Verdict") -> None:
        self.agents_off += other.agents_off
        self.events_off += other.events_off
        self.compared += other.compared
        self.ties += other.ties
        self.worst_vel = max(self.worst_vel, other.worst_vel)
        self.off_uids += other.off_uids


def _explain(world: crowd.World, ctx, i: int, want_vel, want_pos) -> list:
    """uids of edge neighbours whose toggling gives the program's answer
    for row ``i`` of the post-spawn agents; [] when none does."""
    rec, my_pref, a = ctx
    p64 = a.pos.double()
    d = torch.linalg.vector_norm(p64 - p64[i], dim=-1)
    eye = float(a.eye[i])
    ulp = float(np.spacing(np.float32(eye)))
    edge = torch.nonzero((d - eye).abs() <= EDGE_ULPS * ulp).flatten()
    edge = edge[edge != i]
    if edge.numel() == 0 or edge.numel() > MAX_EDGE:
        return []
    rows = torch.tensor([i], device=a.pos.device)
    idx, valid = crowd.neighbours(a.pos, a.eye, rows,
                                  float(a.eye.max()))
    edge_l = edge.tolist()
    for r in range(1, len(edge_l) + 1):
        for subset in itertools.combinations(edge_l, r):
            flip = torch.zeros_like(valid)
            for j in subset:
                flip |= idx == j
            v = crowd.local_velocity(world.zanlungo, a, my_pref, rec, rows,
                                     idx, valid ^ flip)
            p = a.pos[rows] + v * world.dt
            if bool(_close_vel(want_vel[None].to(v.dtype), v)[0]) and bool(
                    _close_pos(want_pos[None].to(p.dtype), p, v,
                               world.dt)[0]):
                return [int(a.uid[j]) for j in subset]
    return []


def _diagnose(world, ctx, uid: int, got_v, ref_v) -> dict:
    """What the record of an agent that is off shows: its uid, the two
    velocities, and (with ``ctx``) its nearest margin to the eyesight edge
    and its time to collision."""
    out = {"uid": uid, "got": got_v.tolist(), "ref": ref_v.tolist()}
    if ctx is None:
        return out
    rec, my_pref, a = ctx
    hit = torch.nonzero(a.uid == uid).flatten()
    if hit.numel() == 0:
        return out
    i = int(hit[0])
    rows = torch.tensor([i], device=a.pos.device)
    idx, valid = crowd.neighbours(a.pos, a.eye, rows, float(a.eye.max()))
    d = torch.linalg.vector_norm(a.pos[idx].double() - a.pos[i].double(),
                                 dim=-1)
    out["edge_margin"] = float((d - float(a.eye[i])).abs().min())
    out["neighbours"] = int(valid.sum())
    ttc = crowd.time_to_collision(a.vel[idx] - a.vel[rows][:, None],
                                  a.pos[idx] - a.pos[rows][:, None],
                                  torch.tensor(world.zanlungo.agent_radius,
                                               dtype=a.pos.dtype))
    out["t_i"] = float(torch.where(valid, ttc, float("inf")).min())
    return out


def judge(world: crowd.World, ref_post: crowd.Agents, got: crowd.Agents,
          ctx=None) -> Verdict:
    """Compare ``got`` (the program's live agents after the step) with
    ``ref_post``; ``ctx`` (the reference step's third result) lets ties be
    recognised."""
    ref = _order(ref_post)
    got = _order(got)
    common = np.intersect1d(ref.uid.cpu().numpy(), got.uid.cpu().numpy())
    only = ref.uid.shape[0] + got.uid.shape[0] - 2 * common.shape[0]
    c = torch.as_tensor(common, device=ref.uid.device)
    r = ref.take(torch.searchsorted(ref.uid, c))
    g = got.take(torch.searchsorted(got.uid, c))
    gv, gp = g.vel.float(), g.pos.float()
    rv, rp = r.vel.float(), r.pos.float()
    ok = (_close_vel(gv, rv) & _close_pos(gp, rp, rv, world.dt)
          & (g.nwp == r.nwp) & (g.rid == r.rid) & (g.rwp == r.rwp))
    v = Verdict(compared=int(c.shape[0]) + only,
                worst_vel=float((gv - rv).abs().max()) if c.numel() else 0.0)
    bad = torch.nonzero(~ok).flatten().tolist()
    off = only
    for k in bad:
        uid = int(c[k])
        tie = []
        same_ints = bool((g.nwp[k] == r.nwp[k]) & (g.rid[k] == r.rid[k])
                         & (g.rwp[k] == r.rwp[k]))
        if ctx is not None and same_ints and len(bad) <= 64:
            i = int(torch.nonzero(ctx[2].uid == uid).flatten()[0])
            tie = _explain(world, ctx, i, gv[k], gp[k])
        if tie:
            v.ties.append((uid, tie))
        else:
            off += 1
            if len(v.off_uids) < 8:
                v.off_uids.append(_diagnose(world, ctx, uid, gv[k], rv[k]))
    v.agents_off = off
    return v


def pairs(uid, pos=None):
    uid = np.asarray(uid, np.int64).reshape(-1)
    if pos is None:
        return sorted(int(u) for u in uid)
    pos = np.asarray(pos, np.float32).reshape(-1, 2)
    return sorted((int(u), float(x), float(y)) for u, (x, y) in zip(uid, pos))


def events_off(ref: crowd.Events, got: dict) -> int:
    """Event records on one side only; ``got`` holds ``spawned`` and
    ``reached`` as (uid, x, y) lists and ``destroyed`` as uids."""
    ref_sets = {
        "spawned": pairs(ref.spawned_uid.cpu(), ref.spawned_pos.float().cpu()),
        "reached": pairs(ref.reached_uid.cpu(), ref.reached_pos.float().cpu()),
        "destroyed": pairs(ref.destroyed_uid.cpu()),
    }
    n = 0
    for kind, want in ref_sets.items():
        have = sorted(got[kind])
        a, b = list(want), list(have)
        for item in list(a):
            if item in b:
                b.remove(item)
                a.remove(item)
        n += len(a) + len(b)
    return n
