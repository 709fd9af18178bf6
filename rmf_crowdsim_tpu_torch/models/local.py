"""Local (collision-avoidance) planners.

Counterpart of ``rmf_crowdsim_tpu/models/local.py``.  Each planner is a
batched function over the neighbor-candidate table::

    plan(params, state, nbr: NeighborSet, rec_vel[N,2], self_pref[N,2])

The Zanlungo math here (``zanlungo_from_rows``) is the port's oracle, the
``brute`` backend's force pass and the spill repair's own-row pass;
``Zanlungo.plan_fused`` and ``plan_fused_dense`` run the ``grid_pallas``
and ``grid_dense`` kernel paths.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import SimState, TensorDataclass
from ..ops.neighbors import NeighborSet, norm


class LocalPlanner:
    """``plan(params, state, nbr, rec_vel, self_pref)``; ``self_pref`` is
    the agent's own fresh preferred velocity, while neighbors expose the
    committed ``state.preferred_vel`` (see the JAX LocalPlanner)."""

    def init_params(self, device="cuda"):
        return ()

    def plan(self, params, state, nbr, rec_vel, self_pref):  # pragma: no cover
        raise NotImplementedError


class NoLocalPlan(LocalPlanner):
    """Returns the recommended velocity unchanged (no_local_plan.rs:7-18)."""

    needs_neighbors = False

    def plan(self, params, state: SimState, nbr: NeighborSet, rec_vel,
             self_pref):
        return rec_vel


@dataclasses.dataclass(frozen=True)
class ZanlungoParams(TensorDataclass):
    """Constructor parameters of the reference (zanlungo.rs:31-48) as 0-d
    float64 tensors; ``force_cap`` defaults to the reference's 1e15
    clamp."""

    agent_scale: torch.Tensor
    obstacle_scale: torch.Tensor
    reaction_time: torch.Tensor
    force_distance: torch.Tensor
    agent_mass: torch.Tensor
    agent_radius: torch.Tensor
    force_cap: torch.Tensor = None

    def __post_init__(self):
        if self.force_cap is None:
            object.__setattr__(
                self, "force_cap",
                torch.tensor(1e15, dtype=torch.float64,
                             device=self.agent_scale.device),
            )


def _dot(a, b):
    return (a * b).sum(-1)


def time_to_collision(rel_vel, rel_pos, agent_radius):
    """Pairwise time-to-collision via |rel_pos + t*rel_vel| = radius
    (zanlungo.rs:49-74): negative discriminant -> inf, roots of opposite
    sign -> 0, else the smallest positive root (inf if none)."""
    a = _dot(rel_vel, rel_vel)
    b = 2.0 * _dot(rel_vel, rel_pos)
    c = _dot(rel_pos, rel_pos) - agent_radius * agent_radius
    disc = b * b - 4.0 * a * c

    one = torch.ones((), dtype=a.dtype, device=a.device)
    safe_a = torch.where(a > 0, a, one)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / (2.0 * safe_a)
    t1 = (-b + sq) / (2.0 * safe_a)

    inf = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    opposite = ((t0 < 0) & (t1 > 0)) | ((t1 < 0) & (t0 > 0))
    res = torch.where(
        opposite,
        zero,
        torch.where((t0 < t1) & (t0 > 0), t0,
                    torch.where(t1 > 0, t1, inf)),
    )
    res = torch.where(disc < 0, inf, res)
    return torch.where(a > 0, res, inf)


def _slerp(t, p0, p1, sin_theta):
    """Spherical interpolation as the reference computes it
    (zanlungo.rs:23-28); parallel vectors (sin_theta == 0) give p0."""
    theta = torch.asin(sin_theta)
    safe = torch.where(sin_theta > 0, sin_theta, torch.ones_like(sin_theta))
    t0 = torch.sin((1.0 - t) * theta) / safe
    t1 = torch.sin(t * theta) / safe
    out = p0 * t0[..., None] + p1 * t1[..., None]
    return torch.where((sin_theta > 0)[..., None], out, p0)


def zanlungo_velocity(p: ZanlungoParams, position, velocity, self_pref,
                      pref_committed, priority, nbr_idx, nbr_valid, rec_vel,
                      *, q_position=None, q_velocity=None, q_priority=None):
    """Batched Zanlungo get_desired_velocity (zanlungo.rs:201-218) over a
    candidate table; ``q_*`` give distinct query rows (chunked use)."""
    if q_position is None:
        q_position, q_velocity, q_priority = position, velocity, priority
    return zanlungo_from_rows(
        p, q_position, q_velocity, self_pref, q_priority,
        position[nbr_idx], velocity[nbr_idx], pref_committed[nbr_idx],
        priority[nbr_idx], nbr_valid, rec_vel,
    )


def zanlungo_from_rows(p: ZanlungoParams, q_position, q_velocity, self_pref,
                       q_priority, opos, ovel, opref, oprio, nbr_valid,
                       rec_vel):
    """The Zanlungo math on pre-gathered candidate rows ([..., K, 2] /
    [..., K]) with arbitrary leading batch dims — line for line the JAX
    ``zanlungo_from_rows``."""
    dtype = q_position.dtype
    dev = q_position.device
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    radius = p.agent_radius.to(dtype)

    mypos = q_position[..., None, :]
    myvel = q_velocity[..., None, :]
    mypref = self_pref[..., None, :]
    myprio = q_priority[..., None]

    # compute_tti: min time-to-collision over neighbors (zanlungo.rs:76-91)
    rel_vel = ovel - myvel
    rel_pos = opos - mypos
    ttc = time_to_collision(rel_vel, rel_pos, radius)
    ttc = torch.where(nbr_valid, ttc, inf)
    t_i = ttc.amin(-1)

    # right_of_way_vel (zanlungo.rs:173-198)
    row = torch.clamp(myprio - oprio, -1.0, 1.0)
    r2n = torch.sqrt(torch.clamp(-row, min=0.0))
    r2p = torch.sqrt(torch.clamp(row, min=0.0))
    w = torch.where(row < 0, -r2n, torch.where(row > 0, r2p, zero))
    my_vel = torch.where((row > 0)[..., None],
                         myvel + r2p[..., None] * (mypref - myvel), myvel)
    other_vel = torch.where((row < 0)[..., None],
                            ovel + r2n[..., None] * (opref - ovel), ovel)

    # compute_agent_force (zanlungo.rs:93-170)
    weight = 1.0 - w
    t = t_i[..., None, None]
    fut = mypos + my_vel * t
    ofut = opos + other_vel * t
    d_ij = fut - ofut
    dist = norm(d_ij)

    pref_speed = norm(opref)
    stationary = pref_speed < 1e-4
    curr_rel = mypos - opos
    perp_s = torch.stack([-curr_rel[..., 1], curr_rel[..., 0]], dim=-1)
    flip_s = _dot(perp_s, myvel) < 0
    perp_s = torch.where(flip_s[..., None], -perp_s, perp_s)
    pref_dir = opref
    perp_m = torch.stack([-pref_dir[..., 1], pref_dir[..., 0]], dim=-1)
    flip_m = _dot(perp_m, d_ij) < 0
    perp_m = torch.where(flip_m[..., None], -perp_m, perp_m)
    moving_interp = _dot(pref_dir, d_ij) > 0

    interpolate = stationary | moving_interp
    perp = torch.where(stationary[..., None], perp_s, perp_m)

    sin_theta = torch.abs(perp[..., 0] * d_ij[..., 1]
                          - perp[..., 1] * d_ij[..., 0])
    sin_theta = torch.clamp(sin_theta, max=1.0)
    d_slerped = _slerp(weight - 1.0, d_ij, perp, sin_theta)
    use_slerp = (weight > 1.0) & interpolate
    d_ij = torch.where(use_slerp[..., None], d_slerped, d_ij)

    d_norm = norm(d_ij)
    d_unit = torch.where(
        (d_norm > 0)[..., None],
        d_ij / torch.where(d_norm > 0, d_norm,
                           torch.ones_like(d_norm))[..., None],
        zero,
    )

    surface_dist = dist - 2.0 * radius
    speed_diff = norm(my_vel - other_vel)
    safe_t = torch.where(t_i > 0, t_i, torch.ones_like(t_i))[..., None]
    magnitude = weight * p.agent_scale.to(dtype) * speed_diff / safe_t
    magnitude = torch.where((t_i == 0)[..., None] & (speed_diff * weight > 0),
                            inf, magnitude)
    magnitude = torch.minimum(magnitude, p.force_cap.to(dtype))

    falloff = torch.exp(-surface_dist / p.force_distance.to(dtype))
    force = d_unit * (magnitude * falloff)[..., None]

    force = torch.where(nbr_valid[..., None], force, zero)
    total = force.sum(-2)
    total = torch.where(torch.isfinite(t_i)[..., None], total, zero)
    return rec_vel + total / p.agent_mass.to(dtype)


class Zanlungo(LocalPlanner):
    """Zanlungo social-force local planner (zanlungo.rs).

    ``force_chunk``: if > 0, the table-based force pass runs over query
    chunks of this size, bounding the [chunk, K] temporaries."""

    def __init__(self, agent_scale: float, obstacle_scale: float,
                 reaction_time: float, force_distance: float,
                 agent_mass: float, agent_radius: float,
                 force_chunk: int = 0, force_cap: float = 1e15):
        self._p = (agent_scale, obstacle_scale, reaction_time,
                   force_distance, agent_mass, agent_radius, force_cap)
        self.force_chunk = int(force_chunk)

    def init_params(self, device="cuda"):
        s, o, r, f, m, rad, cap = self._p

        def t(v):
            return torch.tensor(float(v), dtype=torch.float64, device=device)

        return ZanlungoParams(
            agent_scale=t(s), obstacle_scale=t(o), reaction_time=t(r),
            force_distance=t(f), agent_mass=t(m), agent_radius=t(rad),
            force_cap=t(cap),
        )

    def plan(self, params, state: SimState, nbr: NeighborSet, rec_vel,
             self_pref):
        n = state.capacity
        c = self.force_chunk
        if c <= 0 or n <= c:
            return zanlungo_velocity(
                params, state.position, state.velocity, self_pref,
                state.preferred_vel, state.priority, nbr.idx, nbr.valid,
                rec_vel,
            )
        parts = []
        for lo in range(0, n, c):
            sl = slice(lo, min(n, lo + c))
            parts.append(zanlungo_velocity(
                params, state.position, state.velocity, self_pref[sl],
                state.preferred_vel, state.priority, nbr.idx[sl],
                nbr.valid[sl], rec_vel[sl],
                q_position=state.position[sl],
                q_velocity=state.velocity[sl],
                q_priority=state.priority[sl],
            ))
        return torch.cat(parts, 0)

    def plan_fused_dense(self, params, dense_cfg, state: SimState, rec_vel,
                         self_pref, key_sorted, int_prio: bool = False):
        """Dense fused neighbor-search + force path (the grid_dense
        backend; ops/zanlungo_dense.py).  ``key_sorted`` [N] int32: the
        rows' tile keys in sorted order, fresh or carried.  Returns (vel
        [N,2], max tile occupancy, dropped — column-capacity overflow)."""
        from ..ops.zanlungo_dense import zanlungo_fused_dense

        return zanlungo_fused_dense(
            dense_cfg, params, state.position, state.velocity, self_pref,
            state.preferred_vel, state.priority, state.eyesight, state.alive,
            rec_vel, key_sorted, int_prio=int_prio,
        )

    def plan_fused(self, params, bucket_cfg, state: SimState, rec_vel,
                   self_pref, use_pack_kernel: bool = False,
                   spill_capacity: int = 0, presorted: bool = False,
                   int_prio: bool = False, dual_row: bool = False,
                   binning=None, fused_spills: bool = False,
                   world_mesh=None):
        """Fused neighbor-search + force path (the grid_pallas backend;
        ops/zanlungo_bucketed.py).  Returns (vel [N,2], max tile
        occupancy, dropped).  With ``world_mesh`` (a
        ``parallel.comm.Mesh``) the force pass runs domain-decomposed over
        its shards (parallel/domain.py).  NARROWING, as in the JAX
        package: that branch has no spill repair; ``spill_capacity`` is
        ignored and bucket overflow surfaces through ``dropped``."""
        if world_mesh is not None:
            from ..parallel.domain import zanlungo_fused_domain

            return zanlungo_fused_domain(
                world_mesh, bucket_cfg, params, state.position,
                state.velocity, self_pref, state.preferred_vel,
                state.priority, state.eyesight, state.alive, rec_vel,
                int_prio=int_prio, dual_row=dual_row)
        from ..ops.zanlungo_bucketed import zanlungo_fused

        return zanlungo_fused(
            bucket_cfg, params, state.position, state.velocity, self_pref,
            state.preferred_vel, state.priority, state.eyesight, state.alive,
            rec_vel, use_pack_kernel=use_pack_kernel,
            spill_capacity=spill_capacity, presorted=presorted,
            int_prio=int_prio, dual_row=dual_row, binning=binning,
            fused_spills=fused_spills,
        )
