"""High-level (global routing) planners.

Counterpart of ``rmf_crowdsim_tpu/models/highlevel.py`` (``HLResult``,
``RouteTable``, ``HighLevelPlanner``, ``ConstantVelocity``,
``ParityVelocity`` and ``WaypointFollow``).  Each planner is a function
over the whole agent state::

    plan(params, state) -> HLResult(vel[N,2], valid[N], route_wp[N])

Route-following planners read per-agent ``route_id``/``route_wp`` and a
:class:`RouteTable` in their params; targets are assigned by writing those
fields (the SourceSink leg table inside the step).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import SimState, TensorDataclass
from ..ops.neighbors import norm


@dataclasses.dataclass(frozen=True)
class HLResult(TensorDataclass):
    vel: torch.Tensor  # [N, 2] desired velocity
    valid: torch.Tensor  # [N] bool — reference's Option::Some
    route_wp: torch.Tensor  # [N] int32


@dataclasses.dataclass(frozen=True)
class RouteTable(TensorDataclass):
    """Padded route storage, the RMF planner's ``route_list``
    (rmf/mod.rs:88) as tensors."""

    points: torch.Tensor  # [R, L, 2]
    lengths: torch.Tensor  # [R] int32 — valid prefix length per route

    @classmethod
    def empty(cls, max_routes: int, max_len: int, dtype: torch.dtype,
              device="cuda") -> "RouteTable":
        return cls(
            points=torch.zeros((max_routes, max_len, 2), dtype=dtype,
                               device=device),
            lengths=torch.zeros((max_routes,), dtype=torch.int32,
                                device=device),
        )


class HighLevelPlanner:
    """Base: planners are selected per agent by ``state.hl_idx``."""

    #: True if this planner reads state.route_id/route_wp: SourceSink
    #: waypoint advances then assign the next route leg (lib.rs:325-334).
    uses_routes: bool = False

    def init_params(self, device="cuda"):
        return ()

    def plan(self, params, state: SimState) -> HLResult:  # pragma: no cover
        raise NotImplementedError


class ConstantVelocity(HighLevelPlanner):
    """Always the same velocity (StubHighLevelPlan, lib.rs:391-420)."""

    def __init__(self, vel):
        self._vel = tuple(float(v) for v in vel)

    def init_params(self, device="cuda"):
        return {"vel": torch.tensor(self._vel, dtype=torch.float64,
                                    device=device)}

    def plan(self, params, state: SimState) -> HLResult:
        n = state.capacity
        v = params["vel"].to(state.position.dtype)
        return HLResult(
            vel=v[None, :].expand(n, 2),
            valid=torch.ones((n,), dtype=torch.bool, device=state.device),
            route_wp=state.route_wp,
        )


class ParityVelocity(HighLevelPlanner):
    """Even agent ids move at ``-vel``, odd at ``+vel``
    (rmf_crowdsim_viz/src/main.rs:20-41)."""

    def __init__(self, vel):
        self._vel = tuple(float(v) for v in vel)

    def init_params(self, device="cuda"):
        return {"vel": torch.tensor(self._vel, dtype=torch.float64,
                                    device=device)}

    def plan(self, params, state: SimState) -> HLResult:
        n = state.capacity
        dtype = state.position.dtype
        v = params["vel"].to(dtype)
        sign = torch.where(
            (state.uid % 2) == 0,
            torch.full((), -1.0, dtype=dtype, device=state.device),
            torch.full((), 1.0, dtype=dtype, device=state.device),
        )
        return HLResult(
            vel=sign[:, None] * v[None, :],
            valid=torch.ones((n,), dtype=torch.bool, device=state.device),
            route_wp=state.route_wp,
        )


class WaypointFollow(HighLevelPlanner):
    """Chase-and-advance over a padded route table, the device half of the
    RMF planner (rmf/mod.rs:197-215): within ``arrival_tolerance`` of its
    route waypoint, with more waypoints left, an agent advances its cursor;
    its velocity is the unit vector toward the (possibly advanced)
    waypoint; agents without a route (``route_id < 0``) are not valid."""

    uses_routes = True

    def __init__(self, routes: RouteTable, arrival_tolerance: float = 1e-1):
        self._routes = routes
        self._tol = float(arrival_tolerance)

    def init_params(self, device="cuda"):
        routes = RouteTable(points=self._routes.points.to(device),
                            lengths=self._routes.lengths.to(device))
        return {"routes": routes,
                "tol": torch.tensor(self._tol, dtype=torch.float64,
                                    device=device)}

    def plan(self, params, state: SimState) -> HLResult:
        routes: RouteTable = params["routes"]
        dtype = state.position.dtype
        tol = params["tol"].to(dtype)
        rid = torch.clamp(state.route_id, 0,
                          routes.points.shape[0] - 1).long()
        has_route = state.route_id >= 0
        length = routes.lengths[rid]
        wp = torch.clamp(state.route_wp, 0, routes.points.shape[1] - 1)
        target = routes.points[rid, wp.long()].to(dtype)
        d = norm(state.position - target)
        advance = (d < tol) & (wp + 1 < length)
        wp2 = torch.where(advance, wp + 1, wp)
        to_go = routes.points[rid, wp2.long()].to(dtype) - state.position
        dist = norm(to_go)[:, None]
        # The reference normalizes a zero vector to NaN; an agent exactly
        # on its last waypoint gets zero instead (models/highlevel.py:157).
        pos = dist > 0
        unit = torch.where(pos, to_go / torch.where(pos, dist,
                                                    torch.ones_like(dist)),
                           torch.zeros_like(to_go))
        return HLResult(
            vel=unit,
            valid=has_route,
            route_wp=torch.where(has_route, wp2, state.route_wp),
        )
