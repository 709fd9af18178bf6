"""High-level (global routing) planners.

Counterpart of ``rmf_crowdsim_tpu/models/highlevel.py`` (``HLResult``,
``HighLevelPlanner``, ``ConstantVelocity``, ``ParityVelocity``; the route
planners are not ported yet).  Each planner is a function over the whole
agent state::

    plan(params, state) -> HLResult(vel[N,2], valid[N], route_wp[N])
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import SimState, TensorDataclass


@dataclasses.dataclass(frozen=True)
class HLResult(TensorDataclass):
    vel: torch.Tensor  # [N, 2] desired velocity
    valid: torch.Tensor  # [N] bool — reference's Option::Some
    route_wp: torch.Tensor  # [N] int32


class HighLevelPlanner:
    """Base: planners are selected per agent by ``state.hl_idx``."""

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
