"""Simulation state as a fixed-capacity structure of tensors.

Counterpart of ``rmf_crowdsim_tpu/core/state.py``: the same fields, as a
frozen dataclass of tensors with a ``replace`` helper in place of
``flax.struct``.  The JAX state's ``rng_key`` becomes an explicit
``torch.Generator`` held beside the tensors (``generator``), from which
``PoissonCrowd`` sources draw their requests; the two frameworks draw
different numbers from the same seed, so Poisson spawns are never
compared with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import SimConfig


class TensorDataclass:
    """Mixin for frozen dataclasses of tensors: ``replace`` returns a copy
    with some fields swapped, like ``flax.struct``'s."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class SimState(TensorDataclass):
    position: torch.Tensor  # [N, 2] float
    velocity: torch.Tensor  # [N, 2] float
    preferred_vel: torch.Tensor  # [N, 2] float
    next_waypoint: torch.Tensor  # [N] int32
    eyesight: torch.Tensor  # [N] float
    alive: torch.Tensor  # [N] bool
    uid: torch.Tensor  # [N] int32
    source_id: torch.Tensor  # [N] int32, -1 = none
    hl_idx: torch.Tensor  # [N] int32, -1 = none
    lp_idx: torch.Tensor  # [N] int32, -1 = none
    route_id: torch.Tensor  # [N] int32, -1 = none
    route_wp: torch.Tensor  # [N] int32
    priority: torch.Tensor  # [N] float
    sim_time: torch.Tensor  # [] float
    next_uid: torch.Tensor  # [] int32
    generator: Optional[torch.Generator] = None

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def device(self) -> torch.device:
        return self.position.device

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)


# Tensor fields of SimState, in declaration order.
STATE_TENSOR_FIELDS = tuple(
    f.name for f in dataclasses.fields(SimState) if f.name != "generator"
)


def make_state(config: SimConfig, seed: int = 0,
               device: torch.device | str = "cuda") -> SimState:
    """Create an empty simulation state (0 live agents) on ``device``
    (the card unless the caller names another device)."""
    n = config.capacity
    f = config.tdtype
    i32 = torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return SimState(
        position=full((n, 2), 0, f),
        velocity=full((n, 2), 0, f),
        preferred_vel=full((n, 2), 0, f),
        next_waypoint=full((n,), 0, i32),
        eyesight=full((n,), 0, f),
        alive=full((n,), False, torch.bool),
        uid=full((n,), -1, i32),
        source_id=full((n,), -1, i32),
        hl_idx=full((n,), -1, i32),
        lp_idx=full((n,), -1, i32),
        route_id=full((n,), -1, i32),
        route_wp=full((n,), 0, i32),
        priority=full((n,), 0, f),
        sim_time=full((), 0, f),
        next_uid=full((), 0, i32),
        generator=gen,
    )


@dataclasses.dataclass(frozen=True)
class StepEvents(TensorDataclass):
    """Per-step event masks and diagnostics (see the JAX StepEvents)."""

    spawned: torch.Tensor  # [N] bool
    destroyed: torch.Tensor  # [N] bool
    waypoint_reached: torch.Tensor  # [N] bool
    spawn_position: torch.Tensor  # [N, 2]
    destroyed_uid: torch.Tensor  # [N] int32
    waypoint_position: torch.Tensor  # [N, 2]
    out_of_bounds: torch.Tensor  # [N] bool
    spawn_dropped: torch.Tensor  # [] int32
    max_cell_occupancy: torch.Tensor  # [] int32
    neighbor_truncated: torch.Tensor  # [] int32
