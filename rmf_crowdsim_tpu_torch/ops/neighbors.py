"""Neighbor-candidate tables for the local-planner pass.

Counterpart of ``rmf_crowdsim_tpu/ops/neighbors.py`` (``NeighborSet`` and
``brute_neighbors``): the masked all-pairs table, exact, and the port's
oracle and ``brute`` backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.state import TensorDataclass


@dataclasses.dataclass(frozen=True)
class NeighborSet(TensorDataclass):
    idx: torch.Tensor  # [N, K] int64 — candidate slot indices
    valid: torch.Tensor  # [N, K] bool
    max_cell_occupancy: torch.Tensor  # [] int32 (0 for brute)
    truncated: Optional[torch.Tensor] = None  # [] int32

    def __post_init__(self):
        if self.truncated is None:
            object.__setattr__(
                self, "truncated",
                torch.zeros((), dtype=torch.int32, device=self.idx.device),
            )


def brute_neighbors(position: torch.Tensor, eyesight: torch.Tensor,
                    alive: torch.Tensor) -> NeighborSet:
    """All-pairs candidate table, K == N: alive, not self, and strictly
    within the query's eyesight (location_hash_2d.rs:251)."""
    n = position.shape[0]
    dev = position.device
    idx = torch.arange(n, device=dev).expand(n, n)
    diff = position[:, None, :] - position[None, :, :]
    dist = torch.linalg.vector_norm(diff, dim=-1)
    not_self = ~torch.eye(n, dtype=torch.bool, device=dev)
    valid = (
        alive[:, None]
        & alive[None, :]
        & not_self
        & (dist < eyesight[:, None])
    )
    return NeighborSet(
        idx=idx, valid=valid,
        max_cell_occupancy=torch.zeros((), dtype=torch.int32, device=dev),
    )
