"""Neighbor-candidate tables for the local-planner pass.

Counterpart of ``rmf_crowdsim_tpu/ops/neighbors.py``: ``NeighborSet``,
``brute_neighbors`` (the masked all-pairs table, exact, and the port's
oracle and ``brute`` backend) and the public spatial queries of the
reference's ``SpatialIndex`` (spatial_index.rs:4-14): points in a radius
and the k nearest agents, brute, over a grid window, or tiered.

``jax.lax.top_k`` puts the lower index first among equal keys and
``torch.topk`` promises no order, so the k nearest come from a stable
sort: ties resolve as in the JAX package.
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


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, ``sqrt(x*x + y*y)``."""
    return torch.sqrt((v * v).sum(-1))


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


def neighbors_in_radius(position: torch.Tensor, alive: torch.Tensor,
                        radius, point: torch.Tensor) -> torch.Tensor:
    """bool[N]: alive agents strictly within ``radius`` of ``point`` [2]
    (location_hash_2d.rs:240-258)."""
    return alive & (norm(position - point[None, :]) < radius)


def _k_smallest(d: torch.Tensor, k: int):
    """(values, positions) of the k smallest entries of ``d``, ties in
    position order (``lax.top_k``'s order on ``-d``)."""
    vals, pos = torch.sort(d, stable=True)
    return vals[:k], pos[:k]


def nearest_neighbors(position: torch.Tensor, alive: torch.Tensor, k: int,
                      point: torch.Tensor):
    """Exact k nearest neighbors: (idx [k] int64, valid [k] bool), nearest
    first (spatial_index.rs:7-8).  Exact where the reference's ring scan
    misses corner cells (location_hash_2d.rs:177-218)."""
    d = norm(position - point[None, :])
    d = torch.where(alive, d, torch.full_like(d, float("inf")))
    vals, idx = _k_smallest(d, k)
    return idx, torch.isfinite(vals)


def nearest_neighbors_grid(grid, binning, position: torch.Tensor,
                           alive: torch.Tensor, k: int, point: torch.Tensor,
                           max_ring: int):
    """k nearest neighbors over a prebuilt grid binning
    (``ops.grid.bin_agents``): candidates are up to ``max(k, 64)`` agents
    of every cell of the ``(2*max_ring+1)^2`` window around ``point``.
    Exact iff the k-th neighbor lies within ``max_ring`` cells and no
    window cell holds more than the per-cell budget.  Returns (idx [k]
    int64, valid [k] bool, overflow [] — window agents past the budget),
    nearest first."""
    from .grid import _window_cells, _window_offsets

    n = position.shape[0]
    dev = position.device
    per_cell = max(k, 64)
    cx = torch.clamp(torch.floor((point[0] - grid.offset[0])
                                 / grid.cell_size).to(torch.int32),
                     0, grid.nx - 1)
    cy = torch.clamp(torch.floor((point[1] - grid.offset[1])
                                 / grid.cell_size).to(torch.int32),
                     0, grid.ny - 1)
    dx, dy = _window_offsets(max_ring, dev)
    ok, wcid = _window_cells(grid, cx, cy, dx, dy)  # [C]
    seg_start = binning.starts[wcid]
    seg_len = binning.starts[wcid + 1] - seg_start
    j = torch.arange(per_cell, dtype=torch.int32, device=dev)
    cand_pos = torch.clamp(seg_start[:, None] + j, 0, n - 1).long()
    cand_ok = (ok[:, None] & (j < seg_len[:, None])).reshape(-1)
    cand = binning.order[cand_pos].reshape(-1)
    overflow = torch.where(ok, torch.clamp(seg_len - per_cell, min=0),
                           torch.zeros_like(seg_len)).sum()
    d = norm(position[cand] - point[None, :])
    d = torch.where(cand_ok & alive[cand], d,
                    torch.full_like(d, float("inf")))
    vals, sel = _k_smallest(d, k)
    return cand[sel], torch.isfinite(vals), overflow


def nearest_neighbors_tiered(grid, starts: torch.Tensor, order: torch.Tensor,
                             position: torch.Tensor, alive: torch.Tensor,
                             k: int, point: torch.Tensor,
                             rings=(1, 2, 4, 8)):
    """Exact kNN over a ring ladder ending in the brute query: each
    tier's window result is taken only when all ``k`` hits are valid, the
    k-th lies strictly inside the ring's covered radius and no window cell
    overflowed its read budget (the reference's ring expansion,
    location_hash_2d.rs:151-238).  The JAX package chains the tiers with
    ``lax.cond``; this is a host query, so each tier's decision is one
    host read.  Returns (idx [k] int64, valid [k] bool), nearest first."""
    from .grid import GridBinning

    binning = GridBinning(order, None, starts, None, None, None)
    for ring in rings:
        idx, valid, overflow = nearest_neighbors_grid(
            grid, binning, position, alive, k, point, ring)
        kth = norm(position[idx[-1]] - point)
        good = valid.all() & (kth < ring * grid.cell_size) & (overflow == 0)
        if bool(good):
            return idx, valid
    return nearest_neighbors(position, alive, k, point)
