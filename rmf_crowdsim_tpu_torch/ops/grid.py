"""Uniform-grid spatial binning: the ``grid`` neighbor backend.

Counterpart of ``rmf_crowdsim_tpu/ops/grid.py``.  The binning is rebuilt
from step-start positions every step: a cell id per agent (dead agents
take the sentinel id ``n_cells`` and sort last), a stable sort by cell id,
per-cell start offsets by ``searchsorted``, and up to ``max_per_cell``
candidates from each cell of the ``(2w+1)^2`` window around an agent's
cell.  The stable sort makes ``order``, and with it the candidate table,
equal the JAX package's bit for bit.

The JAX package runs its truncation audit under ``lax.cond`` only on steps
where a cell overflows; here it runs every step, branch-free, on a fixed
``[min(N, 1024), window cells, r_cap]`` audit table, so the step takes no
host read for it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import GridConfig
from ..core.state import TensorDataclass
from .compact import compact_indices
from .neighbors import NeighborSet, norm


def cell_coords(grid: GridConfig, position: torch.Tensor):
    """(cx[N], cy[N], in_bounds[N]) for positions [N, 2]: the floor of
    ``(p - offset) / cell_size``, clipped into the grid.  The Python-float
    operands are rounded to the position dtype, as the JAX package's
    ``jnp.asarray(..., position.dtype)`` does, without a host-to-device
    copy."""
    cx = torch.floor((position[..., 0] - grid.offset[0])
                     / grid.cell_size).to(torch.int32)
    cy = torch.floor((position[..., 1] - grid.offset[1])
                     / grid.cell_size).to(torch.int32)
    in_bounds = (cx >= 0) & (cx < grid.nx) & (cy >= 0) & (cy < grid.ny)
    return (
        torch.clamp(cx, 0, grid.nx - 1),
        torch.clamp(cy, 0, grid.ny - 1),
        in_bounds,
    )


def cell_id(grid: GridConfig, cx: torch.Tensor,
            cy: torch.Tensor) -> torch.Tensor:
    """Flat cell id, x-major with the row stride ``ny``
    (location_hash_2d.rs:59 strides by the width, a bug on non-square
    grids)."""
    return cx * grid.ny + cy


@dataclasses.dataclass(frozen=True)
class GridBinning(TensorDataclass):
    """All agents binned into cells."""

    order: torch.Tensor  # [N] int64 — agent slots sorted by cell id
    sorted_cid: torch.Tensor  # [N] int32
    starts: torch.Tensor  # [n_cells + 1] int32 — cell segment offsets
    cx: torch.Tensor  # [N] int32 (unsorted, clamped)
    cy: torch.Tensor  # [N] int32
    in_bounds: torch.Tensor  # [N] bool


def bin_agents(grid: GridConfig, position: torch.Tensor,
               alive: torch.Tensor) -> GridBinning:
    cx, cy, in_bounds = cell_coords(grid, position)
    cid = cell_id(grid, cx, cy)
    cid_key = torch.where(alive, cid, torch.full_like(cid, grid.n_cells))
    sorted_cid, order = torch.sort(cid_key, stable=True)
    starts = torch.searchsorted(
        sorted_cid,
        torch.arange(grid.n_cells + 1, dtype=torch.int32,
                     device=position.device),
        side="left", out_int32=True)
    return GridBinning(order, sorted_cid, starts, cx, cy, in_bounds)


def _window_offsets(window: int, device):
    """(dx, dy) [side*side] int32: the window's cell offsets, x-major."""
    side = 2 * window + 1
    off = torch.arange(side, dtype=torch.int32, device=device) - window
    return (off[:, None].expand(side, side).reshape(-1),
            off[None, :].expand(side, side).reshape(-1))


def _window_cells(grid: GridConfig, cx, cy, dx, dy):
    """Each row's window cells: (in-grid mask, cell id — 0 off the grid),
    both [..., side*side]."""
    wx = cx[..., None] + dx
    wy = cy[..., None] + dy
    ok = (wx >= 0) & (wx < grid.nx) & (wy >= 0) & (wy < grid.ny)
    wcid = cell_id(grid, torch.clamp(wx, 0, grid.nx - 1),
                   torch.clamp(wy, 0, grid.ny - 1))
    return ok, torch.where(ok, wcid, torch.zeros_like(wcid)).long()


def grid_neighbors(grid: GridConfig, position: torch.Tensor,
                   eyesight: torch.Tensor, alive: torch.Tensor, window: int,
                   max_per_cell: int) -> NeighborSet:
    """Fixed-K candidate table from the cell window around each agent,
    K = (2*window+1)^2 * max_per_cell: exact against ``brute_neighbors``
    while the window covers every eyesight and no queried cell holds more
    than ``max_per_cell`` agents.  ``truncated`` counts the agents past
    ``max_per_cell`` that some alive agent can see (ops/grid.py:142-211)."""
    n = position.shape[0]
    dev = position.device
    b = bin_agents(grid, position, alive)
    dx, dy = _window_offsets(window, dev)
    cell_ok, wcid = _window_cells(grid, b.cx, b.cy, dx, dy)  # [N, C]
    seg_start = b.starts[wcid]
    seg_len = b.starts[wcid + 1] - seg_start

    j = torch.arange(max_per_cell, dtype=torch.int32, device=dev)
    cand_pos = seg_start[:, :, None] + j  # [N, C, P]
    cand_ok = cell_ok[:, :, None] & (j < seg_len[:, :, None])
    cand_idx = b.order[torch.clamp(cand_pos, 0, n - 1).long()]
    k = dx.shape[0] * max_per_cell
    idx = cand_idx.reshape(n, k)
    ok = cand_ok.reshape(n, k)

    # Exact distance, self and eyesight filter (strict <,
    # location_hash_2d.rs:251).
    dist = norm(position[:, None, :] - position[idx])
    me = torch.arange(n, device=dev)[:, None]
    valid = ok & (idx != me) & (dist < eyesight[:, None]) & alive[:, None]

    occ = torch.where(cell_ok, seg_len, torch.zeros_like(seg_len))
    max_occ = occ.max().to(torch.int32)
    truncated = _truncation_audit(grid, b, position, eyesight, dx, dy,
                                  max_per_cell)
    return NeighborSet(idx=idx, valid=valid, max_cell_occupancy=max_occ,
                       truncated=truncated)


def _truncation_audit(grid: GridConfig, b: GridBinning, position, eyesight,
                      dx, dy, max_per_cell: int) -> torch.Tensor:
    """Agents dropped from candidate sets (rank >= ``max_per_cell`` in
    their cell) that some other alive agent in their window can see; the
    first ``min(N, 1024)`` dropped members are distance-checked against
    ``r_cap`` seers a cell, deeper ones are counted conservatively.  0
    when no cell overflows (ops/grid.py:157-211)."""
    n = position.shape[0]
    dev = position.device
    i32 = torch.int32
    cell_counts = b.starts[1:] - b.starts[:-1]
    overflow_total = torch.clamp(cell_counts - max_per_cell,
                                 min=0).sum(dtype=i32)

    k_aud = min(n, 1024)
    r_cap = max_per_cell + max(max_per_cell, 16)
    sent_ok = b.sorted_cid < grid.n_cells
    seg0 = b.starts[torch.clamp(b.sorted_cid, 0, grid.n_cells - 1).long()]
    rank_sorted = torch.arange(n, dtype=i32, device=dev) - seg0
    dropped_sorted = sent_ok & (rank_sorted >= max_per_cell)
    ca = compact_indices(dropped_sorted, k_aud)
    m_idx = b.order[torch.clamp(ca.idx, 0, n - 1).long()]  # [K]
    m_ok, m_cid = _window_cells(grid, b.cx[m_idx], b.cy[m_idx], dx, dy)
    w0 = b.starts[m_cid]  # [K, C]
    wlen = b.starts[m_cid + 1] - w0
    jr = torch.arange(r_cap, dtype=i32, device=dev)
    q_in = m_ok[:, :, None] & (jr < wlen[:, :, None])  # [K, C, R]
    q_idx = b.order[torch.clamp(w0[:, :, None] + jr, 0, n - 1).long()]
    d = norm(position[m_idx][:, None, None, :] - position[q_idx])
    seen_by = q_in & (d < eyesight[q_idx]) & (q_idx != m_idx[:, None, None])
    deep = (m_ok & (wlen > r_cap)).any(1)
    seen_m = ca.valid & (seen_by.flatten(1).any(1) | deep)
    audited = seen_m.sum(dtype=i32)
    rest = torch.clamp(overflow_total - k_aud, min=0)
    return torch.where(overflow_total > 0, audited + rest,
                       torch.zeros_like(overflow_total))
