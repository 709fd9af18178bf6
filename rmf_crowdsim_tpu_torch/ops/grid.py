"""Uniform-grid cell coordinates.

Counterpart of ``rmf_crowdsim_tpu/ops/grid.py`` (``cell_coords`` only —
the step's out-of-bounds flag needs it; the ``grid`` neighbor backend is
not ported yet).
"""

from __future__ import annotations

import torch

from ..core.config import GridConfig


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
