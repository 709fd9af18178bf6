"""Static configuration of the PyTorch port.

Counterpart of ``rmf_crowdsim_tpu/core/config.py``, copied rather than
imported because that module imports ``jax.numpy`` (for ``jdtype``).  The
field names and defaults are the JAX package's, so one scene spec reads
the same in both packages; ``tdtype`` (a ``torch.dtype``) replaces
``jdtype``.

Several fields only tune the TPU kernels (``strip_tiles``, ``sub_tiles``,
``dual_row``).  They are kept so that both packages accept the same
configs and compute the same bucket geometry; the port's kernels do not
read ``strip_tiles``/``sub_tiles`` beyond that geometry, and ``dual_row``
(a TPU lane-packing tier that changes only the f32 reduction order) is
accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

BACKEND_BRUTE = "brute"
BACKEND_GRID = "grid"
BACKEND_GRID_PALLAS = "grid_pallas"
BACKEND_GRID_DENSE = "grid_dense"
BACKEND_CUSTOM = "custom"

# The neighbor backends the port runs: all five of the JAX package.
PORTED_BACKENDS = (BACKEND_BRUTE, BACKEND_GRID, BACKEND_GRID_PALLAS,
                   BACKEND_GRID_DENSE, BACKEND_CUSTOM)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Uniform-grid world geometry (reference location_hash_2d.rs:33-51):
    a ``width`` x ``height`` world of square cells of ``cell_size``, with
    ``offset`` at the corner of cell (0, 0)."""

    width: float
    height: float
    cell_size: float
    offset: Tuple[float, float]

    @property
    def nx(self) -> int:
        return int(self.width / self.cell_size)

    @property
    def ny(self) -> int:
        return int(self.height / self.cell_size)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    def window_radius(self, max_radius: float) -> int:
        return max(1, int(math.ceil(max_radius / self.cell_size)))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Top-level static configuration; see the JAX package's SimConfig for
    the meaning of every field."""

    capacity: int
    grid: Optional[GridConfig] = None
    neighbor_backend: str = BACKEND_BRUTE
    max_per_cell: int = 8
    max_eyesight: float = 0.0
    spawn_clearance: float = 0.4
    dtype: str = "float32"
    commit_preferred_vel: bool = False
    # --- grid_pallas / grid_dense backends (ops/zanlungo_bucketed.py,
    # ops/zanlungo_dense.py) ----------------------------------------------
    bucket_capacity: int = 16
    strip_tiles: int = 96
    sub_tiles: int = 6
    bucket_tile_size: float = 0.0
    use_pack_kernel: bool = False
    dense_col_headroom: float = 2.0
    spill_capacity: int = 128
    fused_spills: bool = False
    presort: bool = False
    integer_priorities: bool = False
    dual_row: bool = False
    sharding_invariance: str = "bitwise"
    # Accepted for spec compatibility; the port has no interpreter mode
    # (its kernels' plain versions run on CPU tensors instead).
    pallas_interpret: bool = False
    on_truncation: str = "raise"
    on_out_of_bounds: str = "ignore"
    knn_grid_threshold: int = 4096
    event_stream_capacity: int = 128

    @property
    def neighbor_capacity_limit(self) -> int:
        if self.neighbor_backend == BACKEND_GRID:
            return self.max_per_cell
        if self.neighbor_backend == BACKEND_GRID_PALLAS:
            return self.bucket_capacity
        return 0

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def __post_init__(self):
        if self.neighbor_backend not in PORTED_BACKENDS:
            raise ValueError(
                f"unknown neighbor backend {self.neighbor_backend!r}")
        if (
            self.neighbor_backend not in (BACKEND_BRUTE, BACKEND_CUSTOM)
            and self.grid is None
        ):
            raise ValueError("grid backends require a GridConfig")
        if self.on_truncation not in ("raise", "ignore"):
            raise ValueError(
                f"on_truncation must be 'raise' or 'ignore', "
                f"got {self.on_truncation!r}"
            )
        if self.on_out_of_bounds not in ("raise", "ignore"):
            raise ValueError(
                f"on_out_of_bounds must be 'raise' or 'ignore', "
                f"got {self.on_out_of_bounds!r}"
            )
        if self.sharding_invariance not in ("bitwise", "tolerance"):
            raise ValueError(
                f"sharding_invariance must be 'bitwise' or 'tolerance', "
                f"got {self.sharding_invariance!r}"
            )
