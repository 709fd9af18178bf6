"""Dense (bucket-free) layout and its fused Zanlungo force kernel (K4).

Counterpart of ``rmf_crowdsim_tpu/ops/zanlungo_dense.py``: the tile-sorted
agent rows themselves are the layout.  There is no pack, no per-tile
bucket and so no spill repair; row ranges per tile come from one
``searchsorted`` over the sorted keys (``tile_start``), and the one
capacity is ``col_cap`` query rows per tile column (surplus rows keep
``rec_vel`` and are counted in ``dropped``).

K4 computes, for every live row whose rank in its tile column is below
``col_cap``, ``rec + F/m`` over every live candidate with another id and
strict ``d^2 < eye^2`` among the rows of sort-time tiles ``tcy-1 ..
tcy+1`` in columns ``c-1 .. c+1`` (clipped at the world's edges), with
``t_i`` the min time-to-collision and ``F`` applied only where ``t_i`` is
finite.  ``zanlungo_forces_dense`` launches ``csrc/zanlungo_dense.cu`` on
CUDA tensors and runs the plain PyTorch version on CPU tensors.

The JAX kernel's 128-aligned DMA table (``dma``), its per-sub-block row
extents (``qn``), its window tiers and full-column sweep are TPU
mechanics and are not ported; the port's kernel is exact for any window
extent.  Where the JAX kernel loses candidates to its strip clamps (only
in a neighbor column past ``col_cap``, i.e. only when ``dropped > 0``),
the port keeps them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .zanlungo_bucketed import (
    NUM_CAND, NUM_F, POS_SENTINEL, ROW_ID, SMEM_LIMIT, _align16,
    candidate_features, pair_mask, pair_velocities, query_features, zparams5,
)

# Row 13 carries the query's sort-time tile row (zanlungo_dense.py:99).
ROW_TCY = 13


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    """Static geometry of the dense tile-sorted layout, identical to the
    JAX package's (zanlungo_dense.py:110-165).  Attribute-compatible with
    :class:`~.zanlungo_bucketed.BucketConfig` for ``tile_key``."""

    tile_size: float
    offset: Tuple[float, float]
    tx: int
    ty: int
    col_cap: int

    @property
    def n_tiles(self) -> int:
        return self.tx * self.ty

    @property
    def slots(self) -> int:
        """Padded output rows, ``tx * col_cap``."""
        return self.tx * self.col_cap

    def __post_init__(self):
        assert self.tx >= 3 and self.ty >= 1, "world must span >= 3 columns"
        assert self.col_cap % 128 == 0 and self.col_cap >= 256

    @classmethod
    def create(cls, width: float, height: float, offset: Tuple[float, float],
               max_eyesight: float, capacity: int,
               tile_size: float | None = None,
               col_headroom: float = 2.0) -> "DenseConfig":
        """``col_cap`` is the uniform per-column mean times
        ``col_headroom``, rounded up to 128, at least 256."""
        tile = max(float(tile_size or 0.0), float(max_eyesight), 1e-6)
        tx = max(3, int(math.ceil(width / tile)))
        ty = max(1, int(math.ceil(height / tile)))
        mean = capacity / tx
        cap = int(math.ceil(mean * col_headroom / 128.0)) * 128
        cap = max(cap, 256)
        return cls(tile_size=tile,
                   offset=(float(offset[0]), float(offset[1])),
                   tx=tx, ty=ty, col_cap=cap)


def dense_prep(cfg: DenseConfig, key_sorted, position, velocity,
               pref_committed, self_pref, priority, eyesight, rec_vel,
               alive):
    """K4's inputs from TILE-SORTED rows (zanlungo_dense.py:173-295).

    ``key_sorted`` [N] int32: each row's tile key in sorted order (dead
    rows carry ``n_tiles`` on fresh sorts; on carried binnings they keep
    their sort-time key and are packed inert here).  Returns (feat [N,
    NUM_F] f32 — row i is sorted agent i, the transpose of the JAX
    ``feat_T[:, :N]``; tile_start [n_tiles + 1] int32; bpos [N] int32 —
    padded output row ``col * col_cap + rank``, ``slots`` past the
    column capacity or for dead-keyed rows; n_col_over [] int32; max_occ
    [] int32)."""
    n = position.shape[0]
    dev = position.device
    assert n < (1 << 24), "row ids must be exact in f32"
    f32 = torch.float32
    i32 = torch.int32
    cap, tx, ty = cfg.col_cap, cfg.tx, cfg.ty
    key_sorted = key_sorted.to(i32).contiguous()

    tile_start = torch.searchsorted(
        key_sorted, torch.arange(cfg.n_tiles + 1, dtype=i32, device=dev),
        side="left", out_int32=True)
    col_start = tile_start[::ty]
    col_len = col_start[1:] - col_start[:-1]
    n_col_over = torch.clamp(col_len - cap, min=0).sum(dtype=i32)
    max_occ = (tile_start[1:] - tile_start[:-1]).max().to(i32)

    # Rank in column: the keys are sorted, so a column's first row is its
    # col_start entry, and one gather gives what the JAX package's running
    # max over column-change marks gives (zanlungo_dense.py:215-226; the
    # scan avoids a TPU gather floor).  col_start has tx + 1 entries, so
    # dead-keyed rows (col == tx) index it too.
    idx = torch.arange(n, dtype=i32, device=dev)
    col = torch.clamp(torch.div(key_sorted, ty, rounding_mode="floor"), 0,
                      tx)
    local = idx - col_start[col.long()]
    in_cap = (col < tx) & (local < cap)
    bpos = torch.where(in_cap, col * cap + local,
                       torch.full_like(idx, cfg.slots))

    # Fresh-dead masking, unconditionally (zanlungo_dense.py:228-235).
    sent = torch.full((), POS_SENTINEL, dtype=f32, device=dev)
    tcy = torch.remainder(torch.clamp(key_sorted, 0, cfg.n_tiles - 1), ty)
    feat = torch.stack([
        torch.where(alive, position[:, 0].to(f32), sent),
        torch.where(alive, position[:, 1].to(f32), sent),
        velocity[:, 0].to(f32), velocity[:, 1].to(f32),
        pref_committed[:, 0].to(f32), pref_committed[:, 1].to(f32),
        priority.to(f32),
        torch.where(alive, idx.to(f32), torch.full((), -1.0, device=dev)),
        rec_vel[:, 0].to(f32), rec_vel[:, 1].to(f32),
        eyesight.to(f32),
        self_pref[:, 0].to(f32), self_pref[:, 1].to(f32),
        tcy.to(f32),
        torch.zeros((n,), dtype=f32, device=dev),
        torch.ones((n,), dtype=f32, device=dev),
    ], dim=1).contiguous()
    return feat, tile_start, bpos, n_col_over, max_occ


def _query_windows(cfg: DenseConfig, feat, tile_start):
    """The query rows and their candidate row ranges, as K4 computes them.

    Returns (rows [Q] int64 — every row whose rank in its column is below
    ``col_cap``; out_row [Q] int64 — its padded output row; lo, hi [Q, 3]
    int64 — the candidate rows ``[lo, hi)`` in columns c-1, c, c+1, empty
    outside the world)."""
    dev = feat.device
    cap, tx, ty = cfg.col_cap, cfg.tx, cfg.ty
    ts = tile_start.long()
    col_start = ts[::ty]
    col_len = torch.clamp(col_start[1:] - col_start[:-1], max=cap)
    c = torch.repeat_interleave(torch.arange(tx, device=dev), col_len)
    local = (torch.arange(c.shape[0], device=dev)
             - torch.repeat_interleave(torch.cumsum(col_len, 0) - col_len,
                                       col_len))
    rows = col_start[c] + local
    tcy = feat[rows, ROW_TCY].long()
    d = torch.arange(-1, 2, device=dev)
    ck = c[:, None] + d                                       # [Q, 3]
    ok = (ck >= 0) & (ck < tx)
    base = torch.clamp(ck, 0, tx - 1) * ty
    t0 = torch.clamp(tcy - 1, min=0)[:, None]
    t1 = torch.clamp(tcy + 1, max=ty - 1)[:, None]
    lo = torch.where(ok, ts[base + t0], torch.zeros_like(base))
    hi = torch.where(ok, ts[base + t1 + 1], torch.zeros_like(base))
    return rows, c * cap + local, lo, hi


# Tile rows of one column per K4 block: at the 1M bench scene (~17.5 rows
# a tile) a block takes ~260 queries and stages ~890 candidate rows, and
# the halo costs 17/15 reads of the rows.
K4_TILES_PER_BLOCK = 15

# Entries of a query's neighbour list in K4 (LIST_CAP in
# csrc/zanlungo_dense.cu); a query with more hits re-walks its window.
K4_LIST_CAP = 32

# Most threads of a K4 block (MAX_THREADS in the .cu).
K4_MAX_THREADS = 512

# Most staged rows a block takes by default: 128 KB of stage, so a block
# of K4_MAX_THREADS still fits the H100's shared memory.  The kernel takes
# up to 65,536 (uint16 staged indices).
K4_MAX_STAGE = 4096


@dataclasses.dataclass(frozen=True)
class K4Geometry:
    """Launch geometry of K4: ``blocks`` runs of ``tiles`` tile rows of
    one column, ``threads`` per block, ``stage_rows`` staged candidate
    rows, ``smem_bytes`` of dynamic shared memory."""

    tiles: int
    threads: int
    stage_rows: int
    blocks: int
    smem_bytes: int


def _ceil32(x: float) -> int:
    return int(math.ceil(x / 32.0)) * 32


def query_threads(queries: float) -> int:
    """K4's threads a block for ``queries`` mean live queries a block:
    1.125 times as many, rounded up to a warp, 64 to 512."""
    return min(K4_MAX_THREADS, max(64, _ceil32(1.125 * queries)))


def k4_smem_bytes(stage_rows: int, threads: int) -> int:
    """K4's shared memory a block, as ``dense_layout`` in
    ``csrc/zanlungo_dense.cu`` lays it out: the stage, two float4 arrays
    [stage_rows]; then the lists [K4_LIST_CAP, threads] uint16."""
    return _align16(_align16(32 * stage_rows) + 2 * K4_LIST_CAP * threads)


def k4_geometry(cfg: DenseConfig, n_rows: int,
                tiles_per_block: int = K4_TILES_PER_BLOCK,
                stage_rows: int | None = None) -> K4Geometry:
    """K4's launch geometry for ``n_rows`` sorted rows.  With ``m`` =
    ``n_rows / n_tiles`` rows a tile: threads cover 1.125 times a run's
    mean queries (``tiles * m``), the stage 1.25 times its mean candidate
    rows (``3 (tiles + 2) m``, at most ``K4_MAX_STAGE`` unless
    ``stage_rows`` is given), each rounded up to 32; a block whose ranges
    exceed the stage reads them in place, exactly.  The kernel lays out
    its shared memory itself; ``smem_bytes`` mirrors that layout
    (:func:`k4_smem_bytes`) so that a block the card cannot hold is
    refused here, before the launch.  Raises if the block needs more than
    the H100's 232,448 bytes."""
    tiles = max(1, min(int(tiles_per_block), cfg.ty))
    m = n_rows / cfg.n_tiles
    threads = query_threads(tiles * m)
    if stage_rows is None:
        stage_rows = min(K4_MAX_STAGE,
                         max(256, _ceil32(1.25 * 3 * (tiles + 2) * m)))
    if not 1 <= stage_rows <= 65536:
        raise ValueError(f"K4: {stage_rows} staged rows overflow the "
                         f"kernel's uint16 indices")
    smem = k4_smem_bytes(stage_rows, threads)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K4: {smem} bytes of shared memory per block "
                         f"({stage_rows} staged rows, {threads} threads) "
                         f"exceed {SMEM_LIMIT}")
    blocks = cfg.tx * -(-cfg.ty // tiles)
    return K4Geometry(tiles=tiles, threads=threads, stage_rows=stage_rows,
                      blocks=blocks, smem_bytes=smem)


def forces_dense_plain(cfg: DenseConfig, zp5, feat, tile_start, int_prio,
                       chunk_pairs: int = 1 << 22):
    """Plain version of K4: every query row against its candidate row
    ranges, padded to the widest range and processed in query chunks of
    about ``chunk_pairs`` pairs.  Output rows that hold no query are 0."""
    dev = feat.device
    out = torch.zeros((cfg.slots, 2), dtype=torch.float32, device=dev)
    rows, out_row, lo, hi = _query_windows(cfg, feat, tile_start)
    if rows.shape[0] == 0:
        return out
    width = max(1, int((hi - lo).max()))
    chunk = max(1, chunk_pairs // (3 * width))
    lane = torch.arange(width, device=dev)
    for a in range(0, rows.shape[0], chunk):
        sl = slice(a, a + chunk)
        cand = lo[sl, :, None] + lane                         # [q, 3, W]
        ok = (cand < hi[sl, :, None]).reshape(cand.shape[0], -1)
        cand = torch.where(ok, cand.reshape(ok.shape), 0)
        cf = feat[cand, :NUM_CAND].permute(2, 0, 1)           # [8, q, 3W]
        cf[ROW_ID] = torch.where(ok, cf[ROW_ID],
                                 torch.full_like(cf[ROW_ID], -1.0))
        c = {k: v.squeeze(-2) for k, v in candidate_features(cf).items()}
        q = query_features(feat[rows[sl]])                    # [q, 1]
        out[out_row[sl]] = pair_velocities(zp5, q, c, pair_mask(q, c),
                                           int_prio)
    return out


def zanlungo_forces_dense(cfg: DenseConfig, zp5: torch.Tensor,
                          feat: torch.Tensor, tile_start: torch.Tensor,
                          int_prio: bool = False,
                          overflow: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """K4: [tx * col_cap, 2] f32 velocities in padded column order
    (replaces zanlungo_dense.py:878 ``zanlungo_forces_dense``); rows that
    hold no query are undefined (callers gather through ``bpos``).  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/zanlungo_dense.cu`` with :func:`k4_geometry`.  ``overflow``: an
    optional [2] int32 CUDA tensor to which the kernel adds the queries
    that overflow their neighbour list and re-walk their window, and the
    blocks whose candidates exceed the stage and are read in place (a
    measurement aid; the result is exact either way)."""
    if feat.device.type == "cpu":
        return forces_dense_plain(cfg, zp5, feat, tile_start, int_prio)
    from ..utils import cuda_build

    counters = {}
    if overflow is not None:
        counters = dict(overflow=(overflow, torch.int32, (2,)))
    cuda_build.check_tensors(
        "zanlungo_forces_dense",
        zp5=(zp5, torch.float32, (5,)),
        feat=(feat, torch.float32, (feat.shape[0], NUM_F)),
        tile_start=(tile_start, torch.int32, (cfg.n_tiles + 1,)),
        **counters,
    )
    geo = k4_geometry(cfg, feat.shape[0])
    out = torch.empty((cfg.slots, 2), dtype=torch.float32, device=feat.device)
    cuda_build.launch("crowdsim_zanlungo_dense", zp5, feat, tile_start, out,
                      overflow, cfg.tx, cfg.ty, cfg.col_cap, geo.tiles,
                      geo.threads, geo.stage_rows, int(bool(int_prio)))
    zanlungo_forces_dense.launches += 1
    return out


zanlungo_forces_dense.launches = 0


def zanlungo_fused_dense(cfg: DenseConfig, zp, position, velocity,
                         self_pref, pref_committed, priority, eyesight,
                         alive, rec_vel, key_sorted, int_prio: bool = False):
    """prep -> K4 -> gather through ``bpos`` over TILE-SORTED rows
    (zanlungo_dense.py:908; its ``dual_row`` is a TPU tier and has no
    counterpart).  Returns (vel [N, 2], max tile occupancy [] int32,
    dropped [] int32 — rows past their column's capacity, which keep
    ``rec_vel``)."""
    feat, tile_start, bpos, n_over, max_occ = dense_prep(
        cfg, key_sorted, position, velocity, pref_committed, self_pref,
        priority, eyesight, rec_vel, alive)
    out = zanlungo_forces_dense(cfg, zparams5(zp), feat, tile_start,
                                int_prio=int_prio)
    ok = (bpos < cfg.slots) & alive
    vel = out[torch.clamp(bpos, 0, cfg.slots - 1).long()].to(position.dtype)
    vel = torch.where(ok[:, None], vel, rec_vel)
    return vel, max_occ, n_over
