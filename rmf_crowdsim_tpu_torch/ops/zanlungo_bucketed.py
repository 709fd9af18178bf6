"""Bucketed supertile layout and the fused Zanlungo force kernels (K1,
K1b).

Counterpart of ``rmf_crowdsim_tpu/ops/zanlungo_pallas.py`` (the layout,
``zanlungo_forces_bucketed`` with and without ``spill_ext``, and
``zanlungo_fused``; the spill half lives in ``ops/spill.py``).

Layout, identical to the JAX package's slot for slot: the world is split
into square supertiles of ``tile_size`` >= max eyesight, ``tx`` x ``ty``,
flat id ``t = tcx * ty + tcy``; each tile owns ``bucket`` slots of a
``[slots, NUM_F]`` feature plane (``packed_t``) and of its 8-row candidate
transpose (``packed_T``); empty slots hold the sentinel row (position
1e30, id -1).  Agents beyond a tile's bucket ("spills") are repaired
exactly by ``ops/spill`` (kernel K2).

K1 computes, for every live slot, ``rec + F/m`` over every live candidate
in the 3x3 tiles around the query's tile with ``d^2 < eye^2`` and another
id — the same neighbor set as the TPU kernel's distance-masked strip
windows — with ``t_i`` = min time-to-collision and ``F`` applied only
where ``t_i`` is finite.  K1b (``fused_spills``) adds up to 128 spills
as a fourth candidate segment for the queries of flagged sub-blocks.
``zanlungo_forces_bucketed`` and ``zanlungo_forces_bucketed_spill``
launch the CUDA kernels (``csrc/zanlungo_bucketed.cu``) on CUDA tensors
and run the plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..utils import cuda_build

# Feature rows of the packed plane (zanlungo_pallas.py:74-87).  Rows
# [0, NUM_CAND) are the candidate-side features.
ROW_PX, ROW_PY = 0, 1
ROW_VX, ROW_VY = 2, 3
ROW_FX, ROW_FY = 4, 5
ROW_PRIO = 6
ROW_ID = 7
NUM_CAND = 8
ROW_RX, ROW_RY = 8, 9
ROW_EYE = 10
ROW_SPX, ROW_SPY = 11, 12
ROW_BPOS = 13
ROW_ONE = 15
NUM_F = 16

POS_SENTINEL = 1e30


def zparams5(zp) -> torch.Tensor:
    """The kernels' 5-scalar parameter vector [5] f32, in the one canonical
    order (agent_scale, force_distance, agent_mass, agent_radius,
    force_cap)."""
    return torch.stack([
        zp.agent_scale, zp.force_distance, zp.agent_mass, zp.agent_radius,
        zp.force_cap,
    ]).to(torch.float32)


def sentinel_rows(n_rows: int, device="cuda") -> torch.Tensor:
    """[n_rows, NUM_F] empty-slot rows: position 1e30, id -1, zeros
    elsewhere."""
    s = torch.zeros((n_rows, NUM_F), dtype=torch.float32, device=device)
    s[:, ROW_PX] = POS_SENTINEL
    s[:, ROW_PY] = POS_SENTINEL
    s[:, ROW_ID] = -1.0
    return s


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """Static geometry of the bucketed supertile layout — geometry-identical
    to the JAX package's (zanlungo_pallas.py:118-210), including its
    TPU-alignment asserts, so both packages accept the same configs.  The
    port's kernels do not depend on ``strip_tiles``/``sub_tiles``."""

    tile_size: float
    offset: Tuple[float, float]
    tx: int
    ty: int
    bucket: int
    strip_tiles: int
    sub_tiles: int

    @property
    def n_tiles(self) -> int:
        return self.tx * self.ty

    @property
    def slots(self) -> int:
        return self.n_tiles * self.bucket

    def __post_init__(self):
        assert self.strip_tiles % self.sub_tiles == 0
        assert self.ty % self.strip_tiles == 0
        assert self.tx >= 3 and self.ty >= 3, "world must span >= 3 tiles"
        assert self.ty >= self.sub_tiles + 2, (
            "ty must be >= sub_tiles + 2 (window must fit in a column)"
        )
        assert (self.sub_tiles + 2) * self.bucket == 128, (
            "(sub_tiles + 2) * bucket must equal 128"
        )
        assert self.bucket % 8 == 0, "bucket must be a multiple of 8"
        assert (self.sub_tiles * self.bucket) % 8 == 0
        assert (self.ty * self.bucket) % 128 == 0, (
            "ty * bucket must be a multiple of 128"
        )

    @classmethod
    def create(cls, width: float, height: float, offset: Tuple[float, float],
               max_eyesight: float, bucket: int = 16,
               strip_tiles: int = 96, sub_tiles: int | None = None,
               tile_size: float | None = None) -> "BucketConfig":
        """``tile_size`` defaults to the eyesight (the correctness
        minimum); the strip is chosen as in the JAX package so ``ty``
        pads identically."""
        if sub_tiles is None:
            sub_tiles = 128 // bucket - 2
        tile = max(float(tile_size or 0.0), float(max_eyesight), 1e-6)
        tx = max(3, int(math.ceil(width / tile)))
        ty = max(3, int(math.ceil(height / tile)))
        ty = max(ty, sub_tiles + 2)
        align = max(1, 128 // bucket)
        base = sub_tiles * align // math.gcd(sub_tiles, align)
        strip_max = max(base, (strip_tiles // base) * base)
        ty_rounded = int(math.ceil(ty / base) * base)
        strip_max = min(strip_max, ty_rounded)
        best = None
        for cand in range(base, strip_max + 1, base):
            padded = int(math.ceil(ty / cand) * cand)
            if best is None or padded < best[0] or (
                padded == best[0] and cand > best[1]
            ):
                best = (padded, cand)
        ty, strip = best
        return cls(tile_size=tile, offset=(float(offset[0]), float(offset[1])),
                   tx=tx, ty=ty, bucket=bucket, strip_tiles=strip,
                   sub_tiles=sub_tiles)


# ---------------------------------------------------------------------------
# Binning and packing
# ---------------------------------------------------------------------------


def tile_coords(cfg: BucketConfig, position: torch.Tensor, col_clip=None,
                col_shift: int = 0):
    """(tcx [N], tcy [N]) int32 supertile coordinates, clipped into the
    world: ``floor((p - offset) * (1 / tile_size))`` in the position dtype
    with a Python-float reciprocal, bit for bit the JAX computation.

    ``col_clip``: (lo, hi) bounds of the column in place of (0, tx - 1),
    as the JAX ``tile_key`` takes them (zanlungo_pallas.py:217).
    ``col_shift``: an integer subtracted from the column before the clip,
    so a shard of the world engine bins global positions into its own
    block of columns with the same float operations at every shard count
    (the JAX engine bins positions shifted by a float instead)."""
    inv_tile = 1.0 / cfg.tile_size
    rel_x = (position[:, 0] - cfg.offset[0]) * inv_tile
    rel_y = (position[:, 1] - cfg.offset[1]) * inv_tile
    lo, hi = col_clip if col_clip is not None else (0, cfg.tx - 1)
    tcx = torch.floor(rel_x).to(torch.int32)
    if col_shift:
        tcx = tcx - int(col_shift)
    tcx = torch.clamp(tcx, lo, hi)
    tcy = torch.clamp(torch.floor(rel_y).to(torch.int32), 0, cfg.ty - 1)
    return tcx, tcy


def tile_key(cfg: BucketConfig, position: torch.Tensor,
             alive: torch.Tensor, col_clip=None,
             col_shift: int = 0) -> torch.Tensor:
    """Supertile sort key per agent [N] int32: flat tile id, ``n_tiles``
    for dead agents (they sort last).  ``col_clip``, ``col_shift``: see
    :func:`tile_coords`."""
    tcx, tcy = tile_coords(cfg, position, col_clip, col_shift)
    tid = tcx * cfg.ty + tcy
    return torch.where(alive, tid, torch.full_like(tid, cfg.n_tiles))


def rank_from_sorted_key(cfg: BucketConfig, sorted_tid: torch.Tensor):
    """Rank-within-tile for a SORTED tile-key array.  Returns (bpos [N]
    int32 — bucket slot per row, ``slots`` for dead/overflow rows; max_occ
    [] int32, saturating at bucket + 2; n_bucket_over [] int32).

    The rank is the JAX package's windowed count over the previous
    ``bucket + 1`` rows (zanlungo_pallas.py:255-277): exact for in-bucket
    rows, saturating for overflow rows."""
    n = sorted_tid.shape[0]
    t_sent = cfg.n_tiles
    w = cfg.bucket + 1
    padded = torch.cat([
        torch.full((w,), -2, dtype=torch.int32, device=sorted_tid.device),
        sorted_tid,
    ])
    rank = torch.zeros((n,), dtype=torch.int32, device=sorted_tid.device)
    for k in range(1, w + 1):
        rank += (padded[w - k:w - k + n] == sorted_tid).to(torch.int32)
    live = sorted_tid < t_sent
    in_bucket = live & (rank < cfg.bucket)
    bpos = torch.where(in_bucket, sorted_tid * cfg.bucket + rank,
                       torch.full_like(rank, cfg.slots))
    max_occ = torch.where(live, rank + 1, torch.zeros_like(rank)).max()
    n_bucket_over = (live & ~in_bucket).sum(dtype=torch.int32)
    return bpos, max_occ.to(torch.int32), n_bucket_over


def bucketize(cfg: BucketConfig, position, velocity, pref_committed,
              self_pref, priority, eyesight, rec_vel, alive,
              use_pack_kernel: bool = False, presorted: bool = False,
              binning=None, col_clip=None, col_shift: int = 0):
    """Pack agent features into the bucketed layout
    (zanlungo_pallas.py:280-413).

    Returns (packed_t [slots, NUM_F] f32, packed_T [NUM_CAND, slots] f32,
    bucket_pos [N] int32 (``slots`` for dropped/dead agents), max tile
    occupancy [] int32, dropped [] int32).

    ``presorted``: agents are already in :func:`tile_key` order.
    ``binning``: a carried (bpos, max_occ, n_bucket_over) from
    :func:`rank_from_sorted_key` (presorted only); agents that died since
    are packed inert (sentinel position, id -1).  ``use_pack_kernel``
    only decides, as in the JAX package, whether feature row 13 carries
    the bucket slot: both settings pack through kernel K3.
    ``col_clip``, ``col_shift``: bounds and shift of the binning column
    (:func:`tile_coords`); the packed rows keep ``position``."""
    from .pack import pack_rows

    feat_t, bpos_sorted, bucket_pos, max_occ, n_bucket_over = feature_rows(
        cfg, position, velocity, pref_committed, self_pref, priority,
        eyesight, rec_vel, alive, use_pack_kernel=use_pack_kernel,
        presorted=presorted, binning=binning, col_clip=col_clip,
        col_shift=col_shift)
    packed_t, packed_T, pack_overflow = pack_rows(feat_t, bpos_sorted,
                                                  cfg.slots)
    dropped = (n_bucket_over + pack_overflow).to(torch.int32)
    return packed_t, packed_T, bucket_pos, max_occ, dropped


def feature_rows(cfg: BucketConfig, position, velocity, pref_committed,
                 self_pref, priority, eyesight, rec_vel, alive,
                 use_pack_kernel: bool = False, presorted: bool = False,
                 binning=None, col_clip=None, col_shift: int = 0):
    """The binning half of :func:`bucketize`: returns (feat_t [NUM_F, N]
    f32 contiguous, tile-sorted — K3's input; bpos_sorted [N] int32;
    bucket_pos [N] int32 in agent order; max_occ; n_bucket_over)."""
    n = position.shape[0]
    dev = position.device
    assert n < (1 << 24), "slot ids must be exact in f32"
    f32 = torch.float32

    order = None
    if binning is not None:
        assert presorted, "binning reuse requires presorted state"
        bpos_sorted, max_occ, n_bucket_over = binning
    else:
        key = tile_key(cfg, position, alive, col_clip, col_shift)
        if presorted:
            sorted_tid = key
        else:
            order = torch.sort(key, stable=True).indices
            sorted_tid = key[order]
        bpos_sorted, max_occ, n_bucket_over = rank_from_sorted_key(
            cfg, sorted_tid)

    px_col = position[:, 0].to(f32)
    py_col = position[:, 1].to(f32)
    id_col = torch.arange(n, dtype=f32, device=dev)
    if binning is not None:
        # Fresh-dead masking (zanlungo_pallas.py:345-356).
        sent = torch.full((), POS_SENTINEL, dtype=f32, device=dev)
        px_col = torch.where(alive, px_col, sent)
        py_col = torch.where(alive, py_col, sent)
        id_col = torch.where(alive, id_col, torch.full_like(id_col, -1.0))
    zeros = torch.zeros((n,), dtype=f32, device=dev)
    feat_t = torch.stack([
        px_col, py_col,
        velocity[:, 0].to(f32), velocity[:, 1].to(f32),
        pref_committed[:, 0].to(f32), pref_committed[:, 1].to(f32),
        priority.to(f32), id_col,
        rec_vel[:, 0].to(f32), rec_vel[:, 1].to(f32),
        eyesight.to(f32),
        self_pref[:, 0].to(f32), self_pref[:, 1].to(f32),
        zeros,  # row 13: bucket slot (set below, in sorted order)
        zeros,  # row 14: padding
        torch.ones((n,), dtype=f32, device=dev),  # row 15: 1.0
    ], dim=0)
    if order is not None:
        feat_t = feat_t[:, order]
    if use_pack_kernel:
        feat_t[ROW_BPOS] = bpos_sorted.to(f32)

    if order is None:
        bucket_pos = bpos_sorted
    else:
        bucket_pos = torch.full((n,), cfg.slots, dtype=torch.int32,
                                device=dev)
        bucket_pos[order] = bpos_sorted
    return (feat_t.contiguous(), bpos_sorted, bucket_pos, max_occ,
            n_bucket_over)


# ---------------------------------------------------------------------------
# Pair math shared by the plain versions of K1 and K2
# ---------------------------------------------------------------------------
#
# Operation for operation the arithmetic of csrc/zanlungo_pair.cuh (which
# is compiled without FMA contraction), so kernel and plain version take
# the same discrete decisions (masks, TTC branches, flips) and differ only
# in the order of the final force sums.  The formulation is the TPU
# kernel's (_pair_ttc / _pair_force, zanlungo_pallas.py:421-624) with
# library asin/sin in place of its polynomials and sqrt in place of rsqrt.

_HALF_PI = 1.5707963267948966


def _pair_ttc(qvx, qvy, qpx, qpy, cvx, cvy, cpx, cpy, radius):
    """Pairwise time-to-collision (zanlungo.rs:49-74), half-b form."""
    rvx = cvx - qvx
    rvy = cvy - qvy
    rpx = cpx - qpx
    rpy = cpy - qpy
    a = rvx * rvx + rvy * rvy
    bh = rvx * rpx + rvy * rpy
    c = rpx * rpx + rpy * rpy - radius * radius
    disc4 = bh * bh - a * c
    safe_a = torch.where(a > 0, a, torch.ones_like(a))
    sq = torch.sqrt(torch.clamp(disc4, min=0.0))
    num0 = -bh - sq
    num1 = -bh + sq
    inf = torch.full_like(a, float("inf"))
    res_num = torch.where(
        (num0 < 0) & (num1 > 0), torch.zeros_like(a),
        torch.where(num0 > 0, num0, torch.where(num1 > 0, num1, inf)),
    )
    res = res_num * (1.0 / safe_a)
    res = torch.where(disc4 < 0, inf, res)
    return torch.where(a > 0, res, inf)


def _pair_force(zp5, t_i, inv_t, qpx, qpy, qvx, qvy, qspx, qspy, qprio,
                cpx, cpy, cvx, cvy, cfx, cfy, cprio, int_prio: bool):
    """Pairwise force (zanlungo.rs:93-198), unmasked: (fx, fy)."""
    agent_scale, force_distance, radius, force_cap = (
        zp5[0], zp5[1], zp5[3], zp5[4])
    zero = torch.zeros((), dtype=qpx.dtype, device=qpx.device)
    row = torch.clamp(qprio - cprio, -1.0, 1.0)
    neg_row = row < 0
    if int_prio:
        # Full right of way takes the candidate's committed preference as
        # ``cv + 1 * (cf - cv)``, rounded as the general path and the
        # oracle round it, not as ``cf``: at t_i == 0 a speed difference
        # of one rounding step is the difference between no force and
        # ``force_cap``.  (Query-outranks pairs have weight 0, so
        # ``mv == qv`` changes nothing.)
        w = row
        mvx, mvy = qvx, qvy
        ovx = torch.where(neg_row, cvx + (cfx - cvx), cvx)
        ovy = torch.where(neg_row, cvy + (cfy - cvy), cvy)
    else:
        r2 = torch.sqrt(torch.abs(row))
        r2n = torch.where(row < 0, r2, zero)
        r2p = torch.where(row > 0, r2, zero)
        w = torch.sign(row) * r2
        pos_row = row > 0
        mvx = torch.where(pos_row, qvx + r2p * (qspx - qvx), qvx)
        mvy = torch.where(pos_row, qvy + r2p * (qspy - qvy), qvy)
        ovx = torch.where(neg_row, cvx + r2n * (cfx - cvx), cvx)
        ovy = torch.where(neg_row, cvy + r2n * (cfy - cvy), cvy)

    weight = 1.0 - w
    dx = (qpx + mvx * t_i) - (cpx + ovx * t_i)
    dy = (qpy + mvy * t_i) - (cpy + ovy * t_i)
    dist = torch.sqrt(dx * dx + dy * dy)

    stationary = (cfx * cfx + cfy * cfy) < 1e-8
    perp_sx = -(qpy - cpy)
    perp_sy = qpx - cpx
    flip_s = (perp_sx * qvx + perp_sy * qvy) < 0
    perp_sx = torch.where(flip_s, -perp_sx, perp_sx)
    perp_sy = torch.where(flip_s, -perp_sy, perp_sy)
    perp_mx = -cfy
    perp_my = cfx
    flip_m = (perp_mx * dx + perp_my * dy) < 0
    perp_mx = torch.where(flip_m, -perp_mx, perp_mx)
    perp_my = torch.where(flip_m, -perp_my, perp_my)
    interpolate = stationary | ((cfx * dx + cfy * dy) > 0)
    perp_x = torch.where(stationary, perp_sx, perp_mx)
    perp_y = torch.where(stationary, perp_sy, perp_my)

    if int_prio:
        cross = perp_x * dy - perp_y * dx
        slerp_live = neg_row & interpolate & (torch.abs(cross) > 0)
        dx = torch.where(slerp_live, perp_x, dx)
        dy = torch.where(slerp_live, perp_y, dy)
    else:
        sin_theta = torch.clamp(torch.abs(perp_x * dy - perp_y * dx),
                                max=1.0)
        theta = torch.asin(sin_theta)
        t_s = weight - 1.0
        s0 = torch.sin(torch.clamp((1.0 - t_s) * theta, 0.0, _HALF_PI))
        s1 = torch.sin(torch.clamp(t_s * theta, 0.0, _HALF_PI))
        slerp_live = (weight > 1.0) & interpolate & (sin_theta > 0)
        dx = torch.where(slerp_live, dx * s0 + perp_x * s1, dx)
        dy = torch.where(slerp_live, dy * s0 + perp_y * s1, dy)

    d2n = dx * dx + dy * dy
    inv_d = torch.where(
        d2n > 0, 1.0 / torch.sqrt(torch.where(d2n > 0, d2n,
                                              torch.ones_like(d2n))), zero)
    ux = dx * inv_d
    uy = dy * inv_d

    surface_dist = dist - 2.0 * radius
    sdx = mvx - ovx
    sdy = mvy - ovy
    speed_diff = torch.sqrt(sdx * sdx + sdy * sdy)
    magnitude = weight * agent_scale * speed_diff * inv_t
    magnitude = torch.where((t_i == 0) & (speed_diff * weight > 0),
                            torch.full_like(magnitude, float("inf")),
                            magnitude)
    magnitude = torch.minimum(magnitude, force_cap)
    falloff = torch.exp(surface_dist * (-1.0 / force_distance))
    scale = magnitude * falloff
    return ux * scale, uy * scale


def pair_velocities(zp5, q, c, mask, int_prio: bool):
    """Velocities ``rec + F/m`` of queries ``q`` against candidates ``c``.

    ``q``: dict of query features shaped [..., Q, 1] (px, py, vx, vy, spx,
    spy, prio, rx, ry); ``c``: dict of candidate features [..., 1, C]
    (px, py, vx, vy, fx, fy, prio); ``mask`` [..., Q, C].  Returns
    [..., Q, 2]."""
    inf = torch.full((), float("inf"), dtype=torch.float32,
                     device=mask.device)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    ttc = _pair_ttc(q["vx"], q["vy"], q["px"], q["py"],
                    c["vx"], c["vy"], c["px"], c["py"], zp5[3])
    t_i = torch.where(mask, ttc, inf).amin(-1, keepdim=True)  # [..., Q, 1]
    has = torch.isfinite(t_i)
    t_safe = torch.where(has, t_i, zero)
    inv_t = 1.0 / torch.where(t_safe > 0, t_safe, torch.ones_like(t_safe))
    pfx, pfy = _pair_force(
        zp5, t_safe, inv_t, q["px"], q["py"], q["vx"], q["vy"], q["spx"],
        q["spy"], q["prio"], c["px"], c["py"], c["vx"], c["vy"], c["fx"],
        c["fy"], c["prio"], int_prio,
    )
    fx = torch.where(mask, pfx, zero).sum(-1, keepdim=True)
    fy = torch.where(mask, pfy, zero).sum(-1, keepdim=True)
    inv_mass = 1.0 / zp5[2]
    out_x = q["rx"] + torch.where(has, fx * inv_mass, zero)
    out_y = q["ry"] + torch.where(has, fy * inv_mass, zero)
    return torch.cat([out_x, out_y], -1)


def query_features(rows: torch.Tensor) -> dict:
    """Query-side features [..., Q, 1] from packed rows [..., Q, NUM_F]."""
    def r(i):
        return rows[..., i:i + 1]
    return dict(px=r(ROW_PX), py=r(ROW_PY), vx=r(ROW_VX), vy=r(ROW_VY),
                spx=r(ROW_SPX), spy=r(ROW_SPY), prio=r(ROW_PRIO),
                rx=r(ROW_RX), ry=r(ROW_RY), eye=r(ROW_EYE), id=r(ROW_ID))


def candidate_features(cand: torch.Tensor) -> dict:
    """Candidate-side features [..., 1, C] from a candidate plane
    [NUM_CAND, ..., C]."""
    def r(i):
        return cand[i].unsqueeze(-2)
    return dict(px=r(ROW_PX), py=r(ROW_PY), vx=r(ROW_VX), vy=r(ROW_VY),
                fx=r(ROW_FX), fy=r(ROW_FY), prio=r(ROW_PRIO), id=r(ROW_ID))


def pair_mask(q: dict, c: dict) -> torch.Tensor:
    """The kernels' candidate mask: strict ``d^2 < eye^2``, another id, a
    live candidate and a live query."""
    ddx = c["px"] - q["px"]
    ddy = c["py"] - q["py"]
    d2 = ddx * ddx + ddy * ddy
    return ((d2 < q["eye"] * q["eye"]) & (c["id"] != q["id"])
            & (c["id"] >= 0) & (q["id"] >= 0))


# ---------------------------------------------------------------------------
# K1: the force kernel
# ---------------------------------------------------------------------------

# Tiles of one column per K1/K1b block: at bucket 32 a block takes ~74 KB
# of shared memory and 256 threads, so three blocks fill an SM's 228 KB
# (k1_geometry), and the halo costs 17/15 reads of the candidate plane.
K1_TILES_PER_BLOCK = 15

# Entries of a query's neighbour list in K1/K1b (LIST_CAP in
# csrc/neighbour_list.cuh); a query with more hits re-walks its window.
K1_LIST_CAP = 32

# Most threads of a K1/K1b block (MAX_THREADS in csrc/zanlungo_bucketed.cuh).
K1_MAX_THREADS = 512

# Shared memory one block of the H100 can take.
SMEM_LIMIT = 232_448


@dataclasses.dataclass(frozen=True)
class K1Geometry:
    """Launch geometry of K1/K1b: ``blocks`` runs of ``tiles`` tiles of
    one column, ``threads`` per block, ``smem_bytes`` of dynamic shared
    memory."""

    tiles: int
    threads: int
    blocks: int
    smem_bytes: int


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def k1_geometry(cfg: BucketConfig, tiles_per_block: int = K1_TILES_PER_BLOCK,
                n_sp: int = 0, threads: int | None = None) -> K1Geometry:
    """K1's (``n_sp`` = 0) or K1b's launch geometry.  The kernel takes
    ``tiles`` and ``threads`` and lays out its shared memory itself
    (``make_layout`` in ``csrc/zanlungo_bucketed.cuh``); ``smem_bytes``
    mirrors that layout so that a block the card cannot hold is refused
    here, before the launch: the
    compacted stage (NUM_CAND f32 for each of 3 (T+2) bucket window
    slots and n_sp spill lanes), the ballot words and their prefix, the
    neighbour lists [K1_LIST_CAP, threads] uint16, the live-query slots
    [T bucket] uint16 and a counter.
    Threads: half the block's slots (the bench scene fills 54% of them),
    rounded up to a warp, unless the caller gives them (the stage probe
    times another rule).  Raises if the block needs more than the H100's
    232,448 bytes."""
    b = cfg.bucket
    tiles = max(1, min(int(tiles_per_block), cfg.ty))
    if threads is None:
        threads = min(K1_MAX_THREADS, max(32, -(-tiles * b // 64) * 32))
    elif not (32 <= threads <= K1_MAX_THREADS and threads % 32 == 0):
        raise ValueError(f"K1: {threads} threads a block; a multiple of 32 "
                         f"up to {K1_MAX_THREADS} is needed")
    cols = 3 * (tiles + 2) * b
    row = cols + n_sp
    chunks = -(-cols // 32)
    smem = _align16(4 * NUM_CAND * row)
    smem = _align16(smem + 4 * chunks)
    smem = _align16(smem + 4 * (chunks + 1))
    smem = _align16(smem + 2 * K1_LIST_CAP * threads)
    smem = _align16(smem + 2 * tiles * b)
    smem = _align16(smem + 4)
    if tiles * b > 65535 or row > 65536:
        raise ValueError(f"K1: {tiles} tiles of {b} slots and {n_sp} spill "
                         f"lanes overflow the kernel's uint16 indices")
    if smem > SMEM_LIMIT:
        raise ValueError(f"K1: {smem} bytes of shared memory per block "
                         f"({tiles} tiles of bucket {b}, {n_sp} spill lanes) "
                         f"exceed {SMEM_LIMIT}")
    blocks = cfg.tx * -(-cfg.ty // tiles)
    return K1Geometry(tiles=tiles, threads=threads, blocks=blocks,
                      smem_bytes=smem)


# Most spills K1b takes as candidates (the JAX package's S_K,
# zanlungo_pallas.py:2162); more fall back to the spill patch.
FUSED_SPILL_LANES = 128


def _window_candidates(cfg: BucketConfig, packed_T, t):
    """The candidate plane [NUM_CAND, T, 9b] of the 3x3 tiles around
    tiles ``t`` [T]; slots outside the world read as id -1."""
    b, tx, ty = cfg.bucket, cfg.tx, cfg.ty
    d = torch.arange(-1, 2, device=t.device)
    lane = torch.arange(b, device=t.device)
    ncx = (t // ty)[:, None, None] + d[None, :, None]         # [T, 3, 1]
    ncy = (t % ty)[:, None, None] + d[None, None, :]          # [T, 1, 3]
    ok = (ncx >= 0) & (ncx < tx) & (ncy >= 0) & (ncy < ty)    # [T, 3, 3]
    base = (ncx * ty + ncy) * b
    cand = (base[..., None] + lane).reshape(t.shape[0], 9 * b)
    ok = ok[..., None].expand(-1, 3, 3, b).reshape(t.shape[0], 9 * b)
    cf = packed_T[:, torch.where(ok, cand, torch.zeros_like(cand))]
    cf[ROW_ID] = torch.where(ok, cf[ROW_ID],
                             torch.full_like(cf[ROW_ID], -1.0))
    return cf


def forces_bucketed_plain(cfg: BucketConfig, zp5, packed_t, packed_T, int_prio,
                  chunk_slots: int = 1 << 17):
    """Plain version of K1: every slot against the 3x3 tiles around its
    tile, in chunks of ``chunk_slots`` queries to bound the pair
    temporaries.  Empty slots get their rec row (zero for sentinels)."""
    b = cfg.bucket
    dev = packed_t.device
    out = torch.empty((cfg.slots, 2), dtype=torch.float32, device=dev)
    chunk_tiles = max(1, chunk_slots // b)
    for t0 in range(0, cfg.n_tiles, chunk_tiles):
        t1 = min(cfg.n_tiles, t0 + chunk_tiles)
        cf = _window_candidates(cfg, packed_T,
                                torch.arange(t0, t1, device=dev))
        c = candidate_features(cf)                             # [T, 1, 9b]
        rows = packed_t[t0 * b:t1 * b].reshape(t1 - t0, b, NUM_F)
        q = query_features(rows)
        mask = pair_mask(q, c)
        out[t0 * b:t1 * b] = pair_velocities(
            zp5, q, c, mask, int_prio).reshape(-1, 2)
    return out


def zanlungo_forces_bucketed(cfg: BucketConfig, zp5: torch.Tensor,
                             packed_t: torch.Tensor, packed_T: torch.Tensor,
                             int_prio: bool = False,
                             overflow: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """K1 over the packed plane: [slots, 2] f32 velocities (rec + F/m)
    per bucket slot (replaces zanlungo_pallas.py:1348
    ``zanlungo_forces_bucketed``).  ``zp5``: [5] f32 from
    :func:`zparams5`.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/zanlungo_bucketed.cu``.  ``overflow``: an optional [1]
    int32 CUDA tensor to which the kernel adds the queries whose hits
    overflow the neighbour list (a measurement aid; the result is exact
    either way)."""
    if packed_t.device.type == "cpu":
        return forces_bucketed_plain(cfg, zp5, packed_t, packed_T, int_prio)
    cuda_build.check_tensors(
        "zanlungo_forces_bucketed",
        zp5=(zp5, torch.float32, (5,)),
        packed_t=(packed_t, torch.float32, (cfg.slots, NUM_F)),
        packed_T=(packed_T, torch.float32, (NUM_CAND, cfg.slots)),
        **_overflow_spec(overflow),
    )
    geo = k1_geometry(cfg)
    out = torch.empty((cfg.slots, 2), dtype=torch.float32,
                      device=packed_t.device)
    cuda_build.launch(
        "crowdsim_zanlungo_bucketed",
        zp5, packed_t, packed_T, out, overflow, cfg.tx, cfg.ty, cfg.bucket,
        geo.tiles, geo.threads, int(bool(int_prio)),
    )
    zanlungo_forces_bucketed.launches += 1
    return out


zanlungo_forces_bucketed.launches = 0


def _overflow_spec(overflow):
    """``check_tensors`` entry of the optional list-overflow counter."""
    if overflow is None:
        return {}
    return dict(overflow=(overflow, torch.int32, (1,)))


def slot_flags(cfg: BucketConfig, sflag: torch.Tensor) -> torch.Tensor:
    """[slots] bool: the slot's sub-block carries a nonzero fused-spill
    flag (sub-block ``tcx * (ty // sub_tiles) + tcy // sub_tiles``)."""
    t = torch.arange(cfg.n_tiles, device=sflag.device)
    blk = ((t // cfg.ty) * (cfg.ty // cfg.sub_tiles)
           + (t % cfg.ty) // cfg.sub_tiles)
    return torch.repeat_interleave(sflag[blk] > 0, cfg.bucket)


def forces_bucketed_spill_plain(cfg: BucketConfig, zp5, packed_t, packed_T,
                                sflag, sp_T, int_prio,
                                chunk_slots: int = 1 << 14):
    """Plain version of K1b: K1's plain version, then every slot of a
    flagged sub-block again against its 3x3 window followed by the spill
    plane's lanes.  Unflagged slots keep K1's output bit for bit."""
    out = forces_bucketed_plain(cfg, zp5, packed_t, packed_T, int_prio)
    s_idx = torch.nonzero(slot_flags(cfg, sflag)).squeeze(1)
    n_sp = sp_T.shape[1]
    for a in range(0, s_idx.shape[0], chunk_slots):
        s = s_idx[a:a + chunk_slots]
        cf = torch.cat([
            _window_candidates(cfg, packed_T, s // cfg.bucket),
            sp_T[:, None, :].expand(-1, s.shape[0], n_sp),
        ], dim=2)                                   # [8, S, 9b + n_sp]
        c = candidate_features(cf)                  # [S, 1, C]
        q = query_features(packed_t[s][:, None, :])  # [S, 1, 1]
        out[s] = pair_velocities(zp5, q, c, pair_mask(q, c),
                                 int_prio)[:, 0, :]
    return out


def zanlungo_forces_bucketed_spill(cfg: BucketConfig, zp5: torch.Tensor,
                                   packed_t: torch.Tensor,
                                   packed_T: torch.Tensor,
                                   sflag: torch.Tensor, sp_T: torch.Tensor,
                                   int_prio: bool = False,
                                   overflow: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """K1b: K1 with the fused-spill segment (replaces
    ``zanlungo_forces_bucketed(spill_ext=(sflag, sp_T))``,
    zanlungo_pallas.py:1365-1437).  ``sflag`` [n_blocks] int32 from
    ``spill.spill_flags``; ``sp_T`` [NUM_CAND, S] f32, id -1 on dead
    lanes.  CPU tensors take the plain version; CUDA tensors launch the
    spill variant of ``csrc/zanlungo_bucketed.cu``.  ``overflow``: as
    for :func:`zanlungo_forces_bucketed`."""
    if packed_t.device.type == "cpu":
        return forces_bucketed_spill_plain(cfg, zp5, packed_t, packed_T,
                                           sflag, sp_T, int_prio)
    n_blocks = cfg.tx * (cfg.ty // cfg.sub_tiles)
    n_sp = sp_T.shape[1]
    cuda_build.check_tensors(
        "zanlungo_forces_bucketed_spill",
        zp5=(zp5, torch.float32, (5,)),
        packed_t=(packed_t, torch.float32, (cfg.slots, NUM_F)),
        packed_T=(packed_T, torch.float32, (NUM_CAND, cfg.slots)),
        sflag=(sflag, torch.int32, (n_blocks,)),
        sp_T=(sp_T, torch.float32, (NUM_CAND, n_sp)),
        **_overflow_spec(overflow),
    )
    geo = k1_geometry(cfg, n_sp=n_sp)
    out = torch.empty((cfg.slots, 2), dtype=torch.float32,
                      device=packed_t.device)
    cuda_build.launch(
        "crowdsim_zanlungo_bucketed_spill",
        zp5, packed_t, packed_T, sflag, sp_T, out, overflow, cfg.tx, cfg.ty,
        cfg.bucket, geo.tiles, geo.threads, cfg.sub_tiles, n_sp,
        int(bool(int_prio)),
    )
    zanlungo_forces_bucketed_spill.launches += 1
    return out


zanlungo_forces_bucketed_spill.launches = 0


# ---------------------------------------------------------------------------
# The fused pass
# ---------------------------------------------------------------------------


def zanlungo_fused(cfg: BucketConfig, zp, position, velocity, self_pref,
                   pref_committed, priority, eyesight, alive, rec_vel,
                   use_pack_kernel: bool = False, spill_capacity: int = 0,
                   presorted: bool = False, int_prio: bool = False,
                   binning=None, dual_row: bool = False,
                   fused_spills: bool = False):
    """bucketize -> K1 (or K1b) -> unbucketize -> spill repair (K2)
    (zanlungo_pallas.py:2106).  Returns (vel [N, 2], max tile occupancy []
    int32, dropped [] int32).

    ``binning``: (key, bpos, max_occ, n_bucket_over) carried by the
    skin-deferred presort.  ``dual_row`` changes only the TPU kernel's f32
    reduction order and is ignored.  The GPU pack has no streaming window,
    so no agent can lose its slot to pack overflow and the JAX package's
    ``_fix_pack_dropped`` branch has nothing to fix.

    With ``spill_capacity > 0`` the first ``spill_capacity`` spills,
    rounded up to whole chunks of 16 as the JAX package's ``spill_patch``
    rounds its list, are listed once (``spill.spill_rows``) and K2
    (``spill.spill_window``)
    writes their own rows and, on the spill-patch path, every affected
    window row into ``vel``.  ``fused_spills`` (on a >= 5x5-tile world):
    the first ``min(128, spill_capacity)`` of them ride K1b as a fourth
    candidate segment on flagged sub-blocks, so K2's window rows are
    needed only in a storm (more spills than that).  Where the JAX package
    picks fused, storm or nothing with ``lax.cond``, the port gates K2's
    window rows with a bool on the device, so the step gains no host
    read."""
    from .spill import spill_candidates, spill_flags, spill_rows, spill_window

    dtype = position.dtype
    tile_xy = None
    bin3 = None
    if binning is not None:
        key_c, bpos_c, occ_c, over_c = binning
        bin3 = (bpos_c, occ_c, over_c)
        t_alive = torch.clamp(key_c, 0, cfg.n_tiles - 1)
        tile_xy = (t_alive // cfg.ty, t_alive % cfg.ty)
    packed_t, packed_T, bucket_pos, max_occ, dropped = bucketize(
        cfg, position, velocity, pref_committed, self_pref, priority,
        eyesight, rec_vel, alive, use_pack_kernel=use_pack_kernel,
        presorted=presorted, binning=bin3,
    )
    zp5 = zparams5(zp)
    if spill_capacity > 0:
        c_sp, rows, sp_tcx, sp_tcy = spill_rows(
            cfg, position, velocity, self_pref, pref_committed, priority,
            eyesight, alive, rec_vel, bucket_pos, int(spill_capacity),
            tile_xy=tile_xy)
    use_fsp = bool(spill_capacity > 0 and fused_spills
                   and cfg.tx >= 5 and cfg.ty >= 5)
    if use_fsp:
        # Fused-spill discovery (zanlungo_pallas.py:2158-2205): the first
        # min(128, spill_capacity) spills are K1b's spill plane, not
        # rounded to the list's chunks (the JAX package's fused_cap).
        n_fused = min(FUSED_SPILL_LANES, int(spill_capacity))
        out = zanlungo_forces_bucketed_spill(
            cfg, zp5, packed_t, packed_T,
            spill_flags(cfg, sp_tcx[:n_fused], sp_tcy[:n_fused],
                        c_sp.valid[:n_fused]),
            spill_candidates(rows[:n_fused]), int_prio=int_prio)
    else:
        out = zanlungo_forces_bucketed(cfg, zp5, packed_t, packed_T,
                                       int_prio=int_prio)
    ok = (bucket_pos < cfg.slots) & alive
    vel = out[torch.clamp(bucket_pos, 0, cfg.slots - 1).long()].to(dtype)
    vel = torch.where(ok[:, None], vel, rec_vel)
    if spill_capacity > 0:
        # Fused: K1b fixed the affected packed rows of the spills it held;
        # K2 rewrites every affected row only in a storm, from scratch
        # (idempotent, so any partial fused contribution is replaced).
        windows = c_sp.count > n_fused if use_fsp else None
        spill_window(cfg, zp5, packed_t, packed_T, rows, sp_tcx, sp_tcy, vel,
                     int_prio=int_prio, windows=windows)
        # `dropped` counted every spill (and any pack overflow); only those
        # past the list stay unresolved.
        dropped = (dropped - c_sp.count + c_sp.n_over).to(torch.int32)
    return vel, max_occ, dropped
