"""The benchmark's frozen yardstick: copies that later changes to the
program cannot move.

- :func:`step_percentiles`: ``utils/profiling.StepTimer.summary``'s
  arithmetic (numpy's linear percentiles over per-step seconds).
- :class:`TileGeometry`: ``ops/zanlungo_bucketed.BucketConfig.create``'s
  tile count and strip padding, so the slots K1 walks are counted alike.
- :func:`k1_bytes`, :func:`k1_work`, :func:`k3_bytes`: ``utils/roofline.py``'s
  counts for K1 and K3.  :func:`k1_work` rebuilds the tiles from the
  positions itself and does not call the program; it keeps the first
  ``bucket`` agents of a tile in slot order, as a stable sort would, and
  counts the rest as spills (the program's unstable sort may spill others
  of the same tile, which moves the count by a few pairs in a million).
- :data:`HBM_BYTES_PER_S`, :data:`F32_OPS_PER_S`: NVIDIA's published peaks
  of one H100 SXM.

``tests/test_bench_frozen.py`` holds each copy against the program's
original on a small seeded state.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Operations of one pair test, one time to collision and one force, as
# csrc/zanlungo_pair.cuh counts them (utils/roofline.py).
MASK_OPS = 11
TTC_OPS = 37
FORCE_OPS = {True: 90, False: 135}

F32 = 4
QUERY_F = 11   # features a live query's row gives K1
CAND_F = 8     # features of a live candidate (the candidate plane)
EMPTY_F = 3    # an empty slot's id and rec
OUT_F = 2      # each output row
ROW_F = 16     # features of a packed row (K3's input and first plane)


def step_percentiles(seconds) -> dict:
    """p50 and p95 (ms) and the count of per-step times ``seconds``."""
    t = np.asarray(seconds, np.float64)
    return {"steps": int(t.size),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3)}


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    tile_size: float
    offset: tuple
    tx: int
    ty: int
    bucket: int

    @property
    def slots(self) -> int:
        return self.tx * self.ty * self.bucket

    @classmethod
    def create(cls, width, height, offset, max_eyesight, bucket,
               strip_tiles, sub_tiles, tile_size) -> "TileGeometry":
        tile = max(float(tile_size or 0.0), float(max_eyesight), 1e-6)
        tx = max(3, int(math.ceil(width / tile)))
        ty = max(3, int(math.ceil(height / tile)), sub_tiles + 2)
        align = max(1, 128 // bucket)
        base = sub_tiles * align // math.gcd(sub_tiles, align)
        strip_max = max(base, (strip_tiles // base) * base)
        strip_max = min(strip_max, int(math.ceil(ty / base) * base))
        best = None
        for cand in range(base, strip_max + 1, base):
            padded = int(math.ceil(ty / cand) * cand)
            if best is None or padded < best[0] or (
                    padded == best[0] and cand > best[1]):
                best = (padded, cand)
        return cls(tile, (float(offset[0]), float(offset[1])), tx, best[0],
                   int(bucket))

    @classmethod
    def of_config(cls, sim: dict) -> "TileGeometry":
        g = sim["grid"]
        return cls.create(g["width"], g["height"], g["offset"],
                          sim["max_eyesight"], sim["bucket_capacity"],
                          sim["strip_tiles"], sim["sub_tiles"],
                          sim["bucket_tile_size"])

    def tiles(self, position: torch.Tensor):
        """(tcx, tcy) int64: the tile of each position, clipped into the
        world, ``floor((p - offset) * (1 / tile_size))``."""
        inv = 1.0 / self.tile_size
        tcx = torch.floor((position[:, 0] - self.offset[0]) * inv).long()
        tcy = torch.floor((position[:, 1] - self.offset[1]) * inv).long()
        return tcx.clamp(0, self.tx - 1), tcy.clamp(0, self.ty - 1)


@dataclasses.dataclass(frozen=True)
class Work:
    tests: int = 0
    pairs: int = 0
    forced: int = 0

    def ops(self, int_prio: bool) -> int:
        return (self.tests * MASK_OPS + self.pairs * TTC_OPS
                + self.forced * FORCE_OPS[bool(int_prio)])


def bound_ms(n_bytes: int, ops: int) -> float:
    """The least time of a kernel: bytes over HBM bandwidth or f32
    operations over the f32 peak, whichever is longer."""
    return max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S)


def k1_bytes(geo: TileGeometry, n_live: int) -> int:
    """K1's bytes with ``n_live`` live slots (utils/roofline.k1_bytes)."""
    n_empty = geo.slots - int(n_live)
    return F32 * (5 + int(n_live) * (QUERY_F + CAND_F + OUT_F)
                  + n_empty * (EMPTY_F + OUT_F))


def k3_bytes(n_rows: int, slots: int) -> int:
    """K3's bytes: [16, N] rows and [N] slots in, both planes out
    (utils/roofline.k3_bytes); K3 computes nothing."""
    return F32 * (n_rows * (ROW_F + 1) + slots * (ROW_F + CAND_F))


def _ttc(qv, qp, cv, cp, radius):
    """utils/roofline's time to collision (the kernels' half-b form)."""
    rvx, rvy = cv[..., 0] - qv[..., 0], cv[..., 1] - qv[..., 1]
    rpx, rpy = cp[..., 0] - qp[..., 0], cp[..., 1] - qp[..., 1]
    a = rvx * rvx + rvy * rvy
    bh = rvx * rpx + rvy * rpy
    c = rpx * rpx + rpy * rpy - radius * radius
    disc4 = bh * bh - a * c
    safe_a = torch.where(a > 0, a, torch.ones_like(a))
    sq = torch.sqrt(torch.clamp(disc4, min=0.0))
    num0, num1 = -bh - sq, -bh + sq
    inf = torch.full_like(a, float("inf"))
    res = torch.where((num0 < 0) & (num1 > 0), torch.zeros_like(a),
                      torch.where(num0 > 0, num0,
                                  torch.where(num1 > 0, num1, inf)))
    res = res * (1.0 / safe_a)
    res = torch.where(disc4 < 0, inf, res)
    return torch.where(a > 0, res, inf)


def k1_inputs(geo: TileGeometry, position, velocity, eyesight, alive):
    """K1's plane rebuilt from agent fields: each live agent's slot
    (``-1`` for a spill) and the number of live slots."""
    tcx, tcy = geo.tiles(position)
    tid = torch.where(alive, tcx * geo.ty + tcy,
                      torch.full_like(tcx, geo.tx * geo.ty))
    key, order = torch.sort(tid, stable=True)
    n = key.shape[0]
    first = torch.searchsorted(key, key, right=False)
    rank = torch.arange(n, device=key.device) - first
    keep = (key < geo.tx * geo.ty) & (rank < geo.bucket)
    slot = torch.full((n,), -1, dtype=torch.long, device=key.device)
    slot[order] = torch.where(keep, key * geo.bucket + rank,
                              torch.full_like(key, -1))
    return slot, int(keep.sum())


def k1_work(geo: TileGeometry, position, velocity, eyesight, alive,
            radius: float, chunk_tiles: int = 2048) -> Work:
    """K1's work (utils/roofline.k1_work): every live slot against the
    live slots of its 3x3 tiles (``tests``), those strictly within the
    query's eyesight by ``d^2 < eye^2`` (``pairs``), and of those the
    ones whose query has a finite time to collision (``forced``)."""
    dev = position.device
    slot, _ = k1_inputs(geo, position, velocity, eyesight, alive)
    b = geo.bucket
    occ = slot >= 0
    src = torch.full((geo.slots,), -1, dtype=torch.long, device=dev)
    src[slot[occ]] = torch.nonzero(occ).flatten()
    d = torch.arange(-1, 2, device=dev)
    lane = torch.arange(b, device=dev)
    tests = pairs = forced = 0
    n_tiles = geo.tx * geo.ty
    for t0 in range(0, n_tiles, chunk_tiles):
        t = torch.arange(t0, min(n_tiles, t0 + chunk_tiles), device=dev)
        ncx = (t // geo.ty)[:, None, None] + d[None, :, None]
        ncy = (t % geo.ty)[:, None, None] + d[None, None, :]
        ok = (ncx >= 0) & (ncx < geo.tx) & (ncy >= 0) & (ncy < geo.ty)
        cs = ((ncx * geo.ty + ncy) * b)[..., None] + lane
        cs = torch.where(ok[..., None], cs, torch.zeros_like(cs))
        cand = torch.where(ok[..., None], src[cs], -1).reshape(t.shape[0],
                                                                 1, 9 * b)
        qry = src[(t[:, None] * b + lane)][:, :, None]       # [T, b, 1]
        live = (qry >= 0) & (cand >= 0)
        qi, ci = qry.clamp(min=0), cand.clamp(min=0)
        qp, cp = position[qi], position[ci]
        dd = cp - qp
        d2 = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
        eye = eyesight[qi]
        mask = live & (ci != qi) & (d2 < eye * eye)
        ttc = _ttc(velocity[qi], qp, velocity[ci], cp, radius)
        t_i = torch.where(mask, ttc, torch.full_like(ttc, float("inf")))
        finite = torch.isfinite(t_i.amin(-1, keepdim=True))
        counts = torch.stack([live.sum(), mask.sum(),
                              (mask & finite).sum()]).tolist()
        tests += counts[0]
        pairs += counts[1]
        forced += counts[2]
    return Work(int(tests), int(pairs), int(forced))
