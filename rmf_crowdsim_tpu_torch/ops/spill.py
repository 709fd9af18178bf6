"""Exact repair of bucket overflow: the spill list and the spill-repair
kernel (K2).

Counterpart of the spill half of ``rmf_crowdsim_tpu/ops/zanlungo_pallas.py``
(``spill_patch``, ``_spill_groups``, ``_spill_own_rows``, ``_spill_flags``
and ``_spill_groups_window_pallas``).

Agents beyond a tile's ``bucket`` slots ("spills") are missing from the
packed plane: they get no force output and every query within eyesight of
one computed a wrong min TTC.  :func:`spill_rows` lists the spills
without a host read; K2 (:func:`spill_window`, ``csrc/spill_window.cu``)
then recomputes, per spill, the queries of its 3x3 tile block against its
5x5 window plus the whole spill list, and the spill's own row against the
3x3 block plus the list (in the models/local math, as the JAX package
keeps it), and writes the affected rows into the velocities itself, in
one launch over all slots of the spill list (``spill_capacity`` rounded
up to whole chunks of 16, as the JAX package rounds it; invalid slots
return at once).  Where the JAX package picks a spill-count tier and
skips clean steps with ``lax.cond`` (zanlungo_pallas.py:1583-1604), the
port pays one launch and no host read.  ``spill_flags`` marks the force
kernel's sub-blocks that the fused-spill path (K1b,
``zanlungo_bucketed.zanlungo_fused``) must extend.
"""

from __future__ import annotations

import types

import torch

from ..models.local import zanlungo_from_rows
from .compact import compact_indices
from .zanlungo_bucketed import (
    NUM_CAND, NUM_F, ROW_EYE, ROW_FX, ROW_FY, ROW_ID, ROW_PRIO, ROW_PX,
    ROW_PY, ROW_RX, ROW_RY, ROW_SPX, ROW_SPY, ROW_VX, ROW_VY, BucketConfig,
    _overflow_spec, candidate_features, pair_mask, pair_velocities,
    query_features, tile_coords,
)


def _window_geometry(cfg: BucketConfig, sp_tcx, sp_tcy):
    """Per spill: the clamped 5x5 window origin (bx, by) and the 3x3 query
    block origin (qcol, qrow), all [S] int64 (zanlungo_pallas.py:1880-1883)."""
    tcx = sp_tcx.long()
    tcy = sp_tcy.long()
    bx = torch.clamp(tcx - 2, 0, cfg.tx - 5)
    by = torch.clamp(tcy - 2, 0, cfg.ty - 5)
    qcol = torch.clamp(tcx - 1, 0, cfg.tx - 3)
    qrow = torch.clamp(tcy - 1, 0, cfg.ty - 3)
    return bx, by, qcol, qrow


def window_query_slots(cfg: BucketConfig, sp_tcx, sp_tcy) -> torch.Tensor:
    """[S, 9b] packed slots of each spill's 3x3 query block, query order
    ``3b*i + b*j + r`` = slot r of tile (qcol + i, qrow + j)."""
    b, ty = cfg.bucket, cfg.ty
    _, _, qcol, qrow = _window_geometry(cfg, sp_tcx, sp_tcy)
    dev = qcol.device
    i = torch.arange(3, device=dev)
    lane = torch.arange(3 * b, device=dev)
    return (((qcol[:, None, None] + i[None, :, None]) * ty
             + qrow[:, None, None]) * b + lane).reshape(-1, 9 * b)


def window_candidate_slots(cfg: BucketConfig, sp_tcx, sp_tcy) -> torch.Tensor:
    """[S, 25b] packed slots of each spill's 5x5 window, column by column,
    each column's 5 tiles in order."""
    b, ty = cfg.bucket, cfg.ty
    bx, by, _, _ = _window_geometry(cfg, sp_tcx, sp_tcy)
    dev = bx.device
    k = torch.arange(5, device=dev)
    base = ((bx[:, None] + k) * ty + by[:, None]) * b             # [S, 5]
    return (base[..., None]
            + torch.arange(5 * b, device=dev)).reshape(-1, 25 * b)


def spill_list_size(spill_capacity: int) -> int:
    """Slots of the spill list: ``spill_capacity`` rounded up to whole
    chunks of ``min(16, spill_capacity)``, as the JAX package sizes it
    (zanlungo_pallas.py:1477-1479)."""
    cap = int(spill_capacity)
    chunk = max(1, min(16, cap))
    return -(-cap // chunk) * chunk


def spill_rows(cfg: BucketConfig, position, velocity, self_pref,
               pref_committed, priority, eyesight, alive, rec_vel,
               bucket_pos, spill_capacity: int, tile_xy=None):
    """The first ``S = spill_list_size(spill_capacity)`` spills (alive
    agents without a bucket slot), found without a host read.  Returns
    (compaction, rows [S, NUM_F] f32 in the packed-row layout — position,
    velocity, committed preference, priority, id (the agent index, -1 on
    invalid slots), rec, eyesight, self preference; rows 13-15 zero, as
    the JAX package builds them at zanlungo_pallas.py:2057-2071 — , sp_tcx
    [S] int32, sp_tcy [S] int32; 1 on invalid slots).  ``tile_xy``:
    carried tiles (tcx, tcy), else fresh ones.  The compaction fills in
    order, so the first k rows are the list of the first k spills; its
    ``n_over`` counts the spills past the S slots."""
    n = position.shape[0]
    f32 = torch.float32
    c_sp = compact_indices(alive & (bucket_pos >= cfg.slots),
                           spill_list_size(spill_capacity))
    valid = c_sp.valid
    s_cap = valid.shape[0]
    sc = torch.clamp(c_sp.idx, 0, n - 1).long()
    if tile_xy is not None:
        tcx, tcy = tile_xy[0][sc], tile_xy[1][sc]
    else:
        tcx, tcy = tile_coords(cfg, position[sc])
    sp_tcx = torch.where(valid, tcx.to(torch.int32), 1).contiguous()
    sp_tcy = torch.where(valid, tcy.to(torch.int32), 1).contiguous()

    def col(x):
        return x[sc].to(f32).reshape(s_cap, -1)

    rows = torch.cat([
        col(position), col(velocity), col(pref_committed), col(priority),
        torch.where(valid, c_sp.idx, -1).to(f32)[:, None],
        col(rec_vel), col(eyesight), col(self_pref),
        torch.zeros((s_cap, NUM_F - 13), dtype=f32, device=position.device),
    ], dim=1)
    return c_sp, rows, sp_tcx, sp_tcy


def spill_candidates(rows: torch.Tensor) -> torch.Tensor:
    """The spill list as a candidate plane [NUM_CAND, S] f32 (K1b's
    ``sp_T``)."""
    return rows[:, :NUM_CAND].t().contiguous()


def spill_flags(cfg: BucketConfig, sp_tcx, sp_tcy, spill_valid):
    """Per-sub-block fused-spill flags [n_blocks] int32
    (zanlungo_pallas.py:1993 ``_spill_flags``): the count of valid
    spills whose tile lies within Chebyshev distance 1 (clamped into the
    world) of one of the sub-block's tiles.  Sub-block ``(cx * n_strips
    + cy // strip_tiles) * nsub + (cy % strip_tiles) // sub_tiles``, the
    JAX kernel's indexing, which equals ``cx * (ty // sub_tiles) + cy //
    sub_tiles``.  Because ``tile_size >= max_eyesight``, every query
    within eyesight of a spill sits in a flagged sub-block."""
    n_strips = cfg.ty // cfg.strip_tiles
    nsub = cfg.strip_tiles // cfg.sub_tiles
    n_blocks = cfg.tx * n_strips * nsub
    dev = sp_tcx.device
    d = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    cx = torch.clamp(sp_tcx[:, None, None] + d[None, :, None], 0, cfg.tx - 1)
    cy = torch.clamp(sp_tcy[:, None, None] + d[None, None, :], 0, cfg.ty - 1)
    blk = ((cx * n_strips + torch.div(cy, cfg.strip_tiles,
                                      rounding_mode="floor")) * nsub
           + torch.div(torch.remainder(cy, cfg.strip_tiles), cfg.sub_tiles,
                       rounding_mode="floor"))
    tgt = torch.where(spill_valid[:, None, None], blk,
                      torch.full_like(blk, n_blocks))
    flags = torch.zeros((n_blocks + 1,), dtype=torch.int32, device=dev)
    flags.index_add_(0, tgt.reshape(-1).long(),
                     torch.ones((tgt.numel(),), dtype=torch.int32,
                                device=dev))
    return flags[:n_blocks]


# ---------------------------------------------------------------------------
# K2: the spill repair
# ---------------------------------------------------------------------------


def affected(cfg: BucketConfig, packed_t, rows, sp_tcx, sp_tcy):
    """[S, 9b] bool: window query q of spill p is rewritten — p is valid,
    q is live and ``d^2(q, spill p) < eye_q^2`` (zanlungo_pallas.py:1546-
    1559), in the kernel's f32 arithmetic."""
    q = packed_t[window_query_slots(cfg, sp_tcx, sp_tcy)]     # [S, 9b, F]
    dx = q[..., ROW_PX] - rows[:, None, ROW_PX]
    dy = q[..., ROW_PY] - rows[:, None, ROW_PY]
    eye = q[..., ROW_EYE]
    return ((rows[:, None, ROW_ID] >= 0) & (q[..., ROW_ID] >= 0)
            & (dx * dx + dy * dy < eye * eye))


def _own_rows_plain(cfg: BucketConfig, zp5, packed_t, rows, sp_tcx,
                    sp_tcy):
    """[S, 1, 2] velocities of the spills' own rows: each against the 9b
    slots of its 3x3 query block plus the spill list, in the models/local
    math (zanlungo_pallas.py:1936 ``_spill_own_rows``)."""
    s_cap = rows.shape[0]
    zp = types.SimpleNamespace(agent_scale=zp5[0], force_distance=zp5[1],
                               agent_mass=zp5[2], agent_radius=zp5[3],
                               force_cap=zp5[4])
    w3 = packed_t[window_query_slots(cfg, sp_tcx, sp_tcy)]   # [S, 9b, F]

    def cat(lo, hi):
        return torch.cat([w3[..., lo:hi],
                          rows[None, :, lo:hi].expand(s_cap, -1, -1)], 1)

    c_pos = cat(ROW_PX, ROW_PY + 1)
    c_prio = cat(ROW_PRIO, ROW_PRIO + 1)[..., 0]
    c_id = cat(ROW_ID, ROW_ID + 1)[..., 0]
    sp_pos = rows[:, ROW_PX:ROW_PY + 1]
    sp_id = rows[:, ROW_ID]
    d2 = ((c_pos - sp_pos[:, None, :]) ** 2).sum(-1)          # [S, nc]
    valid = ((c_id >= 0) & (sp_id >= 0)[:, None]
             & (d2 < (rows[:, ROW_EYE] ** 2)[:, None])
             & (c_id != sp_id[:, None]))
    return zanlungo_from_rows(
        zp, sp_pos[:, None], rows[:, None, ROW_VX:ROW_VY + 1],
        rows[:, None, ROW_SPX:ROW_SPY + 1], rows[:, None, ROW_PRIO],
        c_pos[:, None], cat(ROW_VX, ROW_VY + 1)[:, None],
        cat(ROW_FX, ROW_FY + 1)[:, None], c_prio[:, None], valid[:, None],
        rows[:, None, ROW_RX:ROW_RY + 1],
    )


def spill_window_plain(cfg: BucketConfig, zp5, packed_t, packed_T, rows,
                       sp_tcx, sp_tcy, vel, int_prio: bool, windows=None,
                       chunk: int = 32):
    """Plain version of K2: the window rows against the whole 5x5 window
    plus the list (the JAX contract), in chunks of ``chunk`` valid spills;
    the own rows in the models/local math; then the masked write into
    ``vel``.  Like the kernel, it leaves invalid spills' rows of the
    returned ``out`` unwritten; where ``windows`` is false the window rows
    are computed but not written to ``vel``."""
    b = cfg.bucket
    s_cap = rows.shape[0]
    out = torch.empty((s_cap, 9 * b + 1, 2), dtype=packed_t.dtype,
                      device=packed_t.device)
    q_slots = window_query_slots(cfg, sp_tcx, sp_tcy)
    cand = window_candidate_slots(cfg, sp_tcx, sp_tcy)
    sp_T = spill_candidates(rows)
    valid = rows[:, ROW_ID] >= 0
    live = torch.nonzero(valid).squeeze(1)
    for lo in range(0, live.shape[0], chunk):
        p = live[lo:lo + chunk]
        c = candidate_features(torch.cat([
            packed_T[:, cand[p]], sp_T[:, None, :].expand(-1, p.shape[0], -1),
        ], 2))
        q = query_features(packed_t[q_slots[p]])             # [c, 9b, 1]
        out[p, :9 * b] = pair_velocities(zp5, q, c, pair_mask(q, c),
                                         int_prio)
    own = _own_rows_plain(cfg, zp5, packed_t, rows, sp_tcx, sp_tcy)
    out[valid, 9 * b] = own[valid, 0]
    aff = affected(cfg, packed_t, rows, sp_tcx, sp_tcy)
    if windows is not None:
        aff &= windows
    q_id = packed_t[q_slots, ROW_ID]
    vel[q_id[aff].long()] = out[:, :9 * b][aff].to(vel.dtype)
    vel[rows[valid, ROW_ID].long()] = out[valid, 9 * b].to(vel.dtype)
    return out


def spill_window(cfg: BucketConfig, zp5: torch.Tensor, packed_t, packed_T,
                 rows: torch.Tensor, sp_tcx: torch.Tensor,
                 sp_tcy: torch.Tensor, vel: torch.Tensor,
                 int_prio: bool = False, windows: torch.Tensor | None = None,
                 overflow: torch.Tensor | None = None) -> torch.Tensor:
    """K2: the spill repair in one launch (replaces zanlungo_pallas.py:1867
    ``_spill_groups_window_pallas`` with the own rows of :1936 and the
    write of :1538-1583).  Writes the affected window rows and every valid
    spill's own row into ``vel`` [N, 2] (float32 or float64, in place) and
    returns ``out`` [S, 9b+1, 2] f32: each spill's window rows, then its
    own row (the contract ``csrc/spill_window.cu`` states).

    ``rows``, ``sp_tcx``, ``sp_tcy``: from :func:`spill_rows`.
    ``windows``: a [] bool on the device; where False only the own rows
    are computed and written (the fused-spill pass when its spills fit),
    chosen without a host read.  ``overflow``: an optional [1] int32
    counter of queries whose hits overflow the kernel's neighbour list.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    assert cfg.tx >= 5 and cfg.ty >= 5, (
        "the spill machinery needs a >= 5x5-tile world (set "
        "spill_capacity=0 for smaller worlds)"
    )
    if packed_t.device.type == "cpu":
        return spill_window_plain(cfg, zp5, packed_t, packed_T, rows,
                                  sp_tcx, sp_tcy, vel, int_prio, windows)
    from ..utils import cuda_build

    s_cap = rows.shape[0]
    if vel.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spill_window: vel must be float32 or float64, "
                         f"got {vel.dtype}")
    cuda_build.check_tensors(
        "spill_window",
        zp5=(zp5, torch.float32, (5,)),
        packed_t=(packed_t, torch.float32, (cfg.slots, NUM_F)),
        packed_T=(packed_T, torch.float32, (NUM_CAND, cfg.slots)),
        rows=(rows, torch.float32, (s_cap, NUM_F)),
        sp_tcx=(sp_tcx, torch.int32, (s_cap,)),
        sp_tcy=(sp_tcy, torch.int32, (s_cap,)),
        vel=(vel, vel.dtype, (vel.shape[0], 2)),
        **({} if windows is None else
           dict(windows=(windows, torch.bool, ()))),
        **_overflow_spec(overflow),
    )
    out = torch.empty((s_cap, 9 * cfg.bucket + 1, 2), dtype=torch.float32,
                      device=packed_t.device)
    cuda_build.launch(
        "crowdsim_spill_window", zp5, packed_t, packed_T, rows, sp_tcx,
        sp_tcy, windows, out, vel, overflow, s_cap, cfg.tx, cfg.ty,
        cfg.bucket, int(vel.dtype == torch.float64), int(bool(int_prio)))
    spill_window.launches += 1
    return out


spill_window.launches = 0
