"""Exact repair of bucket overflow, and the spill-window kernel (K2).

Counterpart of the spill half of ``rmf_crowdsim_tpu/ops/zanlungo_pallas.py``
(``spill_patch``, ``_spill_groups``, ``_spill_own_rows``, ``_spill_flags``
and ``_spill_groups_window_pallas``).

Agents beyond a tile's ``bucket`` slots ("spills") are missing from the
packed plane: they get no force output and every query within eyesight of
one computed a wrong min TTC.  Per spill, the queries of its 3x3 tile
block are recomputed exactly against its 5x5 window plus the whole spill
list (K2, ``csrc/spill_window.cu``), the spills' own rows go through the
models/local math, and the affected rows overwrite the kernel's output.

Where the JAX package picks a spill-count tier and skips clean steps with
``lax.cond`` (zanlungo_pallas.py:1583-1604), the port launches K2 once
over all ``spill_capacity`` slots (invalid slots return at once) and
writes the affected rows with one masked ``index_put_`` into a buffer
whose last row is a discard row: no host read of the spill count.
``spill_flags`` marks the force kernel's sub-blocks that the fused-spill
path (K1b, ``zanlungo_bucketed.zanlungo_fused``) must extend.
"""

from __future__ import annotations

import torch

from ..models.local import zanlungo_from_rows
from .compact import compact_indices
from .zanlungo_bucketed import (
    NUM_F, ROW_EYE, ROW_ID, ROW_PX, ROW_PY, BucketConfig,
    candidate_features, pair_mask, pair_velocities, query_features,
    tile_coords, zparams5,
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


def spill_window_plain(cfg: BucketConfig, zp5, packed_t, packed_T, sp_T,
                       sp_tcx, sp_tcy, int_prio: bool, chunk: int = 32):
    """Plain version of K2 over the valid spill slots (like the kernel,
    it leaves invalid slots' rows unwritten), in chunks of ``chunk``."""
    b, ty = cfg.bucket, cfg.ty
    s_cap = sp_T.shape[1]
    dev = packed_t.device
    out = torch.empty((s_cap, 9 * b, 2), dtype=torch.float32, device=dev)
    bx, by, _, _ = _window_geometry(cfg, sp_tcx, sp_tcy)
    q_slots = window_query_slots(cfg, sp_tcx, sp_tcy)
    lane = torch.arange(5 * b, device=dev)
    k = torch.arange(5, device=dev)
    live = torch.nonzero(sp_T[ROW_ID] >= 0).squeeze(1)
    for lo in range(0, live.shape[0], chunk):
        p = live[lo:lo + chunk]
        base = ((bx[p, None] + k) * ty + by[p, None]) * b    # [c, 5]
        cand = (base[..., None] + lane).reshape(p.shape[0], 25 * b)
        cf = torch.cat([
            packed_T[:, cand],
            sp_T[:, None, :].expand(-1, p.shape[0], -1),
        ], dim=2)                                   # [8, c, 25b + S]
        c = candidate_features(cf)                  # [c, 1, C]
        q = query_features(packed_t[q_slots[p]])    # [c, 9b, 1]
        out[p] = pair_velocities(zp5, q, c, pair_mask(q, c), int_prio)
    return out


def spill_window(cfg: BucketConfig, zp5: torch.Tensor, packed_t, packed_T,
                 sp_T: torch.Tensor, sp_tcx: torch.Tensor,
                 sp_tcy: torch.Tensor, int_prio: bool = False):
    """K2: [S, 9b, 2] velocities of each spill's 3x3 window queries
    against its 5x5 window plus the spill list (replaces
    zanlungo_pallas.py:1867 ``_spill_groups_window_pallas``).

    ``sp_T``: [NUM_CAND, S] spill candidate features, id -1 on invalid
    slots; ``sp_tcx``/``sp_tcy``: [S] int32 tiles.  Rows of invalid spills
    are left unwritten by the kernel (callers mask by query id).  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/spill_window.cu``."""
    if packed_t.device.type == "cpu":
        return spill_window_plain(cfg, zp5, packed_t, packed_T, sp_T,
                                  sp_tcx, sp_tcy, int_prio)
    from ..utils import cuda_build

    s_cap = sp_T.shape[1]
    cuda_build.check_tensors(
        "spill_window",
        zp5=(zp5, torch.float32, (5,)),
        packed_t=(packed_t, torch.float32, (cfg.slots, NUM_F)),
        packed_T=(packed_T, torch.float32, (8, cfg.slots)),
        sp_T=(sp_T, torch.float32, (8, s_cap)),
        sp_tcx=(sp_tcx, torch.int32, (s_cap,)),
        sp_tcy=(sp_tcy, torch.int32, (s_cap,)),
    )
    out = torch.empty((s_cap, 9 * cfg.bucket, 2), dtype=torch.float32,
                      device=packed_t.device)
    cuda_build.launch("crowdsim_spill_window", zp5, packed_t, packed_T,
                      sp_T, sp_tcx, sp_tcy, out, s_cap, cfg.tx, cfg.ty,
                      cfg.bucket, int(bool(int_prio)))
    spill_window.launches += 1
    return out


spill_window.launches = 0


def _spill_own_rows(cfg: BucketConfig, zp, packed_t, sp: dict, sp_tcx,
                    sp_tcy, spill_valid):
    """Velocities [S, 1, 2] of the spill agents' own rows: each spill
    against its 3x3 packed window plus the spill list, through the
    models/local math (zanlungo_pallas.py:1936)."""
    s_cap = sp_tcx.shape[0]
    w3 = packed_t[window_query_slots(cfg, sp_tcx, sp_tcy)]   # [S, 9b, F]
    w3_ok = w3[..., ROW_ID] >= 0

    def cat(win, spill):
        return torch.cat([win, spill[None].expand(s_cap, *spill.shape)], 1)

    c_pos = cat(w3[..., ROW_PX:ROW_PX + 2], sp["pos"])
    c_vel = cat(w3[..., 2:4], sp["vel"])
    c_prefc = cat(w3[..., 4:6], sp["prefc"])
    c_prio = cat(w3[..., 6], sp["prio"])
    c_id = cat(torch.where(w3_ok, w3[..., ROW_ID],
                           torch.full_like(w3[..., ROW_ID], -1.0)), sp["id"])
    d2 = ((c_pos - sp["pos"][:, None, :]) ** 2).sum(-1)     # [S, nc]
    valid = ((c_id >= 0) & spill_valid[:, None]
             & (d2 < (sp["eye"] ** 2)[:, None])
             & (c_id != sp["id"][:, None]))
    return zanlungo_from_rows(
        zp, sp["pos"][:, None], sp["vel"][:, None], sp["spref"][:, None],
        sp["prio"][:, None], c_pos[:, None], c_vel[:, None],
        c_prefc[:, None], c_prio[:, None], valid[:, None],
        sp["rec"][:, None],
    )


def spill_rows(cfg: BucketConfig, position, velocity, self_pref,
               pref_committed, priority, eyesight, alive, rec_vel,
               bucket_pos, spill_capacity: int, tile_xy=None, enabled=None):
    """The first ``spill_capacity`` spills (alive agents without a bucket
    slot), found without a host read.  Returns (compaction, sp — dict of
    [S, ...] f32 features pos, vel, prefc, spref, prio, eye, rec, id (the
    agent index, -1 on invalid slots) — , sp_tcx [S] int32, sp_tcy [S]
    int32).  ``tile_xy``: carried tiles (tcx, tcy), else fresh ones.
    ``enabled``: a [] bool on the device; where False every slot is
    invalid (``count`` and ``n_over`` still count the spills)."""
    n = position.shape[0]
    f32 = torch.float32
    c_sp = compact_indices(alive & (bucket_pos >= cfg.slots),
                           int(spill_capacity))
    if enabled is not None:
        c_sp = c_sp._replace(valid=c_sp.valid & enabled)
    valid = c_sp.valid
    sc = torch.clamp(c_sp.idx, 0, n - 1).long()
    if tile_xy is not None:
        tcx, tcy = tile_xy[0][sc], tile_xy[1][sc]
    else:
        tcx, tcy = tile_coords(cfg, position[sc])
    one = torch.ones((), dtype=torch.int32, device=position.device)
    sp_tcx = torch.where(valid, tcx.to(torch.int32), one).contiguous()
    sp_tcy = torch.where(valid, tcy.to(torch.int32), one).contiguous()
    sp = dict(
        pos=position[sc].to(f32),
        vel=velocity[sc].to(f32),
        prefc=pref_committed[sc].to(f32),
        spref=self_pref[sc].to(f32),
        prio=priority[sc].to(f32),
        eye=eyesight[sc].to(f32),
        rec=rec_vel[sc].to(f32),
        id=torch.where(valid, c_sp.idx,
                       torch.full_like(c_sp.idx, -1)).to(f32),
    )
    return c_sp, sp, sp_tcx, sp_tcy


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


def spill_candidates(sp: dict) -> torch.Tensor:
    """The spill list as K2's candidate plane [NUM_CAND, S] f32."""
    return torch.stack([
        sp["pos"][:, 0], sp["pos"][:, 1], sp["vel"][:, 0], sp["vel"][:, 1],
        sp["prefc"][:, 0], sp["prefc"][:, 1], sp["prio"], sp["id"],
    ], dim=0).contiguous()


def _spill_groups(cfg: BucketConfig, zp, packed_t, packed_T, sp: dict,
                  sp_tcx, sp_tcy, spill_valid, int_prio: bool = False):
    """Per-spill group evaluation (zanlungo_pallas.py:2019): out [S, 9b+1,
    2] (window queries by K2, then the spill's own row), q_id [S, 9b+1]
    (the queries' agent ids, -1 where invalid), q_slots [S, 9b]."""
    assert cfg.tx >= 5 and cfg.ty >= 5, (
        "the spill machinery needs a >= 5x5-tile world (set "
        "spill_capacity=0 for smaller worlds)"
    )
    s_cap = sp_tcx.shape[0]
    out_win = spill_window(cfg, zparams5(zp), packed_t, packed_T,
                           spill_candidates(sp), sp_tcx, sp_tcy,
                           int_prio=int_prio)
    q_slots = window_query_slots(cfg, sp_tcx, sp_tcy)
    q_id = torch.where(
        spill_valid[:, None], packed_t[q_slots.reshape(-1), ROW_ID].reshape(
            s_cap, -1),
        torch.full((), -1.0, device=packed_t.device),
    )
    own = _spill_own_rows(cfg, zp, packed_t, sp, sp_tcx, sp_tcy,
                          spill_valid)
    out = torch.cat([out_win, own], dim=1)
    q_id_full = torch.cat([q_id, sp["id"][:, None]], dim=1)
    return out, q_id_full, q_slots


def spill_patch(cfg: BucketConfig, zp, position, velocity, self_pref,
                pref_committed, priority, eyesight, alive, rec_vel,
                packed_t, packed_T, bucket_pos, vel, spill_capacity: int,
                int_prio: bool = False, tile_xy=None, enabled=None):
    """EXACT repair of bucket-overflow truncation (zanlungo_pallas.py:1440).
    Returns (vel, unresolved) — ``unresolved`` counts spills beyond
    ``spill_capacity``.  ``tile_xy``: the carried tiles (tcx, tcy) of the
    skin-deferred presort, else tiles come from fresh positions.
    ``enabled``: a [] bool on the device; where False no row is
    rewritten (the fused-spill pass's storm branch, chosen without a
    host read)."""
    n = position.shape[0]
    s_cap = int(spill_capacity)
    c_sp, sp, sp_tcx, sp_tcy = spill_rows(
        cfg, position, velocity, self_pref, pref_committed, priority,
        eyesight, alive, rec_vel, bucket_pos, s_cap, tile_xy=tile_xy,
        enabled=enabled)
    spill_valid = c_sp.valid
    out, q_id, q_slots = _spill_groups(
        cfg, zp, packed_t, packed_T, sp, sp_tcx, sp_tcy, spill_valid,
        int_prio=int_prio,
    )
    # Overwrite AFFECTED rows only: a window query's force changed iff a
    # spill sits strictly within its eyesight; the spill's own row always.
    q_agent = q_id.long()
    qrows = packed_t[q_slots.reshape(-1)]
    nq = q_slots.shape[1]
    qpx = qrows[:, ROW_PX].reshape(s_cap, nq)
    qpy = qrows[:, ROW_PY].reshape(s_cap, nq)
    qeye = qrows[:, ROW_EYE].reshape(s_cap, nq)
    d2s = ((qpx - sp["pos"][:, 0:1]) ** 2 + (qpy - sp["pos"][:, 1:2]) ** 2)
    aff = torch.cat([(d2s < qeye * qeye) & spill_valid[:, None],
                     spill_valid[:, None]], dim=1) & (q_agent >= 0)
    tgt = torch.where(aff, q_agent, torch.full_like(q_agent, n)).reshape(-1)
    buf = torch.cat([vel, vel.new_zeros((1, 2))], dim=0)     # row n: discard
    buf.index_put_((tgt,), out.reshape(-1, 2).to(vel.dtype))
    return buf[:n], c_sp.n_over.to(torch.int32)
