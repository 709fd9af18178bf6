"""The least time the card could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move, each
input byte that its work needs read once and each output byte written
once, over the H100's 3.35 TB/s; and the f32 operations its inputs need,
over the H100's 67 TFLOP/s outside the tensor cores.  Where the work
depends on the data, both count what these inputs need, not the most
they could: K1's and K4's bytes follow the live slots and rows, K2's the
live spills and the rows it writes; the operations are one mask test per live (query,
candidate) pair of the query's own 3x3 tiles (and the spill list, where
the kernel has one), the time to collision for every
pair that the mask takes, and the force for every such pair of a query
with a finite time to collision.

    Bound(k1_bytes(cfg, n_live), k1_work(cfg, zp5, packed_t,
                                         packed_T).ops(True)).ms

The operation counts follow ``csrc/zanlungo_pair.cuh``, each add,
multiply, compare, select, min, max, square root, exponential, sine,
arcsine and division counted as one.  The counting helpers run the plain
versions' mask and TTC math on the kernel's own inputs, in chunks, on
whatever device those lie on.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import spill as _spill
from ..ops import zanlungo_bucketed as zb
from ..ops import zanlungo_dense as zd

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Dense tensor-core peaks of the H100 SXM (NVIDIA's data sheet), by the
# input type of the product; f32 runs on the FFMA units.
TENSOR_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "s8": 1979e12,
                    "f32": F32_OPS_PER_S}

MASK_OPS = 11                           # pair_mask
TTC_OPS = 37                            # pair_ttc and the running min
FORCE_OPS = {True: 90, False: 135}      # pair_force<int_prio>

_F32 = 4
_SECTOR = 32     # bytes: the unit of a DRAM access
QUERY_F = 11        # features load_query reads from a live query's row
EMPTY_F = 3         # an empty slot's id and rec (rx, ry)
OUT_F = 2           # each output row


@dataclasses.dataclass(frozen=True)
class Bound:
    """A kernel's bytes and operations, and the least time they take."""

    bytes: int
    ops: int = 0
    ops_per_s: float = F32_OPS_PER_S

    @property
    def bytes_ms(self) -> float:
        return 1e3 * self.bytes / HBM_BYTES_PER_S

    @property
    def ops_ms(self) -> float:
        return 1e3 * self.ops / self.ops_per_s

    @property
    def ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


@dataclasses.dataclass(frozen=True)
class Work:
    """What a force kernel's inputs need: ``tests`` live (query,
    candidate) pairs of its windows, ``pairs`` that the mask takes (each
    needs a time to collision), ``forced`` of those whose query has a
    finite time to collision (each needs a force)."""

    tests: int = 0
    pairs: int = 0
    forced: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.tests + other.tests, self.pairs + other.pairs,
                    self.forced + other.forced)

    def __sub__(self, other: "Work") -> "Work":
        return Work(self.tests - other.tests, self.pairs - other.pairs,
                    self.forced - other.forced)

    def ops(self, int_prio: bool) -> int:
        return (self.tests * MASK_OPS + self.pairs * TTC_OPS
                + self.forced * FORCE_OPS[bool(int_prio)])


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _pair_work(zp5, q: dict, c: dict) -> Work:
    """Work of query features ``q`` [..., Q, 1] against candidates ``c``
    [..., 1, C] (or [..., Q, C])."""
    mask = zb.pair_mask(q, c)
    ttc = zb._pair_ttc(q["vx"], q["vy"], q["px"], q["py"], c["vx"],
                       c["vy"], c["px"], c["py"], zp5[3])
    t_i = torch.where(mask, ttc, torch.full_like(ttc, float("inf")))
    finite = torch.isfinite(t_i.amin(-1, keepdim=True))
    counts = torch.stack([((q["id"] >= 0) & (c["id"] >= 0)).sum(),
                          mask.sum(), (mask & finite).sum()]).tolist()
    return Work(*counts)


def _slot_work(cfg, zp5, packed_t, packed_T, s, sp_T=None) -> Work:
    """Work of query slots ``s`` [S] against their 3x3 windows, followed
    by the spill plane's lanes where ``sp_T`` is given."""
    cf = zb._window_candidates(cfg, packed_T, s // cfg.bucket)
    if sp_T is not None:
        cf = torch.cat([cf, sp_T[:, None, :].expand(-1, s.shape[0], -1)], 2)
    q = zb.query_features(packed_t[s][:, None, :])
    return _pair_work(zp5, q, zb.candidate_features(cf))


# ---------------------------------------------------------------------------
# K1, K1b: the force kernel over the bucketed plane
# ---------------------------------------------------------------------------


def k1_plane_bytes(cfg) -> int:
    """An upper number for K1: ``zp5``, the whole of ``packed_t`` [slots,
    16] and ``packed_T`` [8, slots] in and [slots, 2] out, as if every
    slot were live and every feature needed."""
    return _F32 * (5 + cfg.slots * (zb.NUM_F + zb.NUM_CAND + OUT_F))


def k1_bytes(cfg, n_live: int) -> int:
    """What K1 must move with ``n_live`` live slots: ``zp5``; for each
    live slot the 11 query features of its ``packed_t`` row, its 8
    candidate features of ``packed_T`` and its output row; for each empty
    slot its id, its rec (rx, ry) and its output row."""
    n_empty = cfg.slots - int(n_live)
    return _F32 * (5 + int(n_live) * (QUERY_F + zb.NUM_CAND + OUT_F)
                   + n_empty * (EMPTY_F + OUT_F))


def k1_work(cfg, zp5, packed_t, packed_T,
            chunk_slots: int = 1 << 16) -> Work:
    """K1's work on these planes: every live slot against the live slots
    of its 3x3 window."""
    b = cfg.bucket
    chunk_tiles = max(1, chunk_slots // b)
    work = Work()
    for t0 in range(0, cfg.n_tiles, chunk_tiles):
        t1 = min(cfg.n_tiles, t0 + chunk_tiles)
        cf = zb._window_candidates(
            cfg, packed_T, torch.arange(t0, t1, device=packed_T.device))
        q = zb.query_features(
            packed_t[t0 * b:t1 * b].reshape(t1 - t0, b, zb.NUM_F))
        work += _pair_work(zp5, q, zb.candidate_features(cf))
    return work


def k1b_bytes(cfg, n_live: int, sp_T) -> int:
    """K1's bytes, the sub-block flags, and of the spill plane [8, n_sp]
    the 8 features of each live lane and the id of each dead one."""
    n_blocks = cfg.tx * (cfg.ty // cfg.sub_tiles)
    lanes = sp_T.shape[1]
    live = int((sp_T[zb.ROW_ID] >= 0).sum())
    return k1_bytes(cfg, n_live) + _F32 * (
        n_blocks + zb.NUM_CAND * live + (lanes - live))


def k1b_work(cfg, zp5, packed_t, packed_T, sflag, sp_T,
             chunk_slots: int = 1 << 14) -> Work:
    """K1's work, with each flagged slot's window followed by the spill
    plane's lanes."""
    work = k1_work(cfg, zp5, packed_t, packed_T)
    s_idx = torch.nonzero(zb.slot_flags(cfg, sflag)).squeeze(1)
    for a in range(0, s_idx.shape[0], chunk_slots):
        s = s_idx[a:a + chunk_slots]
        work += (_slot_work(cfg, zp5, packed_t, packed_T, s, sp_T)
                 - _slot_work(cfg, zp5, packed_t, packed_T, s))
    return work


# ---------------------------------------------------------------------------
# K2: the spill-window kernel
# ---------------------------------------------------------------------------


def _k2_windows(cfg, rows, sp_tcx, sp_tcy):
    """(live spills [P], the slots of the tiles that their window queries'
    own 3x3 tiles cover [P, 25b] (columns ``qcol - 1 .. qcol + 3``, rows
    likewise; -1 outside the world), their query slots [P, 9b]).  A mask
    takes no candidate outside a query's own 3x3 tiles, so the rest of
    the 5x5 window is no work of the function's."""
    b, tx, ty = cfg.bucket, cfg.tx, cfg.ty
    live = torch.nonzero(rows[:, zb.ROW_ID] >= 0).squeeze(1)
    tcx, tcy = sp_tcx[live], sp_tcy[live]
    _, _, qcol, qrow = _spill._window_geometry(cfg, tcx, tcy)
    k = torch.arange(-1, 4, device=rows.device)
    cx = qcol[:, None, None] + k[None, :, None]               # [P, 5, 1]
    cy = qrow[:, None, None] + k[None, None, :]               # [P, 1, 5]
    ok = (cx >= 0) & (cx < tx) & (cy >= 0) & (cy < ty)        # [P, 5, 5]
    slots = (cx * ty + cy)[..., None] * b + torch.arange(b, device=k.device)
    slots = torch.where(ok[..., None], slots, -1).reshape(-1, 25 * b)
    return live, slots, _spill.window_query_slots(cfg, tcx, tcy)


OWN_F = 5   # spill-row features only the own row reads: rec, eye, self pref


def k2_bytes(cfg, zp5, packed_t, rows, sp_tcx, sp_tcy, vel) -> int:
    """``zp5`` and the spill tiles; of the spill rows [S, 16], the 8
    candidate features and the 5 more that its own row reads of each live
    spill, the id of each other one; for the live spills only (the other
    blocks return at once), each distinct slot of the tiles that their
    window queries' own 3x3 tiles cover once: of a live slot its 8
    candidate features, and its 11 query features where it is a window
    query; of an empty slot its id, and its rec where it is a window
    query (as ``k1_bytes``); their [9b + 1, 2] rows of ``out``; and one
    ``vel`` row for each agent written (each affected window query once,
    each own row)."""
    live, cand, q_slots = _k2_windows(cfg, rows, sp_tcx, sp_tcy)
    n_live = live.numel()
    cand = torch.unique(cand[cand >= 0])
    q_uniq = torch.unique(q_slots)
    live_c = int((packed_t[cand, zb.ROW_ID] >= 0).sum())
    live_q = int((packed_t[q_uniq, zb.ROW_ID] >= 0).sum())
    empty_q = q_uniq.numel() - live_q
    aff = _spill.affected(cfg, packed_t, rows, sp_tcx, sp_tcy)
    q_id = packed_t[_spill.window_query_slots(cfg, sp_tcx, sp_tcy),
                    zb.ROW_ID]
    written = torch.unique(q_id[aff]).numel() + n_live
    return (_nbytes(zp5, sp_tcx, sp_tcy)
            + _F32 * ((zb.NUM_CAND + OWN_F) * n_live
                      + rows.shape[0] - n_live
                      + zb.NUM_CAND * live_c + (cand.numel() - live_c)
                      + QUERY_F * live_q + (EMPTY_F - 1) * empty_q
                      + OUT_F * (q_slots.numel() + n_live))
            + OUT_F * vel.element_size() * written)


def k2_work(cfg, zp5, packed_t, packed_T, rows, sp_tcx, sp_tcy,
            chunk: int = 32) -> Work:
    """Each live spill's window queries against the live slots of their
    own 3x3 tiles followed by the spill list (the contract's window,
    less the candidates no mask can take), and its own row against its
    3x3 block followed by the list (counted at the pair math's costs)."""
    live, _, q_slots = _k2_windows(cfg, rows, sp_tcx, sp_tcy)
    sp_T = _spill.spill_candidates(rows)
    work = Work()
    for lo in range(0, live.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        work += _slot_work(cfg, zp5, packed_t, packed_T,
                           q_slots[sl].reshape(-1), sp_T)
        spl = sp_T[:, None, :].expand(-1, q_slots[sl].shape[0], -1)
        cf = torch.cat([packed_T[:, q_slots[sl]], spl], 2)
        work += _pair_work(zp5, zb.query_features(rows[live[sl]][:, None, :]),
                           zb.candidate_features(cf))
    return work


# ---------------------------------------------------------------------------
# K3: the pack; K4: the dense force kernel
# ---------------------------------------------------------------------------


def k3_bytes(n_rows: int, slots: int) -> int:
    """``feat_t`` [16, N] and ``bpos`` [N] in, both planes out.  K3 moves
    bytes and computes nothing: its operations are 0."""
    return _F32 * (n_rows * (zb.NUM_F + 1)
                   + slots * (zb.NUM_F + zb.NUM_CAND))


def k4_bytes(cfg, feat) -> int:
    """``zp5`` and ``tile_start``; for each live row of ``feat`` [N, 16]
    its 11 query features, its tile row and the 2 force features that
    only candidates give (px, py, vx, vy, prio and id serve both); for
    each dead row its id and rec; and one output row for each of the N
    rows (the padding past a column's rows is not written)."""
    n = feat.shape[0]
    live = int((feat[:, zb.ROW_ID] >= 0).sum())
    return _F32 * (5 + cfg.n_tiles + 1 + live * (QUERY_F + 1 + 2)
                   + (n - live) * EMPTY_F + n * OUT_F)


def k4_work(cfg, zp5, feat, tile_start,
            chunk_pairs: int = 1 << 22) -> Work:
    """Every query row against the rows of its three candidate ranges."""
    rows, _, lo, hi = zd._query_windows(cfg, feat, tile_start)
    work = Work()
    if rows.shape[0] == 0:
        return work
    width = max(1, int((hi - lo).max()))
    chunk = max(1, chunk_pairs // (3 * width))
    lane = torch.arange(width, device=feat.device)
    for a in range(0, rows.shape[0], chunk):
        sl = slice(a, a + chunk)
        cand = lo[sl, :, None] + lane
        ok = (cand < hi[sl, :, None]).reshape(cand.shape[0], -1)
        cand = torch.where(ok, cand.reshape(ok.shape), 0)
        cf = feat[cand, :zb.NUM_CAND].permute(2, 0, 1)
        cf[zb.ROW_ID] = torch.where(ok, cf[zb.ROW_ID],
                                    torch.full_like(cf[zb.ROW_ID], -1.0))
        c = {k: v.squeeze(-2) for k, v in zb.candidate_features(cf).items()}
        q = zb.query_features(feat[rows[sl]])
        work += _pair_work(zp5, q, c)
    return work


# ---------------------------------------------------------------------------
# The probes: K1's stage cuts (P1/P2), the 0/1 product chain (P3), the
# transposes and feature-plane writers (P4)
# ---------------------------------------------------------------------------

# Query features each cut of K1 reads from a live query's packed_t row:
# the mask its position, eyesight and id; the TTC also its velocity.
MASK_QF = 4
TTC_QF = 6


def k1_stage_bytes(cfg, n_live: int, stage: str) -> int:
    """What cut ``stage`` of K1 (``probes/k1_stages.py``) must move with
    ``n_live`` live slots.  ``floor``: every slot's rec in, its output row
    out.  ``queries``: every slot's id too.  From ``stage`` on, an empty
    slot moves its id, rec and output row, and a live one its 8 candidate
    features (its id among them) and its output row, plus from ``mask``
    on the query features that the passes read (``MASK_QF``, ``TTC_QF``;
    ``ttc`` also ``zp5``); ``full`` is :func:`k1_bytes`."""
    n_live = int(n_live)
    if stage == "floor":
        return _F32 * cfg.slots * (2 + OUT_F)
    if stage == "queries":
        return _F32 * cfg.slots * (1 + 2 + OUT_F)
    if stage == "full":
        return k1_bytes(cfg, n_live)
    query_f = {"stage": 0, "mask": MASK_QF, "ttc": TTC_QF}[stage]
    return _F32 * ((5 if stage == "ttc" else 0)
                   + (cfg.slots - n_live) * (EMPTY_F + OUT_F)
                   + n_live * (zb.NUM_CAND + query_f + OUT_F))


def k1_stage_ops(work: Work, stage: str, int_prio: bool) -> int:
    """The operations of the passes cut ``stage`` runs on ``work``
    (:func:`k1_work`): none before the mask pass, then the mask tests,
    the times to collision, and the forces."""
    if stage in ("floor", "queries", "stage"):
        return 0
    if stage == "mask":
        return work.tests * MASK_OPS
    if stage == "ttc":
        return work.tests * MASK_OPS + work.pairs * TTC_OPS
    return work.ops(int_prio)


def mma_bound(m: int, k: int, n: int, dtype: str, iters: int = 1) -> Bound:
    """``iters`` chained [m, k] @ [k, n] products (``probes/
    mma_chain.py``): 2 m k n operations each at the dense peak of
    ``dtype`` (``TENSOR_OPS_PER_S``); x and w read once, the bits and the
    last product written once, all f32.  This is the card's rate, not the
    chain's: each product waits for the one before, so the chain is bound
    by the latency of its dependent instructions, far above this."""
    return Bound(_F32 * (m * k + k * n + 2 * m * n), 2 * m * k * n * iters,
                 TENSOR_OPS_PER_S[dtype])


def plane_bytes(kind: str, slots: int, k: int = 8) -> int:
    """The feature-plane writers (``probes/planes.py``): ``columns`` and
    ``rows`` read ``k`` [slots] vectors and write ``k`` floats a slot;
    ``rebuild`` reads 8 vectors and writes 16 floats a slot."""
    if kind == "rebuild":
        return _F32 * slots * (8 + zb.NUM_F)
    return _F32 * slots * 2 * k


def plane_sector_bytes(slots: int, k: int) -> int:
    """The columns writer's traffic as its layout forces it: the ``k``
    vectors read once, and each 32-byte sector its stores touch (one a
    slot for k = 4 or 8: the row's first 16 or 32 bytes) written whole.
    Equal to :func:`plane_bytes` at k = 8; 48 B a slot against 32 at
    k = 4."""
    return slots * (_F32 * k + _SECTOR * -(-_F32 * k // _SECTOR))


def transpose_bytes(rows: int, cols: int) -> int:
    """A [rows, cols] block read once and written once, transposed."""
    return _F32 * 2 * rows * cols
