"""Each kernel's bound (``utils/roofline.py``) and K1's launch geometry.

Bytes pinned at the 1M bench config: K1 by need at 1,000,000 live slots
(11 query + 8 candidate features + the output for each live slot; id,
rec and the output for each of the 835,520 empty ones; zp5), and its
whole-plane upper number (packed_t 117.47 MB + packed_T 58.74 MB + out
14.68 MB + zp5); K3: feat_t 64 MB + bpos 4 MB + both planes 176.21 MB.
The work counts of K1, K1b, K2 and K4 are held against counts made here
from the positions alone; K1/K1b's shared memory within the H100's
232,448 bytes a block.
"""

import types

import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.ops import spill as tspill
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as tzd
from rmf_crowdsim_tpu_torch.utils import roofline as rl

from test_torch_fused_spills import CFG_ARGS, overflow_scene
from test_torch_zanlungo import random_scene, torch_params


def test_bytes_and_bound_at_the_1m_bench_config():
    cfg = scenes.bench_bucket_config(1_000_000)
    assert cfg.slots == 1_835_520
    assert rl.k1_plane_bytes(cfg) == 190_894_100
    assert rl.k1_bytes(cfg, 1_000_000) == 100_710_420
    assert rl.k3_bytes(1_000_000, cfg.slots) == 244_209_920
    b = rl.Bound(rl.k1_bytes(cfg, 1_000_000))
    assert b.bound_by == "bytes"
    assert b.ms == pytest.approx(0.0300628, rel=1e-5)
    # The bench's 2.2 G f32 operations outweigh those bytes.
    ops = rl.Bound(rl.k1_bytes(cfg, 1_000_000), 2_203_948_590)
    assert ops.bound_by == "operations"
    assert ops.ms == pytest.approx(0.0328948, rel=1e-5)
    # K1b adds the sub-block flags (239 x 120) and, of a 128-lane spill
    # plane with 62 live lanes, their 8 features and the others' ids.
    sp_T = torch.full((8, 128), 0.5)
    sp_T[tzb.ROW_ID, 62:] = -1.0
    assert rl.k1b_bytes(cfg, 1_000_000, sp_T) == 100_710_420 + 4 * (
        239 * 120 + 8 * 62 + 66)


def test_gate_bound_at_the_streams_shapes():
    """G1 at the 1M streaming scene: 1,048,576 alive flags, 1,000,000
    live positions, 1,024 sources in and their bytes out; 6 operations a
    (live agent, source) pair bind it."""
    b = rl.gate_bound(1_048_576, 1_000_000, 1024)
    assert b.bytes == 1_048_576 + 8 * 1_000_000 + 9 * 1024 == 9_057_792
    assert b.ops == 6 * 1_000_000 * 1024
    assert b.bound_by == "operations"
    assert b.ms == pytest.approx(0.0917015, rel=1e-5)
    assert rl.gate_bound(4096, 0, 64).ops == 0


def test_k1_bytes_between_no_slot_and_every_slot_live():
    cfg = scenes.bench_bucket_config(1_000_000)
    # Every slot live: the whole planes but the 5 features of each
    # packed_t row that load_query leaves (fx, fy, rows 13-15).
    assert rl.k1_bytes(cfg, cfg.slots) == (
        rl.k1_plane_bytes(cfg) - 4 * 5 * cfg.slots)
    # No slot live: each slot's id, rec and output row.
    assert rl.k1_bytes(cfg, 0) == 4 * (5 + 5 * cfg.slots)


def _window_counts(cfg, pos, eye, alive):
    """(live pairs in the 3x3 tile windows, pairs within eyesight), made
    from the positions with the kernel mask's f32 arithmetic."""
    tcx, tcy = tzb.tile_coords(cfg, pos)
    near = ((tcx[:, None] - tcx[None, :]).abs() <= 1) & (
        (tcy[:, None] - tcy[None, :]).abs() <= 1)
    live = alive[:, None] & alive[None, :]
    ddx = pos[None, :, 0] - pos[:, None, 0]
    ddy = pos[None, :, 1] - pos[:, None, 1]
    within = (ddx * ddx + ddy * ddy) < (eye * eye)[:, None]
    not_self = ~torch.eye(pos.shape[0], dtype=torch.bool)
    return int((near & live).sum()), int((within & live & not_self).sum())


def _scene(seed):
    return [torch.as_tensor(x) for x in random_scene(seed, 96, 24.0, 3.0)]


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_work_counts_live_tests_and_neighbours(seed):
    cfg = tzb.BucketConfig.create(24.0, 24.0, (0.0, 0.0), 3.0, bucket=16,
                                  strip_tiles=6, sub_tiles=6)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = _scene(seed)
    packed_t, packed_T, _, occ, dropped = tzb.bucketize(
        cfg, pos, vel, pref_c, self_pref, prio, eye, rec, alive)
    assert int(occ) <= cfg.bucket and int(dropped) == 0
    zp5 = tzb.zparams5(torch_params())
    w = rl.k1_work(cfg, zp5, packed_t, packed_T, chunk_slots=64)
    tests, pairs = _window_counts(cfg, pos, eye, alive)
    assert (w.tests, w.pairs) == (tests, pairs)
    assert 0 < w.forced <= w.pairs
    assert w.ops(True) == 11 * tests + 37 * pairs + 90 * w.forced
    assert w.ops(False) == 11 * tests + 37 * pairs + 135 * w.forced


def test_k4_work_counts_the_same_neighbours():
    """The dense layout sees the same neighbour pairs as K1; its tests
    are the live rows of its three candidate ranges."""
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = _scene(2)
    dcfg = tzd.DenseConfig.create(24.0, 24.0, (0.0, 0.0), 3.0, 96)
    key = tzb.tile_key(dcfg, pos, alive)
    order = torch.sort(key, stable=True).indices
    args = [x[order] for x in (pos, vel, pref_c, self_pref, prio, eye, rec,
                               alive)]
    feat, tile_start, _, n_over, _ = tzd.dense_prep(dcfg, key[order], *args)
    assert int(n_over) == 0
    w = rl.k4_work(dcfg, tzb.zparams5(torch_params()), feat, tile_start)
    tests, pairs = _window_counts(dcfg, pos, eye, alive)
    assert (w.tests, w.pairs) == (tests, pairs)
    # Bytes: 14 features of each live row, id and rec of each dead one,
    # one output row for each row (not the padded [slots, 2]).
    n_live = int(alive.sum())
    assert 0 < n_live < 96
    assert rl.k4_bytes(dcfg, feat) == 4 * (
        5 + dcfg.n_tiles + 1 + 14 * n_live + 3 * (96 - n_live) + 2 * 96)


def test_k1b_and_k2_work_on_an_overflowing_scene():
    tcfg = tzb.BucketConfig.create(**CFG_ARGS)
    scene = [torch.as_tensor(x) for x in overflow_scene(11)]
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = scene
    packed_t, packed_T, bucket_pos, occ, _ = tzb.bucketize(
        tcfg, pos, vel, pref_c, self_pref, prio, eye, rec, alive)
    assert int(occ) > tcfg.bucket
    c_sp, rows, sp_tcx, sp_tcy = tspill.spill_rows(
        tcfg, *scene, bucket_pos, tzb.FUSED_SPILL_LANES)
    sflag = tspill.spill_flags(tcfg, sp_tcx, sp_tcy, c_sp.valid)
    sp_T = tspill.spill_candidates(rows)
    zp5 = tzb.zparams5(torch_params())

    k1 = rl.k1_work(tcfg, zp5, packed_t, packed_T)
    k1b = rl.k1b_work(tcfg, zp5, packed_t, packed_T, sflag, sp_T)
    flagged = tzb.slot_flags(tcfg, sflag) & (packed_T[tzb.ROW_ID] >= 0)
    n_spills = int((sp_T[tzb.ROW_ID] >= 0).sum())
    assert n_spills == int(c_sp.count) > 0
    # Every flagged live query tests every live spill lane once more.
    assert k1b.tests - k1.tests == int(flagged.sum()) * n_spills
    assert k1b.pairs > k1.pairs

    k2 = rl.k2_work(tcfg, zp5, packed_t, packed_T, rows, sp_tcx, sp_tcy)
    assert k2.tests >= k2.pairs >= k2.forced > 0
    # Each live window query against the live slots of its own 3x3 tiles
    # (in the world) and the live spills; each own row against the live
    # slots of its 3x3 block and the live spills.
    b, tx, ty = tcfg.bucket, tcfg.tx, tcfg.ty
    slot_live = (packed_t[:, tzb.ROW_ID] >= 0).numpy()
    occ = np.pad(slot_live.reshape(tx, ty, b).sum(-1), 1)
    near = sum(occ[1 + dx:1 + dx + tx, 1 + dy:1 + dy + ty]
               for dx in (-1, 0, 1) for dy in (-1, 0, 1)).reshape(-1)
    live_sp = (rows[:, tzb.ROW_ID] >= 0).numpy()
    q_slots = tspill.window_query_slots(tcfg, sp_tcx, sp_tcy)[live_sp]
    q_slots = q_slots.numpy()
    assert q_slots.shape[0] == n_spills
    q_live = slot_live[q_slots]
    assert k2.tests == int((q_live * (near[q_slots // b] + n_spills)).sum()
                           + (q_live.sum(1) + n_spills).sum())
    # K2's bytes: each slot of the tiles the window queries' own 3x3
    # tiles cover once (8 candidate features of a live slot, the id of an
    # empty one; 11 query features of a live window query, the rec of an
    # empty one); the spill rows by need; out's rows; each written vel
    # row once.
    tcx, tcy = sp_tcx.numpy()[live_sp], sp_tcy.numpy()[live_sp]
    cover = set()
    for cx0, cy0 in zip(np.clip(tcx - 1, 0, tx - 3) - 1,
                        np.clip(tcy - 1, 0, ty - 3) - 1):
        for cx in range(max(cx0, 0), min(cx0 + 5, tx)):
            for cy in range(max(cy0, 0), min(cy0 + 5, ty)):
                cover.update(range((cx * ty + cy) * b, (cx * ty + cy + 1) * b))
    cover = np.array(sorted(cover))
    q_uniq = np.unique(q_slots)
    assert np.isin(q_uniq, cover).all() and cover.size < 25 * b * n_spills
    aff = tspill.affected(tcfg, packed_t, rows, sp_tcx, sp_tcy)
    q_all = tspill.window_query_slots(tcfg, sp_tcx, sp_tcy)
    written = np.unique(packed_t[q_all, tzb.ROW_ID][aff].numpy()).size
    assert written > 0
    s = rows.shape[0]
    vel = torch.zeros((pos.shape[0], 2), dtype=torch.float64)
    want = (4 * (5 + 2 * s)
            + 4 * (13 * n_spills + (s - n_spills)
                   + 8 * slot_live[cover].sum() + (~slot_live[cover]).sum()
                   + 11 * slot_live[q_uniq].sum()
                   + 2 * (~slot_live[q_uniq]).sum()
                   + 2 * (q_slots.size + n_spills))
            + 2 * 8 * (written + n_spills))
    assert rl.k2_bytes(tcfg, zp5, packed_t, rows, sp_tcx, sp_tcy,
                       vel) == want


# ---------------------------------------------------------------------------
# K1/K1b launch geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", [16, 32, 64])
def test_k1_geometry_fits_the_h100(bucket):
    """At the 1M bench world with a 128-lane spill plane.  A bucket of 64
    is not a BucketConfig the JAX package accepts ((sub_tiles + 2) *
    bucket must be 128), so it is given as plain geometry: the kernel
    itself takes any bucket."""
    cfg = types.SimpleNamespace(tx=239, ty=240, bucket=bucket)
    for n_sp in (0, 128):
        g = tzb.k1_geometry(cfg, n_sp=n_sp)
        assert g.smem_bytes <= tzb.SMEM_LIMIT == 232_448
        assert g.smem_bytes % 16 == 0
        assert g.threads % 32 == 0 and 32 <= g.threads <= tzb.K1_MAX_THREADS
        assert g.threads * 2 >= g.tiles * bucket     # half the block's slots
        assert g.blocks == 239 * -(-240 // g.tiles)
        staged = 4 * 8 * (3 * (g.tiles + 2) * bucket + n_sp)
        lists = 2 * tzb.K1_LIST_CAP * g.threads
        assert staged + lists < g.smem_bytes < staged + lists + 2048 + (
            2 * g.tiles * bucket)


def test_k1_geometry_at_the_bench_config():
    g = tzb.k1_geometry(scenes.bench_bucket_config(1_000_000))
    assert (g.tiles, g.threads, g.blocks) == (15, 256, 239 * 16)
    # Three blocks (and the 1 KB each reserves) fit one SM's 228 KB.
    assert 3 * (g.smem_bytes + 1024) <= 233_472
    g1b = tzb.k1_geometry(scenes.bench_bucket_config(1_000_000), n_sp=128)
    assert 3 * (g1b.smem_bytes + 1024) <= 233_472


def test_k1_geometry_raises_when_a_block_cannot_fit():
    cfg = types.SimpleNamespace(tx=239, ty=240, bucket=64)
    with pytest.raises(ValueError, match="exceed 232448"):
        tzb.k1_geometry(cfg, tiles_per_block=32, n_sp=128)
    with pytest.raises(ValueError, match="exceed 232448"):
        tzb.k1_geometry(types.SimpleNamespace(tx=239, ty=240, bucket=32),
                        n_sp=8192)


def test_k1_stage_bytes_at_the_1m_bench_config():
    """Each cut of K1 (the stage probe) at 1,000,000 live slots of
    1,835,520: floor the rec rows in and the output out (4 floats a
    slot), queries each slot's id too (5); from stage on an empty slot
    moves 5 floats and a live one its 8 candidate features and output
    (10), the mask 4 query features more (14), the TTC 6 (16) and zp5;
    full is K1's 100,710,420."""
    cfg = scenes.bench_bucket_config(1_000_000)
    want = {"floor": 4 * 4 * cfg.slots, "queries": 4 * 5 * cfg.slots,
            "stage": 4 * (835_520 * 5 + 1_000_000 * 10),
            "mask": 4 * (835_520 * 5 + 1_000_000 * 14),
            "ttc": 4 * (5 + 835_520 * 5 + 1_000_000 * 16),
            "full": 100_710_420}
    got = {s: rl.k1_stage_bytes(cfg, 1_000_000, s) for s in want}
    assert got == want
    assert got["floor"] == 29_368_320 and got["ttc"] == 80_710_420
    assert list(got.values()) == sorted(got.values())


def test_k1_stage_ops_follow_the_passes():
    cfg = tzb.BucketConfig.create(24.0, 24.0, (0.0, 0.0), 3.0, bucket=16,
                                  strip_tiles=6, sub_tiles=6)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = (
        torch.as_tensor(x) for x in random_scene(3, 96, 24.0, 3.0))
    packed_t, packed_T, _, _, _ = tzb.bucketize(
        cfg, pos, vel, pref_c, self_pref, prio, eye, rec, alive)
    zp5 = tzb.zparams5(torch_params())
    work = rl.k1_work(cfg, zp5, packed_t, packed_T)
    assert work.tests > work.pairs > work.forced > 0
    for stage in ("floor", "queries", "stage"):
        assert rl.k1_stage_ops(work, stage, True) == 0
    assert rl.k1_stage_ops(work, "mask", True) == 11 * work.tests
    assert rl.k1_stage_ops(work, "ttc", False) == (11 * work.tests
                                                   + 37 * work.pairs)
    for int_prio in (True, False):
        assert rl.k1_stage_ops(work, "full", int_prio) == work.ops(int_prio)
    assert (rl.k1_stage_bytes(cfg, int(alive.sum()), "full")
            == rl.k1_bytes(cfg, int(alive.sum())))


def test_mma_bound_at_the_probe_shapes():
    """2 m k n operations a product at the type's dense peak; the 4,000
    products outweigh the bytes of x, w and the two [m, n] outputs."""
    b = rl.mma_bound(64, 128, 128, "bf16", 4000)
    assert b.ops == 2 * 64 * 128 * 128 * 4000 == 8_388_608_000
    assert b.bytes == 4 * (64 * 128 + 128 * 128 + 2 * 64 * 128)
    assert b.bound_by == "operations"
    assert b.ms == pytest.approx(8_388_608_000 / 989e12 * 1e3)
    one_hot = {d: rl.mma_bound(8, 384, 128, d, 4000).ms / 4000
               for d in ("bf16", "s8", "tf32", "f32")}
    assert one_hot["s8"] == pytest.approx(786_432 / 1979e12 * 1e3)
    assert one_hot["s8"] < one_hot["bf16"] < one_hot["tf32"] < one_hot["f32"]


@pytest.mark.parametrize("dtype", ["bf16", "s8", "tf32", "f32"])
@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (8, 384, 128)])
def test_mma_chain_bound_latency_and_rate(m, k, n, dtype):
    """A link of 20 ns binds the chain by latency (4,000 links: 0.08 ms)
    wherever it exceeds the type's rate bound a product, which is every
    tensor-core type and the one-hot f32 (11.7 ns); the prefix f32 (31.3
    ns a product at 67 TFLOP/s) stays bound by operations.  A link of 0
    leaves the rate bound as it was."""
    rate = rl.mma_bound(m, k, n, dtype, 4000)
    b = rl.mma_chain_bound(m, k, n, dtype, 4000, 20.0)
    assert (b.bytes, b.ops, b.ops_per_s) == (rate.bytes, rate.ops,
                                             rate.ops_per_s)
    assert b.latency_ms == pytest.approx(4000 * 20e-6)
    if rate.ms < b.latency_ms:
        assert b.bound_by == "latency" and b.ms == b.latency_ms
    else:
        assert (m, k, dtype) == (64, 128, "f32")
        assert b.bound_by == "operations" and b.ms == rate.ms
    zero = rl.mma_chain_bound(m, k, n, dtype, 4000, 0.0)
    assert zero.bound_by == "operations" and zero.ms == rate.ms


def test_bound_without_latency_is_unchanged():
    """``latency_ms`` defaults to 0: bytes and operations decide as they
    did, ties to bytes."""
    for args in [(1_000_000,), (1_000_000, 10**9), (670, 10**7)]:
        b = rl.Bound(*args)
        assert b.latency_ms == 0.0
        assert b.ms == max(b.bytes_ms, b.ops_ms)
        assert b.bound_by == ("bytes" if b.bytes_ms >= b.ops_ms
                              else "operations")
    assert rl.Bound(3350, latency_ms=1e-3).bound_by == "latency"
    assert rl.Bound(3350, latency_ms=1e-6).bound_by == "bytes"


def test_mma_link_bound():
    """One smallest product a link (2 * 16 * 8 * K operations) at the
    type's rate; f32 one fma a lane of a warp."""
    b = rl.mma_link_bound("bf16", 200_000)
    assert b.ops == 2 * 16 * 8 * 16 * 200_000 and b.bytes == 512
    assert b.bound_by == "operations"
    assert rl.mma_link_bound("f32", 10).ops == 640


def test_plane_bytes_at_the_probe_sizes():
    """Each writer reads its vectors and writes its floats once: at the
    1M bucketed plane's 1,835,520 slots and the dense path's 2,019,072
    rows."""
    assert rl.plane_bytes("columns", 1_835_520, 8) == 117_473_280
    assert rl.plane_bytes("columns", 1_835_520, 4) == 58_736_640
    assert rl.plane_bytes("rows", 2_019_072, 4) == 64_610_304
    assert rl.plane_bytes("rebuild", 2_019_072) == 193_830_912
    assert rl.transpose_bytes(8, 128) == 8192
    assert rl.Bound(rl.plane_bytes("rebuild", 2_019_072)).bound_by == "bytes"


@pytest.mark.parametrize("slots", [1_835_520, 2_019_072])
def test_plane_sector_bytes(slots):
    """The columns writer's 32-byte sectors: one a slot, written whole, so
    k = 4 moves 48 B a slot against its 32 counted and k = 8 its 64."""
    assert rl.plane_sector_bytes(slots, 4) == 48 * slots
    assert rl.plane_sector_bytes(slots, 4) == (
        rl.plane_bytes("columns", slots, 4) * 3 // 2)
    assert rl.plane_sector_bytes(slots, 8) == rl.plane_bytes("columns",
                                                            slots, 8)
