"""K4's launch geometry and block plan, on the CPU.

``k4_geometry`` mirrors the shared-memory layout that
``csrc/zanlungo_dense.cu`` documents, and refuses a block that the H100
cannot hold.  A pure-Python model of the kernel's block plan (one block
per tile column and run of ``tiles`` tile rows; its queries the rows of
those tiles below ``col_cap``; its stage the rows of tiles t0-1 ..
t0+tiles of columns c-1 .. c+1, three contiguous ranges) covers every
query row exactly once, writes each to its padded output row, and puts
each query's window (tile rows tcy-1 .. tcy+1 of the three columns, as
``_query_windows`` names it for the plain version) inside its block's
stage as three contiguous runs.  Scenes: an empty column, a column past
``col_cap``, a crowd whose blocks exceed their stage, and a uniform one.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as tzd

CU = (Path(tzd.__file__).resolve().parent.parent / "csrc"
      / "zanlungo_dense.cu").read_text()


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def _align16(x):
    return (x + 15) // 16 * 16


def test_k4_geometry_at_the_1m_bench():
    cfg = scenes.bench_dense_config(1_000_000)
    geo = tzd.k4_geometry(cfg, 1_000_000)
    assert (geo.tiles, geo.threads, geo.stage_rows, geo.blocks,
            geo.smem_bytes) == (15, 320, 1120, 239 * 16, 56_320)


def test_k4_smem_bytes_mirror_the_kernel_layout():
    """The .cu's constants and layout: the stage as two float4 arrays
    [stage_rows], then the lists [LIST_CAP][threads] uint16, each part
    16-byte aligned."""
    assert _cu_constant("LIST_CAP") == tzd.K4_LIST_CAP
    assert _cu_constant("MAX_THREADS") == tzd.K4_MAX_THREADS
    assert _cu_constant("MAX_STAGE") == 65536
    assert "2 * sizeof(float4) * (size_t)stage_rows" in CU
    assert "sizeof(unsigned short) * LIST_CAP * (size_t)threads" in CU
    for stage_rows in (1, 256, 1120, 4095, 65536):
        for threads in (32, 64, 320, 512):
            want = _align16(_align16(2 * 16 * stage_rows)
                            + 2 * tzd.K4_LIST_CAP * threads)
            assert tzd.k4_smem_bytes(stage_rows, threads) == want


@pytest.mark.parametrize("stage_rows,match", [(7000, "exceed"),
                                              (70_000, "uint16"),
                                              (0, "uint16")])
def test_k4_geometry_refuses_a_block_the_card_cannot_run(stage_rows, match):
    cfg = scenes.bench_dense_config(1_000_000)
    with pytest.raises(ValueError, match=match):
        tzd.k4_geometry(cfg, 1_000_000, stage_rows=stage_rows)


def test_k4_default_geometry_fits_any_density():
    """Without an explicit stage the block always fits: a crowd denser
    than the stage takes the in-place walk instead."""
    cfg = tzd.DenseConfig(tile_size=4.0, offset=(0.0, 0.0), tx=3, ty=2,
                          col_cap=256)
    for n in (0, 1, 1000, 10 ** 7):
        geo = tzd.k4_geometry(cfg, n)
        assert 64 <= geo.threads <= tzd.K4_MAX_THREADS
        assert 256 <= geo.stage_rows <= tzd.K4_MAX_STAGE
        assert geo.smem_bytes <= tzb.SMEM_LIMIT
        assert geo.blocks == cfg.tx * -(-cfg.ty // geo.tiles)


# ---------------------------------------------------------------------------
# The block plan
# ---------------------------------------------------------------------------


def block_plan(cfg, ts, geo):
    """The kernel's blocks that hold a query, as its code computes them:
    (c, t0, t1, cs, qa, qb, shift[3], off[4], staged)."""
    T, ty = geo.tiles, cfg.ty
    runs = -(-ty // T)
    for b in range(cfg.tx * runs):
        c, r = divmod(b, runs)
        t0 = r * T
        t1 = min(t0 + T, ty)
        cs = ts[c * ty]
        qa = ts[c * ty + t0]
        qb = min(ts[c * ty + t1], cs + cfg.col_cap)
        if qa >= qb:
            continue
        sa, sb = max(t0 - 1, 0), min(t1 + 1, ty)
        shift, off = [], [0]
        for k in range(3):
            ck = c + k - 1
            glo = length = 0
            if 0 <= ck < cfg.tx:
                glo = ts[ck * ty + sa]
                length = ts[ck * ty + sb] - glo
            shift.append(glo - off[k])
            off.append(off[k] + length)
        yield c, t0, t1, cs, qa, qb, shift, off, off[3] <= geo.stage_rows


def _scene(name):
    """(cfg, positions [N, 2] f32, alive [N]) of one test scene."""
    rng = np.random.default_rng({"empty_column": 1, "column_past_cap": 2,
                                 "over_stage": 3, "uniform": 4}[name])
    cfg = tzd.DenseConfig(tile_size=4.0, offset=(0.0, 0.0), tx=10, ty=12,
                          col_cap=256)
    n = 1200
    pos = rng.uniform(0.0, 40.0, (n, 2)) * [1.0, 1.2]
    if name == "empty_column":
        pos[:, 0] = np.where((pos[:, 0] >= 20.0) & (pos[:, 0] < 24.0),
                             pos[:, 0] - 8.0, pos[:, 0])
    elif name == "column_past_cap":
        pos[:400, 0] = rng.uniform(4.0, 8.0, 400)
    elif name == "over_stage":
        pos[:500] = rng.uniform(0.0, 2.0, (500, 2)) + [21.0, 21.0]
        cfg = tzd.DenseConfig(tile_size=4.0, offset=(0.0, 0.0), tx=10,
                              ty=12, col_cap=1024)
    alive = rng.random(n) > 0.1
    return cfg, pos.astype(np.float32), alive


@pytest.mark.parametrize("tiles", [3, 15])
@pytest.mark.parametrize("name", ["empty_column", "column_past_cap",
                                  "over_stage", "uniform"])
def test_block_plan_covers_each_query_once_with_its_window(name, tiles):
    cfg, pos, alive = _scene(name)
    pos, alive = torch.as_tensor(pos), torch.as_tensor(alive)
    key = tzb.tile_key(cfg, pos, alive)
    order = torch.sort(key, stable=True).indices
    pos, alive, key = pos[order], alive[order], key[order]
    n = pos.shape[0]
    z2 = torch.zeros((n, 2))
    feat, tile_start, _, n_over, _ = tzd.dense_prep(
        cfg, key, pos, z2, z2, z2, torch.zeros(n), torch.full((n,), 2.0),
        z2, alive)
    geo = tzd.k4_geometry(cfg, n, tiles_per_block=tiles)
    ts = tile_start.tolist()
    col_len = np.diff(ts[::cfg.ty])
    if name == "empty_column":
        assert (col_len == 0).any()
    if name == "column_past_cap":
        assert int(n_over) > 0 and col_len.max() > cfg.col_cap

    rows, out_row, lo, hi = tzd._query_windows(cfg, feat, tile_start)
    want = {r: (o, l, h) for r, o, l, h in zip(
        rows.tolist(), out_row.tolist(), lo.tolist(), hi.tolist())}
    covered = []
    n_staged = n_in_place = 0
    for c, t0, t1, cs, qa, qb, shift, off, staged in block_plan(cfg, ts,
                                                                geo):
        n_staged += staged
        n_in_place += not staged
        for row in range(qa, qb):
            covered.append(row)
            o, l, h = want[row]
            assert c * cfg.col_cap + row - cs == o
            # The kernel's window from the row's tile row (feature 13).
            tcy = min(max(int(feat[row, tzd.ROW_TCY]), t0), t1 - 1)
            assert tcy == int(feat[row, tzd.ROW_TCY])
            w0, w1 = max(tcy - 1, 0), min(tcy + 1, cfg.ty - 1) + 1
            for k in range(3):
                ck = c + k - 1
                if not 0 <= ck < cfg.tx:
                    assert l[k] == h[k] == 0
                    continue
                a, b = ts[ck * cfg.ty + w0], ts[ck * cfg.ty + w1]
                assert (a, b) == (l[k], h[k])
                # Three contiguous runs of the stage, in walk order.
                assert off[k] <= a - shift[k] <= b - shift[k] <= off[k + 1]
    assert sorted(covered) == sorted(want) and len(covered) == len(want)
    assert n_staged > 0
    if name == "over_stage":
        assert n_in_place > 0
