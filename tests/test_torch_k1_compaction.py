"""The premise of K1's compacted staging, on the CPU.

K1 stages each tile's candidate rows with the empty slots (id < 0)
removed and the order kept.  A carried binning packs agents that died
since the sort inert *inside* their bucket (sentinel position, id -1), so
a bucket's live slots need not form a prefix: the kernel may not assume
one.  Dropping such a row changes nothing, because the mask rejects it:
every query keeps the same sequence of masked-in candidates, and K1's
plain version gives the same velocities.
"""

import pytest
import torch

from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb

from test_torch_zanlungo import random_scene, torch_params


def _compacted(cfg, packed_T):
    """``packed_T`` with each tile's live candidate columns moved to the
    front of its bucket, in order, and sentinel columns behind them."""
    b = cfg.bucket
    tiles = packed_T.reshape(tzb.NUM_CAND, cfg.n_tiles, b)
    live = tiles[tzb.ROW_ID] >= 0                            # [tiles, b]
    # Stable: live slots first, each group in slot order.
    order = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
    out = torch.gather(tiles, 2, order[None].expand(tzb.NUM_CAND, -1, -1))
    n_live = live.sum(1, keepdim=True)
    dead = torch.arange(b)[None, :] >= n_live
    sent = tzb.sentinel_rows(1, "cpu")[0, :tzb.NUM_CAND]
    out = torch.where(dead[None], sent[:, None, None], out)
    return out.reshape(tzb.NUM_CAND, cfg.slots)


def _masked_sequences(cfg, packed_t, packed_T):
    """Per slot, the ids of the candidates its mask takes, in K1's walk
    order (3x3 window, column by column, tiles bottom to top)."""
    b = cfg.bucket
    cf = tzb._window_candidates(cfg, packed_T, torch.arange(cfg.n_tiles))
    c = tzb.candidate_features(cf)
    q = tzb.query_features(packed_t.reshape(cfg.n_tiles, b, tzb.NUM_F))
    mask = tzb.pair_mask(q, c).reshape(cfg.slots, 9 * b)
    ids = c["id"].expand(-1, b, -1).reshape(cfg.slots, 9 * b)
    return [ids[s][mask[s]].tolist() for s in range(cfg.slots)]


@pytest.mark.parametrize("int_prio", [True, False])
def test_fresh_dead_slot_inside_a_bucket_drops_out(int_prio):
    cfg = tzb.BucketConfig.create(24.0, 24.0, (0.0, 0.0), 3.0, bucket=16,
                                  strip_tiles=6, sub_tiles=6)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = (
        torch.as_tensor(x) for x in random_scene(5, 240, 24.0, 3.0))
    alive = torch.ones_like(alive)
    # Sort by tile and bin, as the skin-deferred presort does.
    key = tzb.tile_key(cfg, pos, alive)
    order = torch.sort(key, stable=True).indices
    pos, vel, self_pref, pref_c, prio, eye, rec = (
        x[order] for x in (pos, vel, self_pref, pref_c, prio, eye, rec))
    binning = tzb.rank_from_sorted_key(cfg, key[order])
    bpos = binning[0]
    # Agents that die after the sort, each with a live agent behind it in
    # its bucket: the first of every tile that holds three or more.
    tile = bpos // cfg.bucket
    first = torch.ones_like(tile, dtype=torch.bool)
    first[1:] = tile[1:] != tile[:-1]
    count = torch.bincount(tile, minlength=cfg.n_tiles + 1)
    dies = first & (count[tile] >= 3) & (bpos < cfg.slots)
    assert int(dies.sum()) >= 2
    alive = alive & ~dies

    packed_t, packed_T, _, _, dropped = tzb.bucketize(
        cfg, pos, vel, pref_c, self_pref, prio, eye, rec, alive,
        presorted=True, binning=binning)
    assert int(dropped) == 0
    ids = packed_T[tzb.ROW_ID]
    for s in bpos[dies].tolist():
        assert ids[s] == -1 and ids[s + 1] >= 0     # not a live prefix
        assert packed_T[tzb.ROW_PX, s] == tzb.POS_SENTINEL

    squeezed = _compacted(cfg, packed_T)
    assert not torch.equal(squeezed, packed_T)
    assert _masked_sequences(cfg, packed_t, squeezed) == _masked_sequences(
        cfg, packed_t, packed_T)

    # In float64, with the bench scene's force cap (20): the time to
    # collision cancels in bh^2 - a c, and PyTorch's CPU kernels do not
    # round it alike in every process (~1e-4 relative in f32), while
    # overlapping pairs reach a cap of 1e15 whose terms cancel.
    zp5 = torch.tensor([1.3, 4.0, 2.0, 0.4, 20.0], dtype=torch.float64)
    pt64 = packed_t.double()
    want = tzb.forces_bucketed_plain(cfg, zp5, pt64, packed_T.double(),
                                     int_prio)
    got = tzb.forces_bucketed_plain(cfg, zp5, pt64, squeezed.double(),
                                    int_prio)
    live = ids >= 0
    forced = (want[live] - packed_t[live, 8:10]).abs().sum(1) > 0
    assert int(forced.sum()) > 10
    # The plain version sums a [Q, 9b] row: dropping the rejected rows
    # moves the nonzero terms within it, so the float64 sum is reordered
    # (~1e-15 relative) before the f32 output rounds it.  K1 itself walks
    # the same sequence and is bitwise unchanged.
    torch.testing.assert_close(got[live], want[live], rtol=1e-6, atol=1e-6)


def test_overflow_counter_is_ignored_by_the_plain_version():
    """CPU tensors take the plain version; the overflow counter belongs to
    the kernel and is left as it was."""
    cfg = tzb.BucketConfig.create(24.0, 24.0, (0.0, 0.0), 3.0, bucket=16,
                                  strip_tiles=6, sub_tiles=6)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = (
        torch.as_tensor(x) for x in random_scene(0, 96, 24.0, 3.0))
    packed_t, packed_T, _, _, _ = tzb.bucketize(
        cfg, pos, vel, pref_c, self_pref, prio, eye, rec, alive)
    zp5 = tzb.zparams5(torch_params())
    over = torch.zeros((1,), dtype=torch.int32)
    got = tzb.zanlungo_forces_bucketed(cfg, zp5, packed_t, packed_T,
                                       int_prio=True, overflow=over)
    want = tzb.forces_bucketed_plain(cfg, zp5, packed_t, packed_T, True)
    assert torch.equal(got, want) and int(over) == 0
