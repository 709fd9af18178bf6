"""The port's spill repair and spill-window kernel against the JAX package.

K2's plain version (the path CPU tensors take through ``spill_window``):
its window rows against ``_spill_groups_window_pallas`` in interpret mode
on rows with a live query, and the whole fused pass with the spill patch
against the JAX ``zanlungo_fused`` on the overflowing scene of
``test_spill_patch_int_prio_matches_oracle``; both to 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu_torch.models import local as tlocal
from rmf_crowdsim_tpu_torch.ops import neighbors as tnbr
from rmf_crowdsim_tpu_torch.ops import spill as tspill
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb

from test_torch_zanlungo import jax_params, torch_params

CFG_ARGS = dict(width=24.0, height=24.0, offset=(0.0, 0.0), max_eyesight=3.0,
                bucket=16, strip_tiles=6, sub_tiles=6)


def overflow_scene(seed=11, n=96, world=24.0, lo=9.0, hi=11.5):
    """30 agents crammed into one tile, the rest spread out
    (tests/test_zanlungo_pallas.py:415)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    pos = rng.uniform(0.0, world, (n, 2))
    pos[:30] = rng.uniform(lo, hi, (30, 2))
    return (pos.astype(f),
            rng.uniform(-2, 2, (n, 2)).astype(f),       # vel
            rng.uniform(-2, 2, (n, 2)).astype(f),       # pref (committed)
            rng.uniform(-2, 2, (n, 2)).astype(f),       # self_pref
            rng.permutation(n).astype(f),               # prio
            rng.uniform(0.5, 3.0, (n,)).astype(f),      # eye
            rng.random(n) > 0.1,                        # alive
            rng.uniform(-2, 2, (n, 2)).astype(f))       # rec


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("int_prio", [True, False])
def test_spill_window_plain_matches_jax_kernel(int_prio):
    jcfg = jzp.BucketConfig.create(**CFG_ARGS)
    tcfg = tzb.BucketConfig.create(**CFG_ARGS)
    pos, vel, pref, spref, prio, eye, alive, rec = overflow_scene()
    packed_t, packed_T, bucket_pos, occ, _ = jzp.bucketize(
        jcfg, *(jnp.asarray(x) for x in
                (pos, vel, pref, spref, prio, eye, rec, alive)))
    assert int(occ) > jcfg.bucket
    s_cap = 64
    c_sp, rows, sp_tcx, sp_tcy = tspill.spill_rows(
        tcfg, *(_t(x) for x in (pos, vel, spref, pref, prio, eye, alive,
                                rec)),
        _t(bucket_pos), s_cap)
    n_spill = int(c_sp.count)
    assert n_spill > 0
    sp_T = tspill.spill_candidates(rows)
    # The JAX kernel reads its spill list lane-padded to 128 (id -1).
    sp_pad = np.zeros((8, 128), np.float32)
    sp_pad[tzb.ROW_ID] = -1.0
    sp_pad[:, :s_cap] = sp_T.numpy()
    want = np.asarray(jzp._spill_groups_window_pallas(
        jcfg, jzp.zparams5(jax_params()), packed_t, jnp.asarray(sp_pad),
        jnp.asarray(sp_tcx.numpy()), jnp.asarray(sp_tcy.numpy()),
        interpret=True, int_prio=int_prio, packed_T=packed_T))
    got = tspill.spill_window(
        tcfg, tzb.zparams5(torch_params()), _t(packed_t), _t(packed_T),
        rows, sp_tcx, sp_tcy, torch.zeros((pos.shape[0], 2)),
        int_prio=int_prio).numpy()[:, :9 * tcfg.bucket]
    q_slots = tspill.window_query_slots(tcfg, sp_tcx, sp_tcy).numpy()
    q_live = (c_sp.valid.numpy()[:, None]
              & (np.asarray(packed_t)[q_slots, tzb.ROW_ID] >= 0))
    assert q_live.sum() > 100
    np.testing.assert_allclose(got[q_live], want[q_live], rtol=2e-4,
                               atol=2e-4)


def test_zanlungo_fused_spill_patch_matches_jax():
    """The port's fused pass with the spill patch against the JAX
    ``zanlungo_fused(spill_capacity=64, int_prio=True)``."""
    jcfg = jzp.BucketConfig.create(**CFG_ARGS)
    tcfg = tzb.BucketConfig.create(**CFG_ARGS)
    scene = overflow_scene()
    want, jocc, jdrop = jzp.zanlungo_fused(
        jcfg, jax_params(), *(jnp.asarray(x) for x in scene),
        interpret=True, spill_capacity=64, int_prio=True)
    got, tocc, tdrop = tzb.zanlungo_fused(
        tcfg, torch_params(), *(_t(x) for x in scene),
        spill_capacity=64, int_prio=True)
    assert int(tocc) == int(jocc) > tcfg.bucket
    assert int(tdrop) == int(jdrop) == 0
    a = scene[6]
    np.testing.assert_allclose(got.numpy()[a], np.asarray(want)[a],
                               rtol=2e-4, atol=2e-4)


def _fused_vs_oracle(scene, spill_capacity, **kw):
    cfg = tzb.BucketConfig.create(**CFG_ARGS)
    pos, vel, pref, spref, prio, eye, alive, rec = (_t(x) for x in scene)
    zp = torch_params()
    got, occ, dropped = tzb.zanlungo_fused(
        cfg, zp, pos, vel, spref, pref, prio, eye, alive, rec,
        spill_capacity=spill_capacity, **kw)
    nb = tnbr.brute_neighbors(pos, eye, alive)
    want = tlocal.zanlungo_velocity(zp, pos, vel, spref, pref, prio,
                                    nb.idx, nb.valid, rec)
    return got, want, int(occ), int(dropped), alive.numpy()


@pytest.mark.parametrize("int_prio", [True, False])
@pytest.mark.parametrize("corner", [False, True])
def test_spill_patch_repairs_overflow_exactly(corner, int_prio):
    """Every agent — spills and their neighbors included — equals the
    brute oracle, also with the hotspot in the world's corner tile, where
    the 5x5 window and the 3x3 query block are clamped (the port of
    test_spill_patch_repairs_overflow_exactly and _at_world_edge)."""
    lo, hi = (0.1, 2.4) if corner else (9.0, 11.5)
    scene = overflow_scene(seed=3 if corner else 11, lo=lo, hi=hi)
    got, want, occ, dropped, a = _fused_vs_oracle(
        scene, 64, use_pack_kernel=True, int_prio=int_prio)
    assert occ > 16 and dropped == 0
    np.testing.assert_allclose(got.numpy()[a], want.numpy()[a], rtol=2e-4,
                               atol=2e-4)


def test_spill_cap_overrun_is_counted():
    """Spills beyond ``spill_capacity`` surface in ``dropped``."""
    rng = np.random.default_rng(5)
    n = 64
    f = np.float32
    pos = rng.uniform(10.0, 11.0, (n, 2)).astype(f)
    zero = np.zeros((n, 2), f)
    scene = (pos, zero, zero, zero, np.arange(n, dtype=f),
             np.full((n,), 2.0, f), np.ones((n,), bool), zero)
    _, _, occ, dropped, _ = _fused_vs_oracle(scene, 4)
    assert occ > 16
    assert dropped == n - 16 - 4
