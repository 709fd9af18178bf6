"""K2, the spill repair, against the JAX package on numpy-seeded scenes.

K2's plain version (the path CPU tensors take through ``spill_window``):
its window rows against ``_spill_groups_window_pallas`` in interpret
mode, its own rows against ``_spill_own_rows``, and its write into the
velocities; the port's ``zanlungo_fused`` against the JAX one with the
spill patch and with ``fused_spills`` (spills that fit K1b's segment, and
a storm), with the spills in mid-world and in the world's corner tile,
on fresh and on carried tiles (``binning``); all to 2e-4.  Then the
premise of the kernel's walk: every window candidate that a live query's
mask takes lies in that query's own 3x3 tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu_torch.ops import spill as tspill
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb

from test_torch_fused_spills import overflow_scene
from test_torch_zanlungo import jax_params, torch_params

TOL = 2e-4
CFG_ARGS = dict(width=24.0, height=24.0, offset=(0.0, 0.0), max_eyesight=3.0,
                bucket=16, strip_tiles=6, sub_tiles=6)
# Tiles of 4 m for eyesight up to 3 m: a skin margin of 0.5 m, within
# which agents may move from their carried tiles.
CARRIED_ARGS = dict(CFG_ARGS, tile_size=4.0)
SCENES = {
    "mid": dict(seed=11),
    "corner": dict(seed=13, n_cram=28, cram_lo=0.2, cram_hi=2.2),
    "carried": dict(seed=17, n_cram=30, cram_lo=5.0, cram_hi=7.5),
}
SPILL_CAP = 64
STORM_CAP = 8           # fewer than the scenes' spills: a storm
FUSED_SPILLS = {"patch": (False, SPILL_CAP), "fits": (True, SPILL_CAP),
                "storm": (True, STORM_CAP)}


def _t(x):
    return torch.tensor(np.asarray(x))


def scene_inputs(name):
    """(cfg args, the scene as numpy in ``zanlungo_fused``'s argument
    order, carried binning as numpy (key, bpos, max_occ, n_over) or
    None).  The carried scene is tile-sorted and binned, then every agent
    moves less than the skin margin and a few die."""
    scene = list(overflow_scene(**SCENES[name]))
    if name != "carried":
        return CFG_ARGS, scene, None
    cfg = tzb.BucketConfig.create(**CARRIED_ARGS)
    pos = _t(scene[0])
    alive = np.ones(pos.shape[0], bool)
    key = tzb.tile_key(cfg, pos, _t(alive))
    order = np.argsort(key.numpy(), kind="stable")
    scene = [x[order] for x in scene]
    key = key[order]
    bpos, occ, n_over = tzb.rank_from_sorted_key(cfg, key)
    rng = np.random.default_rng(5)
    scene[0] = (scene[0] + rng.uniform(-0.45, 0.45, scene[0].shape)
                ).astype(np.float32)
    scene[6] = rng.random(pos.shape[0]) > 0.05
    binning = tuple(x.numpy() for x in (key, bpos, occ, n_over))
    return CARRIED_ARGS, scene, binning


def spill_inputs(name):
    """The JAX bucketize of the scene and the port's spill list on it."""
    cfg_args, scene, binning = scene_inputs(name)
    jcfg = jzp.BucketConfig.create(**cfg_args)
    tcfg = tzb.BucketConfig.create(**cfg_args)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = scene
    kw = {}
    tile_xy = None
    if binning is not None:
        kw = dict(presorted=True, binning=tuple(jnp.asarray(x)
                                                for x in binning[1:]))
        key = _t(binning[0])
        tile_xy = (key // tcfg.ty, key % tcfg.ty)
    packed_t, packed_T, bucket_pos, occ, _ = jzp.bucketize(
        jcfg, *(jnp.asarray(x) for x in
                (pos, vel, pref_c, self_pref, prio, eye, rec, alive)), **kw)
    assert int(occ) > jcfg.bucket
    c_sp, rows, sp_tcx, sp_tcy = tspill.spill_rows(
        tcfg, *(_t(x) for x in scene), _t(bucket_pos), SPILL_CAP,
        tile_xy=tile_xy)
    assert 0 < int(c_sp.count) <= SPILL_CAP
    return (jcfg, tcfg, scene, c_sp, rows, sp_tcx, sp_tcy,
            _t(packed_t), _t(packed_T))


@pytest.mark.parametrize("name", ["corner", "carried"])
@pytest.mark.parametrize("int_prio", [True, False])
def test_window_rows_match_jax_kernel(name, int_prio):
    """The mid-world scene is test_torch_spill's
    ``test_spill_window_plain_matches_jax_kernel``."""
    jcfg, tcfg, scene, c_sp, rows, sp_tcx, sp_tcy, pt, pT = spill_inputs(name)
    sp_pad = np.zeros((tzb.NUM_CAND, 128), np.float32)
    sp_pad[tzb.ROW_ID] = -1.0
    sp_pad[:, :SPILL_CAP] = tspill.spill_candidates(rows).numpy()
    want = np.asarray(jzp._spill_groups_window_pallas(
        jcfg, jzp.zparams5(jax_params()), jnp.asarray(pt.numpy()),
        jnp.asarray(sp_pad), jnp.asarray(sp_tcx.numpy()),
        jnp.asarray(sp_tcy.numpy()), interpret=True, int_prio=int_prio,
        packed_T=jnp.asarray(pT.numpy())))
    vel = torch.zeros((pt.shape[0], 2))
    got = tspill.spill_window(tcfg, tzb.zparams5(torch_params()), pt, pT,
                              rows, sp_tcx, sp_tcy, vel, int_prio=int_prio)
    q_slots = tspill.window_query_slots(tcfg, sp_tcx, sp_tcy)
    q_live = (c_sp.valid[:, None] & (pt[q_slots, tzb.ROW_ID] >= 0)).numpy()
    assert q_live.sum() > 50
    np.testing.assert_allclose(got[:, :9 * tcfg.bucket].numpy()[q_live],
                               want[q_live], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(SCENES))
def test_own_rows_match_jax(name):
    """The own rows against the JAX ``_spill_own_rows``, its spill dict
    gathered here from the scene (so ``spill_rows``' layout is held too)."""
    jcfg, tcfg, scene, c_sp, rows, sp_tcx, sp_tcy, pt, pT = spill_inputs(name)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = scene
    valid = c_sp.valid.numpy()
    idx = np.where(valid, c_sp.idx.numpy(), 0)
    sp = dict(pos=pos[idx], vel=vel[idx], prefc=pref_c[idx],
              spref=self_pref[idx], prio=prio[idx], eye=eye[idx],
              rec=rec[idx], id=np.where(valid, idx, -1).astype(np.float32))
    want = np.asarray(jzp._spill_own_rows(
        jcfg, jax_params(), jnp.asarray(pt.numpy()),
        {k: jnp.asarray(v) for k, v in sp.items()},
        jnp.asarray(sp_tcx.numpy()), jnp.asarray(sp_tcy.numpy()),
        jnp.asarray(valid)))[:, 0]
    got = tspill.spill_window(
        tcfg, tzb.zparams5(torch_params()), pt, pT, rows, sp_tcx, sp_tcy,
        torch.zeros((pos.shape[0], 2)), int_prio=True)[:, -1].numpy()
    forced = np.abs(want[valid] - sp["rec"][valid]).sum(1) > 0
    assert forced.sum() > 3
    np.testing.assert_allclose(got[valid], want[valid], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("windows", [None, True, False])
def test_write_lands_on_affected_rows_only(windows):
    """Every valid spill's own row is written; a window row only where
    windows are on and the spill lies within the query's eyesight; every
    other row keeps its bits.  The velocities keep their dtype."""
    _, tcfg, scene, c_sp, rows, sp_tcx, sp_tcy, pt, pT = spill_inputs("mid")
    n = scene[0].shape[0]
    base = torch.arange(2 * n, dtype=torch.float64).reshape(n, 2) + 0.5
    vel = base.clone()
    flag = None if windows is None else torch.tensor(windows)
    out = tspill.spill_window(tcfg, tzb.zparams5(torch_params()), pt, pT,
                              rows, sp_tcx, sp_tcy, vel, int_prio=True,
                              windows=flag)
    assert vel.dtype == torch.float64
    b9 = 9 * tcfg.bucket
    want = base.clone()
    aff = tspill.affected(tcfg, pt, rows, sp_tcx, sp_tcy)
    if windows is not False:
        q_id = pt[tspill.window_query_slots(tcfg, sp_tcx, sp_tcy),
                  tzb.ROW_ID]
        assert int(aff.sum()) > 0
        want[q_id[aff].long()] = out[:, :b9][aff].double()
    valid = c_sp.valid
    want[c_sp.idx[valid].long()] = out[valid, b9].double()
    assert torch.equal(vel, want)
    n_changed = int((vel != base).any(1).sum())
    if windows is False:
        assert n_changed == int(valid.sum())
    else:
        assert n_changed > int(valid.sum())


def _fused(jax_side, name, mode, int_prio):
    cfg_args, scene, binning = scene_inputs(name)
    fused_spills, cap = FUSED_SPILLS[mode]
    kw = dict(spill_capacity=cap, int_prio=int_prio,
              fused_spills=fused_spills, use_pack_kernel=True)
    if jax_side:
        if binning is not None:
            kw.update(presorted=True,
                      binning=tuple(jnp.asarray(x) for x in binning))
        got, occ, dropped = jzp.zanlungo_fused(
            jzp.BucketConfig.create(**cfg_args), jax_params(),
            *(jnp.asarray(x) for x in scene), interpret=True, **kw)
        return np.asarray(got), int(occ), int(dropped)
    if binning is not None:
        kw.update(presorted=True, binning=tuple(_t(x) for x in binning))
    got, occ, dropped = tzb.zanlungo_fused(
        tzb.BucketConfig.create(**cfg_args), torch_params(),
        *(_t(x) for x in scene), **kw)
    return got.numpy(), int(occ), int(dropped)


@pytest.mark.parametrize("name,mode", [
    ("mid", "storm"), ("corner", "patch"), ("corner", "storm"),
    ("carried", "patch"), ("carried", "fits"), ("carried", "storm"),
])
def test_zanlungo_fused_matches_jax(name, mode):
    """The other three cases are held elsewhere: mid-world with the patch
    by test_torch_spill, mid-world and corner with fitting fused spills by
    test_torch_fused_spills."""
    int_prio = name != "corner"
    want, jocc, jdrop = _fused(True, name, mode, int_prio)
    got, tocc, tdrop = _fused(False, name, mode, int_prio)
    assert tocc == jocc > 16
    assert tdrop == jdrop
    assert (tdrop > 0) == (mode == "storm")
    alive = scene_inputs(name)[1][6]
    np.testing.assert_allclose(got[alive], want[alive], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(SCENES))
def test_window_hits_lie_in_the_query_tiles(name):
    """The premise that lets K2 walk only a query's own 3x3 tiles: of each
    live spill's 5x5 window, every candidate that a live window query's
    mask takes sits in a tile within one column and one row of the
    query's, while the window holds live candidates outside them."""
    _, tcfg, _, c_sp, rows, sp_tcx, sp_tcy, pt, pT = spill_inputs(name)
    live = c_sp.valid
    q_slots = tspill.window_query_slots(tcfg, sp_tcx, sp_tcy)[live]
    cand = tspill.window_candidate_slots(tcfg, sp_tcx, sp_tcy)[live]
    q = tzb.query_features(pt[q_slots])                       # [P, 9b, 1]
    c = tzb.candidate_features(pT[:, cand])                   # [P, 1, 25b]
    hit = tzb.pair_mask(q, c)
    b, ty = tcfg.bucket, tcfg.ty
    qt, ct = q_slots // b, cand // b
    near = (((qt // ty)[..., None] - (ct // ty)[:, None, :]).abs() <= 1) & (
        ((qt % ty)[..., None] - (ct % ty)[:, None, :]).abs() <= 1)
    assert int(hit.sum()) > 100
    assert not bool((hit & ~near).any())
    live_pairs = (q["id"] >= 0) & (c["id"] >= 0)
    assert bool((live_pairs & ~near).any())
