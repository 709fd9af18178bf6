"""The port's fused spill repair (K1b) against the JAX package.

``spill_flags`` bitwise against ``_spill_flags``; K1b's plain version (the
path CPU tensors take through ``zanlungo_forces_bucketed_spill``) against
``zanlungo_forces_bucketed(spill_ext=...)`` in interpret mode; the port's
``zanlungo_fused(fused_spills=True)`` against JAX's on the overflowing
scenes of tests/test_spill_fused.py (to 2e-4, ``dropped`` equal), bitwise
against ``fused_spills=False`` on a clean scene, and equal to the patch
path in a spill storm; and the whole slice: a 1,024-agent fused rollout
against JAX's (interpret), by uid to 2e-4, counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu_torch import ParityVelocity, Zanlungo, scenes
from rmf_crowdsim_tpu_torch.core.step import build_rollout
from rmf_crowdsim_tpu_torch.ops import spill as tspill
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb

from test_torch_step import DT, N, STEPS, by_uid, jax_bench, port_inputs
from test_torch_zanlungo import jax_params, random_scene, torch_params

TOL = 2e-4
CFG_ARGS = dict(width=24.0, height=24.0, offset=(0.0, 0.0), max_eyesight=3.0,
                bucket=16, strip_tiles=6, sub_tiles=6)


def _t(x):
    return torch.tensor(np.asarray(x))


def overflow_scene(seed, n=96, world=24.0, eyesight_max=3.0, n_cram=30,
                   cram_lo=9.0, cram_hi=11.5):
    """tests/test_spill_fused.py:30, as float32 numpy in the argument order
    of ``zanlungo_fused``."""
    rng = np.random.default_rng(seed)
    f = np.float32
    pos = rng.uniform(0.0, world, (n, 2))
    pos[:n_cram] = rng.uniform(cram_lo, cram_hi, (n_cram, 2))
    return (pos.astype(f),
            rng.uniform(-2, 2, (n, 2)).astype(f),
            rng.uniform(-2, 2, (n, 2)).astype(f),
            rng.uniform(-2, 2, (n, 2)).astype(f),
            rng.permutation(n).astype(f),
            rng.uniform(0.5, eyesight_max, (n,)).astype(f),
            rng.random(n) > 0.1,
            rng.uniform(-2, 2, (n, 2)).astype(f))


def jax_fused(scene, **kw):
    got, occ, dropped = jzp.zanlungo_fused(
        jzp.BucketConfig.create(**CFG_ARGS), jax_params(),
        *(jnp.asarray(x) for x in scene), interpret=True, **kw)
    return np.asarray(got), int(occ), int(dropped)


def port_fused(scene, **kw):
    got, occ, dropped = tzb.zanlungo_fused(
        tzb.BucketConfig.create(**CFG_ARGS), torch_params(),
        *(_t(x) for x in scene), **kw)
    return got.numpy(), int(occ), int(dropped)


@pytest.mark.parametrize("cfg_args", [
    CFG_ARGS,
    dict(width=1266.0, height=1266.0, offset=(-633.0, -633.0),
         max_eyesight=2.0, bucket=32, strip_tiles=96, sub_tiles=2,
         tile_size=5.3),
])
def test_spill_flags_bitwise(cfg_args):
    """Random spill tiles with the world's edges and corners forced in and
    a third of the lanes dead; on the 1M bench geometry ty = 240 holds
    three strips of 80 tiles, 40 sub-blocks each."""
    jcfg = jzp.BucketConfig.create(**cfg_args)
    tcfg = tzb.BucketConfig.create(**cfg_args)
    rng = np.random.default_rng(4)
    s = 128
    tcx = rng.integers(0, tcfg.tx, s).astype(np.int32)
    tcy = rng.integers(0, tcfg.ty, s).astype(np.int32)
    tcx[:4] = [0, tcfg.tx - 1, 0, tcfg.tx - 1]
    tcy[:4] = [0, tcfg.ty - 1, tcfg.ty - 1, 0]
    tcx[4:8] = tcfg.tx - 1
    valid = rng.random(s) > 0.33
    valid[:8] = True
    want = np.asarray(jzp._spill_flags(jcfg, jnp.asarray(tcx),
                                       jnp.asarray(tcy), jnp.asarray(valid)))
    got = tspill.spill_flags(tcfg, _t(tcx), _t(tcy), _t(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # Dead lanes flag nothing.
    none = tspill.spill_flags(tcfg, _t(tcx), _t(tcy), _t(np.zeros(s, bool)))
    assert int(none.sum()) == 0


def _k1b_inputs():
    jcfg = jzp.BucketConfig.create(**CFG_ARGS)
    tcfg = tzb.BucketConfig.create(**CFG_ARGS)
    scene = overflow_scene(11)
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = scene
    packed_t, packed_T, bucket_pos, occ, _ = jzp.bucketize(
        jcfg, *(jnp.asarray(x) for x in
                (pos, vel, pref_c, self_pref, prio, eye, rec, alive)))
    assert int(occ) > jcfg.bucket
    c_sp, sp, sp_tcx, sp_tcy = tspill.spill_rows(
        tcfg, *(_t(x) for x in scene), _t(bucket_pos),
        tzb.FUSED_SPILL_LANES)
    sflag = tspill.spill_flags(tcfg, sp_tcx, sp_tcy, c_sp.valid)
    sp_T = tspill.spill_candidates(sp)
    return jcfg, tcfg, packed_t, packed_T, sflag, sp_T, int(c_sp.count)


@pytest.mark.parametrize("int_prio", [True, False])
def test_k1b_plain_matches_jax_kernel(int_prio):
    jcfg, tcfg, packed_t, packed_T, sflag, sp_T, n_spill = _k1b_inputs()
    assert n_spill > 0 and int((sflag > 0).sum()) > 0
    want = np.asarray(jzp.zanlungo_forces_bucketed(
        jcfg, jzp.zparams5(jax_params()), packed_t, interpret=True,
        int_prio=int_prio, packed_T=packed_T,
        spill_ext=(jnp.asarray(sflag.numpy()), jnp.asarray(sp_T.numpy()))))
    zp5 = tzb.zparams5(torch_params())
    pt, pT = _t(packed_t), _t(packed_T)
    got = tzb.zanlungo_forces_bucketed_spill(
        tcfg, zp5, pt, pT, sflag, sp_T, int_prio=int_prio).numpy()
    live = np.asarray(packed_T)[tzb.ROW_ID] >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=TOL, atol=TOL)
    # The spill segment changed some flagged rows, and left every
    # unflagged row bitwise equal to K1.
    k1 = tzb.zanlungo_forces_bucketed(tcfg, zp5, pt, pT,
                                      int_prio=int_prio).numpy()
    flagged = tzb.slot_flags(tcfg, sflag).numpy()
    assert (np.abs(got - k1).sum(1)[live & flagged] > 0).sum() > 0
    np.testing.assert_array_equal(got[~flagged], k1[~flagged])


@pytest.mark.parametrize("scene_kw", [
    dict(seed=11),
    dict(seed=13, n_cram=28, cram_lo=0.2, cram_hi=2.2),  # corner tile
])
def test_fused_spills_match_jax(scene_kw):
    scene = overflow_scene(**scene_kw)
    want, jocc, jdrop = jax_fused(scene, spill_capacity=64, int_prio=True,
                                  fused_spills=True)
    got, tocc, tdrop = port_fused(scene, spill_capacity=64, int_prio=True,
                                  fused_spills=True)
    assert tocc == jocc > 16 and tdrop == jdrop == 0
    a = scene[6]
    np.testing.assert_allclose(got[a], want[a], rtol=TOL, atol=TOL)


def test_fused_clean_scene_bitwise_plain():
    """No overflow: the fused pass equals fused_spills=False bit for bit
    (no sub-block flagged, no own row written, no patch row)."""
    scene = random_scene(3, 96, 24.0, 3.0)
    a, occ, d_a = port_fused(scene, spill_capacity=64, fused_spills=True)
    b, _, d_b = port_fused(scene, fused_spills=False)
    assert occ <= 16 and d_a == 0 and d_b == 0
    np.testing.assert_array_equal(a, b)


def test_fused_storm_falls_back_to_patch():
    """More spills than min(128, spill_capacity): the full patch runs on
    the device; velocities equal the patch path and JAX's storm branch,
    and ``dropped`` (the unresolved spills) equals JAX's."""
    scene = overflow_scene(7, n_cram=40)
    got, occ, dropped = port_fused(scene, spill_capacity=8,
                                   fused_spills=True)
    ref, _, dropped_ref = port_fused(scene, spill_capacity=8,
                                     fused_spills=False)
    want, _, jdrop = jax_fused(scene, spill_capacity=8, fused_spills=True)
    assert occ > 16
    assert dropped == dropped_ref == jdrop > 0
    a = scene[6]
    np.testing.assert_allclose(got[a], ref[a], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[a], want[a], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# The slice: grid_pallas with fused_spills=True through build_rollout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fused_runs():
    rollout, params, state = jax_bench("grid_pallas", fused_spills=True)
    st, cnt = jax.jit(rollout, static_argnums=(3,))(params, state, DT, STEPS)
    out = {"jax": (by_uid(st.position, st.uid),
                   jax.tree.map(np.asarray, cnt))}

    t_params, t_state = port_inputs(params, state)
    t_rollout = build_rollout(
        scenes.bench_config(N, fused_spills=True),
        [ParityVelocity((1.0, 0.0))],
        [Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=20.0)])
    tzb.zanlungo_forces_bucketed_spill.launches = 0
    st, cnt = t_rollout(t_params, t_state, DT, STEPS)
    out["launches"] = tzb.zanlungo_forces_bucketed_spill.launches
    out["torch"] = (by_uid(st.position, st.uid), cnt)
    return out


def test_fused_rollout_matches_jax_by_uid(fused_runs):
    got = fused_runs["torch"][0]
    assert np.isfinite(got).all() and got.shape == (N, 2)
    np.testing.assert_allclose(got, fused_runs["jax"][0], rtol=TOL, atol=TOL)


def test_fused_rollout_counters_match_jax(fused_runs):
    got = fused_runs["torch"][1]
    want = fused_runs["jax"][1]
    for name in ("n_alive", "max_cell_occupancy", "neighbor_truncated",
                 "n_spawned", "n_destroyed", "out_of_bounds"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    assert (got.neighbor_truncated.numpy() == 0).all()
    # The hotspot overflows a bucket on every step: the fused path ran.
    assert (got.max_cell_occupancy.numpy() > 32).all()
    assert fused_runs["launches"] == 0      # CPU tensors: plain version
