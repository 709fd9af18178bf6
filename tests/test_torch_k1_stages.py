"""K1's stage cuts (the P1/P2 probe, ``probes/k1_stages.py``) against the
JAX package, on the CPU.

The scene is the 4,096-agent bench scene with the 48-agent hotspot, two
steps in (the second step has pair forces), packed by the JAX package's
``bucketize``; both sides read that plane.  The plain version of each cut
(the path CPU tensors take through ``k1_stage``) is held against:

- ``stage``: the live candidates of each live query's 3x3 tiles, and
  ``mask``: its hits, both bitwise against counts made here with numpy
  from the JAX plane in the kernel's f32 arithmetic;
- ``ttc``: the minimum time to collision, in float64 on both sides,
  against ``rmf_crowdsim_tpu.models.local.time_to_collision`` over the
  same masked pairs (f32 times to collision cancel in ``bh^2 - a c`` and
  PyTorch's CPU kernels do not round them alike in every process);
- ``full``: ``zanlungo_forces_bucketed`` in interpret mode, to 2e-4 on
  live slots;
- ``floor`` and ``queries``: the rec rows, and every empty slot keeps its
  rec row at every stage.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.models import local as jlocal
from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.probes import k1_stages

N = 4096
TOL = 2e-4


@pytest.fixture(scope="module")
def plane():
    """(port config, JAX config, zp5, packed_t, packed_T as numpy, as
    torch)."""
    config, tcfg, params, st, rec, *_ = scenes.bench_bucketed(N, device="cpu")
    g = config.grid
    jcfg = jzp.BucketConfig.create(
        g.width, g.height, g.offset, config.max_eyesight,
        bucket=config.bucket_capacity, strip_tiles=config.strip_tiles,
        sub_tiles=config.sub_tiles, tile_size=config.bucket_tile_size)
    assert (jcfg.tx, jcfg.ty, jcfg.bucket) == (tcfg.tx, tcfg.ty, tcfg.bucket)

    def a(x):
        return jnp.asarray(x.numpy())

    packed_t, packed_T, _, occ, _ = jzp.bucketize(
        jcfg, a(st.position), a(st.velocity), a(st.preferred_vel), a(rec),
        a(st.priority), a(st.eyesight), a(rec), a(st.alive),
        use_pack_kernel=True, interpret=True, presorted=True)
    assert int(occ) > jcfg.bucket       # the hotspot overflows a bucket
    pt, pT = np.asarray(packed_t), np.asarray(packed_T)
    zp5 = tzb.zparams5(params.lp[0])
    return tcfg, jcfg, zp5, pt, pT, torch.tensor(pt), torch.tensor(pT)


def _window_slots(cfg):
    """[slots, 9b] the slots of each slot's 3x3 tiles in K1's walk order
    (column by column, tiles upward), -1 outside the world."""
    b, tx, ty = cfg.bucket, cfg.tx, cfg.ty
    t = np.arange(cfg.n_tiles)
    d = np.arange(-1, 2)
    cx = (t // ty)[:, None, None] + d[None, :, None]
    cy = (t % ty)[:, None, None] + d[None, None, :]
    ok = (cx >= 0) & (cx < tx) & (cy >= 0) & (cy < ty)
    s = (cx * ty + cy)[..., None] * b + np.arange(b)
    s = np.where(ok[..., None], s, -1).reshape(cfg.n_tiles, 9 * b)
    return np.repeat(s, b, axis=0)


def _numpy_masks(cfg, pt, pT, dtype):
    """(live query slots [Q], their window slots [Q, 9b], the mask [Q, 9b])
    in ``dtype`` arithmetic, as the kernel's pair_mask."""
    q = np.nonzero(pT[tzb.ROW_ID] >= 0)[0]
    w = _window_slots(cfg)[q]
    ok = w >= 0
    c = pT[:, np.where(ok, w, 0)].astype(dtype)                # [8, Q, 9b]
    qf = pt[q].astype(dtype)
    ddx = c[tzb.ROW_PX] - qf[:, None, tzb.ROW_PX]
    ddy = c[tzb.ROW_PY] - qf[:, None, tzb.ROW_PY]
    eye = qf[:, None, tzb.ROW_EYE]
    with np.errstate(over="ignore"):    # sentinel rows: 1e30 squared
        d2 = ddx * ddx + ddy * ddy
    mask = (ok & (d2 < eye * eye)
            & (c[tzb.ROW_ID] != qf[:, None, tzb.ROW_ID])
            & (c[tzb.ROW_ID] >= 0))
    return q, w, mask


def test_stage_counts_and_mask_hits_bitwise(plane):
    cfg, _, zp5, pt, pT, tt, tT = plane
    q, w, mask = _numpy_masks(cfg, pt, pT, np.float32)
    ok = w >= 0
    live_c = (pT[tzb.ROW_ID][np.where(ok, w, 0)] >= 0) & ok
    stage = k1_stages.k1_stage(cfg, zp5, tt, tT, "stage", True).numpy()
    np.testing.assert_array_equal(stage[q, 0], live_c.sum(1))
    assert (stage[q, 1] == 0).all()
    got = k1_stages.k1_stage(cfg, zp5, tt, tT, "mask", True).numpy()
    hits = mask.sum(1)
    assert hits.max() > 20                  # the scattered hotspot
    np.testing.assert_array_equal(got[q, 0], hits)
    np.testing.assert_array_equal(got[q, 1], hits > tzb.K1_LIST_CAP)


def test_ttc_matches_jax_time_to_collision(plane):
    cfg, _, zp5, pt, pT, tt, tT = plane
    got = k1_stages.k1_stage(cfg, zp5.double(), tt.double(), tT.double(),
                             "ttc", False).numpy()
    q, w, mask = _numpy_masks(cfg, pt, pT, np.float64)
    c = pT[:, np.where(w >= 0, w, 0)].astype(np.float64)
    qf = pt[q].astype(np.float64)
    rel_vel = np.stack([c[tzb.ROW_VX] - qf[:, None, tzb.ROW_VX],
                        c[tzb.ROW_VY] - qf[:, None, tzb.ROW_VY]], -1)
    rel_pos = np.stack([c[tzb.ROW_PX] - qf[:, None, tzb.ROW_PX],
                        c[tzb.ROW_PY] - qf[:, None, tzb.ROW_PY]], -1)
    ttc = np.asarray(jlocal.time_to_collision(
        jnp.asarray(rel_vel), jnp.asarray(rel_pos),
        jnp.float64(float(zp5[3]))))
    want = np.where(mask, ttc, np.inf).min(1)
    fin = np.isfinite(want)
    assert fin.sum() > 500 and (~fin).sum() > 500
    np.testing.assert_array_equal(np.isfinite(got[q, 0]), fin)
    np.testing.assert_allclose(got[q, 0][fin], want[fin], rtol=1e-9)
    np.testing.assert_array_equal(got[q, 1], mask.sum(1))


@pytest.mark.parametrize("int_prio", [True, False])
def test_full_matches_jax_kernel(plane, int_prio):
    cfg, jcfg, zp5, pt, pT, tt, tT = plane
    want = np.asarray(jzp.zanlungo_forces_bucketed(
        jcfg, jnp.asarray(zp5.numpy()), jnp.asarray(pt), interpret=True,
        int_prio=int_prio, packed_T=jnp.asarray(pT)))
    got = k1_stages.k1_stage(cfg, zp5, tt, tT, "full", int_prio).numpy()
    live = pT[tzb.ROW_ID] >= 0
    forced = np.abs(want[live] - pt[live, tzb.ROW_RX:tzb.ROW_RY + 1]).sum(1)
    assert (forced > 0).sum() > 100
    np.testing.assert_allclose(got[live], want[live], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("stage", k1_stages.STAGES)
def test_rec_rows_where_the_cut_writes_them(plane, stage):
    cfg, _, zp5, pt, pT, tt, tT = plane
    got = k1_stages.k1_stage(cfg, zp5, tt, tT, stage, True).numpy()
    rec = pt[:, tzb.ROW_RX:tzb.ROW_RY + 1]
    rows = (np.ones(cfg.slots, bool) if stage in ("floor", "queries")
            else pT[tzb.ROW_ID] < 0)
    assert rows.sum() > 1000
    np.testing.assert_array_equal(got[rows], rec[rows])


def test_wrapper_refusals_and_cpu_path(plane):
    cfg, _, zp5, _, _, tt, tT = plane
    with pytest.raises(ValueError, match="stage"):
        k1_stages.k1_stage(cfg, zp5, tt, tT, "force", True)
    with pytest.raises(ValueError, match="threads"):
        tzb.k1_geometry(cfg, threads=300)
    over = torch.zeros((1,), dtype=torch.int32)
    k1_stages.k1_stage.launches = 0
    k1_stages.k1_stage(cfg, zp5, tt, tT, "mask", True, overflow=over)
    assert int(over) == 0 and k1_stages.k1_stage.launches == 0


def test_k4_thread_rule():
    """1.125 times the mean live queries of a 15-tile block, to a warp:
    at the 1M bench 15 x 999,938 / 57,360 = 261.5 live queries a block,
    so 320 threads where K1's own rule gives 256."""
    cfg = scenes.bench_bucket_config(1_000_000)
    assert k1_stages.k4_rule_threads(cfg, 999_938) == 320
    assert tzb.k1_geometry(cfg).threads == 256
    geo = tzb.k1_geometry(cfg, threads=320)
    assert geo.threads == 320 and geo.smem_bytes <= tzb.SMEM_LIMIT
    assert k1_stages.k4_rule_threads(cfg, 0) == 64
