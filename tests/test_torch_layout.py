"""The port's bucketed layout against the JAX package's, bitwise.

The same numpy-seeded inputs go through
``rmf_crowdsim_tpu.ops.zanlungo_pallas`` (the pack kernel in Pallas
interpret mode) and
``rmf_crowdsim_tpu_torch.ops.zanlungo_bucketed`` (K3's plain version, the
path CPU tensors take): geometry, tile keys, ranks, bucket slots and both
packed planes must be identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu.ops.pack_pallas import CHUNK, MAX_CHUNKS
from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.ops import pack as tpack
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb


def _bench_args(n):
    c = scenes.bench_config(n)
    return dict(width=c.grid.width, height=c.grid.height,
                offset=c.grid.offset, max_eyesight=c.max_eyesight,
                bucket=c.bucket_capacity, strip_tiles=c.strip_tiles,
                sub_tiles=c.sub_tiles, tile_size=c.bucket_tile_size)


GEOMETRIES = {
    "bench_4096": _bench_args(4096),
    "bench_100k": _bench_args(100_000),
    "bench_1M": _bench_args(1_000_000),
    "test_24m_b16": dict(width=24.0, height=24.0, offset=(0.0, 0.0),
                         max_eyesight=3.0, bucket=16, strip_tiles=6,
                         sub_tiles=6),
    "test_16m_b16": dict(width=16.0, height=16.0, offset=(0.0, 0.0),
                         max_eyesight=2.0, bucket=16, strip_tiles=6,
                         sub_tiles=6),
    "test_32m_b8": dict(width=32.0, height=32.0, offset=(0.0, 0.0),
                        max_eyesight=2.0, bucket=8, strip_tiles=14,
                        sub_tiles=14),
    "test_12m_tile2": dict(width=12.0, height=12.0, offset=(0.0, 0.0),
                           max_eyesight=2.0, bucket=16, strip_tiles=8,
                           sub_tiles=6, tile_size=2.0),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_bucket_config_geometry_matches_jax(name):
    args = GEOMETRIES[name]
    j = jzp.BucketConfig.create(**args)
    t = tzb.BucketConfig.create(**args)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.slots, t.n_tiles) == (j.slots, j.n_tiles)


def test_bench_1m_geometry():
    """The 1M bench scene's layout: 239 x 240 tiles of 32 slots."""
    t = tzb.BucketConfig.create(**GEOMETRIES["bench_1M"])
    assert (t.tx, t.ty, t.bucket, t.slots) == (239, 240, 32, 1_835_520)


def _scene(seed=5, n=400, world=24.0, hot=60):
    """Uniform agents plus a ``hot``-agent cluster (bucket overflow) and a
    few agents outside the world (edge clipping); ~15% dead."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, world, (n, 2))
    pos[:hot] = rng.uniform(9.2, 11.8, (hot, 2))
    pos[hot:hot + 4] = [[-3.0, 5.0], [world + 2.0, 7.0], [4.0, -1.0],
                        [world + 9.0, world + 9.0]]
    f = np.float32
    return dict(
        pos=pos.astype(f),
        vel=rng.uniform(-2, 2, (n, 2)).astype(f),
        pref=rng.uniform(-2, 2, (n, 2)).astype(f),
        spref=rng.uniform(-2, 2, (n, 2)).astype(f),
        prio=rng.permutation(n).astype(f),
        eye=rng.uniform(0.5, 3.0, (n,)).astype(f),
        alive=rng.random(n) > 0.15,
        rec=rng.uniform(-2, 2, (n, 2)).astype(f),
    )


CFG_ARGS = GEOMETRIES["test_24m_b16"]


def _sorted(s, cfg):
    """The scene reordered by the JAX tile key (stable), i.e. presorted."""
    key = np.asarray(jzp.tile_key(cfg, jnp.asarray(s["pos"]),
                                  jnp.asarray(s["alive"])))
    order = np.argsort(key, kind="stable")
    return {k: v[order] for k, v in s.items()}


def _args(s, lib):
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return [conv(s[k]) for k in ("pos", "vel", "pref", "spref", "prio",
                                 "eye", "rec", "alive")]


def test_tile_key_rank_and_slots_bitwise():
    jcfg = jzp.BucketConfig.create(**CFG_ARGS)
    tcfg = tzb.BucketConfig.create(**CFG_ARGS)
    s = _scene()
    jkey = np.asarray(jzp.tile_key(jcfg, jnp.asarray(s["pos"]),
                                   jnp.asarray(s["alive"])))
    tkey = tzb.tile_key(tcfg, torch.as_tensor(s["pos"]),
                        torch.as_tensor(s["alive"])).numpy()
    np.testing.assert_array_equal(tkey, jkey)
    assert tkey.dtype == np.int32

    skey = np.sort(jkey, kind="stable")
    jb, jocc, jover = jzp.rank_from_sorted_key(jcfg, jnp.asarray(skey))
    tb, tocc, tover = tzb.rank_from_sorted_key(tcfg, torch.as_tensor(skey))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(tocc) == int(jocc) == jcfg.bucket + 2  # saturated
    assert int(tover) == int(jover) > 0


@pytest.mark.parametrize("use_pack_kernel,presorted",
                         [(True, True), (False, False)])
def test_bucketize_planes_bitwise(use_pack_kernel, presorted):
    """Presorted + pack kernel (the main path) against the JAX pack kernel
    in interpret mode; unsorted + scatter path against the JAX scatter."""
    jcfg = jzp.BucketConfig.create(**CFG_ARGS)
    tcfg = tzb.BucketConfig.create(**CFG_ARGS)
    s = _scene(seed=6)
    if presorted:
        s = _sorted(s, jcfg)
    pos, vel, pref, spref, prio, eye, rec, alive = _args(s, "jax")
    jout = jzp.bucketize(jcfg, pos, vel, pref, spref, prio, eye, rec, alive,
                         use_pack_kernel=use_pack_kernel, interpret=True,
                         presorted=presorted)
    pos, vel, pref, spref, prio, eye, rec, alive = _args(s, "torch")
    tout = tzb.bucketize(tcfg, pos, vel, pref, spref, prio, eye, rec, alive,
                         use_pack_kernel=use_pack_kernel,
                         presorted=presorted)
    names = ("packed_t", "packed_T", "bucket_pos", "max_occ", "dropped")
    for name, j, t in zip(names, jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    assert int(tout[4]) > 0  # the cluster overflows its bucket


def test_carried_binning_packs_fresh_dead_inert():
    """A carried binning with agents that died since the sort: their
    slots hold the position sentinel and id -1 (zanlungo_pallas.py:
    345-356), identically in both packages."""
    jcfg = jzp.BucketConfig.create(**CFG_ARGS)
    tcfg = tzb.BucketConfig.create(**CFG_ARGS)
    s = _sorted(_scene(seed=7), jcfg)
    skey = np.asarray(jzp.tile_key(jcfg, jnp.asarray(s["pos"]),
                                   jnp.asarray(s["alive"])))
    jbin = jzp.rank_from_sorted_key(jcfg, jnp.asarray(skey))
    tbin = tzb.rank_from_sorted_key(tcfg, torch.tensor(skey))
    died = np.flatnonzero(s["alive"])[::7]
    s["alive"] = s["alive"].copy()
    s["alive"][died] = False
    pos, vel, pref, spref, prio, eye, rec, alive = _args(s, "jax")
    jout = jzp.bucketize(jcfg, pos, vel, pref, spref, prio, eye, rec, alive,
                         use_pack_kernel=True, interpret=True,
                         presorted=True, binning=jbin)
    pos, vel, pref, spref, prio, eye, rec, alive = _args(s, "torch")
    tout = tzb.bucketize(tcfg, pos, vel, pref, spref, prio, eye, rec, alive,
                         use_pack_kernel=True, presorted=True, binning=tbin)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    packed_t, _, bucket_pos = (x.numpy() for x in tout[:3])
    slots = bucket_pos[died]
    slots = slots[slots < tcfg.slots]
    assert slots.size > 0
    np.testing.assert_array_equal(packed_t[slots, tzb.ROW_ID], -1.0)
    np.testing.assert_array_equal(packed_t[slots, tzb.ROW_PX],
                                  np.float32(tzb.POS_SENTINEL))


def test_pack_has_no_window_overflow():
    """The scene in which the TPU pack kernel loses 12 in-bucket rows past
    its streaming window (test_pack_kernel_overflow_diagnostic): the GPU
    pack's contract has no window, so every in-bucket row lands and the
    overflow count is 0."""
    slots = 512 * 4
    window = CHUNK * MAX_CHUNKS
    n = window + 512
    bpos = np.full((n,), slots, np.int32)
    bpos[:8] = np.arange(8)
    bpos[window + 100:window + 112] = np.arange(100, 112)
    feat = np.zeros((tzb.NUM_F, n), np.float32)
    feat[tzb.ROW_BPOS] = bpos
    feat[tzb.ROW_ONE] = 1.0
    feat[tzb.ROW_PX] = np.arange(n)
    packed_t, packed_T, overflow = tpack.pack_rows(
        torch.as_tensor(feat), torch.as_tensor(bpos), slots)
    assert int(overflow) == 0
    landed = bpos < slots
    np.testing.assert_array_equal(packed_t.numpy()[bpos[landed]],
                                  feat[:, landed].T)
    np.testing.assert_array_equal(packed_T.numpy(),
                                  packed_t.numpy()[:, :tzb.NUM_CAND].T)
    empty = np.setdiff1d(np.arange(slots), bpos[landed])
    np.testing.assert_array_equal(packed_t.numpy()[empty],
                                  tzb.sentinel_rows(empty.size, "cpu").numpy())
