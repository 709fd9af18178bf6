"""The port's dense layout and force kernel (K4) against the JAX package.

``DenseConfig`` geometry and ``dense_prep`` bitwise against
``rmf_crowdsim_tpu/ops/zanlungo_dense.py``; K4's plain version (the path
CPU tensors take through ``zanlungo_forces_dense``) against the Pallas
kernel in interpret mode, live rows, to 2e-4; the port's
``zanlungo_fused_dense`` against the JAX oracle (``zanlungo_velocity``
over ``brute_neighbors``) on the scenes of tests/test_zanlungo_dense.py;
and the whole ``grid_dense`` slice: the port's ``build_rollout`` at 1,024
agents with a hotspot against the JAX ``grid_dense`` (interpret) and
``brute`` rollouts, by uid to 2e-4, counters equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
from rmf_crowdsim_tpu.models import local as jlocal
from rmf_crowdsim_tpu.ops import neighbors as jnbr
from rmf_crowdsim_tpu.ops import zanlungo_dense as jzd
from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu_torch import ParityVelocity, Zanlungo, scenes
from rmf_crowdsim_tpu_torch.core.step import build_rollout
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as tzd

from test_torch_step import DT, N, STEPS, by_uid, jax_bench, port_inputs
from test_torch_zanlungo import jax_params, random_scene, torch_params

TOL = 2e-4


def _t(x):
    return torch.tensor(np.asarray(x))


def cfgs(**kw):
    """The same DenseConfig in both packages."""
    return jzd.DenseConfig.create(**kw), tzd.DenseConfig.create(**kw)


def sort_scene(jcfg, scene):
    """Tile-sort a numpy scene (pos, vel, self_pref, pref_c, prio, eye,
    alive, rec) with a stable sort; returns (sorted scene, sorted keys)."""
    key = np.asarray(jzp.tile_key(jcfg, jnp.asarray(scene[0]),
                                  jnp.asarray(scene[6])))
    order = np.argsort(key, kind="stable")
    return tuple(a[order] for a in scene), key[order]


def prep_args(scene):
    """dense_prep's argument order (position, velocity, pref_committed,
    self_pref, priority, eyesight, rec_vel, alive) from a scene."""
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = scene
    return pos, vel, pref_c, self_pref, prio, eye, rec, alive


def carried_scene():
    """tests/test_zanlungo_dense.py:217: a sorted scene whose agents then
    drift within the skin margin and partly die, with the STALE keys."""
    rng = np.random.default_rng(11)
    n, world, eyesight = 180, 24.0, 2.0
    jcfg, tcfg = cfgs(width=world, height=world, offset=(0.0, 0.0),
                      max_eyesight=eyesight, capacity=n, tile_size=4.0)
    margin = (jcfg.tile_size - eyesight) / 2.0
    scene = random_scene(7, n, world, eyesight)
    scene = scene[:6] + (np.ones(n, bool),) + scene[7:]
    s0, key_s = sort_scene(jcfg, scene)
    drift = rng.uniform(-margin * 0.95, margin * 0.95, (n, 2))
    pos1 = (s0[0] + drift.astype(np.float32)).astype(np.float32)
    alive1 = (rng.random(n) > 0.1) & s0[6]
    s1 = (pos1,) + s0[1:6] + (alive1,) + s0[7:]
    return jcfg, tcfg, s1, key_s


def cluster_scene(seed, n_c, n_u):
    """A one-tile cluster of ``n_c`` agents plus ``n_u`` spread ones
    (tests/test_zanlungo_dense.py:103-165)."""
    rng = np.random.default_rng(seed)
    world = 30.0
    pos = np.concatenate([rng.uniform(12.0, 15.0, (n_c, 2)),
                          rng.uniform(0.0, world, (n_u, 2))]).astype(
                              np.float32)
    n = n_c + n_u
    f = np.float32
    scene = (pos, rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.permutation(n).astype(f), np.full((n,), 3.0, f),
             np.ones((n,), bool), rng.uniform(-2, 2, (n, 2)).astype(f))
    return cfgs(width=world, height=world, offset=(0.0, 0.0),
                max_eyesight=3.0, capacity=n, col_headroom=8.0), scene


def edge_scene():
    """tests/test_zanlungo_dense.py:250: agents at and beyond the world's
    border."""
    rng = np.random.default_rng(9)
    n, world = 140, 16.0
    f = np.float32
    pos = rng.uniform(-2.0, world + 2.0, (n, 2)).astype(f)
    scene = (pos, rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.permutation(n).astype(f), np.full((n,), 3.0, f),
             np.ones((n,), bool), rng.uniform(-2, 2, (n, 2)).astype(f))
    return cfgs(width=world, height=world, offset=(0.0, 0.0),
                max_eyesight=3.0, capacity=n), scene


def overflow_scene():
    """tests/test_zanlungo_dense.py:168: 900 agents in one tile column of
    a 10 x 10-tile world with col_cap 512."""
    rng = np.random.default_rng(3)
    n, world = 900, 40.0
    f = np.float32
    pos = np.stack([rng.uniform(1.0, 3.9, n),
                    rng.uniform(0.0, world, n)], axis=1).astype(f)
    scene = (pos, rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.uniform(-2, 2, (n, 2)).astype(f),
             rng.permutation(n).astype(f), np.full((n,), 3.0, f),
             np.ones((n,), bool), rng.uniform(-2, 2, (n, 2)).astype(f))
    kw = dict(tile_size=4.0, offset=(0.0, 0.0), tx=10, ty=10, col_cap=512)
    return (jzd.DenseConfig(**kw), tzd.DenseConfig(**kw)), scene


@pytest.mark.parametrize("kw", [
    dict(width=24.0, height=24.0, offset=(0.0, 0.0), max_eyesight=3.0,
         capacity=160),
    dict(width=16.0, height=40.0, offset=(-8.0, -20.0), max_eyesight=2.0,
         capacity=50, tile_size=4.0, col_headroom=8.0),
    "bench_1m",
])
def test_dense_config_matches_jax(kw):
    if kw == "bench_1m":
        c = scenes.bench_config(1_000_000, backend="grid_dense")
        kw = dict(width=c.grid.width, height=c.grid.height,
                  offset=c.grid.offset, max_eyesight=c.max_eyesight,
                  capacity=c.capacity, tile_size=c.bucket_tile_size,
                  col_headroom=c.dense_col_headroom)
    jcfg, tcfg = cfgs(**kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.n_tiles, tcfg.slots) == (jcfg.n_tiles, jcfg.slots)
    if kw["capacity"] == 1_000_000:
        assert (tcfg.tx, tcfg.ty, tcfg.col_cap, tcfg.slots) == (
            239, 239, 8448, 2_019_072)


def _assert_prep_bitwise(jcfg, tcfg, scene, key_s):
    n = scene[0].shape[0]
    jout = jzd.dense_prep(jcfg, jnp.asarray(key_s),
                          *(jnp.asarray(x) for x in prep_args(scene)))
    feat_T, tile_start, _, _, bpos, n_over, max_occ = map(np.asarray, jout)
    feat, t_ts, t_bpos, t_over, t_occ = tzd.dense_prep(
        tcfg, _t(key_s), *(_t(x) for x in prep_args(scene)))
    np.testing.assert_array_equal(t_ts.numpy(), tile_start)
    np.testing.assert_array_equal(t_bpos.numpy(), bpos)
    assert int(t_over) == int(n_over) and int(t_occ) == int(max_occ)
    assert t_ts.dtype == t_bpos.dtype == torch.int32
    np.testing.assert_array_equal(feat.numpy(), feat_T[:, :n].T)
    return bpos, int(n_over)


def test_dense_prep_bitwise_fresh_sort():
    jcfg, tcfg = cfgs(width=24.0, height=24.0, offset=(0.0, 0.0),
                      max_eyesight=3.0, capacity=160)
    scene, key_s = sort_scene(jcfg, random_scene(0, 160, 24.0, 3.0))
    assert (key_s == jcfg.n_tiles).any()      # dead rows sort last
    _assert_prep_bitwise(jcfg, tcfg, scene, key_s)


def test_dense_prep_bitwise_carried_keys():
    """Stale keys with fresh-dead rows: they count in col_len, max_occ and
    bpos, and read as inert rows."""
    jcfg, tcfg, scene, key_s = carried_scene()
    assert not scene[6].all() and (key_s < jcfg.n_tiles).all()
    bpos, _ = _assert_prep_bitwise(jcfg, tcfg, scene, key_s)
    assert (bpos < jcfg.slots).all()


def test_dense_prep_bitwise_column_overflow():
    (jcfg, tcfg), scene = overflow_scene()
    s, key_s = sort_scene(jcfg, scene)
    _, n_over = _assert_prep_bitwise(jcfg, tcfg, s, key_s)
    assert n_over == 900 - 512


@pytest.mark.parametrize("empty", ["edge_columns", "middle_column"])
def test_dense_prep_bitwise_empty_columns(empty):
    """Empty tile columns at the world's edges or inside it, with dead
    rows keyed ``n_tiles`` sorted behind the last column: the column rank
    taken by a gather of ``col_start`` gives the JAX scan's ``bpos``."""
    jcfg, tcfg = cfgs(width=24.0, height=24.0, offset=(0.0, 0.0),
                      max_eyesight=3.0, capacity=200)
    scene = random_scene(13, 200, 24.0, 3.0)
    pos = scene[0].copy()
    if empty == "edge_columns":          # x in [3, 21): columns 0 and 7
        pos[:, 0] = 3.0 + pos[:, 0] * np.float32(0.75)
    else:                                # column 3 moves into column 4
        pos[:, 0] = np.where((pos[:, 0] >= 9.0) & (pos[:, 0] < 12.0),
                             pos[:, 0] + 3.0, pos[:, 0])
    scene, key_s = sort_scene(jcfg, (pos,) + scene[1:])
    col_len = np.diff(np.searchsorted(key_s, np.arange(0, jcfg.n_tiles + 1,
                                                       jcfg.ty)))
    assert (col_len == 0).sum() == (2 if empty == "edge_columns" else 1)
    assert (key_s == jcfg.n_tiles).any()
    _assert_prep_bitwise(jcfg, tcfg, scene, key_s)


@pytest.fixture(scope="module")
def jax_dense_kernel():
    """K4's JAX reference in interpret mode, once per int_prio mode, on a
    160-agent scene with dead agents."""
    jcfg, tcfg = cfgs(width=24.0, height=24.0, offset=(0.0, 0.0),
                      max_eyesight=3.0, capacity=160)
    scene, key_s = sort_scene(jcfg, random_scene(1, 160, 24.0, 3.0))
    feat_T, tile_start, qn, dma, bpos, _, _ = jzd.dense_prep(
        jcfg, jnp.asarray(key_s), *(jnp.asarray(x) for x in
                                    prep_args(scene)))
    want = {
        int_prio: np.asarray(jzd.zanlungo_forces_dense(
            jcfg, jzp.zparams5(jax_params()), feat_T, tile_start, qn, dma,
            interpret=True, int_prio=int_prio))
        for int_prio in (True, False)
    }
    return tcfg, scene, key_s, np.asarray(bpos), want


@pytest.mark.parametrize("int_prio", [True, False])
def test_forces_dense_plain_matches_jax_kernel(jax_dense_kernel, int_prio):
    tcfg, scene, key_s, bpos, want = jax_dense_kernel
    feat, tile_start, _, _, _ = tzd.dense_prep(
        tcfg, _t(key_s), *(_t(x) for x in prep_args(scene)))
    got = tzd.zanlungo_forces_dense(tcfg, tzb.zparams5(torch_params()), feat,
                                    tile_start, int_prio=int_prio).numpy()
    rows = bpos[scene[6] & (bpos < tcfg.slots)]
    assert rows.shape[0] == scene[6].sum()
    forced = np.abs(want[int_prio][rows] - feat.numpy()[
        np.nonzero(scene[6])[0], 8:10]).sum(1)
    assert (forced > 0).sum() > 10      # real pair forces, not just rec
    np.testing.assert_allclose(got[rows], want[int_prio][rows], rtol=TOL,
                               atol=TOL)


def _oracle(scene):
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = (
        jnp.asarray(x) for x in scene)
    nb = jnbr.brute_neighbors(pos, eye, alive)
    return np.asarray(jlocal.zanlungo_velocity(
        jax_params(), pos, vel, self_pref, pref_c, prio, nb.idx, nb.valid,
        rec))


def _fused_dense(tcfg, scene, key_s, **kw):
    pos, vel, self_pref, pref_c, prio, eye, alive, rec = (
        _t(x) for x in scene)
    got, occ, dropped = tzd.zanlungo_fused_dense(
        tcfg, torch_params(), pos, vel, self_pref, pref_c, prio, eye, alive,
        rec, _t(key_s), **kw)
    return got.numpy(), int(occ), int(dropped)


@pytest.mark.parametrize("name", [
    "random0", "random2_int_prio", "hotspot", "extreme_hotspot",
    "carried", "world_edges",
])
def test_fused_dense_matches_oracle(name):
    kw = {}
    if name.startswith("random"):
        seed = int(name[6])
        jcfg, tcfg = cfgs(width=24.0, height=24.0, offset=(0.0, 0.0),
                          max_eyesight=3.0, capacity=160)
        scene, key_s = sort_scene(jcfg, random_scene(seed, 160, 24.0, 3.0))
        kw = dict(int_prio=name.endswith("int_prio"))
    elif name in ("hotspot", "extreme_hotspot"):
        (jcfg, tcfg), raw = (cluster_scene(5, 220, 120) if name == "hotspot"
                             else cluster_scene(11, 430, 140))
        scene, key_s = sort_scene(jcfg, raw)
    elif name == "carried":
        jcfg, tcfg, scene, key_s = carried_scene()
    else:
        (jcfg, tcfg), raw = edge_scene()
        scene, key_s = sort_scene(jcfg, raw)
    got, occ, dropped = _fused_dense(tcfg, scene, key_s, **kw)
    assert dropped == 0
    if name == "extreme_hotspot":
        assert occ > 400        # window extents past 256 rows
    a = scene[6]
    np.testing.assert_allclose(got[a], _oracle(scene)[a], rtol=TOL, atol=TOL)


def test_fused_dense_column_overflow_counted():
    """Rows past col_cap keep rec_vel and are counted in ``dropped``."""
    (jcfg, tcfg), raw = overflow_scene()
    scene, key_s = sort_scene(jcfg, raw)
    got, _, dropped = _fused_dense(tcfg, scene, key_s)
    assert dropped == 900 - 512
    np.testing.assert_array_equal(got[512:], scene[7][512:])


# ---------------------------------------------------------------------------
# The slice: grid_dense through build_rollout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_runs():
    out = {}
    for backend in ("grid_dense", "brute"):
        rollout, params, state = jax_bench(backend)
        st, c = jax.jit(rollout, static_argnums=(3,))(params, state, DT,
                                                      STEPS)
        out["jax_" + backend] = (by_uid(st.position, st.uid),
                                 jax.tree.map(np.asarray, c))
        if backend == "brute":
            continue
        t_params, t_state = port_inputs(params, state)
        t_rollout = build_rollout(
            scenes.bench_config(N, backend=backend),
            [ParityVelocity((1.0, 0.0))],
            [Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=20.0)])
        tzd.zanlungo_forces_dense.launches = 0
        st, c = t_rollout(t_params, t_state, DT, STEPS)
        out["launches"] = tzd.zanlungo_forces_dense.launches
        out["torch_" + backend] = (by_uid(st.position, st.uid), c)
    return out


@pytest.mark.parametrize("ref", ["grid_dense", "brute"])
def test_dense_rollout_matches_jax_by_uid(dense_runs, ref):
    got = dense_runs["torch_grid_dense"][0]
    assert np.isfinite(got).all() and got.shape == (N, 2)
    np.testing.assert_allclose(got, dense_runs["jax_" + ref][0], rtol=TOL,
                               atol=TOL)


def test_dense_rollout_counters_match_jax(dense_runs):
    got = dense_runs["torch_grid_dense"][1]
    want = dense_runs["jax_grid_dense"][1]
    for name in ("n_alive", "max_cell_occupancy", "neighbor_truncated",
                 "n_spawned", "n_destroyed", "out_of_bounds"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    assert (got.neighbor_truncated.numpy() == 0).all()
    assert (got.n_alive.numpy() == N).all()
    # The hotspot tile holds more than the bucketed layout's 32 slots.
    assert (got.max_cell_occupancy.numpy() > 32).all()
    assert dense_runs["launches"] == 0      # CPU tensors: plain version


def test_grid_dense_config_is_the_bench_spec():
    """scenes.bench_config(backend='grid_dense') is bench.py:31-75 field
    for field: presort, integer priorities and dual_row on, no pack."""
    c = scenes.bench_config(1_000_000, backend="grid_dense")
    assert c.neighbor_backend == "grid_dense"
    assert c.presort and c.integer_priorities and c.dual_row
    assert not c.use_pack_kernel and not c.fused_spills
    assert (c.bucket_tile_size, c.max_eyesight, c.dense_col_headroom) == (
        5.3, 2.0, 2.0)
    assert c.grid.width == 1266.0
    j = J.SimConfig(capacity=4, grid=J.GridConfig(1.0, 1.0, 1.0, (0.0, 0.0)),
                    neighbor_backend="grid_dense")
    assert j.dense_col_headroom == c.dense_col_headroom
