"""The ``grid`` and ``custom`` neighbor backends and the spatial queries of
the port against the JAX package.

``bin_agents`` and ``grid_neighbors`` bit for bit (a stable sort by cell
id); the truncation audit on an overflowing cell that somebody sees and
one that nobody sees (mirroring tests/test_truncation.py); the ``grid``
backend's rollout of the bench scene; the ``custom`` backend with a user
``neighbor_fn`` and its ``ValueError``; and the four spatial queries,
including scenes whose distances tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
from rmf_crowdsim_tpu.core.step import build_rollout as jax_build_rollout
from rmf_crowdsim_tpu.ops import grid as jgrid
from rmf_crowdsim_tpu.ops import neighbors as jnbr
from rmf_crowdsim_tpu_torch import (
    ConstantVelocity,
    GridConfig,
    SimConfig,
    SimParams,
    Zanlungo,
    build_rollout,
    build_step,
    scenes,
)
from rmf_crowdsim_tpu_torch.ops import grid as tgrid
from rmf_crowdsim_tpu_torch.ops import neighbors as tnbr
from rmf_crowdsim_tpu_torch.utils import convert

GRID = dict(width=40.0, height=30.0, cell_size=2.0, offset=(-20.0, -15.0))


def random_scene(seed, n=512, dead=0.1, cluster=0):
    """Positions [n, 2] f32 (some outside the grid), eyesight [n], alive
    [n]; ``cluster`` agents crammed into one cell."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-21.0, -16.0], [21.0, 16.0], (n, 2))
    pos[:cluster] = rng.uniform(0.1, 1.9, (cluster, 2))
    eye = rng.uniform(0.5, 4.0, n)
    alive = rng.random(n) >= dead
    return pos.astype(np.float32), eye.astype(np.float32), alive


def both(pos, eye, alive):
    return ((jnp.asarray(pos), jnp.asarray(eye), jnp.asarray(alive)),
            (torch.as_tensor(pos), torch.as_tensor(eye),
             torch.as_tensor(alive)))


@pytest.mark.parametrize("seed,cluster", [(0, 0), (1, 30), (2, 200)])
def test_bin_agents_bitwise_jax(seed, cluster):
    pos, eye, alive = random_scene(seed, cluster=cluster)
    (jp, _, ja), (tp, _, ta) = both(pos, eye, alive)
    jb = jgrid.bin_agents(J.GridConfig(**GRID), jp, ja)
    tb = tgrid.bin_agents(GridConfig(**GRID), tp, ta)
    for name in ("order", "sorted_cid", "starts", "cx", "cy", "in_bounds"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


@pytest.mark.parametrize("seed,cluster,window,mpc", [
    (0, 0, 2, 8), (1, 30, 1, 16), (2, 200, 2, 4), (3, 0, 1, 2)])
def test_grid_neighbors_bitwise_jax(seed, cluster, window, mpc):
    """``idx``, ``valid``, ``max_cell_occupancy`` and ``truncated`` as
    the JAX package's, with and without overflowing cells."""
    pos, eye, alive = random_scene(seed, cluster=cluster)
    (jp, je, ja), (tp, te, ta) = both(pos, eye, alive)
    jn = jgrid.grid_neighbors(J.GridConfig(**GRID), jp, je, ja,
                              window=window, max_per_cell=mpc)
    tn = tgrid.grid_neighbors(GridConfig(**GRID), tp, te, ta,
                              window=window, max_per_cell=mpc)
    assert tuple(tn.idx.shape) == (pos.shape[0], (2 * window + 1) ** 2 * mpc)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))
    assert int(tn.max_cell_occupancy) == int(jn.max_cell_occupancy)
    assert int(tn.truncated) == int(jn.truncated)
    assert tn.valid.any()


def _cluster_cell(eyesight, watcher):
    """tests/test_truncation.py's scenes: five agents 0.2 m apart in one
    5 m cell with ``max_per_cell`` 2, and optionally a far-seeing watcher
    in the next cell."""
    pts = [(1.0 + 0.2 * i, 1.0) for i in range(5)]
    eye = [eyesight] * 5
    if watcher:
        pts.append((6.0, 1.0))
        eye.append(5.0)
    grid = dict(width=100.0, height=100.0, cell_size=5.0,
                offset=(-50.0, -50.0))
    pos = np.asarray(pts, np.float32)
    return grid, pos, np.asarray(eye, np.float32), np.ones(len(pts), bool)


@pytest.mark.parametrize("eyesight,watcher,expected", [
    (5.0, False, 3),   # seen by each other
    (0.1, False, 0),   # nobody sees the dropped members
    (0.1, True, 3),    # the watcher sees all three
])
def test_truncation_audit_matches_jax(eyesight, watcher, expected):
    grid, pos, eye, alive = _cluster_cell(eyesight, watcher)
    (jp, je, ja), (tp, te, ta) = both(pos, eye, alive)
    jn = jgrid.grid_neighbors(J.GridConfig(**grid), jp, je, ja, window=1,
                              max_per_cell=2)
    tn = tgrid.grid_neighbors(GridConfig(**grid), tp, te, ta, window=1,
                              max_per_cell=2)
    assert int(tn.truncated) == int(jn.truncated) == expected
    assert int(tn.max_cell_occupancy) == int(jn.max_cell_occupancy) == 5


def test_truncation_audit_deep_cell_matches_jax():
    """Cells with more seers than the audit examines (``r_cap``): every
    dropped member is counted, conservatively, as JAX counts it."""
    rng = np.random.default_rng(9)
    pos = rng.uniform(0.2, 1.8, (60, 2)).astype(np.float32)
    # Two cells (y = 1 is a cell edge), each far past max_per_cell 4.
    counts = np.bincount((pos[:, 1] >= 1.0).astype(int))
    dropped = int(np.maximum(counts - 4, 0).sum())
    eye = np.full(60, 3.0, np.float32)
    alive = np.ones(60, bool)
    (jp, je, ja), (tp, te, ta) = both(pos, eye, alive)
    jn = jgrid.grid_neighbors(J.GridConfig(**GRID), jp, je, ja, window=1,
                              max_per_cell=4)
    tn = tgrid.grid_neighbors(GridConfig(**GRID), tp, te, ta, window=1,
                              max_per_cell=4)
    assert counts.max() > 4 + 20
    assert int(tn.truncated) == int(jn.truncated) == dropped


def test_grid_backend_rollout_matches_jax():
    """The 1,024-agent bench scene, 3 steps, on the ``grid`` backend of
    both packages (the table-based Zanlungo pass): positions by uid to
    2e-4 and equal counters."""
    n = 1024
    c = scenes.bench_config(n, backend="grid")
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    fields["grid"] = J.GridConfig(**dataclasses.asdict(c.grid))
    jc = J.SimConfig(**fields)
    ro, tparams, tst = scenes.build_bench(n, backend="grid", device="cpu")
    jst = J.make_state(jc).replace(**{
        k: jnp.asarray(v) for k, v in convert.state_to_numpy(tst).items()})
    jhl = J.ParityVelocity((1.0, 0.0))
    jlp = J.Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=20.0)
    jparams = J.SimParams(hl=(jhl.init_params(),), lp=(jlp.init_params(),),
                          sources=None)
    js, jcnt = jax.jit(jax_build_rollout(jc, [jhl], [jlp]),
                       static_argnums=(3,))(jparams, jst, 1 / 60, 3)
    ts, tcnt = ro(tparams, tst, 1 / 60, 3)
    order_j = np.argsort(np.asarray(js.uid))
    order_t = np.argsort(ts.uid.numpy())
    np.testing.assert_allclose(ts.position.numpy()[order_t],
                               np.asarray(js.position)[order_j],
                               rtol=2e-4, atol=2e-4)
    for name in ("n_alive", "max_cell_occupancy", "neighbor_truncated",
                 "out_of_bounds"):
        np.testing.assert_array_equal(getattr(tcnt, name).numpy(),
                                      np.asarray(getattr(jcnt, name)),
                                      err_msg=name)
    assert (tcnt.neighbor_truncated.numpy() == 0).all()


def _user_backend(state):
    """A user-written all-pairs index (tests/test_custom_backend.py's),
    not the built-in brute_neighbors."""
    n = state.position.shape[0]
    d = state.position[:, None, :] - state.position[None, :, :]
    dist = torch.sqrt((d * d).sum(-1))
    valid = (state.alive[:, None] & state.alive[None, :]
             & (dist < state.eyesight[:, None])
             & ~torch.eye(n, dtype=torch.bool))
    return tnbr.NeighborSet(
        idx=torch.arange(n).expand(n, n), valid=valid,
        max_cell_occupancy=torch.zeros((), dtype=torch.int32))


def test_custom_backend_matches_brute():
    """tests/test_custom_backend.py's scene, 10 steps of 0.1 s: the
    ``custom`` backend with a user ``neighbor_fn`` equals ``brute``."""
    grid = GridConfig(width=40.0, height=40.0, cell_size=2.0,
                      offset=(-20.0, -20.0))
    rng = np.random.default_rng(4)
    pts = rng.uniform(-8.0, 8.0, (12, 2))
    lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=5.0)
    hls = [ConstantVelocity((0.7, 0.0)), ConstantVelocity((-0.7, 0.0))]
    out = {}
    for backend, fn in (("brute", None), ("custom", _user_backend)):
        config = SimConfig(capacity=32, grid=grid, neighbor_backend=backend,
                           max_eyesight=4.0)
        st = convert.state_from_numpy(dict(
            position=np.concatenate([pts, np.zeros((20, 2))]).astype(
                np.float32),
            velocity=np.zeros((32, 2), np.float32),
            preferred_vel=np.zeros((32, 2), np.float32),
            next_waypoint=np.zeros(32, np.int32),
            eyesight=np.where(np.arange(32) < 12, 4.0, 0.0).astype(
                np.float32),
            alive=np.arange(32) < 12, uid=np.arange(32, dtype=np.int32),
            source_id=np.full(32, -1, np.int32),
            hl_idx=(np.arange(32) >= 6).astype(np.int32),
            lp_idx=np.zeros(32, np.int32), route_id=np.full(32, -1, np.int32),
            route_wp=np.zeros(32, np.int32),
            priority=np.arange(32, dtype=np.float32),
            sim_time=np.zeros((), np.float32),
            next_uid=np.asarray(12, np.int32)), device="cpu")
        params = SimParams(hl=tuple(h.init_params("cpu") for h in hls),
                           lp=(lp.init_params("cpu"),))
        st, c = build_rollout(config, hls, [lp], neighbor_fn=fn)(
            params, st, 0.1, 10)
        out[backend] = st.position.numpy()
    np.testing.assert_allclose(out["custom"], out["brute"], rtol=1e-6,
                               atol=1e-6)


def test_custom_backend_requires_fn():
    config = SimConfig(capacity=8, neighbor_backend="custom")
    with pytest.raises(ValueError, match="neighbor_fn"):
        build_step(config, [], [])
    with pytest.raises(ValueError, match="neighbor_fn"):
        build_rollout(config, [], [])


def query_scene(seed, tied):
    """Positions [n, 2] f32, alive [n]; ``tied``: agents on a 0.5 m
    lattice (many equal distances to a lattice-aligned point)."""
    rng = np.random.default_rng(seed)
    if tied:
        g = np.arange(-10, 10) * 0.5
        pos = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    else:
        pos = rng.uniform(-14.0, 14.0, (400, 2))
    alive = rng.random(pos.shape[0]) >= 0.15
    return pos.astype(np.float32), alive


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("point", [(0.0, 0.0), (13.0, 9.0)])
def test_spatial_queries_match_jax(tied, point):
    pos, alive = query_scene(1, tied)
    jp, ja = jnp.asarray(pos), jnp.asarray(alive)
    tp, ta = torch.as_tensor(pos), torch.as_tensor(alive)
    jpt = jnp.asarray(point, jnp.float32)
    tpt = torch.tensor(point, dtype=torch.float32)

    for radius in (0.5, 1.0, 3.0):
        np.testing.assert_array_equal(
            tnbr.neighbors_in_radius(tp, ta, radius, tpt).numpy(),
            np.asarray(jnbr.neighbors_in_radius(
                jp, ja, jnp.asarray(radius, jnp.float32), jpt)))

    grid_j, grid_t = J.GridConfig(**GRID), GridConfig(**GRID)
    jb = jgrid.bin_agents(grid_j, jp, ja)
    tb = tgrid.bin_agents(grid_t, tp, ta)
    for k in (1, 9):
        ji, jv = jnbr.nearest_neighbors(jp, ja, k, jpt)
        ti, tv = tnbr.nearest_neighbors(tp, ta, k, tpt)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        for ring in (1, 2):
            ji, jv, jo = jnbr.nearest_neighbors_grid(grid_j, jb, jp, ja, k,
                                                     jpt, ring)
            ti, tv, to = tnbr.nearest_neighbors_grid(grid_t, tb, tp, ta, k,
                                                     tpt, ring)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            assert int(to) == int(jo)
        ji, jv = jnbr.nearest_neighbors_tiered(grid_j, jb.starts, jb.order,
                                               jp, ja, k, jpt)
        ti, tv = tnbr.nearest_neighbors_tiered(grid_t, tb.starts, tb.order,
                                               tp, ta, k, tpt)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_tiered_query_falls_back_to_brute():
    """A crowd in one cell past the per-cell budget and a query whose k-th
    neighbour lies beyond ring 8: both leave the ladder for the exact
    brute query, as JAX's does."""
    rng = np.random.default_rng(2)
    pos = np.concatenate([rng.uniform(0.1, 1.9, (80, 2)),
                          [[19.0, 14.0], [-19.0, -14.0]]]).astype(np.float32)
    alive = np.ones(pos.shape[0], bool)
    jp, ja = jnp.asarray(pos), jnp.asarray(alive)
    tp, ta = torch.as_tensor(pos), torch.as_tensor(alive)
    jb = jgrid.bin_agents(J.GridConfig(**GRID), jp, ja)
    tb = tgrid.bin_agents(GridConfig(**GRID), tp, ta)
    for point, k in (((1.0, 1.0), 70), ((19.0, 14.0), 3)):
        ji, jv = jnbr.nearest_neighbors_tiered(
            J.GridConfig(**GRID), jb.starts, jb.order, jp, ja, k,
            jnp.asarray(point, jnp.float32))
        ti, tv = tnbr.nearest_neighbors_tiered(
            GridConfig(**GRID), tb.starts, tb.order, tp, ta, k,
            torch.tensor(point))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        bi, _ = tnbr.nearest_neighbors(tp, ta, k, torch.tensor(point))
        assert torch.equal(ti, bi)
