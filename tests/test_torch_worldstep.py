"""The world-sharded engine (parallel/worldstep.py) on the CPU.

The scene is tests/test_worldstep.py:34-102 in both packages: sources on
the left edge, sinks on the right, agents crossing every region boundary.

- Against one shard of the port: D = 4 and 8 equal D = 1 bit for bit by
  uid in bitwise mode (``dual_row`` off and on), with agents migrating
  and none overflowing, dropped or stray, the lifecycle counters equal
  step by step; tolerance mode (``spill_capacity`` 0 and 32) within 2e-4
  with the counters equal, amortising its sorts.
- Against the JAX package: the port's D = 4 rollout against JAX's
  ``build_world_rollout`` on a 4-device mesh (its kernels in interpret
  mode), 40 steps, the length of the JAX test: positions and velocities
  by uid to 2e-4, the counters and the uid sets exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu_torch.parallel.comm import make_thread_mesh
from rmf_crowdsim_tpu_torch.parallel.sharding import gather_shards
from rmf_crowdsim_tpu_torch.parallel.worldstep import (
    build_world_rollout,
    build_world_step,
    init_world_skin,
    shard_state_by_region,
)
from tests.torch_multidevice import world_scene

TOL = 2e-4
LIFECYCLE = ("n_alive", "n_spawned", "n_destroyed", "n_waypoint_reached",
             "spawn_dropped")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def agents(shards):
    """{uid: (x, y, vx, vy, next_waypoint)} of the live agents."""
    g = gather_shards(shards)
    idx = torch.nonzero(g.alive).flatten().tolist()
    pos, vel = g.position.tolist(), g.velocity.tolist()
    uid, nwp = g.uid.tolist(), g.next_waypoint.tolist()
    return {uid[i]: (*pos[i], *vel[i], nwp[i]) for i in idx}


@functools.lru_cache(maxsize=None)
def run_world(d, n_steps=40, dual_row=False, invariance="bitwise", tile=0.0,
              capacity=128, spill=0):
    cfg, hl, lp, params, st = world_scene(capacity, dual_row, invariance,
                                          tile, spill)
    mesh = make_thread_mesh(d, "cpu")
    shards = shard_state_by_region(cfg, mesh, st)
    shards, c = build_world_rollout(cfg, [hl], [lp], mesh)(
        params, shards, 1.0, n_steps)
    return agents(shards), c


def _lifecycle_equal(ca, cb):
    for name in LIFECYCLE:
        assert torch.equal(getattr(ca, name), getattr(cb, name)), name


def _clean_migration(c):
    assert int(c.migrated.sum()) > 0
    assert int(c.migration_overflow.sum()) == 0
    assert int(c.arrival_dropped.sum()) == 0
    assert int(c.stray.sum()) == 0


@pytest.mark.parametrize("dual_row", [False, True])
@pytest.mark.parametrize("d", [4, 8])
def test_world_sharded_matches_one_shard_bitwise(d, dual_row):
    ad, cd = run_world(d, dual_row=dual_row)
    a1, c1 = run_world(1, dual_row=dual_row)
    _clean_migration(cd)
    assert int(c1.migrated.sum()) == 0
    assert ad.keys() == a1.keys() and len(ad) > 20
    for k in ad:
        assert ad[k] == a1[k], (k, ad[k], a1[k])
    _lifecycle_equal(cd, c1)
    assert int(cd.n_destroyed.sum()) > 0
    assert torch.equal(cd.resorted, torch.full_like(cd.resorted, d))


@pytest.mark.parametrize("spill", [0, 32])
def test_world_tolerance_matches_one_shard(spill):
    """bucket_tile_size 4 gives the mode its positive skin margin
    ((4 - 3) / 2); spill 32 turns on the riders (spawns and arrivals on
    the spill repair instead of re-sorts)."""
    kw = dict(invariance="tolerance", tile=4.0, capacity=256, spill=spill)
    a8, c8 = run_world(8, **kw)
    a1, c1 = run_world(1, **kw)
    _clean_migration(c8)
    assert a8.keys() == a1.keys() and len(a8) > 20
    for k in a8:
        np.testing.assert_allclose(a8[k][:4], a1[k][:4], rtol=TOL, atol=TOL,
                                   err_msg=str(k))
        assert a8[k][4] == a1[k][4]
    _lifecycle_equal(c8, c1)
    # The mode's point: fewer sorts than one a shard a step.
    assert int(c8.resorted.sum()) < 8 * c8.resorted.shape[0]


def test_world_step_threads_the_skin_carry():
    """``build_world_step`` in tolerance mode: one step at a time with the
    carry from ``init_world_skin`` equals the rollout."""
    cfg, hl, lp, params, st = world_scene(256, invariance="tolerance",
                                          tile=4.0, spill=32)
    mesh = make_thread_mesh(4, "cpu")
    step = build_world_step(cfg, [hl], [lp], mesh)
    assert step.tolerance_mode
    shards = shard_state_by_region(cfg, mesh, st)
    skins = init_world_skin(cfg, mesh)
    migrated = 0
    for _ in range(12):
        shards, events, diag, skins = step(params, shards, 1.0, skins)
        assert len(events) == 4
        migrated += int(diag.migrated)
    roll = build_world_rollout(cfg, [hl], [lp], mesh)
    shards_r, c = roll(params, shard_state_by_region(cfg, mesh, st), 1.0, 12)
    assert migrated == int(c.migrated.sum()) > 0
    assert agents(shards) == agents(shards_r)


def _jax_world(d, n_steps):
    from tests.test_worldstep import run_world as jax_run_world

    a, c, _ = jax_run_world(d, n_steps=n_steps)
    return a, jax.device_get(c)


def test_world_matches_jax_world_rollout():
    """40 steps: the port's single-device rollout already agrees with
    JAX's on this scene, and the world engines agree to 2e-4 over all of
    them."""
    aj, cj = _jax_world(4, 40)
    ap, cp = run_world(4)
    assert aj.keys() == ap.keys()
    for k in aj:
        np.testing.assert_allclose(np.asarray(aj[k][:4], np.float64),
                                   ap[k][:4], rtol=TOL, atol=TOL,
                                   err_msg=str(k))
        assert int(aj[k][4]) == ap[k][4]
    for name in LIFECYCLE + ("migrated", "migration_overflow",
                             "arrival_dropped", "stray", "out_of_bounds"):
        np.testing.assert_array_equal(np.asarray(getattr(cj, name)),
                                      getattr(cp, name).numpy(),
                                      err_msg=name)
