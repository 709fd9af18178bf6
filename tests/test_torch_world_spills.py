"""The world-sharded engine's boundaries on the CPU: spills across a shard
boundary, the shard-capacity spawn drop, forces across a boundary, and
the process-group comm.

- Boundary hotspot (tests/test_worldstep.py:141-197): 40 agents over the
  two tiles at the x = 12 boundary of 8 regions overflow their buckets on
  both sides; the spill exchange and K2 on the extended blocks repair
  them with zero truncation, D = 8 equal to D = 1 and to the
  single-device rollout, in both invariance modes.
- Shard capacity (tests/test_worldstep.py:494-575): a spawn drops when
  its shard is full although the world has room, and uids advance by
  committed spawns only.
- Closing pair (tests/test_worldstep.py:578-666): two agents closing
  across a boundary feel each other, D = 8 bitwise D = 1.
- ``ProcessGroupComm`` over gloo at D = 2 equals ``ThreadComm`` at D = 2
  bit for bit on the streaming scene.
"""

import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu_torch import (
    ConstantVelocity,
    GridConfig,
    MonotonicCrowd,
    SimConfig,
    SourceSink,
    Zanlungo,
    make_state,
)
from rmf_crowdsim_tpu_torch.core.step import SimParams, build_rollout
from rmf_crowdsim_tpu_torch.models.source_sink import stack_source_params
from rmf_crowdsim_tpu_torch.parallel.comm import make_thread_mesh
from rmf_crowdsim_tpu_torch.parallel.sharding import gather_shards
from rmf_crowdsim_tpu_torch.parallel.worldstep import (
    build_world_rollout,
    shard_state_by_region,
)
from tests.torch_multidevice import (
    run_process_group,
    world_rollout_shard,
    world_scene,
)

TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(capacity, **kw):
    return SimConfig(
        capacity=capacity,
        grid=GridConfig(width=48.0, height=48.0, cell_size=3.0,
                        offset=(0.0, 0.0)),
        neighbor_backend="grid_pallas", max_eyesight=3.0,
        bucket_capacity=16, strip_tiles=6, sub_tiles=6, dtype="float32",
        **kw)


def _zanlungo(cap=10.0):
    return Zanlungo(agent_scale=1.0, obstacle_scale=1.0, reaction_time=0.0,
                    force_distance=1.0, agent_mass=2.0, agent_radius=0.25,
                    force_cap=cap)


def _crowd(cfg, pos, n_alive, hl_idx=None, seed=5):
    n = cfg.capacity
    f = torch.float32
    alive = torch.arange(n) < n_alive
    return make_state(cfg, seed=seed, device="cpu").replace(
        position=torch.as_tensor(pos, dtype=f),
        eyesight=torch.where(alive, 3.0, 0.0).to(f),
        alive=alive,
        uid=torch.arange(n, dtype=torch.int32),
        hl_idx=(torch.zeros(n, dtype=torch.int32) if hl_idx is None
                else torch.as_tensor(hl_idx, dtype=torch.int32)),
        lp_idx=torch.zeros(n, dtype=torch.int32),
        priority=torch.arange(n, dtype=f),
        next_uid=torch.tensor(n, dtype=torch.int32))


def hotspot_scene(invariance="bitwise", tile=0.0, capacity=512):
    cfg = _cfg(capacity, spill_capacity=32, on_truncation="ignore",
               sharding_invariance=invariance, bucket_tile_size=tile)
    hl, lp = ConstantVelocity((0.6, 0.2)), _zanlungo()
    rng = np.random.default_rng(12)
    pos = np.zeros((capacity, 2))
    pos[:80] = rng.uniform(3.0, 45.0, (80, 2))
    # ~20 agents in each 3 m tile touching x = 12: > bucket 16 on both
    # sides of the boundary.
    pos[:40] = rng.uniform(0.0, 1.0, (40, 2)) * [2.0, 1.0] + [11.0, 22.0]
    params = SimParams(hl=(hl.init_params("cpu"),),
                       lp=(lp.init_params("cpu"),), sources=None)
    return cfg, [hl], [lp], params, _crowd(cfg, pos, 80)


def _by_uid(st):
    uid = st.uid[st.alive]
    order = torch.argsort(uid)
    return uid[order], st.position[st.alive][order]


def _run_world(d, scene, dt, n_steps):
    cfg, hls, lps, params, st = scene
    mesh = make_thread_mesh(d, "cpu")
    shards, c = build_world_rollout(cfg, hls, lps, mesh)(
        params, shard_state_by_region(cfg, mesh, st), dt, n_steps)
    return _by_uid(gather_shards(shards)), c


@pytest.mark.parametrize("invariance,tile", [("bitwise", 0.0),
                                             ("tolerance", 4.0)])
def test_world_boundary_hotspot_repaired(invariance, tile):
    scene = hotspot_scene(invariance, tile)
    (u8, p8), c8 = _run_world(8, scene, 0.2, 8)
    (u1, p1), c1 = _run_world(1, scene, 0.2, 8)
    for c in (c8, c1):
        assert int(c.neighbor_truncated.sum()) == 0
        assert int(c.max_cell_occupancy.max()) > 16
    assert torch.equal(u8, u1)
    torch.testing.assert_close(p8, p1, rtol=1e-5, atol=1e-5)
    cfg, hls, lps, params, st = scene
    stg, cg = build_rollout(cfg, hls, lps)(params, st, 0.2, 8)
    assert int(cg.neighbor_truncated.max()) == 0
    ug, pg = _by_uid(stg)
    assert torch.equal(ug, u1)
    torch.testing.assert_close(pg, p1, rtol=TOL, atol=TOL)
    if invariance == "tolerance":
        assert int(c8.resorted.sum()) < 8 * 8


def test_world_shard_capacity_spawn_drop_divergence():
    """8 slots a shard on 8 shards; 8 motionless blockers fill shard 3,
    whose region holds the source: all 4 requests drop and next_uid stays
    (committed-count uids), while one device has room and spawns once
    (then its own spawn blocks the source, lib.rs:208-218)."""
    capacity = 64
    cfg = _cfg(capacity, on_truncation="ignore")
    hl, lp = ConstantVelocity((0.0, 0.0)), _zanlungo()
    src = SourceSink(source=(20.0, 20.0), waypoints=[(20.0, 40.0)],
                     radius_sink=1.0, crowd_generator=MonotonicCrowd(1.0),
                     high_level_planner=hl, local_planner=lp,
                     agent_eyesight_range=3.0)
    params = SimParams(
        hl=(hl.init_params("cpu"),), lp=(lp.init_params("cpu"),),
        sources=stack_source_params([src], [0], [0], [[-1]], cfg.tdtype,
                                    device="cpu"))
    pos = np.full((capacity, 2), 40.0)
    pos[:8] = np.stack([np.linspace(18.5, 23.5, 8), np.full(8, 30.0)], -1)
    st = _crowd(cfg, pos, 8, seed=2)
    mesh = make_thread_mesh(8, "cpu")
    shards, c8 = build_world_rollout(cfg, [hl], [lp], mesh)(
        params, shard_state_by_region(cfg, mesh, st), 0.5, 4)
    assert int(c8.spawn_dropped.sum()) == 4
    assert int(c8.n_alive[-1]) == 8
    assert max(int(s.next_uid) for s in shards) == capacity
    stg, cg = build_rollout(cfg, [hl], [lp])(params, st, 0.5, 4)
    assert cg.spawn_dropped.tolist() == [0, 1, 1, 1]
    assert int(cg.n_alive[-1]) == 9
    assert int(stg.next_uid) == capacity + 1


def test_world_cross_boundary_forces():
    """Two agents at x = 11 and 13 (regions 1 and 2 of 8) closing at 0.5
    m/s: finite time to collision, real forces across the boundary."""
    cfg = _cfg(16, on_truncation="raise")
    hls = [ConstantVelocity((0.5, 0.0)), ConstantVelocity((-0.5, 0.0))]
    lp = _zanlungo()
    pos = np.zeros((16, 2))
    pos[0], pos[1] = (11.0, 24.0), (13.0, 24.0)
    st = _crowd(cfg, pos, 2, hl_idx=[0, 1] + [0] * 14, seed=7)
    params = SimParams(hl=tuple(h.init_params("cpu") for h in hls),
                       lp=(lp.init_params("cpu"),), sources=None)
    scene = (cfg, hls, [lp], params, st)
    (u8, p8), _ = _run_world(8, scene, 1.0, 3)
    (u1, p1), _ = _run_world(1, scene, 1.0, 3)
    assert u8.tolist() == u1.tolist() == [0, 1]
    assert torch.equal(p8, p1)
    stg, _ = build_rollout(cfg, hls, [lp])(params, st, 1.0, 3)
    ug, pg = _by_uid(stg)
    assert (pg[0] - torch.tensor([11.0 + 1.5, 24.0])).abs().max() > 1e-3
    torch.testing.assert_close(p8, pg, rtol=1e-5, atol=1e-5)


def test_process_group_world_equals_thread_comm(tmp_path):
    # Agents reach the x = 24 boundary of 2 regions from step 15.
    n_steps = 20
    got = run_process_group(2, tmp_path, world_rollout_shard, n_steps)
    cfg, hl, lp, params, st = world_scene()
    mesh = make_thread_mesh(2, "cpu")
    shards, c = build_world_rollout(cfg, [hl], [lp], mesh)(
        params, shard_state_by_region(cfg, mesh, st), 1.0, n_steps)
    assert int(c.migrated.sum()) > 0
    for r in range(2):
        for k in ("position", "velocity", "alive", "uid"):
            np.testing.assert_array_equal(got[r][k],
                                          getattr(shards[r], k).numpy(),
                                          err_msg=f"shard {r} {k}")
        for k, v in vars(c).items():
            np.testing.assert_array_equal(got[r][f"c_{k}"], v.numpy(),
                                          err_msg=k)
