"""Dry run of the three multi-device engines over a mesh of D shards.

Counterpart of ``__graft_entry__.dryrun_multichip``: where the JAX package
runs its engines on D virtual CPU devices, this runs the port's on a
``ThreadMesh`` of D shards in one process, on the card unless the caller
asks for the CPU:

1. the agent-sharded full step (``parallel/sharding.py``) on the
   flagship scene, a two-way crossing crowd with Zanlungo avoidance on the
   grid backend fed by two SourceSinks;
2. the full step with its force pass domain-decomposed over the world's
   columns (``build_step(world_mesh=...)``, ``parallel/domain.py``);
3. a 12-step world-sharded rollout with migration
   (``parallel/worldstep.py``), which must lose no arrival and leave no
   agent stray.

Run: ``python -m rmf_crowdsim_tpu_torch.dryrun [D] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .core.config import GridConfig, SimConfig
from .core.state import make_state
from .core.step import SimParams, build_step
from .models.highlevel import ParityVelocity
from .models.local import Zanlungo
from .models.source_sink import MonotonicCrowd, SourceSink, stack_source_params
from .parallel.comm import make_thread_mesh
from .parallel.sharding import build_sharded_step, gather_shards, shard_state
from .parallel.worldstep import build_world_rollout, shard_state_by_region


def _planners():
    return (ParityVelocity((1.0, 0.0)),
            Zanlungo(agent_scale=1.0, obstacle_scale=1.0, reaction_time=0.0,
                     force_distance=2.0, agent_mass=2.0, agent_radius=0.25))


def _crowd(config: SimConfig, pos: np.ndarray, n_alive: int, eyesight,
           device):
    """``config``'s state with agents at ``pos`` [capacity, 2], the first
    ``n_alive`` of them alive."""
    n = config.capacity
    f = config.tdtype
    i32 = torch.int32
    alive = torch.arange(n, device=device) < n_alive
    return make_state(config, device=device).replace(
        position=torch.as_tensor(pos, dtype=f).to(device),
        eyesight=torch.where(alive, eyesight, 0.0).to(f),
        alive=alive,
        uid=torch.arange(n, dtype=i32, device=device),
        hl_idx=torch.zeros((n,), dtype=i32, device=device),
        lp_idx=torch.zeros((n,), dtype=i32, device=device),
        priority=torch.arange(n, dtype=f, device=device),
        next_uid=torch.full((), n, dtype=i32, device=device))


def _sources(config, hl, lp, ends, eyesight, device):
    sources = [SourceSink(source=a, waypoints=[b], radius_sink=1.0,
                          crowd_generator=MonotonicCrowd(1.0),
                          high_level_planner=hl, local_planner=lp,
                          agent_eyesight_range=eyesight)
               for a, b in ends]
    k = len(sources)
    return stack_source_params(sources, [0] * k, [0] * k, [[-1]] * k,
                               config.tdtype, device=device)


def flagship(capacity: int, n_agents: int, device="cuda"):
    """__graft_entry__.py:42-111: the crossing crowd on the grid backend
    (uniform in a square of side ``max(64, 2 sqrt(capacity))``, seed 0)
    with two SourceSinks.  Returns (config, hl, lp, params, state)."""
    side = max(64.0, float(np.sqrt(capacity)) * 2.0)
    config = SimConfig(
        capacity=capacity,
        grid=GridConfig(width=side, height=side, cell_size=4.0,
                        offset=(-side / 2, -side / 2)),
        neighbor_backend="grid", max_per_cell=8, max_eyesight=4.0,
        dtype="float32")
    hl, lp = _planners()
    lim = side / 2 - 2.0
    pos = np.random.default_rng(0).uniform(-lim, lim, size=(capacity, 2))
    state = _crowd(config, pos.astype(np.float32), n_agents, 4.0, device)
    sp = _sources(config, hl, lp, [((-lim, 0.0), (lim, 0.0)),
                                   ((lim, 1.0), (-lim, 1.0))], 4.0, device)
    params = SimParams(hl=(hl.init_params(device),),
                       lp=(lp.init_params(device),), sources=sp)
    return config, hl, lp, params, state


def dryrun(n_shards: int = 8, device="cuda") -> dict:
    """Run the three engines over a ``ThreadMesh`` of ``n_shards`` shards
    on ``device`` (the card unless the caller names another device),
    print one line per mode, and return their results."""
    mesh = make_thread_mesh(n_shards, device)
    dev = mesh.device
    out = {}

    # 1. The agent-sharded full step.
    capacity = 16 * n_shards
    config, hl, lp, params, state = flagship(capacity, capacity // 2, dev)
    sstep = build_sharded_step(config, [hl], [lp], mesh)
    shards, _ = sstep(params, shard_state(mesh, state), 1.0 / 60.0)
    n_alive = int(gather_shards(shards).num_alive)
    out["agent_sharded"] = dict(alive=n_alive)
    print(f"dryrun[agent-sharded]: {n_shards} shards, capacity {capacity}, "
          f"{n_alive} alive after one step")

    # 2. The full step with the force pass domain-decomposed.
    world = 16.0 * n_shards
    dcfg = SimConfig(
        capacity=capacity,
        grid=GridConfig(width=world, height=16.0, cell_size=2.0,
                        offset=(0.0, 0.0)),
        neighbor_backend="grid_pallas", max_eyesight=2.0,
        bucket_capacity=16, strip_tiles=6, sub_tiles=6, dtype="float32")
    rng = np.random.default_rng(0)
    pos = np.stack([rng.uniform(1.0, world - 1.0, capacity),
                    rng.uniform(1.0, 15.0, capacity)], -1)
    dstate = _crowd(dcfg, pos, capacity, 2.0, dev)
    dparams = SimParams(hl=(hl.init_params(dev),),
                        lp=(lp.init_params(dev),), sources=None)
    dstep = build_step(dcfg, [hl], [lp], world_mesh=mesh)
    dnew, dev_ev = dstep(dparams, dstate, 1.0 / 60.0)
    out["domain_sharded"] = dict(
        alive=int(dnew.num_alive),
        max_tile_occupancy=int(dev_ev.max_cell_occupancy))
    print(f"dryrun[domain-sharded full step]: world sharded over {n_shards} "
          f"shards, {out['domain_sharded']['alive']} alive, max tile "
          f"occupancy {out['domain_sharded']['max_tile_occupancy']}, ok")

    # 3. The world-sharded rollout with migration.
    wside = 6.0 * max(8, n_shards)
    wcfg = dataclasses.replace(
        dcfg, grid=GridConfig(width=wside, height=48.0, cell_size=3.0,
                              offset=(0.0, 0.0)),
        max_eyesight=3.0, on_truncation="ignore")
    wparams = SimParams(
        hl=(hl.init_params(dev),), lp=(lp.init_params(dev),),
        sources=_sources(wcfg, hl, lp,
                         [((2.0, y), (wside - 2.0, y)) for y in (16.0, 32.0)],
                         3.0, dev))
    wshards = shard_state_by_region(wcfg, mesh,
                                    make_state(wcfg, seed=3, device=dev))
    wshards, wc = build_world_rollout(wcfg, [hl], [lp], mesh)(
        wparams, wshards, 1.0, 12)
    lost, stray = int(wc.arrival_dropped.sum()), int(wc.stray.sum())
    if lost or stray:
        raise AssertionError(f"world rollout: {lost} arrivals dropped, "
                             f"{stray} stray")
    out["world_sharded"] = dict(
        alive=int(gather_shards(wshards).num_alive),
        migrated=int(wc.migrated.sum()), arrival_dropped=lost, stray=stray)
    print(f"dryrun[world-sharded whole step]: {n_shards}-shard 12-step "
          f"rollout, {out['world_sharded']['alive']} alive, "
          f"{out['world_sharded']['migrated']} cross-shard migrations, ok")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shards", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="device of the shards (cpu to run without a card)")
    args = ap.parse_args(argv)
    dryrun(args.shards, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
