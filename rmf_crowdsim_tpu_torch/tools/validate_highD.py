"""High shard-count validation of the world-sharded engine, on the port.

Counterpart of ``tools/validate_highD.py``: the crossing scene's D-vs-1
checks (``scenes.crossing_scene``, 40 steps at dt 1) at D = 16 (or
``--d``) in both sharding-invariance modes, with the D shards on one
device over ``make_thread_mesh``, and the halo-overhead table of the 1M
bench world across D.

- bitwise (capacity 256): D equals D = 1 exactly, by uid, over more than
  20 agents, with migrations and no arrival dropped;
- tolerance (bucket tiles of 4 m, capacity 512, spill list 32): D within
  rtol = atol = 1e-5 of D = 1, the lifecycle counters equal.

Usage::

    python -m rmf_crowdsim_tpu_torch.tools.validate_highD [--d 16]
    python -m rmf_crowdsim_tpu_torch.tools.validate_highD --table-only

on the card; ``--device cpu`` runs it on the CPU.  Exits non-zero on any
failure.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import scenes
from ..parallel.comm import make_thread_mesh
from ..parallel.sharding import gather_shards
from ..parallel.worldstep import build_world_rollout, shard_state_by_region

HALO = 2  # spill mode: two halo tile columns a side
TABLE_D = (4, 8, 10, 16, 20, 32, 40, 64)
N_STEPS = 40
TOL = 1e-5
LIFECYCLE = ("n_alive", "n_spawned", "n_destroyed")


def halo_table(n_world: int = 1_000_000) -> list:
    """Prints, for each D of ``TABLE_D``, the bench world's tile columns
    padded to a multiple of D, the columns a shard owns, the halo's share
    of a shard's extended block (the kernels' cost scales with the block,
    the owned work with its columns) and the agents a shard holds.
    Returns the rows (D, tx_pad, cols/shard, halo fraction,
    agents/shard)."""
    b = scenes.bench_bucket_config(n_world)
    print(f"bench world: tx={b.tx} tile columns (tile {b.tile_size} m), "
          f"H={HALO} halo cols/side")
    print(f"{'D':>4} {'tx_pad':>7} {'cols/shard':>10} {'halo_frac':>10} "
          f"{'agents/shard':>12}")
    rows = []
    for d in TABLE_D:
        tx = b.tx + (-b.tx) % d
        cols = tx // d
        frac = 2 * HALO / (cols + 2 * HALO)
        print(f"{d:>4} {tx:>7} {cols:>10} {frac:>10.1%} "
              f"{n_world // d:>12,}")
        rows.append((d, tx, cols, frac, n_world // d))
    return rows


def run_world(d: int, device, invariance: str = "bitwise", tile: float = 0.0,
              capacity: int = 256, spill: int = 0):
    """The crossing scene's world rollout over ``d`` shards on ``device``:
    ({uid: (x, y, vx, vy, next waypoint)} of the live agents, the
    counters)."""
    cfg, hl, lp, params, st = scenes.crossing_scene(
        capacity, invariance=invariance, tile=tile, spill=spill,
        device=device)
    mesh = make_thread_mesh(d, device)
    shards = shard_state_by_region(cfg, mesh, st)
    shards, counters = build_world_rollout(cfg, [hl], [lp], mesh)(
        params, shards, 1.0, N_STEPS)
    g = gather_shards(shards)
    idx = torch.nonzero(g.alive).flatten().tolist()
    pos, vel = g.position.tolist(), g.velocity.tolist()
    uid, nwp = g.uid.tolist(), g.next_waypoint.tolist()
    return {uid[i]: (*pos[i], *vel[i], nwp[i]) for i in idx}, counters


def _total(counters, name) -> int:
    return int(getattr(counters, name).sum())


def validate(d: int, device="cuda") -> dict:
    """Both checks at ``d`` shards on ``device`` (the card unless the
    caller names another device); raises ``AssertionError`` on a
    failure.  Returns the figures it prints."""
    ab, cb = run_world(d, device)
    a1, _ = run_world(1, device)
    if ab.keys() != a1.keys() or len(ab) <= 20:
        raise AssertionError(f"bitwise {d}-vs-1: {len(ab)} agents against "
                             f"{len(a1)}, or other uids")
    differ = [k for k in ab if ab[k] != a1[k]]
    if differ:
        raise AssertionError(f"bitwise {d}-vs-1: {len(differ)} agents "
                             f"differ, e.g. uid {differ[0]}: "
                             f"{ab[differ[0]]} vs {a1[differ[0]]}")
    migrated = _total(cb, "migrated")
    if migrated == 0 or _total(cb, "arrival_dropped"):
        raise AssertionError(f"bitwise {d}-vs-1: {migrated} migrations, "
                             f"{_total(cb, 'arrival_dropped')} dropped")
    print(f"bitwise {d}-vs-1: EXACT over {len(ab)} agents, {migrated} "
          f"migrations", flush=True)

    kw = dict(invariance="tolerance", tile=4.0, capacity=512, spill=32)
    at, ct = run_world(d, device, **kw)
    a1t, c1t = run_world(1, device, **kw)
    if at.keys() != a1t.keys():
        raise AssertionError(f"tolerance {d}-vs-1: other uids alive")
    diff = 0.0
    for k in at:
        np.testing.assert_allclose(np.asarray(at[k]), np.asarray(a1t[k]),
                                   rtol=TOL, atol=TOL, err_msg=str(k))
        diff = max(diff, float(np.abs(np.subtract(at[k], a1t[k])).max()))
    for name in LIFECYCLE:
        if not torch.equal(getattr(ct, name), getattr(c1t, name)):
            raise AssertionError(f"tolerance {d}-vs-1: {name} differs")
    resorted = _total(ct, "resorted")
    n_steps = ct.resorted.shape[0]
    print(f"tolerance {d}-vs-1: allclose over {len(at)} agents (max abs "
          f"diff {diff}, tol {TOL}); resorts {resorted} of {d * n_steps} "
          f"shard-steps", flush=True)
    return {"d": d, "agents": len(ab), "migrations": migrated,
            "tolerance_agents": len(at), "tolerance_max_diff": diff,
            "resorted": resorted, "shard_steps": d * n_steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--table-only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    halo_table()
    if not args.table_only:
        validate(args.d, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
