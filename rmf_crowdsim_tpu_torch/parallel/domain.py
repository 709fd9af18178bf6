"""Domain decomposition of the fused force pass over a mesh of shards.

Counterpart of ``rmf_crowdsim_tpu/parallel/domain.py``.  The packed plane
of the bucketed layout is a ``[tx * ty * bucket, NUM_F]`` grid of world
columns, so it shards by column:

- each shard owns a block of ``tx / D`` columns;
- the only remote rows a shard needs are one halo column from each
  neighbour (tile size >= eyesight), exchanged with ``Comm.exchange``;
- the ends of the world get sentinel halos (zeros would read as live
  agents at the origin);
- K1 runs on the block with its two halo columns (``tx = cols_per + 2``)
  and the halo queries' outputs are dropped.

The shards then gather their outputs, so every shard holds the whole
``[slots, 2]`` result, which the replicated rest of the step reads.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.zanlungo_bucketed import (
    NUM_CAND,
    BucketConfig,
    bucketize,
    sentinel_rows,
    zanlungo_forces_bucketed,
    zparams5,
)
from .comm import Comm, Mesh


def _local_forces(comm: Comm, cfg: BucketConfig, zp5, block, int_prio):
    """One shard: the halo exchange and K1 on the extended block; returns
    the shard's own ``[cols_per * col_slots, 2]`` rows."""
    d, i = comm.size, comm.axis_index()
    col_slots = cfg.ty * cfg.bucket
    cols_per = cfg.tx // d
    local_cfg = dataclasses.replace(cfg, tx=cols_per + 2)
    # My last column is the right neighbour's left halo, my first the
    # left neighbour's right halo.
    left, right = comm.exchange(block[-col_slots:], block[:col_slots])
    if i == 0:
        left = sentinel_rows(col_slots, block.device)
    if i == d - 1:
        right = sentinel_rows(col_slots, block.device)
    ext = torch.cat([left, block, right])
    out = zanlungo_forces_bucketed(local_cfg, zp5, ext,
                                   ext[:, :NUM_CAND].t().contiguous(),
                                   int_prio=int_prio)
    return out[col_slots:col_slots + cols_per * col_slots]


def forces_domain_sharded(mesh: Mesh, cfg: BucketConfig, zp5, packed_t,
                          int_prio: bool = False,
                          dual_row: bool = False) -> torch.Tensor:
    """K1 with the world's columns sharded over ``mesh``; ``cfg.tx`` must
    divide by the mesh size.  Returns the whole ``[slots, 2]`` output on
    every shard (``dual_row`` is accepted and ignored, as everywhere in
    the port)."""
    d = mesh.size
    if cfg.tx % d:
        raise ValueError(f"tx={cfg.tx} must divide over {d} shards")
    n_block = (cfg.tx // d) * cfg.ty * cfg.bucket
    blocks = [packed_t[r * n_block:(r + 1) * n_block]
              for r in mesh.local_ranks]

    def shard(comm, block):
        return comm.all_gather(_local_forces(comm, cfg, zp5, block,
                                             int_prio))

    return mesh.run(shard, blocks)[0]


def zanlungo_fused_domain(mesh: Mesh, cfg: BucketConfig, zp, position,
                          velocity, self_pref, pref_committed, priority,
                          eyesight, alive, rec_vel, int_prio: bool = False,
                          dual_row: bool = False):
    """``zanlungo_fused`` with the force pass domain-sharded over
    ``mesh``: the same signature plus the mesh, the same results.  No
    spill repair: bucket overflow surfaces through ``dropped``, as on the
    JAX package's branch (its NARROWING note, models/local.py:422-428).
    Returns (vel [N, 2], max tile occupancy, dropped)."""
    dtype = position.dtype
    packed_t, _packed_T, bucket_pos, max_occ, dropped = bucketize(
        cfg, position, velocity, pref_committed, self_pref, priority,
        eyesight, rec_vel, alive)
    out = forces_domain_sharded(mesh, cfg, zparams5(zp), packed_t,
                                int_prio=int_prio, dual_row=dual_row)
    ok = (bucket_pos < cfg.slots) & alive
    vel = out[torch.clamp(bucket_pos, 0, cfg.slots - 1).long()].to(dtype)
    return torch.where(ok[:, None], vel, rec_vel), max_occ, dropped
