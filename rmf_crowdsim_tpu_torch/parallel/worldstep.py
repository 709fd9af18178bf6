"""The world-sharded engine: the whole step, domain-decomposed over a
mesh of shards, with agents migrating between them.

Counterpart of ``rmf_crowdsim_tpu/parallel/worldstep.py``.  Each shard
runs the entire step (spawn, planners, the fused force pass, integration,
waypoint bookkeeping, despawn) on the agents of its own region, and
talks to its neighbours through a :class:`~.comm.Comm`:

- The world's ``tx`` tile columns (rounded up to a multiple of D) split
  into D regions of ``cols_per`` columns; shard ``i`` owns region ``i``
  and holds ``m = N / D`` slots.
- Forces: each shard bins its agents into an extended block, its region
  plus H halo columns a side (H = 2 with the spill repair, else 1), fills
  the halo columns from its neighbours, and runs K3 and K1 on the block.
  Halo rows carry their ids plus ``m`` (left) or ``2m`` (right), so the
  kernels' self test cannot mask a real neighbour.
- Bucket overflow (``spill_capacity`` > 0) is repaired exactly: the
  shards exchange their spills with both neighbours, sort the merged list
  by uid, and K2 repairs it on the extended block.  K2 writes the rows it
  repairs by id, so it writes into a scratch of ``3m`` + the list's rows,
  of which the shard keeps the first ``m``: rows of halo agents and of
  the neighbours' spills never reach the shard's state.
- Migration: after integration, agents whose column left the region are
  compacted into ``k_mig`` records a side and sent to the neighbour, which
  puts them into its first free slots.
- Spawns: every shard draws the same requests from its copy of the
  generator; the 0.4 m clearance is a ``psum`` of the shards' tests; a
  source's agent takes a free slot on the shard that owns the source, and
  uids advance by the ``psum`` of committed spawns.

``sharding_invariance == "bitwise"``: each shard bins in the canonical
``(tile, uid)`` order (a uid sort feeding bucketize's stable tile sort),
so every tile's content and order are independent of slot history, and
the force sums of D shards equal one shard's bit for bit.  Unlike the JAX
engine, which bins positions shifted by a float per shard and adds the
shift back to the packed x, the port bins the global position and
subtracts an integer column offset (``tile_coords``' ``col_shift``), and
decides regions by the same global column: the packed rows carry the
global position as it is and no shard's float rounding enters the
binning, so the invariance also holds where positions round differently
in shifted frames (any world that is not a few integers wide).  One
divergence from one device remains: a spawn is dropped when its shard
is full although the world has room.

``"tolerance"``: each shard keeps its state tile-sorted across steps with
the skin-deferred presort, re-sorting only when an agent outruns the skin
margin ``(tile_size - max_eyesight) / 2``, when the carry is invalid, or
when riders and spills fill 3/4 of the spill list.  Deaths (despawns,
departures) pack inert; new agents (spawns, arrivals) ride the spill
repair, unbinned, until the next re-sort (without the spill repair a
spawn forces a re-sort and an arrival invalidates the carry).  The skin
decision is the shard's one host read a step.  Neighbour sets and forces
stay exact; only the f32 sum order depends on shard history, so D shards
agree with one to tolerance, and the lifecycle counters exactly.

Scope: the grid_pallas backend; local planners are fused (``Zanlungo``)
or need no neighbours.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..core.config import BACKEND_GRID_PALLAS, SimConfig
from ..core.state import STATE_TENSOR_FIELDS, SimState, TensorDataclass
from ..core.state import make_state
from ..core.step import (
    SimParams,
    _finish_phase,
    _hl_phase,
    _stack,
    payload_sort_by_key,
    spawn_blocked,
    spawn_requests,
    spawn_write,
)
from ..ops.compact import compact_indices
from ..ops.spill import spill_rows, spill_window
from ..ops.zanlungo_bucketed import (
    NUM_CAND,
    ROW_ID,
    BucketConfig,
    bucketize,
    rank_from_sorted_key,
    sentinel_rows,
    tile_coords,
    tile_key,
    zanlungo_forces_bucketed,
    zparams5,
)
from .comm import Mesh
from .sharding import clone_generator

I32_MAX = 2 ** 31 - 1

# The fields a migrating agent carries (alive travels as the uid's sign).
MIGRATE_FIELDS = ("position", "velocity", "preferred_vel", "next_waypoint",
                  "eyesight", "uid", "source_id", "hl_idx", "lp_idx",
                  "route_id", "route_wp", "priority")


@dataclasses.dataclass(frozen=True)
class WorldDiag(TensorDataclass):
    """Per-step diagnostics of the world engine, global (summed over the
    shards).  Nonzero ``migration_overflow`` or ``arrival_dropped`` mean
    agents were left in the wrong region or lost: callers must surface
    both."""

    migrated: torch.Tensor            # [] int32 — agents that changed shard
    migration_overflow: torch.Tensor  # [] int32 — leavers past k_mig (stay)
    arrival_dropped: torch.Tensor     # [] int32 — arrivals with no free slot
    stray: torch.Tensor               # [] int32 — agents outside their
    #                                   shard's region at force time
    resorted: torch.Tensor            # [] int32 — shards that sorted (D a
    #                                   step in bitwise mode)


@dataclasses.dataclass(frozen=True)
class WorldCounters(TensorDataclass):
    """Per-step global counters of the world rollout, each [T] int32."""

    n_alive: torch.Tensor
    n_spawned: torch.Tensor
    n_destroyed: torch.Tensor
    n_waypoint_reached: torch.Tensor
    spawn_dropped: torch.Tensor
    out_of_bounds: torch.Tensor
    max_cell_occupancy: torch.Tensor
    neighbor_truncated: torch.Tensor
    migrated: torch.Tensor
    migration_overflow: torch.Tensor
    arrival_dropped: torch.Tensor
    stray: torch.Tensor
    resorted: torch.Tensor


@dataclasses.dataclass(frozen=True)
class WorldGeometry:
    """The static layout of a world over ``d`` shards: the world's bucket
    config ``cfg0``, ``cols_per`` columns a region, ``halo`` columns a
    side, the extended block's config ``ext_cfg``, the spill list's
    ``s_cap`` rows, ``m`` slots a shard."""

    cfg0: BucketConfig
    d: int
    cols_per: int
    halo: int
    ext_cfg: BucketConfig
    use_spills: bool
    s_cap: int
    m: int

    @classmethod
    def create(cls, config: SimConfig, d: int) -> "WorldGeometry":
        cfg0 = BucketConfig.create(
            config.grid.width, config.grid.height, config.grid.offset,
            config.max_eyesight, bucket=config.bucket_capacity,
            strip_tiles=config.strip_tiles, sub_tiles=config.sub_tiles,
            tile_size=config.bucket_tile_size or None)
        tx = -(-cfg0.tx // d) * d
        cols_per = tx // d
        # The spill repair reads 5x5 tile windows: two halo columns, and
        # a block of >= 5 tiles each way (worldstep.py:214-222).
        s_cap = -(-max(16, int(config.spill_capacity)) // 16) * 16
        use_spills = (config.spill_capacity > 0 and cols_per >= 2
                      and cfg0.ty >= 5)
        halo = 2 if use_spills else 1
        if config.capacity % d:
            raise ValueError(f"capacity {config.capacity} must divide over "
                             f"{d} shards")
        return cls(cfg0=cfg0, d=d, cols_per=cols_per, halo=halo,
                   ext_cfg=dataclasses.replace(cfg0,
                                               tx=cols_per + 2 * halo),
                   use_spills=use_spills, s_cap=s_cap,
                   m=config.capacity // d)

    @property
    def col_slots(self) -> int:
        return self.cfg0.ty * self.cfg0.bucket

    def col_shift(self, i: int) -> int:
        """Global column minus extended-block column on shard ``i``."""
        return i * self.cols_per - self.halo

    def col_clip(self, i: int):
        """Shard ``i``'s binning bounds: the block, narrowed on the edge
        shards to the world's outermost real column, where out-of-world
        agents bin as on one device (worldstep.py:346-358)."""
        lo = self.halo if i == 0 else 0
        hi = (self.cols_per + self.halo - 1 if i == self.d - 1
              else self.ext_cfg.tx - 1)
        return lo, hi

    def global_col(self, x: torch.Tensor) -> torch.Tensor:
        """[N] int32 world tile column of x, unclipped: the float
        operations of ``tile_coords``."""
        inv_tile = 1.0 / self.cfg0.tile_size
        return torch.floor((x - self.cfg0.offset[0]) * inv_tile).to(
            torch.int32)

    def region(self, x: torch.Tensor) -> torch.Tensor:
        """[N] int32 region (shard) of x, clipped into [0, d)."""
        return torch.clamp(torch.div(self.global_col(x), self.cols_per,
                                     rounding_mode="floor"), 0, self.d - 1)


def _compact_rows(mask, k: int, arrays: dict):
    """``arrays[mask]`` in fixed ``k`` rows, first slot first: int rows
    -1 filled, float rows 0 filled.  Returns (records, n past k)."""
    c = compact_indices(mask, k)
    safe = torch.clamp(c.idx, 0, mask.shape[0] - 1).long()
    out = {}
    for name, arr in arrays.items():
        fill = -1 if not arr.dtype.is_floating_point else 0
        v = c.valid.reshape((k,) + (1,) * (arr.dim() - 1))
        out[name] = torch.where(v, arr[safe],
                                torch.full((), fill, dtype=arr.dtype,
                                           device=arr.device))
    return out, c.n_over


def _insert(arr: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor):
    """``arr`` with rows ``tgt`` set to ``vals``; rows whose target is
    ``len(arr)`` are dropped."""
    out = torch.cat([arr, arr[:1]])
    out[tgt] = vals
    return out[:arr.shape[0]]


def empty_world_skin(m: int, dtype: torch.dtype, device) -> dict:
    """One shard's skin carry before its first sort (``valid`` False)."""
    i32 = torch.int32
    return dict(key=torch.zeros((m,), dtype=i32, device=device),
                bpos=torch.zeros((m,), dtype=i32, device=device),
                ref=torch.zeros((m, 2), dtype=dtype, device=device),
                max_occ=torch.zeros((), dtype=i32, device=device),
                n_over=torch.zeros((), dtype=i32, device=device),
                valid=torch.zeros((), dtype=torch.bool, device=device))


def init_world_skin(config: SimConfig, mesh: Mesh) -> list:
    """Fresh (invalid) skin carries of a tolerance-mode world step, one a
    local shard on the mesh's device: the first step sorts every shard."""
    m = config.capacity // mesh.size
    return [empty_world_skin(m, config.tdtype, mesh.device)
            for _ in mesh.local_ranks]


def _world_body(config: SimConfig, hl_planners, lp_planners, d: int,
                migration_capacity: int):
    """The per-shard step body ``local_step(comm, params, st, dt, skin)
    -> (st, events, diag, skin)`` and the geometry."""
    if config.neighbor_backend != BACKEND_GRID_PALLAS:
        raise ValueError("the world-sharded engine needs the grid_pallas "
                         "backend")
    for p in lp_planners:
        if getattr(p, "needs_neighbors", True) and not hasattr(
                p, "plan_fused"):
            raise ValueError("world-sharded local planners must be fused "
                             "(Zanlungo) or need no neighbours")
    g = WorldGeometry.create(config, d)
    ext = g.ext_cfg
    m, H, cols_per, col_slots = g.m, g.halo, g.cols_per, g.col_slots
    k_mig = int(migration_capacity) or max(8, m // 64)
    f = config.tdtype
    i32 = torch.int32
    tol = config.sharding_invariance == "tolerance"
    skin_margin = (float(g.cfg0.tile_size) - float(config.max_eyesight)) / 2
    if tol and skin_margin <= 0.0:
        raise ValueError(
            "sharding_invariance='tolerance' needs tile_size > max_eyesight "
            f"(margin {skin_margin}); use bucket_tile_size")
    int_prio = config.integer_priorities

    def spawn_phase(comm, sp, st: SimState, dt: float):
        """Phase A (lib.rs:199-254) with shard-local slots and global
        uids (worldstep.py:246-325)."""
        i, s = comm.axis_index(), sp.source.shape[0]
        n_req = spawn_requests(sp, dt, st.generator)
        blocked = comm.psum(spawn_blocked(
            st.position, st.alive, sp.source,
            config.spawn_clearance).to(i32)) > 0
        want = (n_req > 0) & ~blocked
        mine = want & (g.region(sp.source[:, 0]) == i)
        local_rank = torch.cumsum(mine.to(i32), 0, dtype=i32) - 1
        free = compact_indices(~st.alive, s)
        can = mine & (local_rank < free.count)
        slot = free.idx[torch.clamp(local_rank, 0, s - 1).long()]
        tgt = torch.where(can, torch.clamp(slot, 0, m - 1), m)
        # Each source belongs to one shard: the psum of the commits is
        # the global commit vector, and uids advance by it.
        can_global = comm.psum(can.to(i32)) > 0
        rank_global = torch.cumsum(can_global.to(i32), 0, dtype=i32) - 1
        n_new = can_global.sum(dtype=i32)
        st, spawned = spawn_write(st, sp, tgt,
                                  (st.next_uid + rank_global).to(i32), n_new)
        return st, spawned, n_req.sum(dtype=i32) - n_new

    def spill_patch(comm, st, rec_vel, self_pref, bucket_pos, tiles,
                    packed_t, packed_T, zp5, vel):
        """The exact repair of bucket overflow on the extended block
        (worldstep.py:491-695): the shard's spills (global positions, uid,
        global tile) exchanged with both neighbours, the merged list in
        uid order, K2 into a scratch.  Returns (vel, n_spill, n_past)."""
        i = comm.axis_index()
        shift = g.col_shift(i)
        c_sp, rows, sp_tcx, sp_tcy = spill_rows(
            ext, st.position, st.velocity, self_pref, st.preferred_vel,
            st.priority, st.eyesight, st.alive, rec_vel, bucket_pos,
            g.s_cap, tile_xy=tiles)
        sc = torch.clamp(c_sp.idx, 0, m - 1).long()
        meta = torch.stack([
            torch.where(c_sp.valid, st.uid[sc], I32_MAX),
            sp_tcx + shift, sp_tcy], 1)
        mine = dict(rows=rows, meta=meta)
        from_left, from_right = comm.exchange(mine, mine)

        def none():
            r = torch.zeros_like(rows)
            r[:, ROW_ID] = -1.0
            return dict(rows=r, meta=torch.full_like(meta, I32_MAX))
        if i == 0:
            from_left = none()
        if i == d - 1:
            from_right = none()
        rows_a = torch.cat([rows, from_left["rows"], from_right["rows"]])
        meta_a = torch.cat([meta, from_left["meta"], from_right["meta"]])
        valid_a = rows_a[:, ROW_ID] >= 0
        order = torch.sort(torch.where(valid_a, meta_a[:, 0], I32_MAX),
                           stable=True).indices
        rows_m, meta_m, valid_m = rows_a[order], meta_a[order], valid_a[order]
        n_list = rows_m.shape[0]
        # Own spills keep their index (K2 writes their rows into the
        # shard's velocities); the neighbours' get ids past every packed
        # (< m) and halo (< 3m) id, and their rows land in the scratch.
        own = order < g.s_cap
        ids = torch.where(
            own, rows_m[:, ROW_ID],
            torch.arange(n_list, dtype=torch.float32, device=rows.device)
            + float(3 * m))
        rows_m[:, ROW_ID] = torch.where(valid_m, ids, -1.0)
        lo, hi = g.col_clip(i)
        tcx = torch.where(valid_m, torch.clamp(meta_m[:, 1] - shift, lo, hi),
                          1).to(i32).contiguous()
        tcy = torch.where(valid_m, torch.clamp(meta_m[:, 2], 0, ext.ty - 1),
                          1).to(i32).contiguous()
        scratch = torch.zeros((3 * m + n_list, 2), dtype=vel.dtype,
                              device=vel.device)
        scratch[:m] = vel
        spill_window(ext, zp5, packed_t, packed_T, rows_m.contiguous(), tcx,
                     tcy, scratch, int_prio=int_prio)
        return scratch[:m], c_sp.count, c_sp.n_over

    def local_forces(comm, st: SimState, rec_vel, self_pref, zp,
                     carried=None):
        """The shard's bucketize, halo splice, K1 and spill repair
        (worldstep.py:327-489).  ``carried`` (tolerance mode): the
        state is tile-sorted and (key, bpos, max_occ, n_over) carried.
        Returns (vel [m, 2], max_occ, dropped, stray)."""
        i = comm.axis_index()
        shift, clip = g.col_shift(i), g.col_clip(i)
        dev = st.position.device
        tcx, tcy = tile_coords(ext, st.position, clip, shift)
        # Agents binned outside the shard's own columns (mid-migration or
        # transiting): their rows are overwritten by the halo splice.
        stray = (st.alive & ((tcx < H) | (tcx >= cols_per + H))).sum(
            dtype=i32)
        if carried is not None:
            key_c, bpos_c, occ_c, nover_c = carried
            packed_t, _, bucket_pos, occ, dropped = bucketize(
                ext, st.position, st.velocity, st.preferred_vel, self_pref,
                st.priority, st.eyesight, rec_vel, st.alive,
                use_pack_kernel=config.use_pack_kernel, presorted=True,
                binning=(bpos_c, occ_c, nover_c))
            t = torch.clamp(key_c, 0, ext.n_tiles - 1)
            tiles = (t // ext.ty, t % ext.ty)
        else:
            # Canonical (tile, uid) order: a uid sort feeding bucketize's
            # stable tile sort.
            ord_u = torch.sort(torch.where(st.alive, st.uid, I32_MAX),
                               stable=True).indices
            packed_t, _, bpos_perm, occ, dropped = bucketize(
                ext, st.position[ord_u], st.velocity[ord_u],
                st.preferred_vel[ord_u], self_pref[ord_u],
                st.priority[ord_u], st.eyesight[ord_u], rec_vel[ord_u],
                st.alive[ord_u], use_pack_kernel=config.use_pack_kernel,
                col_clip=clip, col_shift=shift)
            bucket_pos = torch.empty_like(bpos_perm)
            bucket_pos[ord_u] = bpos_perm
            # Packed ids name rows of the permuted input; make them the
            # agents' own indices, which K2 writes to.
            pid = packed_t[:, ROW_ID]
            packed_t[:, ROW_ID] = torch.where(
                pid >= 0, ord_u[torch.clamp(pid, min=0).long()].float(),
                -1.0)
            tiles = (tcx, tcy)

        # Halo exchange: my last H real columns are the right neighbour's
        # left halo, my first H the left neighbour's right halo.
        hs = H * col_slots
        left, right = comm.exchange(
            packed_t[cols_per * col_slots:(cols_per + H) * col_slots],
            packed_t[hs:2 * hs])
        if i == 0:
            left = sentinel_rows(hs, dev)
        else:
            left[:, ROW_ID] = torch.where(left[:, ROW_ID] >= 0,
                                          left[:, ROW_ID] + float(m), -1.0)
        if i == d - 1:
            right = sentinel_rows(hs, dev)
        else:
            right[:, ROW_ID] = torch.where(right[:, ROW_ID] >= 0,
                                           right[:, ROW_ID] + float(2 * m),
                                           -1.0)
        packed_t = torch.cat([left, packed_t[hs:(cols_per + H) * col_slots],
                              right])
        packed_T = packed_t[:, :NUM_CAND].t().contiguous()
        zp5 = zparams5(zp)
        out = zanlungo_forces_bucketed(ext, zp5, packed_t, packed_T,
                                       int_prio=int_prio)
        ok = (bucket_pos < ext.slots) & st.alive
        vel = out[torch.clamp(bucket_pos, 0, ext.slots - 1).long()].to(f)
        vel = torch.where(ok[:, None], vel, rec_vel)
        if g.use_spills:
            vel, n_sp, n_past = spill_patch(comm, st, rec_vel, self_pref,
                                            bucket_pos, tiles, packed_t,
                                            packed_T, zp5, vel)
            # bucketize counted every spill; only those past the list
            # stay unresolved.
            dropped = n_past + torch.clamp(dropped - n_sp, min=0)
        return vel, occ, dropped.to(i32), stray

    def migrate(comm, st: SimState):
        """Send agents whose column left the region to the neighbour
        (worldstep.py:697-782).  Returns (state, [migrated, overflow,
        lost] summed over shards, arrival slots [m] bool)."""
        i = comm.axis_index()
        dev = st.position.device
        col = g.global_col(st.position[:, 0])
        none = torch.zeros((m,), dtype=torch.bool, device=dev)
        go_l = st.alive & (col < i * cols_per) if i > 0 else none
        go_r = (st.alive & (col >= (i + 1) * cols_per) if i < d - 1
                else none)
        fields = {k: getattr(st, k) for k in MIGRATE_FIELDS}
        send_l, over_l = _compact_rows(go_l, k_mig, fields)
        send_r, over_r = _compact_rows(go_r, k_mig, fields)
        # Leavers past the buffer stay and retry next step.
        left_ok = go_l & (torch.cumsum(go_l.to(i32), 0) <= k_mig)
        right_ok = go_r & (torch.cumsum(go_r.to(i32), 0) <= k_mig)
        from_left, from_right = comm.exchange(send_r, send_l)
        nobody = torch.zeros((k_mig,), dtype=torch.bool, device=dev)
        lv = from_left["uid"] >= 0 if i > 0 else nobody
        rv = from_right["uid"] >= 0 if i < d - 1 else nobody
        alive = st.alive & ~(left_ok | right_ok)
        avalid = torch.cat([lv, rv])
        a_rank = torch.cumsum(avalid.to(i32), 0, dtype=i32) - 1
        free = compact_indices(~alive, 2 * k_mig)
        can = avalid & (a_rank < free.count)
        slot = free.idx[torch.clamp(a_rank, 0, 2 * k_mig - 1).long()]
        tgt = torch.where(can, torch.clamp(slot, 0, m - 1), m).long()
        st = st.replace(
            alive=_insert(alive, tgt, can),
            **{k: _insert(getattr(st, k), tgt,
                          torch.cat([from_left[k], from_right[k]]))
               for k in MIGRATE_FIELDS})
        sums = comm.psum(torch.stack([
            (left_ok | right_ok).sum(dtype=i32), (over_l + over_r).to(i32),
            (avalid & ~can).sum(dtype=i32)]))
        return st, sums, _insert(none, tgt, can)

    def sort_or_carry(comm, st, spawned, skin):
        """Tolerance mode's per-shard skin-deferred presort
        (worldstep.py:800-878): one host read, the re-sort decision.
        Returns (state, spawned, (key, bpos, max_occ, n_over), ref, need)."""
        i = comm.axis_index()
        clip, shift = g.col_clip(i), g.col_shift(i)
        key_r, bpos_r, ref_r = skin["key"], skin["bpos"], skin["ref"]
        need = ~skin["valid"]
        if g.use_spills:
            # Spawns ride the spill repair: carried key = insertion tile,
            # carried slot = none.
            fresh = tile_key(ext, st.position, st.alive, clip, shift)
            key_r = torch.where(spawned, fresh, key_r)
            bpos_r = torch.where(spawned, ext.slots, bpos_r)
            ref_r = torch.where(spawned[:, None], st.position, ref_r)
            riding = (st.alive & (bpos_r >= ext.slots)).sum(dtype=i32)
            need = need | (riding > (3 * g.s_cap) // 4)
        else:
            need = need | spawned.any()
        dref = torch.abs(st.position - ref_r)
        disp = torch.where(st.alive[:, None], dref,
                           torch.zeros_like(dref)).max()
        need = need | (disp > skin_margin)
        # The shard's one host read a step: which branch to run.
        if bool(need.item()):
            st, spawned, key = payload_sort_by_key(
                st, tile_key(ext, st.position, st.alive, clip, shift),
                spawned)
            bpos, occ, n_over = rank_from_sorted_key(ext, key)
            return st, spawned, (key, bpos, occ, n_over), st.position, need
        return (st, spawned, (key_r, bpos_r, skin["max_occ"],
                              skin["n_over"]), ref_r, need)

    def local_step(comm, params: SimParams, st: SimState, dt, skin=None):
        """One step of one shard (the body under the JAX shard_map)."""
        i = comm.axis_index()
        dev = st.position.device
        dt = float(dt)
        if params.sources is not None:
            st, spawned, spawn_dropped = spawn_phase(comm, params.sources,
                                                     st, dt)
        else:
            spawned = torch.zeros((m,), dtype=torch.bool, device=dev)
            spawn_dropped = torch.zeros((), dtype=i32, device=dev)

        carried = None
        if tol:
            st, spawned, carried, ref, need = sort_or_carry(comm, st,
                                                            spawned, skin)
            resorted = comm.psum(need.to(i32))
        else:
            resorted = torch.full((), d, dtype=i32, device=dev)

        vel, self_pref, st = _hl_phase(config, hl_planners, params, st)
        max_occ = torch.zeros((), dtype=i32, device=dev)
        truncated = torch.zeros((), dtype=i32, device=dev)
        stray = torch.zeros((), dtype=i32, device=dev)
        for pi, planner in enumerate(lp_planners):
            if hasattr(planner, "plan_fused"):
                v, occ, dropped, stray_i = local_forces(
                    comm, st, vel, self_pref, params.lp[pi], carried)
                max_occ = torch.maximum(max_occ, comm.pmax(occ))
                sums = comm.psum(torch.stack([dropped, stray_i]))
                truncated = truncated + sums[0]
                stray = stray + sums[1]
            else:
                v = planner.plan(params.lp[pi], st, None, vel, self_pref)
            sel = (st.lp_idx == pi) & st.alive
            vel = torch.where(sel[:, None], v, vel)

        st, events, _ = _finish_phase(
            config, hl_planners, params, st, vel, self_pref, spawned,
            spawn_dropped, max_occ, truncated, dt)
        # The events name pre-migration slots; their uids and positions
        # are resolved, so reductions over them are exact.
        st, sums, arrived = migrate(comm, st)
        diag = WorldDiag(migrated=sums[0], migration_overflow=sums[1],
                         arrival_dropped=sums[2], stray=stray,
                         resorted=resorted)
        if not tol:
            return st, events, diag, None
        key, bpos, occ, n_over = carried
        if g.use_spills:
            # Arrivals ride the spill repair like spawns; departures and
            # despawns pack inert.
            fresh = tile_key(ext, st.position, st.alive, g.col_clip(i),
                             g.col_shift(i))
            key = torch.where(arrived, fresh, key)
            bpos = torch.where(arrived, ext.slots, bpos)
            ref = torch.where(arrived[:, None], st.position, ref)
            valid = torch.ones((), dtype=torch.bool, device=dev)
        else:
            valid = ~arrived.any()
        return st, events, diag, dict(key=key, bpos=bpos, ref=ref,
                                      max_occ=occ, n_over=n_over,
                                      valid=valid)

    return local_step, g, tol


def build_world_step(config: SimConfig, hl_planners: Sequence[Any],
                     lp_planners: Sequence[Any], mesh: Mesh,
                     migration_capacity: int = 0):
    """The world-sharded step over ``mesh``: ``step(params, shards, dt) ->
    (shards, events, diag)``, or in tolerance mode (the returned
    function's ``tolerance_mode``) ``step(params, shards, dt, skins) ->
    (shards, events, diag, skins)``.  ``shards``: the local shards from
    :func:`shard_state_by_region`; ``events``: one per local shard;
    ``diag``: a :class:`WorldDiag`.  ``migration_capacity``: leavers a
    side per shard and step (default ``max(8, m // 64)``); more stay put
    and retry, counted in ``migration_overflow``."""
    local_step, _, tol = _world_body(config, hl_planners, lp_planners,
                                     mesh.size, migration_capacity)

    def step(params, shards, dt, skins=None):
        k = len(shards)
        res = mesh.run(local_step, [params] * k, shards, [dt] * k,
                       skins if tol else [None] * k)
        out = ([r[0] for r in res], [r[1] for r in res], res[0][2])
        return out + ([r[3] for r in res],) if tol else out

    step.tolerance_mode = tol
    return step


def _counters(comm, st, ev, diag) -> WorldCounters:
    i32 = torch.int32
    s = comm.psum(torch.stack([
        st.alive.sum(dtype=i32), ev.spawned.sum(dtype=i32),
        ev.destroyed.sum(dtype=i32), ev.waypoint_reached.sum(dtype=i32),
        ev.out_of_bounds.sum(dtype=i32)]))
    return WorldCounters(
        n_alive=s[0], n_spawned=s[1], n_destroyed=s[2],
        n_waypoint_reached=s[3], spawn_dropped=ev.spawn_dropped,
        out_of_bounds=s[4], max_cell_occupancy=ev.max_cell_occupancy,
        neighbor_truncated=ev.neighbor_truncated, migrated=diag.migrated,
        migration_overflow=diag.migration_overflow,
        arrival_dropped=diag.arrival_dropped, stray=diag.stray,
        resorted=diag.resorted)


def build_world_rollout(config: SimConfig, hl_planners: Sequence[Any],
                        lp_planners: Sequence[Any], mesh: Mesh,
                        migration_capacity: int = 0):
    """``rollout(params, shards, dt, n_steps) -> (shards, counters)``:
    each shard runs all ``n_steps`` steps in its own loop (the JAX engine's
    scan inside the shard_map), tolerance mode from a fresh skin carry.
    ``counters``: :class:`WorldCounters`, global, [T] each."""
    local_step, g, tol = _world_body(config, hl_planners, lp_planners,
                                     mesh.size, migration_capacity)

    def body(comm, params, st, dt, n_steps):
        skin = (empty_world_skin(g.m, config.tdtype, st.position.device)
                if tol else None)
        rows = []
        for _ in range(n_steps):
            st, ev, diag, skin = local_step(comm, params, st, dt, skin)
            rows.append(_counters(comm, st, ev, diag))
        if not rows:
            z = torch.zeros((0,), dtype=torch.int32,
                            device=st.position.device)
            return st, WorldCounters(**{
                fl.name: z for fl in dataclasses.fields(WorldCounters)})
        return st, _stack(rows)

    def rollout(params, shards, dt, n_steps: int):
        k = len(shards)
        res = mesh.run(body, [params] * k, shards, [dt] * k,
                       [int(n_steps)] * k)
        return [r[0] for r in res], res[0][1]

    rollout.tolerance_mode = tol
    return rollout


def shard_state_by_region(config: SimConfig, mesh: Mesh,
                          state: SimState) -> list:
    """The local shards of ``state`` with each shard's slot block holding
    exactly the live agents inside its region, first slots first
    (required before the world step), on the mesh's device, each with a
    copy of the generator.  Raises if a region holds more live agents
    than a shard's ``m`` slots."""
    g = WorldGeometry.create(config, mesh.size)
    n, m = config.capacity, g.m
    host = {k: getattr(state, k).detach().cpu() for k in STATE_TENSOR_FIELDS}
    alive = host["alive"].numpy()
    region = g.region(host["position"][:, 0]).numpy()
    fresh = make_state(config, device="cpu")
    rows = []
    for r in range(mesh.size):
        idx = np.flatnonzero(alive & (region == r))
        if len(idx) > m:
            raise ValueError(f"region {r} holds {len(idx)} agents, more "
                             f"than the shard capacity {m}")
        rows.append(idx)
    out = []
    for r in mesh.local_ranks:
        fields = {}
        for k in STATE_TENSOR_FIELDS:
            v = host[k]
            if v.dim() >= 1 and v.shape[0] == n:
                blk = getattr(fresh, k)[:m].clone()
                blk[:len(rows[r])] = v[torch.as_tensor(rows[r],
                                                       dtype=torch.long)]
                v = blk
            fields[k] = v.to(mesh.device)
        out.append(SimState(**fields, generator=clone_generator(
            state.generator, mesh.device)))
    return out
