"""The simulation step and the multi-step rollout.

Counterpart of ``rmf_crowdsim_tpu/core/step.py``: ``SimParams``, the
SourceSink spawn phase, ``payload_sort_by_key``, the high-level, sink and
finish phases, ``build_step`` on all five neighbor backends with the
presort and the skin-deferred re-sort, ``RolloutCounters``,
``EventStream`` and ``build_rollout``.

PyTorch runs eagerly, so the JAX package's ``lax.scan`` becomes a Python
loop and its on-device branches become host decisions or branch-free
code.  The step reads the device once: the skin decision (``need``, which
includes whether anything spawned), as one ``.item()``.  Everything else
— the spawn gate and slot allocation, the spill repair, the truncation
audit, the counters and event records — stays on the device without a
host read.  So the step is ``pre`` (before the read), ``read`` and
``post`` (one of two fixed sequences after it), and on CUDA
``build_rollout`` replays each half as a captured CUDA graph
(``core/graphs.py``).  The step's phases are ``crowdsim.step.*`` spans
and its re-sorts the ``crowdsim.resorts`` counter (``utils/profiling.py``),
recorded only while a ``torch.profiler`` session is active.

With ``world_mesh`` (a ``parallel.comm.Mesh``) the step runs with its
force pass domain-decomposed over the mesh's shards (``parallel/domain.py``);
the agent-sharded and world-sharded engines are in ``parallel/``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from ..models.source_sink import GEN_CUSTOM, GEN_POISSON, SourceParams
from ..ops import grid as grid_ops
from ..ops import neighbors as nbr_ops
from ..ops.compact import compact_indices
from ..ops.spawn_gate import spawn_blocked
from ..utils.profiling import count, span
from .config import (
    BACKEND_BRUTE,
    BACKEND_CUSTOM,
    BACKEND_GRID,
    BACKEND_GRID_DENSE,
    BACKEND_GRID_PALLAS,
    SimConfig,
)
from .graphs import StepGraphs
from .state import SimState, StepEvents, TensorDataclass


@dataclasses.dataclass(frozen=True)
class SimParams(TensorDataclass):
    """Per-planner parameters plus the stacked SourceSink table."""

    hl: Tuple[Any, ...]
    lp: Tuple[Any, ...]
    sources: Optional[SourceParams] = None


def spawn_requests(sp: SourceParams, dt: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """[S] int32: each source's request this step.  ``MonotonicCrowd``:
    ``floor(rate*dt + 0.5)`` in the config dtype (``dt`` rounded to it
    first, as the JAX step's ``jnp.asarray(dt, f)``); ``PoissonCrowd``: a
    ``torch.poisson`` draw of ``rate*dt`` from ``generator``; GEN_CUSTOM:
    the host's ``custom_count``; inactive sources: 0."""
    i32 = torch.int32
    rt = sp.rate * dt
    mono = torch.floor(rt + 0.5).to(i32)
    pois = torch.poisson(rt.to(torch.float32), generator=generator).to(i32)
    n_req = torch.where(sp.gen_kind == GEN_POISSON, pois, mono)
    n_req = torch.where(sp.gen_kind == GEN_CUSTOM, sp.custom_count, n_req)
    return torch.where(sp.active, n_req, 0)


def _spawn_phase(config: SimConfig, sp: SourceParams, state: SimState,
                 dt: float):
    """Phase A (lib.rs:199-254): each active source asks its generator for
    a count; if positive and no alive agent of the PRE-spawn state lies
    strictly within ``spawn_clearance`` of it, it spawns exactly one agent
    at the source; surplus requests are dropped.  The k-th spawning source
    takes the k-th free slot (the first S free slots by ``compact_indices``,
    JAX's sorted free-slot prefix); uids are ``next_uid + rank`` over the
    wanting sources, and ``next_uid`` grows by the spawns, as the JAX
    package assigns them (core/step.py:68-178), written by
    :func:`spawn_write`.  Returns (state, spawned [N] bool, dropped []
    int32)."""
    i32 = torch.int32
    s = sp.source.shape[0]

    n_req = spawn_requests(sp, dt, state.generator)
    with span("crowdsim.step.spawn_gate", device=True):
        blocked = spawn_blocked(state.position, state.alive, sp.source,
                                config.spawn_clearance)
    want = (n_req > 0) & ~blocked
    free = compact_indices(~state.alive, s)
    rank = torch.cumsum(want.to(i32), 0, dtype=i32) - 1
    can = want & (rank < free.count)
    slot = free.idx[torch.clamp(rank, 0, s - 1).long()]
    n_can = can.sum(dtype=i32)
    tgt = torch.where(can, slot, state.capacity)
    state, spawned = spawn_write(state, sp, tgt,
                                 (state.next_uid + rank).to(i32), n_can)
    return state, spawned, n_req.sum(dtype=i32) - n_can


def spawn_write(state: SimState, sp: SourceParams, tgt: torch.Tensor,
                new_uid: torch.Tensor, n_new: torch.Tensor):
    """Write one agent of each source ``s`` into slot ``tgt[s]`` (``N``
    for a source that spawns none; the slots of the others distinct) with
    uid ``new_uid[s]``, and advance ``next_uid`` by ``n_new``.  Where the
    JAX package scatters with ``mode="drop"``, each source's index is
    scattered once into an [N+1] map whose last row absorbs the sources
    that spawn none.  Returns (state, spawned [N] bool)."""
    n = state.capacity
    dev = state.device
    i32 = torch.int32
    s = sp.source.shape[0]
    tgt = tgt.long()
    src_of_slot = torch.full((n + 1,), -1, dtype=i32, device=dev)
    src_of_slot.scatter_(0, tgt, torch.arange(s, dtype=i32, device=dev))
    src = src_of_slot[:n]
    spawned = src >= 0
    si = torch.clamp(src, min=0).long()

    def put(field, values):
        if field.dim() == 2:
            return torch.where(spawned[:, None], values[si], field)
        return torch.where(spawned, values[si], field)

    def zero(field):
        m = spawned[:, None] if field.dim() == 2 else spawned
        return torch.where(m, torch.zeros((), dtype=field.dtype, device=dev),
                           field)

    state = state.replace(
        position=put(state.position, sp.source),
        velocity=zero(state.velocity),
        preferred_vel=zero(state.preferred_vel),
        next_waypoint=zero(state.next_waypoint),
        eyesight=put(state.eyesight, sp.eyesight),
        alive=state.alive | spawned,
        uid=put(state.uid, new_uid),
        source_id=torch.where(spawned, src, state.source_id),
        hl_idx=put(state.hl_idx, sp.hl_idx),
        lp_idx=put(state.lp_idx, sp.lp_idx),
        # Route leg 0, source -> waypoints[0] (lib.rs:242-249).
        route_id=put(state.route_id, sp.leg_route[:, 0]),
        route_wp=zero(state.route_wp),
        # Zanlungo's right-of-way priority defaults to the agent id
        # (zanlungo.rs:94-98).
        priority=put(state.priority, new_uid.to(state.priority.dtype)),
        next_uid=state.next_uid + n_new,
    )
    return state, spawned


def _hl_phase(config: SimConfig, hl_planners, params: SimParams,
              state: SimState):
    """High-level planner pass (lib.rs:263-273): vel starts at zero; a
    planner result marked valid sets both vel and the agent's own
    preferred velocity.  Returns (vel, self_pref, state-with-route_wp)."""
    n = state.capacity
    vel = torch.zeros((n, 2), dtype=config.tdtype, device=state.device)
    self_pref = state.preferred_vel
    route_wp = state.route_wp
    for i, planner in enumerate(hl_planners):
        res = planner.plan(params.hl[i], state)
        sel = state.hl_idx == i
        use = sel & res.valid & state.alive
        vel = torch.where(use[:, None], res.vel, vel)
        self_pref = torch.where(use[:, None], res.vel, self_pref)
        route_wp = torch.where(sel & state.alive, res.route_wp, route_wp)
    return vel, self_pref, state.replace(route_wp=route_wp)


def _sink_phase(config: SimConfig, hl_planners, params: SimParams,
                state: SimState):
    """SourceSink waypoint bookkeeping (lib.rs:304-336) against the
    pre-integration position: rogue agents (waypoint index past the end)
    are removed, an agent strictly inside its waypoint's disc advances,
    wraps (``loop_forever``) or despawns at the last one, and
    route-following planners get the next leg on an advance, never on a
    wrap (lib.rs:318-320).  Returns (state, destroyed, reached)."""
    n = state.capacity
    none = torch.zeros((n,), dtype=torch.bool, device=state.device)
    if params.sources is None:
        return state, none, none
    sp = params.sources
    s = sp.source.shape[0]
    w = sp.waypoints.shape[1]
    has_ss = state.alive & (state.source_id >= 0)
    src = torch.clamp(state.source_id, 0, s - 1).long()
    wlen = sp.n_waypoints[src]
    nwp = state.next_waypoint
    rogue = has_ss & (nwp >= wlen)
    target = sp.waypoints[src, torch.clamp(nwp, 0, w - 1).long()]
    dist = nbr_ops.norm(state.position - target)
    reached = has_ss & ~rogue & (dist < sp.radius_sink[src])
    at_last = nwp == wlen - 1
    looping = sp.loop_forever[src]
    despawn = reached & at_last & ~looping
    wrap = reached & at_last & looping
    advance = reached & ~at_last
    next_wp = torch.where(wrap, 0, torch.where(advance, nwp + 1, nwp))
    route_id = state.route_id
    route_wp = state.route_wp
    for i, planner in enumerate(hl_planners):
        if getattr(planner, "uses_routes", False):
            sel = advance & (state.hl_idx == i)
            new_rid = sp.leg_route[src, torch.clamp(next_wp, 0, w - 1).long()]
            route_id = torch.where(sel, new_rid, route_id)
            route_wp = torch.where(sel, 0, route_wp)
    state = state.replace(
        next_waypoint=torch.where(has_ss, next_wp, nwp),
        route_id=route_id,
        route_wp=route_wp,
    )
    return state, despawn | rogue, reached


def payload_sort_by_key(state: SimState, key: torch.Tensor,
                        spawned: torch.Tensor):
    """Order the whole state by ``key`` [N] int32: one unstable sort of
    the key plus one gather per field (core/step.py:259).  Tie order
    differs from JAX's, so state is compared by ``uid``, never by slot.
    Returns (sorted state, sorted spawned mask, sorted keys)."""
    key_s, order = torch.sort(key)
    fields = ("position", "velocity", "preferred_vel", "next_waypoint",
              "eyesight", "alive", "uid", "source_id", "hl_idx", "lp_idx",
              "route_id", "route_wp", "priority")
    state = state.replace(**{f: getattr(state, f)[order] for f in fields})
    return state, spawned[order], key_s


def _finish_phase(config: SimConfig, hl_planners, params: SimParams,
                  state: SimState, vel, self_pref, spawned, spawn_dropped,
                  max_occ, truncated, dt: float):
    """Euler integration (lib.rs:295-297), out-of-grid flag, sink
    bookkeeping, commit (lib.rs:350-359), despawn and the event record.
    ``dt`` stays a Python float: multiplying by it rounds it to the state
    dtype, as the JAX step's ``jnp.asarray(dt, f)`` does, without a
    host-to-device copy."""
    n = state.capacity
    dev = state.device
    new_pos = state.position + vel * dt
    if config.grid is not None:
        _, _, in_bounds = grid_ops.cell_coords(config.grid, new_pos)
        out_of_bounds = state.alive & ~in_bounds
    else:
        out_of_bounds = torch.zeros((n,), dtype=torch.bool, device=dev)

    state, destroyed, reached = _sink_phase(config, hl_planners, params,
                                            state)
    alive_pre = state.alive
    pos_premove = state.position
    committed_pref = (
        torch.where(alive_pre[:, None], self_pref, state.preferred_vel)
        if config.commit_preferred_vel else state.preferred_vel
    )
    state = state.replace(
        position=torch.where(alive_pre[:, None], new_pos, state.position),
        velocity=torch.where(alive_pre[:, None], vel, state.velocity),
        preferred_vel=committed_pref,
        alive=alive_pre & ~destroyed,
        sim_time=state.sim_time + dt,
    )
    zeros2 = torch.zeros((n, 2), dtype=config.tdtype, device=dev)
    events = StepEvents(
        spawned=spawned,
        destroyed=destroyed,
        waypoint_reached=reached,
        spawn_position=torch.where(spawned[:, None], pos_premove, zeros2),
        destroyed_uid=torch.where(destroyed, state.uid,
                                  torch.full_like(state.uid, -1)),
        waypoint_position=torch.where(reached[:, None], pos_premove, zeros2),
        out_of_bounds=out_of_bounds,
        spawn_dropped=spawn_dropped.to(torch.int32),
        max_cell_occupancy=max_occ,
        neighbor_truncated=truncated,
    )
    return state, events, destroyed


def build_step(config: SimConfig, hl_planners: Sequence[Any],
               lp_planners: Sequence[Any], neighbor_fn=None,
               skin_mode: bool = False, world_mesh=None):
    """Construct ``step(params, state, dt) -> (state, events)``, or with a
    granted ``skin_mode`` (presorted grid_pallas or grid_dense with a
    positive skin margin; see the returned function's ``skin_mode``
    attribute)
    ``step(params, state, dt, skin) -> (state, events, skin)``, which
    re-sorts only when an agent has moved more than the skin margin
    ``(tile_size - max_eyesight) / 2`` since the last sort or an agent
    spawned (core/step.py:378).

    ``neighbor_fn``: required with ``neighbor_backend == "custom"``, a
    function ``(state) -> NeighborSet`` (the reference's SpatialIndex
    trait, spatial_index.rs:4-14) that sets ``truncated`` honestly.

    ``world_mesh``: a ``parallel.comm.Mesh``; the grid_pallas force pass
    then runs domain-decomposed over its shards (``parallel/domain.py``),
    ``tx`` rounded up to a multiple of the shard count, without presort
    (core/step.py:444-476).  ``grid_dense`` is single-device only."""
    hl_planners = tuple(hl_planners)
    lp_planners = tuple(lp_planners)
    if config.neighbor_backend == BACKEND_CUSTOM and neighbor_fn is None:
        raise ValueError("neighbor_backend='custom' requires a neighbor_fn")
    window = None
    if config.grid is not None:
        window = config.grid.window_radius(config.max_eyesight)

    bucket_cfg = None
    if config.neighbor_backend == BACKEND_GRID_PALLAS:
        from ..ops.zanlungo_bucketed import BucketConfig

        bucket_cfg = BucketConfig.create(
            config.grid.width, config.grid.height, config.grid.offset,
            config.max_eyesight, bucket=config.bucket_capacity,
            strip_tiles=config.strip_tiles, sub_tiles=config.sub_tiles,
            tile_size=config.bucket_tile_size or None,
        )
        if world_mesh is not None and bucket_cfg.tx % world_mesh.size:
            d = world_mesh.size
            bucket_cfg = dataclasses.replace(bucket_cfg,
                                             tx=(bucket_cfg.tx // d + 1) * d)
    dense_cfg = None
    if config.neighbor_backend == BACKEND_GRID_DENSE:
        from ..ops.zanlungo_dense import DenseConfig

        if world_mesh is not None:
            raise ValueError("grid_dense is single-device only; use "
                             "grid_pallas with a world_mesh or the "
                             "world-sharded engine")

        dense_cfg = DenseConfig.create(
            config.grid.width, config.grid.height, config.grid.offset,
            config.max_eyesight, config.capacity,
            tile_size=config.bucket_tile_size or None,
            col_headroom=config.dense_col_headroom,
        )
    # The dense layout IS the sorted order, so grid_dense implies presort;
    # a domain-sharded pass keeps the plain binning.
    presort = bool(((config.presort and bucket_cfg is not None)
                    or dense_cfg is not None) and world_mesh is None)
    sort_cfg = dense_cfg if dense_cfg is not None else bucket_cfg
    skin_margin = 0.0
    if sort_cfg is not None:
        skin_margin = (float(sort_cfg.tile_size)
                       - float(config.max_eyesight)) / 2.0
    skin_mode = bool(skin_mode and presort and skin_margin > 0.0)

    def neighbor_table(state: SimState) -> nbr_ops.NeighborSet:
        if config.neighbor_backend == BACKEND_CUSTOM:
            return neighbor_fn(state)
        if config.neighbor_backend == BACKEND_BRUTE:
            return nbr_ops.brute_neighbors(state.position, state.eyesight,
                                           state.alive)
        return grid_ops.grid_neighbors(
            config.grid, state.position, state.eyesight, state.alive,
            window=window, max_per_cell=config.max_per_cell)

    def _presort_state(state: SimState, spawned):
        from ..ops.zanlungo_bucketed import tile_key

        return payload_sort_by_key(
            state, tile_key(sort_cfg, state.position, state.alive),
            spawned)

    def _force_pass(params: SimParams, state: SimState, vel, self_pref,
                    binning, dense_key):
        """The local planners: (vel, max_occ, truncated)."""
        dev = state.device
        max_occ = torch.zeros((), dtype=torch.int32, device=dev)
        truncated = torch.zeros((), dtype=torch.int32, device=dev)
        if not lp_planners:
            return vel, max_occ, truncated
        use_fused = bucket_cfg is not None
        use_dense = dense_cfg is not None
        need_nbr = any(
            getattr(p, "needs_neighbors", True)
            and not ((use_fused and hasattr(p, "plan_fused"))
                     or (use_dense and hasattr(p, "plan_fused_dense")))
            for p in lp_planners
        )
        nbr = None
        if need_nbr:
            nbr = neighbor_table(state)
            max_occ = nbr.max_cell_occupancy
            truncated = truncated + nbr.truncated
        for i, planner in enumerate(lp_planners):
            if use_dense and hasattr(planner, "plan_fused_dense"):
                v, occ, dropped = planner.plan_fused_dense(
                    params.lp[i], dense_cfg, state, vel, self_pref,
                    dense_key, int_prio=config.integer_priorities,
                )
                max_occ = torch.maximum(max_occ, occ)
                truncated = truncated + dropped
            elif use_fused and hasattr(planner, "plan_fused"):
                v, occ, dropped = planner.plan_fused(
                    params.lp[i], bucket_cfg, state, vel, self_pref,
                    use_pack_kernel=config.use_pack_kernel,
                    spill_capacity=config.spill_capacity,
                    presorted=presort,
                    int_prio=config.integer_priorities,
                    dual_row=config.dual_row,
                    binning=binning,
                    fused_spills=config.fused_spills,
                    world_mesh=world_mesh,
                )
                max_occ = torch.maximum(max_occ, occ)
                truncated = truncated + dropped
            else:
                v = planner.plan(params.lp[i], state, nbr, vel, self_pref)
            sel = (state.lp_idx == i) & state.alive
            vel = torch.where(sel[:, None], v, vel)
        return vel, max_occ, truncated

    def pre(params: SimParams, state: SimState, dt: float, skin=None):
        """The step up to its read: the spawn phase and, in skin mode, the
        skin decision ``need`` ([] bool on the device; None otherwise).
        Returns (state, spawned, spawn_dropped, need)."""
        n = config.capacity
        dev = state.device
        with span("crowdsim.step.spawn"):
            if params.sources is not None:
                state, spawned, spawn_dropped = _spawn_phase(
                    config, params.sources, state, dt)
            else:
                spawned = torch.zeros((n,), dtype=torch.bool, device=dev)
                spawn_dropped = torch.zeros((), dtype=torch.int32,
                                            device=dev)
        need = None
        if skin_mode:
            d = torch.abs(state.position - skin["ref"])
            disp = torch.where(state.alive[:, None], d,
                               torch.zeros_like(d)).max()
            # Spawns break the sort; despawns do not (see post's end).
            need = ((~skin["valid"]) | spawned.any()
                    | (disp > skin_margin))
        return state, spawned, spawn_dropped, need

    def read(need) -> bool:
        """The step's one host read: whether to re-sort (the skin's
        decision; the presort's every step without the skin)."""
        resort = presort
        if skin_mode:
            with span("crowdsim.step.read"):
                resort = bool(need.item())
        if presort:
            count("crowdsim.resorts", resort)
        return resort

    def post(params: SimParams, state: SimState, spawned, spawn_dropped,
             dt: float, skin, resort: bool):
        """The step after its read: the re-sort or the carried binning
        (``resort``), the high-level planners, the force pass and the
        finish.  Returns (state, events) or, in skin mode, (state,
        events, skin)."""
        n = config.capacity
        dev = state.device
        binning = None
        dense_key = None
        skin_out = None
        if skin_mode:
            from ..ops.zanlungo_bucketed import rank_from_sorted_key

            with span("crowdsim.step.sort"):
                if resort:
                    state, spawned, key = _presort_state(state, spawned)
                    if dense_cfg is not None:
                        # The dense pass derives its tables from the
                        # sorted key each step; only the key is carried.
                        bpos = torch.zeros((n,), dtype=torch.int32,
                                           device=dev)
                        occ = torch.zeros((), dtype=torch.int32, device=dev)
                        nover = torch.zeros((), dtype=torch.int32,
                                            device=dev)
                    else:
                        bpos, occ, nover = rank_from_sorted_key(bucket_cfg,
                                                                key)
                    ref = state.position
                else:
                    key, bpos, occ, nover, ref = (
                        skin["key"], skin["bpos"], skin["max_occ"],
                        skin["n_over"], skin["ref"])
            binning = (key, bpos, occ, nover)
            dense_key = key
            skin_out = dict(key=key, bpos=bpos, max_occ=occ, n_over=nover,
                            ref=ref, resorted=resort)
        elif presort:
            with span("crowdsim.step.sort"):
                state, spawned, dense_key = _presort_state(state, spawned)

        with span("crowdsim.step.high_level"):
            vel, self_pref, state = _hl_phase(config, hl_planners, params,
                                              state)

        with span("crowdsim.step.force_pass"):
            vel, max_occ, truncated = _force_pass(params, state, vel,
                                                  self_pref, binning,
                                                  dense_key)

        with span("crowdsim.step.finish"):
            state, events, _ = _finish_phase(
                config, hl_planners, params, state, vel, self_pref, spawned,
                spawn_dropped, max_occ, truncated, dt,
            )
        if skin_mode:
            # Despawns keep the carried binning valid: bucketize and
            # dense_prep pack fresh-dead rows inert (position sentinel, id
            # -1), so they are no candidate and no spill
            # (core/step.py:652-659).
            skin_out["valid"] = torch.ones((), dtype=torch.bool, device=dev)
            return state, events, skin_out
        return state, events

    def step(params: SimParams, state: SimState, dt: float, skin=None):
        dt = float(dt)
        with span("crowdsim.step", new_step=True):
            state, spawned, spawn_dropped, need = pre(params, state, dt,
                                                      skin)
            return post(params, state, spawned, spawn_dropped, dt, skin,
                        read(need))

    step.skin_mode = skin_mode
    step.pre, step.read, step.post = pre, read, post
    return step


@dataclasses.dataclass(frozen=True)
class RolloutCounters(TensorDataclass):
    """Per-step event summaries of a rollout, each [T] int32."""

    n_alive: torch.Tensor
    n_spawned: torch.Tensor
    n_destroyed: torch.Tensor
    n_waypoint_reached: torch.Tensor
    spawn_dropped: torch.Tensor
    out_of_bounds: torch.Tensor
    max_cell_occupancy: torch.Tensor
    neighbor_truncated: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EventStream(TensorDataclass):
    """Per-step compacted event records of a rollout: up to K uids (and
    positions) per event kind and step, first slot first, so a host can
    replay the reference's per-id EventListener calls (lib.rs:151-153,
    189-191; the waypoint hook lib.rs:32/317) without [T, N] masks.
    Unused entries hold uid -1; ``overflow`` counts the events of a step
    past K (delivery would be incomplete)."""

    spawned_uid: torch.Tensor  # [T, K] int32, -1 padded
    spawned_pos: torch.Tensor  # [T, K, 2]
    destroyed_uid: torch.Tensor  # [T, K] int32, -1 padded
    reached_uid: torch.Tensor  # [T, K] int32, -1 padded
    reached_pos: torch.Tensor  # [T, K, 2]
    overflow: torch.Tensor  # [T] int32
    counters: RolloutCounters


def _compact_events(mask: torch.Tensor, uid: torch.Tensor, k: int,
                    pos: Optional[torch.Tensor] = None):
    """``uid[mask]`` (and ``pos[mask]``) in fixed ``k`` rows, first slot
    first, with no host read.  Returns (uid_k, pos_k or None, n_dropped)."""
    c = compact_indices(mask, k)
    safe = torch.clamp(c.idx, 0, mask.shape[0] - 1).long()
    uid_k = torch.where(c.valid, uid[safe].to(torch.int32), -1)
    pos_k = None
    if pos is not None:
        pos_k = torch.where(c.valid[:, None], pos[safe],
                            torch.zeros((), dtype=pos.dtype,
                                        device=pos.device))
    return uid_k, pos_k, c.n_over


def emit_rollout_record(ev: StepEvents, st: SimState, k: int):
    """One step's rollout record: :class:`RolloutCounters` of 0-d
    tensors when ``k`` == 0, else an :class:`EventStream` row (up to ``k``
    records per kind).  Spawned and reached agents are alive with their
    uid in the post-step state; destroyed uids come from the events."""
    i32 = torch.int32
    c = RolloutCounters(
        n_alive=st.num_alive,
        n_spawned=ev.spawned.sum(dtype=i32),
        n_destroyed=ev.destroyed.sum(dtype=i32),
        n_waypoint_reached=ev.waypoint_reached.sum(dtype=i32),
        spawn_dropped=ev.spawn_dropped,
        out_of_bounds=ev.out_of_bounds.sum(dtype=i32),
        max_cell_occupancy=ev.max_cell_occupancy,
        neighbor_truncated=ev.neighbor_truncated,
    )
    if k == 0:
        return c
    s_uid, s_pos, s_drop = _compact_events(ev.spawned, st.uid, k,
                                           ev.spawn_position)
    d_uid, _, d_drop = _compact_events(ev.destroyed, ev.destroyed_uid, k)
    r_uid, r_pos, r_drop = _compact_events(ev.waypoint_reached, st.uid, k,
                                           ev.waypoint_position)
    return EventStream(
        spawned_uid=s_uid, spawned_pos=s_pos, destroyed_uid=d_uid,
        reached_uid=r_uid, reached_pos=r_pos,
        overflow=s_drop + d_drop + r_drop, counters=c,
    )


def _stack(rows):
    """Stack per-step records (tensors or record dataclasses) over steps."""
    r0 = rows[0]
    if isinstance(r0, torch.Tensor):
        return torch.stack(rows)
    return type(r0)(**{f.name: _stack([getattr(r, f.name) for r in rows])
                       for f in dataclasses.fields(r0)})


def _empty_records(k: int, dtype: torch.dtype, dev):
    """The records of a rollout of zero steps."""
    def z(*shape, dt=torch.int32):
        return torch.zeros((0, *shape), dtype=dt, device=dev)

    c = RolloutCounters(**{f.name: z()
                           for f in dataclasses.fields(RolloutCounters)})
    if k == 0:
        return c
    return EventStream(spawned_uid=z(k), spawned_pos=z(k, 2, dt=dtype),
                       destroyed_uid=z(k), reached_uid=z(k),
                       reached_pos=z(k, 2, dt=dtype), overflow=z(),
                       counters=c)


def empty_skin(config: SimConfig, device) -> dict:
    """The carry of a skin-mode step before its first sort (``valid``
    False, so the first step sorts)."""
    n = config.capacity
    i32 = torch.int32
    return dict(
        valid=torch.zeros((), dtype=torch.bool, device=device),
        key=torch.zeros((n,), dtype=i32, device=device),
        bpos=torch.zeros((n,), dtype=i32, device=device),
        max_occ=torch.zeros((), dtype=i32, device=device),
        n_over=torch.zeros((), dtype=i32, device=device),
        ref=torch.zeros((n, 2), dtype=config.tdtype, device=device),
        resorted=False,
    )


def build_rollout(config: SimConfig, hl_planners: Sequence[Any],
                  lp_planners: Sequence[Any], event_capacity: int = 0,
                  neighbor_fn=None):
    """Construct ``rollout(params, state, dt, n_steps) -> (state,
    records)``: ``n_steps`` steps in a Python loop, on the presorted
    grid_pallas and grid_dense paths with the skin-deferred re-sort
    (core/step.py:753).  ``records`` is :class:`RolloutCounters` ([T]
    each) when ``event_capacity`` is 0, else an :class:`EventStream` with
    ``[T, event_capacity]`` records per kind and the counters inside.
    ``neighbor_fn``: see :func:`build_step`.

    On CUDA states the steps replay as captured CUDA graphs, bit for bit
    the eager loop (``rollout.graphs``, a :class:`~.graphs.StepGraphs`;
    None with the ``custom`` backend, whose ``neighbor_fn`` may read the
    host); ``rollout.eager`` is the eager loop itself."""
    step = build_step(config, hl_planners, lp_planners,
                      neighbor_fn=neighbor_fn, skin_mode=True)
    uses_skin = bool(step.skin_mode)
    k = int(event_capacity)

    def eager(params: SimParams, state: SimState, dt: float, n_steps: int):
        dev = state.device
        skin = empty_skin(config, dev) if uses_skin else None
        rows = []
        for _ in range(n_steps):
            if uses_skin:
                state, ev, skin = step(params, state, dt, skin)
            else:
                state, ev = step(params, state, dt)
            with span("crowdsim.rollout.record"):
                rows.append(emit_rollout_record(ev, state, k))
        if not rows:
            return state, _empty_records(k, config.tdtype, dev)
        return state, _stack(rows)

    graphs = None
    if config.neighbor_backend != BACKEND_CUSTOM:
        graphs = StepGraphs(step, lambda dev: empty_skin(config, dev),
                            lambda ev, st: emit_rollout_record(ev, st, k),
                            eager)

    def rollout(params: SimParams, state: SimState, dt: float,
                n_steps: int):
        if graphs is not None and graphs.engages(state):
            return graphs.run(params, state, dt, n_steps)
        return eager(params, state, dt, n_steps)

    rollout.engine = "standard"
    rollout.eager = eager
    rollout.graphs = graphs
    return rollout
