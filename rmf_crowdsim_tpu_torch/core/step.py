"""The simulation step and the multi-step rollout.

Counterpart of ``rmf_crowdsim_tpu/core/step.py`` for the ``brute``,
``grid_pallas`` and ``grid_dense`` backends: ``SimParams``,
``payload_sort_by_key``, the high-level, sink and finish phases,
``build_step`` with the presort and the skin-deferred re-sort,
``RolloutCounters`` and ``build_rollout``.

PyTorch runs eagerly, so the JAX package's ``lax.scan`` becomes a Python
loop and its on-device branches become host decisions or branch-free
code.  The step reads the device once: the skin decision (``need``), as
one ``.item()``.  Everything else — the spill repair, the counters —
stays on the device without a host read.

Not ported yet (they raise ``NotImplementedError``): SourceSink spawning
and waypoint bookkeeping (``params.sources``), per-uid event streams
(``event_capacity > 0``), the ``grid`` and ``custom`` backends, and
domain decomposition.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from ..ops import grid as grid_ops
from ..ops import neighbors as nbr_ops
from .config import (
    BACKEND_BRUTE,
    BACKEND_GRID_DENSE,
    BACKEND_GRID_PALLAS,
    PORTED_BACKENDS,
    SimConfig,
)
from .state import SimState, StepEvents, TensorDataclass


@dataclasses.dataclass(frozen=True)
class SimParams(TensorDataclass):
    """Per-planner parameters plus the SourceSink table (``None``: the
    port does not run sources yet)."""

    hl: Tuple[Any, ...]
    lp: Tuple[Any, ...]
    sources: Optional[Any] = None


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
    """SourceSink waypoint bookkeeping (lib.rs:304-336); only the
    no-sources branch is ported, so a step given sources (whose spawn
    phase the port also lacks) raises here.  Returns (state, destroyed,
    reached)."""
    if params.sources is not None:
        raise NotImplementedError(
            "SourceSink spawning and waypoint bookkeeping are not ported "
            "yet")
    none = torch.zeros((state.capacity,), dtype=torch.bool,
                       device=state.device)
    return state, none, none


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
               lp_planners: Sequence[Any], skin_mode: bool = False):
    """Construct ``step(params, state, dt) -> (state, events)``, or with a
    granted ``skin_mode`` (presorted grid_pallas or grid_dense with a
    positive skin margin; see the returned function's ``skin_mode``
    attribute)
    ``step(params, state, dt, skin) -> (state, events, skin)``, which
    re-sorts only when an agent has moved more than the skin margin
    ``(tile_size - max_eyesight) / 2`` since the last sort or an agent
    spawned (core/step.py:378)."""
    hl_planners = tuple(hl_planners)
    lp_planners = tuple(lp_planners)
    if config.neighbor_backend not in PORTED_BACKENDS:
        raise NotImplementedError(
            f"neighbor backend {config.neighbor_backend!r} is not ported "
            f"yet (ported: {PORTED_BACKENDS})")

    bucket_cfg = None
    if config.neighbor_backend == BACKEND_GRID_PALLAS:
        from ..ops.zanlungo_bucketed import BucketConfig

        bucket_cfg = BucketConfig.create(
            config.grid.width, config.grid.height, config.grid.offset,
            config.max_eyesight, bucket=config.bucket_capacity,
            strip_tiles=config.strip_tiles, sub_tiles=config.sub_tiles,
            tile_size=config.bucket_tile_size or None,
        )
    dense_cfg = None
    if config.neighbor_backend == BACKEND_GRID_DENSE:
        from ..ops.zanlungo_dense import DenseConfig

        dense_cfg = DenseConfig.create(
            config.grid.width, config.grid.height, config.grid.offset,
            config.max_eyesight, config.capacity,
            tile_size=config.bucket_tile_size or None,
            col_headroom=config.dense_col_headroom,
        )
    # The dense layout IS the sorted order, so grid_dense implies presort.
    presort = bool((config.presort and bucket_cfg is not None)
                   or dense_cfg is not None)
    sort_cfg = dense_cfg if dense_cfg is not None else bucket_cfg
    skin_margin = 0.0
    if sort_cfg is not None:
        skin_margin = (float(sort_cfg.tile_size)
                       - float(config.max_eyesight)) / 2.0
    skin_mode = bool(skin_mode and presort and skin_margin > 0.0)

    def _presort_state(state: SimState, spawned):
        from ..ops.zanlungo_bucketed import tile_key

        return payload_sort_by_key(
            state, tile_key(sort_cfg, state.position, state.alive),
            spawned)

    def step(params: SimParams, state: SimState, dt: float, skin=None):
        n = config.capacity
        dev = state.device
        dt = float(dt)
        spawned = torch.zeros((n,), dtype=torch.bool, device=dev)
        spawn_dropped = torch.zeros((), dtype=torch.int32, device=dev)

        binning = None
        dense_key = None
        skin_out = None
        if skin_mode:
            from ..ops.zanlungo_bucketed import rank_from_sorted_key

            d = torch.abs(state.position - skin["ref"])
            disp = torch.where(state.alive[:, None], d,
                               torch.zeros_like(d)).max()
            need = ((~skin["valid"]) | spawned.any()
                    | (disp > skin_margin))
            # The step's one host read: which branch to run.
            resort = bool(need.item())
            if resort:
                state, spawned, key = _presort_state(state, spawned)
                if dense_cfg is not None:
                    # The dense pass derives its tables from the sorted
                    # key each step; only the key is carried.
                    bpos = torch.zeros((n,), dtype=torch.int32, device=dev)
                    occ = torch.zeros((), dtype=torch.int32, device=dev)
                    nover = torch.zeros((), dtype=torch.int32, device=dev)
                else:
                    bpos, occ, nover = rank_from_sorted_key(bucket_cfg, key)
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
            state, spawned, dense_key = _presort_state(state, spawned)

        vel, self_pref, state = _hl_phase(config, hl_planners, params, state)

        max_occ = torch.zeros((), dtype=torch.int32, device=dev)
        truncated = torch.zeros((), dtype=torch.int32, device=dev)
        if lp_planners:
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
                if config.neighbor_backend != BACKEND_BRUTE:
                    raise NotImplementedError(
                        "table-based planners need the brute backend in "
                        "the port")
                nbr = nbr_ops.brute_neighbors(state.position, state.eyesight,
                                              state.alive)
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
                    )
                    max_occ = torch.maximum(max_occ, occ)
                    truncated = truncated + dropped
                else:
                    v = planner.plan(params.lp[i], state, nbr, vel,
                                     self_pref)
                sel = (state.lp_idx == i) & state.alive
                vel = torch.where(sel[:, None], v, vel)

        state, events, _ = _finish_phase(
            config, hl_planners, params, state, vel, self_pref, spawned,
            spawn_dropped, max_occ, truncated, dt,
        )
        if skin_mode:
            # Despawns keep the carried binning valid: bucketize packs
            # fresh-dead rows inert (core/step.py:652-659).
            skin_out["valid"] = torch.ones((), dtype=torch.bool, device=dev)
            return state, events, skin_out
        return state, events

    step.skin_mode = skin_mode
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


def _step_counters(ev: StepEvents, st: SimState) -> dict:
    i32 = torch.int32
    return dict(
        n_alive=st.num_alive,
        n_spawned=ev.spawned.sum(dtype=i32),
        n_destroyed=ev.destroyed.sum(dtype=i32),
        n_waypoint_reached=ev.waypoint_reached.sum(dtype=i32),
        spawn_dropped=ev.spawn_dropped,
        out_of_bounds=ev.out_of_bounds.sum(dtype=i32),
        max_cell_occupancy=ev.max_cell_occupancy,
        neighbor_truncated=ev.neighbor_truncated,
    )


def build_rollout(config: SimConfig, hl_planners: Sequence[Any],
                  lp_planners: Sequence[Any], event_capacity: int = 0):
    """Construct ``rollout(params, state, dt, n_steps) -> (state,
    RolloutCounters)``: ``n_steps`` steps in a Python loop, on the
    presorted grid_pallas and grid_dense paths with the skin-deferred
    re-sort
    (core/step.py:753).  Per-uid event streams (``event_capacity > 0``)
    are not ported yet."""
    if event_capacity:
        raise NotImplementedError("event streams are not ported yet")
    step = build_step(config, hl_planners, lp_planners, skin_mode=True)
    uses_skin = bool(step.skin_mode)

    def rollout(params: SimParams, state: SimState, dt: float,
                n_steps: int):
        n = config.capacity
        dev = state.device
        skin = None
        if uses_skin:
            i32 = torch.int32
            skin = dict(
                valid=torch.zeros((), dtype=torch.bool, device=dev),
                key=torch.zeros((n,), dtype=i32, device=dev),
                bpos=torch.zeros((n,), dtype=i32, device=dev),
                max_occ=torch.zeros((), dtype=i32, device=dev),
                n_over=torch.zeros((), dtype=i32, device=dev),
                ref=torch.zeros((n, 2), dtype=config.tdtype, device=dev),
                resorted=False,
            )
        rows = []
        for _ in range(n_steps):
            if uses_skin:
                state, ev, skin = step(params, state, dt, skin)
            else:
                state, ev = step(params, state, dt)
            rows.append(_step_counters(ev, state))
        counters = RolloutCounters(**{
            k: torch.stack([r[k] for r in rows]) if rows
            else torch.zeros((0,), dtype=torch.int32, device=dev)
            for k in (f.name for f in dataclasses.fields(RolloutCounters))
        })
        return state, counters

    rollout.engine = "standard"
    return rollout
