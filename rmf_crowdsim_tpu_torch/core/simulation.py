"""Host-side simulation session: the public API mirroring the reference's
``Simulation<T: SpatialIndex>`` (lib.rs:69-192).

Counterpart of ``rmf_crowdsim_tpu/core/simulation.py`` (``EventListener``,
``AgentView``, ``NeighborTruncationError``, ``OutOfBoundsError`` and
``Simulation``, :43-707).  The host object owns the planner, source and
listener registries and the ``SimState`` on its device; each ``step(dt)``
runs the port's ``build_step`` and, only when listeners are registered,
brings the step's events back to dispatch ``EventListener`` callbacks
(lib.rs:22-33).

Method correspondence:

====================================  ==================================
reference (lib.rs)                     here
====================================  ==================================
``Simulation::new``        :103       ``Simulation(config)``
``add_agents``             :119       ``add_agents``
``add_source_sink``        :159       ``add_source_sink``
``remove_source_sink``     :164       ``remove_source_sink``
``add_event_listener``     :171       ``add_event_listener``
``remove_agents``          :176       ``remove_agents``
``step``                   :195       ``step``
``agents`` (public map)    :71        ``agents`` property / ``num_agents``
====================================  ==================================

Where the port differs from the JAX session:

- **One host read a step.**  Every read of the device from the host
  drains the launch queue, so ``step()`` fetches the truncation count, the
  out-of-bounds count and (with listeners) the step's events in one
  transfer (the JAX session reads the two counts separately).  ``run()``
  takes the rollout's one read a step, then one for the replay and the
  error counts.
- **Index-gathered dispatch.**  In place of the seven ``[N]`` arrays the
  JAX session fetches, the device compacts each event mask to the indices
  of its set bits (``compact_indices``) and gathers their uids and
  positions; only those cross.  A buffer too small for a step's events is
  grown and the step's events fetched again, so delivery stays complete.
- **Within a kind, events go out in uid order.**  The JAX session goes
  by slot, and slot order is an artifact of the layout: after the presort
  (``grid_pallas``, ``grid_dense``) ``step()`` re-sorts every step while
  ``run()`` re-sorts only when the skin demands it, so their slot orders
  differ.  The reference's own order is its agent ``HashMap``'s
  (lib.rs:304-336) for waypoints and despawns, and source order, which is
  uid order, for spawns.  In uid order ``step()`` and ``run()`` deliver
  the same sequence on every backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.source_sink import (
    GEN_CUSTOM,
    GEN_MONOTONIC,
    GEN_POISSON,
    SourceSink,
    stack_source_params,
)
from ..ops.compact import compact_indices
from ..utils.profiling import span
from ..utils.registry import Registry
from .config import SimConfig
from .state import SimState, make_state
from .step import (
    RolloutCounters,
    SimParams,
    _empty_records,
    _stack,
    build_rollout,
    build_step,
    emit_rollout_record,
)


class NeighborTruncationError(RuntimeError):
    """A step silently truncated neighbor interactions: some grid cell /
    supertile held more agents than the configured per-cell capacity
    (``max_per_cell`` / ``bucket_capacity``).  The reference's cells are
    unbounded (location_hash_2d.rs:15), so truncation is a physics
    divergence.  Raise-by-default; set ``SimConfig.on_truncation="ignore"``
    to audit manually via ``events.neighbor_truncated``."""


class OutOfBoundsError(RuntimeError):
    """An alive agent integrated outside the configured grid while
    ``SimConfig.on_out_of_bounds == "raise"`` — the strict-parity mode
    mirroring the reference, which errors the whole step when the spatial
    index rejects the new position (location_hash_2d.rs:61-63 →
    lib.rs:299-302).  The default ("ignore") surfaces the same condition
    as the ``events.out_of_bounds`` mask instead."""


class EventListener:
    """Observer API (lib.rs:22-33).  Subclass and override; all hooks are
    optional (the reference gives ``waypoint_reached`` a default no-op)."""

    def agent_spawned(self, position, agent_id: int) -> None:
        pass

    def agent_destroyed(self, agent_id: int) -> None:
        pass

    def waypoint_reached(self, position, agent_id: int) -> None:
        pass


@dataclasses.dataclass
class AgentView:
    """Host-side snapshot of one agent — the reference ``Agent`` struct
    (lib.rs:47-65) minus the dead ``orientation``/``angular_vel`` fields."""

    agent_id: int
    position: Tuple[float, float]
    velocity: Tuple[float, float]
    preferred_vel: Tuple[float, float]
    next_waypoint: int
    eyesight_range: float


def fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """numpy copies of ``tensors`` through one device-to-host transfer:
    their bytes are joined on the device and split again on the host."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[at:at + nbytes].copy().view(dtype).reshape(t.shape))
        at += nbytes
    return out


def _set_rows(state: SimState, slots: torch.Tensor, **values) -> SimState:
    """A copy of ``state`` whose fields ``values`` hold the given values at
    ``slots``; the old state's tensors stay as they were."""
    fields = {}
    for name, value in values.items():
        t = getattr(state, name).clone()
        t[slots] = value
        fields[name] = t
    return state.replace(**fields)


def _deliver(listeners, spawned, reached, destroyed) -> None:
    """One step's events in the reference's order of kinds (lib.rs:151-153,
    317, 189-191): spawns, waypoint hits, despawns; each kind in uid order.
    ``spawned``/``reached``: (uid [k], position [k, 2]); ``destroyed``: uid
    [k], each a numpy array."""
    s_uid, s_pos = spawned
    for j in np.argsort(s_uid, kind="stable"):
        for listener in listeners:
            listener.agent_spawned(tuple(s_pos[j]), int(s_uid[j]))
    r_uid, r_pos = reached
    for j in np.argsort(r_uid, kind="stable"):
        for listener in listeners:
            listener.waypoint_reached(tuple(r_pos[j]), int(r_uid[j]))
    for u in np.sort(destroyed, kind="stable"):
        for listener in listeners:
            listener.agent_destroyed(int(u))


class Simulation:
    def __init__(self, config: SimConfig, seed: int = 0, neighbor_fn=None,
                 device="cuda"):
        """A session whose state lives on ``device`` (the card unless the
        caller names another device).  ``neighbor_fn``: required iff
        ``config.neighbor_backend == "custom"`` — a function ``(state) ->
        NeighborSet`` (the SpatialIndex-trait extension point,
        spatial_index.rs:4-14; see core/step.build_step)."""
        self.config = config
        self.neighbor_fn = neighbor_fn
        if config.neighbor_backend == "custom" and neighbor_fn is None:
            raise ValueError(
                "neighbor_backend='custom' requires a neighbor_fn"
            )
        self.device = torch.device(device)
        self.state: SimState = make_state(config, seed, self.device)
        self._hl_planners: List[object] = []
        self._lp_planners: List[object] = []
        self._sources: List[SourceSink] = []
        self._source_registry: Registry[SourceSink] = Registry()
        # Registry id -> stacked-table row, recorded at add time: two
        # identically-configured SourceSinks are equal as dataclasses, so
        # a value search (list.index) would deactivate the wrong one.
        self._source_slot: Dict[int, int] = {}
        self._inactive_sources: set = set()
        self._event_listeners: Registry[EventListener] = Registry()
        self._params: Optional[SimParams] = None
        self._step_fn = None
        self._step_key = None
        self._rollouts: dict = {}
        self._dirty = True
        # Monotonic version bumped whenever a planner registry grows: the
        # step is rebuilt only when it changes.
        self._registry_version = 0
        # Event records a kind fetched per step; grown when a step has
        # more (see _read_step).
        self._event_k = max(1, config.event_stream_capacity)
        self._knn_cache = None
        self.last_events = None

    # -- planner registry ---------------------------------------------------

    def _planner_index(self, registry: List[object], planner: object) -> int:
        for i, p in enumerate(registry):
            if p is planner:
                return i
        registry.append(planner)
        self._dirty = True
        self._registry_version += 1
        return len(registry) - 1

    # -- public API ----------------------------------------------------------

    def add_agents(
        self,
        spawn_positions: Sequence[Tuple[float, float]],
        high_level_planner,
        local_planner,
        agent_eyesight_range: float,
    ) -> List[int]:
        """Spawn a group of agents sharing the same planners (lib.rs:119-156)
        in the first free slots.  Returns their (monotonic, never reused)
        agent ids; each agent's priority is its id.  Fires
        ``agent_spawned`` synchronously per agent, as the reference does
        (lib.rs:151-153)."""
        hl = self._planner_index(self._hl_planners, high_level_planner)
        lp = self._planner_index(self._lp_planners, local_planner)
        st = self.state
        f = self.config.tdtype
        n_new = len(spawn_positions)
        free = torch.nonzero(~st.alive).flatten()
        if free.shape[0] < n_new:
            raise ValueError(
                f"capacity exceeded: {n_new} spawns, "
                f"{free.shape[0]} free slots of {self.config.capacity}"
            )
        slots = free[:n_new]
        pos = torch.as_tensor(np.asarray(spawn_positions, np.float64)
                              .reshape(n_new, 2)).to(f).to(self.device)
        next_uid = int(st.next_uid)
        uids = torch.arange(next_uid, next_uid + n_new, dtype=torch.int32,
                            device=self.device)
        self.state = _set_rows(
            st, slots, position=pos, velocity=0.0, preferred_vel=0.0,
            next_waypoint=0, eyesight=float(agent_eyesight_range),
            alive=True, uid=uids, source_id=-1, hl_idx=hl, lp_idx=lp,
            route_id=-1, route_wp=0, priority=uids.to(f),
        ).replace(next_uid=torch.full((), next_uid + n_new,
                                      dtype=torch.int32, device=self.device))
        uid_list = list(range(next_uid, next_uid + n_new))
        for p, u in zip(spawn_positions, uid_list):
            for listener in self._event_listeners.values():
                listener.agent_spawned(tuple(p), u)
        return uid_list

    def add_source_sink(self, source_sink: SourceSink) -> int:
        """Register a SourceSink (lib.rs:159-161); its planners join the
        planner registries."""
        self._planner_index(self._hl_planners, source_sink.high_level_planner)
        self._planner_index(self._lp_planners, source_sink.local_planner)
        self._sources.append(source_sink)
        self._dirty = True
        sid = self._source_registry.add_new_item(source_sink)
        self._source_slot[sid] = len(self._sources) - 1
        return sid

    def remove_source_sink(self, source_id: int) -> None:
        """Deactivate a SourceSink (lib.rs:164-168 — like the reference,
        already-spawned agents are NOT removed; reference TODO at
        lib.rs:165-166).  The row stays in the stacked table (inactive) so
        existing agents keep their waypoint bookkeeping."""
        self._source_registry.remove(source_id)
        idx = self._source_slot.pop(source_id, None)
        if idx is None:
            return
        self._inactive_sources.add(idx)
        if self._params is not None and self._params.sources is not None:
            sp = self._params.sources
            active = sp.active.clone()
            active[idx] = False
            self._params = self._params.replace(
                sources=sp.replace(active=active))

    def add_event_listener(self, listener: EventListener) -> int:
        return self._event_listeners.add_new_item(listener)

    def remove_event_listener(self, listener_id: int) -> None:
        self._event_listeners.remove(listener_id)

    def remove_agents(self, agent_id: int) -> None:
        """Despawn one agent by id (lib.rs:176-192); fires
        ``agent_destroyed``.  Unlike the reference — which panics on an
        unknown id via direct map indexing (lib.rs:177-184) — unknown ids
        raise KeyError."""
        slot = self._slot_of(agent_id)
        self.state = _set_rows(self.state, slot, alive=False)
        for listener in self._event_listeners.values():
            listener.agent_destroyed(agent_id)

    def set_priority(self, agent_id: int, priority: float) -> None:
        """Override an agent's Zanlungo right-of-way priority — the
        reference's ``agent_priorities`` map (zanlungo.rs:17, defaulting to
        the agent id).

        With ``config.integer_priorities`` the force kernel is
        specialized to integer priority DIFFERENCES (the default uid
        priorities qualify); a fractional override would silently break
        that contract, so it raises here — set the flag False for
        fractional priority schemes."""
        if self.config.integer_priorities:
            p = float(priority)
            # math.isfinite first: int(inf) raises OverflowError and
            # int(nan) ValueError with the wrong message — non-finite
            # input must get this contract error, not a conversion error.
            if not (math.isfinite(p) and p == int(p)):
                raise ValueError(
                    f"priority {priority!r} is not a finite integer but "
                    "config.integer_priorities promises integer priority "
                    "differences (the int_prio kernel specialization); "
                    "set integer_priorities=False for fractional "
                    "priorities"
                )
        slot = self._slot_of(agent_id)
        self.state = _set_rows(self.state, slot, priority=float(priority))

    def set_target(self, agent_id: int, point: Tuple[float, float],
                   tolerance: Tuple[float, float] = (0.0, 0.0)) -> None:
        """Route an agent toward ``point`` via its high-level planner — the
        user-facing half of ``HighLevelPlanner::set_target``
        (highlevel_planners.rs:12).  Only meaningful for route-following
        planners; the planner plans (or cache-hits) on the host and the
        agent's route_id/route_wp are updated.  Tolerance is accepted for
        API parity; the reference's RMFPlanner ignores it
        (rmf/mod.rs:217-236)."""
        slot = self._slot_of(agent_id)
        hl_idx, pos = fetch(self.state.hl_idx[slot],
                            self.state.position[slot])
        planner = self._hl_planners[int(hl_idx)]
        if not getattr(planner, "uses_routes", False):
            return  # stub planners' set_target is a no-op (lib.rs:413-415)
        route_id = planner.plan_route_cached(tuple(pos), tuple(point))
        self._dirty = True  # route table may have grown
        if route_id is None:
            # Reference prints and leaves the agent planless
            # (rmf/mod.rs:233-235).
            return
        self.state = _set_rows(self.state, slot, route_id=route_id,
                               route_wp=0)

    # -- stepping -------------------------------------------------------------

    def _rebuild(self) -> None:
        """Refresh the parameters on the device (planning each source's
        route legs first, which may grow route tables); rebuild the step
        only when a planner registry grew."""
        dev = self.device
        sources = None
        if self._sources:
            hl_idx = [
                self._planner_index(self._hl_planners, s.high_level_planner)
                for s in self._sources
            ]
            lp_idx = [
                self._planner_index(self._lp_planners, s.local_planner)
                for s in self._sources
            ]
            leg_routes = []
            for s in self._sources:
                planner = s.high_level_planner
                if getattr(planner, "uses_routes", False):
                    leg_routes.append(planner.plan_source_legs(s))
                else:
                    leg_routes.append([-1] * len(s.waypoints))
            sources = stack_source_params(
                self._sources, hl_idx, lp_idx, leg_routes,
                self.config.tdtype, device=dev)
            if self._inactive_sources:
                active = sources.active.clone()
                active[sorted(self._inactive_sources)] = False
                sources = sources.replace(active=active)
        self._params = SimParams(
            hl=tuple(p.init_params(dev) for p in self._hl_planners),
            lp=tuple(p.init_params(dev) for p in self._lp_planners),
            sources=sources)
        if self._step_fn is None or self._step_key != self._registry_version:
            self._step_fn = build_step(self.config, self._hl_planners,
                                       self._lp_planners,
                                       neighbor_fn=self.neighbor_fn)
            self._step_key = self._registry_version
        self._dirty = False

    def _has_custom_generators(self) -> bool:
        return any(
            getattr(s.crowd_generator, "kind", GEN_CUSTOM)
            not in (GEN_MONOTONIC, GEN_POISSON)
            for s in self._sources
        )

    def _refresh_custom_counts(self, dt: float) -> None:
        """Call each GEN_CUSTOM generator's ``get_number_to_spawn(dt)``
        (the reference trait, source_sink.rs:30-33) and store the counts in
        the stacked params for the device spawn phase."""
        if not self._has_custom_generators():
            return
        counts = [
            0 if getattr(s.crowd_generator, "kind", GEN_CUSTOM)
            in (GEN_MONOTONIC, GEN_POISSON)
            else int(s.crowd_generator.get_number_to_spawn(dt))
            for s in self._sources
        ]
        sp = self._params.sources
        self._params = self._params.replace(sources=sp.replace(
            custom_count=torch.tensor(counts, dtype=torch.int32,
                                      device=self.device)))

    def step(self, dt: float) -> None:
        """Run one simulation step of ``dt`` seconds (lib.rs:195-383)."""
        if self._dirty or self._step_fn is None:
            self._rebuild()
        if self._params.sources is not None:
            self._refresh_custom_counts(dt)
        self.state, events = self._step_fn(self._params, self.state, dt)
        self.last_events = events
        self._read_step(events)

    def _read_step(self, events) -> None:
        """The step's one host read: the truncation and out-of-bounds
        counts and, with listeners, each event kind's uids and positions
        (compacted on the device); then dispatch, then the errors, as the
        JAX session orders them."""
        cfg = self.config
        listeners = list(self._event_listeners.values())
        if not (listeners or cfg.on_truncation == "raise"
                or cfg.on_out_of_bounds == "raise"):
            return
        i32 = torch.int32
        diag = torch.stack([events.neighbor_truncated.to(i32),
                            events.max_cell_occupancy.to(i32),
                            events.out_of_bounds.sum(dtype=i32)])
        kinds = ((events.spawned, self.state.uid, events.spawn_position),
                 (events.waypoint_reached, self.state.uid,
                  events.waypoint_position),
                 (events.destroyed, events.destroyed_uid, None))
        with span("crowdsim.session.read"):
            while True:
                k = self._event_k
                parts = [diag]
                if listeners:
                    comps = [compact_indices(mask, k) for mask, _, _ in kinds]
                    parts.append(torch.stack([c.count for c in comps]))
                    for c, (mask, uid, pos) in zip(comps, kinds):
                        safe = torch.clamp(c.idx, 0, mask.shape[0] - 1).long()
                        parts.append(uid[safe])
                        if pos is not None:
                            parts.append(pos[safe])
                host = fetch(*parts)
                if not listeners or int(host[1].max()) <= k:
                    break
                # More events than records: grow the buffer, fetch again.
                self._event_k = 1 << (int(host[1].max()) - 1).bit_length()
        truncated, max_occ, n_oob = (int(v) for v in host[0])
        if listeners:
            n_s, n_r, n_d = (int(v) for v in host[1])
            s_uid, s_pos, r_uid, r_pos, d_uid = host[2:]
            _deliver(listeners, (s_uid[:n_s], s_pos[:n_s]),
                     (r_uid[:n_r], r_pos[:n_r]), d_uid[:n_d])
        if cfg.on_truncation == "raise" and truncated > 0:
            raise NeighborTruncationError(
                f"{truncated} agents lost neighbor interactions this "
                f"step (occupancy {max_occ} > "
                f"{cfg.neighbor_capacity_limit} per "
                f"cell/tile); raise max_per_cell/bucket_capacity or "
                f"set on_truncation='ignore'"
            )
        if cfg.on_out_of_bounds == "raise" and n_oob > 0:
            raise OutOfBoundsError(
                f"{n_oob} alive agents left the grid this step "
                f"(strict-parity mode: the reference errors the whole "
                f"step, lib.rs:299-302); enlarge the grid or set "
                f"on_out_of_bounds='ignore'"
            )

    def run(self, n_steps: int, dt: float) -> RolloutCounters:
        """Run ``n_steps`` steps through ``build_rollout`` — equivalent to
        calling :meth:`step` ``n_steps`` times.

        With EventListeners registered, the rollout also records a
        compacted per-step event stream (exact uids and positions, up to
        ``config.event_stream_capacity`` per kind per step), replayed
        through the listeners on the host afterwards, in step order;
        more events than that raise before any is delivered.  Returns the
        per-step :class:`RolloutCounters` either way."""
        if self._dirty or self._step_fn is None:
            self._rebuild()
        n_steps = int(n_steps)
        if self._has_custom_generators():
            # Custom generators are host callbacks, called before each
            # step: step one at a time (built-in Poisson/Monotonic
            # generators keep the rollout).
            rows = []
            for _ in range(n_steps):
                self.step(dt)
                rows.append(emit_rollout_record(self.last_events,
                                                self.state, 0))
            if not rows:
                return _empty_records(0, self.config.tdtype, self.device)
            return _stack(rows)
        listeners = list(self._event_listeners.values())
        k = self.config.event_stream_capacity if listeners else 0
        rollout = self._rollouts.get(k)
        if rollout is None or rollout.key != self._step_key:
            rollout = build_rollout(self.config, self._hl_planners,
                                    self._lp_planners, event_capacity=k,
                                    neighbor_fn=self.neighbor_fn)
            rollout.key = self._step_key
            self._rollouts[k] = rollout
        self.state, ys = rollout(self._params, self.state, dt, n_steps)
        counters = ys.counters if listeners else ys
        self._read_run(counters, ys if listeners else None)
        return counters

    def _read_run(self, counters: RolloutCounters, stream) -> None:
        """``run()``'s one read after the rollout: the error counts and,
        with listeners, the event stream; then the replay and the
        errors."""
        cfg = self.config
        if not (stream is not None or cfg.on_truncation == "raise"
                or cfg.on_out_of_bounds == "raise"):
            return
        i32 = torch.int32
        occ = counters.max_cell_occupancy
        diag = torch.stack([
            counters.neighbor_truncated.sum(dtype=i32),
            occ.max().to(i32) if occ.numel() else occ.new_zeros((), dtype=i32),
            counters.out_of_bounds.sum(dtype=i32)])
        parts = [diag]
        if stream is not None:
            parts += [stream.overflow, stream.spawned_uid, stream.spawned_pos,
                      stream.reached_uid, stream.reached_pos,
                      stream.destroyed_uid]
        host = fetch(*parts)
        truncated, max_occ, n_oob = (int(v) for v in host[0])
        if stream is not None:
            self._replay_event_stream(*host[1:])
        if cfg.on_truncation == "raise" and truncated > 0:
            raise NeighborTruncationError(
                f"{truncated} agent-steps lost neighbor interactions "
                f"during the rollout (peak occupancy {max_occ} > "
                f"{cfg.neighbor_capacity_limit} per cell/tile)"
            )
        if cfg.on_out_of_bounds == "raise" and n_oob > 0:
            raise OutOfBoundsError(
                f"{n_oob} agent-steps left the grid during the "
                f"rollout (strict-parity mode, lib.rs:299-302); "
                f"enlarge the grid or set on_out_of_bounds='ignore'"
            )

    def _replay_event_stream(self, overflow, s_uid, s_pos, r_uid, r_pos,
                             d_uid) -> None:
        """Replay a rollout's :class:`EventStream` (as numpy arrays)
        through the registered listeners, in step order, each step as
        :meth:`step` delivers it."""
        total_over = int(overflow.sum())
        if total_over > 0:
            raise RuntimeError(
                f"{total_over} events exceeded "
                f"event_stream_capacity={self.config.event_stream_capacity} "
                f"during run(); listener delivery would be incomplete — "
                f"raise the capacity or step() instead"
            )
        listeners = list(self._event_listeners.values())
        for t in range(s_uid.shape[0]):
            s, r, d = s_uid[t] >= 0, r_uid[t] >= 0, d_uid[t] >= 0
            _deliver(listeners, (s_uid[t][s], s_pos[t][s]),
                     (r_uid[t][r], r_pos[t][r]), d_uid[t][d])

    # -- spatial queries (the reference's public SpatialIndex surface,
    #    spatial_index.rs:4-14) -----------------------------------------------

    def _knn_binning(self):
        """Grid binning of the current state, cached until the state
        changes (every mutation replaces ``self.state``, so object
        identity is the cache key) — repeated queries within a step share
        one binning, like the reference's incrementally-maintained hash
        (location_hash_2d.rs:126-149)."""
        from ..ops.grid import bin_agents

        cached = self._knn_cache
        if cached is not None and cached[0] is self.state:
            return cached[1]
        b = bin_agents(self.config.grid, self.state.position,
                       self.state.alive)
        self._knn_cache = (self.state, b)
        return b

    def _point(self, point) -> torch.Tensor:
        return torch.tensor(tuple(point), dtype=torch.float64).to(
            self.config.tdtype).to(self.device)

    def get_neighbours_in_radius(self, radius: float, point) -> List[int]:
        """Agent ids strictly within ``radius`` of ``point``
        (location_hash_2d.rs:240-258 semantics: strict <)."""
        from ..ops.neighbors import neighbors_in_radius

        r = torch.tensor(float(radius), dtype=torch.float64).to(
            self.config.tdtype).to(self.device)
        mask = neighbors_in_radius(self.state.position, self.state.alive, r,
                                   self._point(point))
        return self.state.uid[mask].tolist()

    def get_nearest_neighbours(self, n: int, point) -> List[int]:
        """The ``n`` nearest agent ids to ``point``, nearest first
        (spatial_index.rs:7-8).  Exact — unlike the reference's ring scan,
        which misses corner cells (location_hash_2d.rs:177-218).

        With a grid configured and ``capacity >=
        config.knn_grid_threshold``, the query is spatially bounded like
        the reference's: candidates come from an expanding cell window
        (ops/neighbors.nearest_neighbors_tiered, over the cached binning)
        that grows until the k-th hit is provably inside it, with the O(N)
        brute pass as its last tier; below the threshold, or without a
        grid, the brute pass alone.  Exact either way."""
        from ..ops.neighbors import nearest_neighbors, nearest_neighbors_tiered

        pt = self._point(point)
        if (self.config.grid is not None
                and self.config.capacity >= self.config.knn_grid_threshold):
            b = self._knn_binning()
            idx, valid = nearest_neighbors_tiered(
                self.config.grid, b.starts, b.order, self.state.position,
                self.state.alive, n, pt)
        else:
            idx, valid = nearest_neighbors(self.state.position,
                                           self.state.alive, n, pt)
        return self.state.uid[idx[valid]].tolist()

    # -- checkpoint / resume (absent in the reference, SURVEY.md §5) ----------

    def save(self, path: str) -> None:
        """Checkpoint the complete simulation state, its generator
        included, to ``path`` (.npz)."""
        from ..utils.checkpoint import save_state

        save_state(path, self.state)

    def load(self, path: str) -> None:
        """Restore state from a checkpoint onto this session's device.
        Capacity must match the current config (static shapes)."""
        from ..utils.checkpoint import load_state

        state = load_state(path, device=self.device)
        if state.capacity != self.config.capacity:
            raise ValueError(
                f"checkpoint capacity {state.capacity} != config "
                f"capacity {self.config.capacity}"
            )
        self.state = state

    # -- observability ---------------------------------------------------------

    def _slot_of(self, agent_id: int) -> int:
        hits = torch.nonzero((self.state.uid == agent_id) & self.state.alive)
        if hits.shape[0] == 0:
            raise KeyError(f"no live agent with id {agent_id}")
        return int(hits[0, 0])

    @property
    def num_agents(self) -> int:
        return int(self.state.num_alive)

    @property
    def sim_time(self) -> float:
        return float(self.state.sim_time)

    @property
    def agents(self) -> Dict[int, AgentView]:
        """Host snapshot of all live agents, keyed by agent id — the
        reference's public ``agents`` HashMap (lib.rs:71)."""
        st = self.state
        uid, alive, pos, vel, pref, nwp, eye = fetch(
            st.uid, st.alive, st.position, st.velocity, st.preferred_vel,
            st.next_waypoint, st.eyesight)
        out = {}
        for slot in np.flatnonzero(alive):
            out[int(uid[slot])] = AgentView(
                agent_id=int(uid[slot]),
                position=tuple(pos[slot]),
                velocity=tuple(vel[slot]),
                preferred_vel=tuple(pref[slot]),
                next_waypoint=int(nwp[slot]),
                eyesight_range=float(eye[slot]),
            )
        return out
