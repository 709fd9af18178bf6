"""The bench scene and the streaming scene, built without JAX.

``build_bench`` is the counterpart of ``bench.py:31-123`` (``_bench_config``
and ``build_bench``) and of the hotspot of ``compiled_parity_check``
(``bench.py:138-143``): a uniform dense Zanlungo crowd (~1.6 m^2 per
agent, eyesight 2 m) with ``ParityVelocity`` + ``Zanlungo``, built from
the same numpy seeds so both packages start from the same positions.

``build_streams`` has no counterpart in ``bench.py`` (which passes no
sources): the same crowd at a larger capacity, plus a square lattice of
SourceSinks over the world's interior that stream ``WaypointFollow``
agents through two waypoints each, so agents spawn, reach waypoints,
despawn or loop, and are blocked by the 0.4 m spawn clearance.
``build_session`` is the same scene as a ``Simulation`` session, built
through its public API, with an ``RMFPlanner`` planning the sources'
route legs.

``crossing_scene`` is the JAX package's world-engine test scene
(tests/test_worldstep.py:34-76): sources on the left edge of a 48 m
world, sinks on the right, agents crossing every region boundary.
``build_world_bench`` is the bench scene on the world-sharded engine
(``parallel/worldstep.py``), its state split by region over a
``ThreadMesh``; ``build_shard_proxy`` copies ``bench.py:162-260``'s world
of one shard of a D-shard bench world at full width, on one shard.
``build_rmf_hall`` is ``bench.py:299-390``'s walled hall with every agent
routed by an ``RMFPlanner``.

The randomized differential sweep of tests/test_fuzz_step.py is here as
plain data: ``fuzz_case``, ``agree_case`` and ``bucket32_case`` draw its
cases seed for seed into a ``FuzzCase`` (no JAX needed), which
``populate_fuzz_session`` adds to a ``Simulation`` of either package and
``drive_fuzz`` steps and holds against ``brute``; ``wide_cases`` are the
same draws at the card's scale.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import sys
import time

import numpy as np
import torch

from .core.config import GridConfig, SimConfig
from .core.simulation import Simulation
from .core.state import make_state
from .core.step import SimParams, build_rollout, payload_sort_by_key
from .models.highlevel import (
    ConstantVelocity,
    ParityVelocity,
    RouteTable,
    WaypointFollow,
)
from .models.local import Zanlungo
from .models.rmf import RMFPlanner
from .models.source_sink import MonotonicCrowd, SourceSink, stack_source_params
from .ops import zanlungo_bucketed as zb
from .ops.zanlungo_dense import DenseConfig

HOTSPOT_AGENTS = 48
# The streaming sources' two waypoints, metres along +x from the source,
# and their sink radius.
STREAM_WAYPOINTS = (0.3, 1.25)
STREAM_SINK_RADIUS = 1.0
STREAM_RATE = 60.0  # agents/s: one request a step at dt = 1/60


def bench_config(n_agents: int, dtype: str = "float32",
                 backend: str = "grid_pallas",
                 fused_spills: bool = False) -> SimConfig:
    """bench.py:31-75: tiles of 5.3 m with buckets of 32, the pack
    kernel, ``spill_capacity = max(128, n // 4096)``, and on the kernel
    backends presort, integer priorities and ``dual_row``.
    ``fused_spills``: the SimConfig field of that name (bench.py leaves
    it at its default, False)."""
    area_per_agent = 1.6
    side = float(np.ceil(np.sqrt(n_agents * area_per_agent)))
    cell = 2.0
    side = float(np.ceil(side / cell) * cell)
    kernel_backend = backend in ("grid_pallas", "grid_dense")
    return SimConfig(
        capacity=n_agents,
        grid=GridConfig(width=side, height=side, cell_size=cell,
                        offset=(-side / 2, -side / 2)),
        neighbor_backend=backend,
        max_per_cell=16,
        max_eyesight=2.0,
        bucket_capacity=32,
        sub_tiles=2,
        strip_tiles=96,
        bucket_tile_size=5.3,
        use_pack_kernel=(backend == "grid_pallas"),
        spill_capacity=max(128, n_agents // 4096),
        presort=kernel_backend,
        integer_priorities=kernel_backend,
        dual_row=kernel_backend,
        fused_spills=fused_spills,
        dtype=dtype,
    )


def bench_positions(n_agents: int, side: float, hotspot: bool = False,
                    hotspot_origin=(10.0, 10.0)) -> np.ndarray:
    """Initial positions [N, 2] float64: uniform in the world's interior
    (seed 0), with ``hotspot`` the first 48 agents moved into one 2 m
    square at ``hotspot_origin`` (seed 7).  At bench.py's origin (10, 10)
    the square overflows a bucket of 32 from 4,096 agents up; at 1,024
    agents it straddles tile corners and needs an origin inside one tile,
    such as (6, 6), to overflow."""
    lim = side / 2 - 1.0
    pos = np.random.default_rng(0).uniform(-lim, lim, size=(n_agents, 2))
    if hotspot:
        rng = np.random.default_rng(7)
        pos[:HOTSPOT_AGENTS] = (
            rng.uniform(0.0, 2.0, (HOTSPOT_AGENTS, 2))
            + np.asarray(hotspot_origin, np.float64))
    return pos


def bench_zanlungo(force_chunk: int = 0) -> Zanlungo:
    """The bench scene's local planner (bench.py:95-100); ``force_chunk``:
    the query chunk of the table-based backends."""
    return Zanlungo(agent_scale=1.0, obstacle_scale=1.0, reaction_time=0.0,
                    force_distance=1.0, agent_mass=2.0, agent_radius=0.25,
                    force_chunk=force_chunk, force_cap=20.0)


def _crowd_state(config: SimConfig, n_agents: int, pos: np.ndarray, device):
    """A state of ``config.capacity`` slots whose first ``n_agents`` hold
    the bench crowd at ``pos`` (uids and priorities 0..n-1, planners 0),
    the rest free."""
    f = config.tdtype
    i32 = torch.int32
    st = make_state(config, device=device)
    crowd = dict(
        position=torch.as_tensor(pos, dtype=f).to(device),
        eyesight=torch.full((n_agents,), 2.0, dtype=f, device=device),
        alive=torch.ones((n_agents,), dtype=torch.bool, device=device),
        uid=torch.arange(n_agents, dtype=i32, device=device),
        hl_idx=torch.zeros((n_agents,), dtype=i32, device=device),
        lp_idx=torch.zeros((n_agents,), dtype=i32, device=device),
        priority=torch.arange(n_agents, dtype=f, device=device),
    )
    fields = {}
    for name, value in crowd.items():
        full = getattr(st, name).clone()
        full[:n_agents] = value
        fields[name] = full
    return st.replace(next_uid=torch.full((), n_agents, dtype=i32,
                                          device=device), **fields)


def build_bench(n_agents: int, dtype: str = "float32",
                backend: str = "grid_pallas", device="cuda",
                hotspot: bool = False, hotspot_origin=(10.0, 10.0),
                fused_spills: bool = False, force_chunk: int = 0):
    """The bench scene at ``n_agents`` on ``device`` (the card unless the
    caller names another device): returns (rollout, params, state) like
    bench.py's ``build_bench``.  ``force_chunk``: ``Zanlungo``'s query
    chunk for the table-based backends (``grid``, ``brute``)."""
    config = bench_config(n_agents, dtype=dtype, backend=backend,
                          fused_spills=fused_spills)
    hl = ParityVelocity((1.0, 0.0))
    lp = bench_zanlungo(force_chunk)
    rollout = build_rollout(config, [hl], [lp])
    pos = bench_positions(n_agents, config.grid.width, hotspot=hotspot,
                          hotspot_origin=hotspot_origin)
    state = _crowd_state(config, n_agents, pos, device)
    params = SimParams(hl=(hl.init_params(device),),
                       lp=(lp.init_params(device),), sources=None)
    return rollout, params, state


def bucket_config(c: SimConfig) -> zb.BucketConfig:
    """The bucketed layout ``build_step`` derives from ``c``."""
    return zb.BucketConfig.create(
        c.grid.width, c.grid.height, c.grid.offset, c.max_eyesight,
        bucket=c.bucket_capacity, strip_tiles=c.strip_tiles,
        sub_tiles=c.sub_tiles, tile_size=c.bucket_tile_size or None)


def bench_bucket_config(n_agents: int) -> zb.BucketConfig:
    """The bucketed layout of the ``grid_pallas`` bench scene."""
    return bucket_config(bench_config(n_agents))


def bench_dense_config(n_agents: int, capacity: int = 0) -> DenseConfig:
    """The dense layout of the ``grid_dense`` bench scene (with
    ``capacity`` slots: the streaming scene's), as ``build_step`` derives
    it."""
    c = stream_config(n_agents, capacity or n_agents, backend="grid_dense")
    return DenseConfig.create(
        c.grid.width, c.grid.height, c.grid.offset, c.max_eyesight,
        c.capacity, tile_size=c.bucket_tile_size,
        col_headroom=c.dense_col_headroom)


def bench_bucketed(n_agents: int, device="cuda", steps: int = 2,
                   hotspot_origin=(10.0, 10.0)):
    """The inputs of the bucketed force kernels on the bench scene with
    the 48-agent hotspot, after ``steps`` steps of the ``grid_pallas``
    rollout: the state tile-sorted and binned as the fused pass bins it.
    The first step starts from rest and has no pair forces; the second
    has them, and its capped overlap forces scatter the hotspot over
    ~8 m.  Returns (config, bucket config, params, state, rec, feat_t
    [NUM_F, N], bpos_sorted [N], bucket_pos [N]); ``rec`` is the
    planner's velocity, passed as both self and recommended velocity."""
    config = bench_config(n_agents)
    bcfg = bench_bucket_config(n_agents)
    rollout, params, st = build_bench(n_agents, device=device, hotspot=True,
                                      hotspot_origin=hotspot_origin)
    st, _ = rollout(params, st, 1.0 / 60.0, steps)
    st, _, _ = payload_sort_by_key(st, zb.tile_key(bcfg, st.position,
                                                   st.alive),
                                   torch.zeros_like(st.alive))
    rec = ParityVelocity((1.0, 0.0)).plan(params.hl[0], st).vel
    feat_t, bpos, bucket_pos, _, _ = zb.feature_rows(
        bcfg, st.position, st.velocity, st.preferred_vel, rec, st.priority,
        st.eyesight, rec, st.alive, use_pack_kernel=True, presorted=True)
    return config, bcfg, params, st, rec, feat_t, bpos, bucket_pos


def stream_sources(n_sources: int, side: float) -> np.ndarray:
    """[S, 2] float64: the centres of a sqrt(S) x sqrt(S) lattice over the
    bench crowd's interior ``[-(side/2 - 1), side/2 - 1]^2``."""
    m = math.isqrt(n_sources)
    if m * m != n_sources:
        raise ValueError(f"n_sources {n_sources} is not a square")
    lim = side / 2 - 1.0
    c = -lim + (np.arange(m) + 0.5) * (2 * lim / m)
    return np.stack(np.meshgrid(c, c, indexing="ij"), -1).reshape(-1, 2)


def stream_routes(src: np.ndarray, dtype: torch.dtype, device) -> RouteTable:
    """One two-point route per leg of each source: route ``2s`` runs from
    source ``s`` to its first waypoint, ``2s + 1`` from the first to the
    second (R = 2S, L = 2)."""
    w0, w1 = STREAM_WAYPOINTS
    pts = np.empty((src.shape[0], 2, 2, 2))
    pts[:, 0, 0] = src
    pts[:, 0, 1] = src + (w0, 0.0)
    pts[:, 1, 0] = src + (w0, 0.0)
    pts[:, 1, 1] = src + (w1, 0.0)
    return RouteTable(
        points=torch.as_tensor(pts.reshape(-1, 2, 2), dtype=dtype).to(device),
        lengths=torch.full((2 * src.shape[0],), 2, dtype=torch.int32,
                           device=device))


def stream_config(n_agents: int, capacity: int, dtype: str = "float32",
                  backend: str = "grid_pallas",
                  fused_spills: bool = False) -> SimConfig:
    """``bench_config(n_agents)`` (world, tiles, buckets, spill capacity
    sized by the crowd) with ``capacity`` slots."""
    return dataclasses.replace(
        bench_config(n_agents, dtype=dtype, backend=backend,
                     fused_spills=fused_spills),
        capacity=capacity)


def stream_planners(routes: RouteTable):
    """The streaming scene's planner registries: (``[ParityVelocity,
    WaypointFollow(routes)]``, ``[Zanlungo]``)."""
    return ([ParityVelocity((1.0, 0.0)), WaypointFollow(routes)],
            [bench_zanlungo()])


def stream_sinks(src: np.ndarray, hl, lp):
    """The streaming scene's SourceSinks at ``src`` [S, 2]: each requests
    ``STREAM_RATE`` agents/s (``MonotonicCrowd``), whose agents get
    eyesight 2 and the planners ``hl`` and ``lp``; the waypoints lie
    ``STREAM_WAYPOINTS`` metres along +x with sink radius
    ``STREAM_SINK_RADIUS``; odd sources loop forever."""
    w0, w1 = STREAM_WAYPOINTS
    return [
        SourceSink(source=(float(x), float(y)),
                   waypoints=[(float(x) + w0, float(y)),
                              (float(x) + w1, float(y))],
                   radius_sink=STREAM_SINK_RADIUS,
                   crowd_generator=MonotonicCrowd(STREAM_RATE),
                   high_level_planner=hl, local_planner=lp,
                   agent_eyesight_range=2.0, loop_forever=bool(i % 2))
        for i, (x, y) in enumerate(src)
    ]


def build_streams(n_agents: int, capacity: int, n_sources: int,
                  dtype: str = "float32", backend: str = "grid_pallas",
                  device="cuda", hotspot: bool = False,
                  hotspot_origin=(10.0, 10.0), fused_spills: bool = False,
                  event_capacity: int = 0):
    """The streaming scene on ``device`` (the card unless the caller names
    another device): the bench crowd of ``n_agents`` (``ParityVelocity`` at
    ``hl_idx`` 0, ``Zanlungo``; :func:`stream_config`) in ``capacity``
    slots, and ``n_sources`` SourceSinks on the lattice of
    :func:`stream_sources`.  Each source requests ``STREAM_RATE`` agents/s
    (``MonotonicCrowd``); new agents get eyesight 2, ``WaypointFollow`` at
    ``hl_idx`` 1 over :func:`stream_routes` and ``Zanlungo``; the
    waypoints lie ``STREAM_WAYPOINTS`` metres along +x with sink radius
    ``STREAM_SINK_RADIUS``; odd sources loop forever.  Returns (rollout,
    params, state); ``event_capacity`` is ``build_rollout``'s."""
    config = stream_config(n_agents, capacity, dtype=dtype, backend=backend,
                           fused_spills=fused_spills)
    f = config.tdtype
    src = stream_sources(n_sources, config.grid.width)
    hl, lp = stream_planners(stream_routes(src, f, device))
    rollout = build_rollout(config, hl, lp, event_capacity=event_capacity)
    pos = bench_positions(n_agents, config.grid.width, hotspot=hotspot,
                          hotspot_origin=hotspot_origin)
    state = _crowd_state(config, n_agents, pos, device)
    sources = stream_sinks(src, hl[1], lp[0])
    sp = stack_source_params(
        sources, [1] * n_sources, [0] * n_sources,
        [[2 * i, 2 * i + 1] for i in range(n_sources)], f, device=device)
    params = SimParams(hl=tuple(h.init_params(device) for h in hl),
                       lp=(lp[0].init_params(device),), sources=sp)
    return rollout, params, state


def build_session(n_agents: int, capacity: int, n_sources: int,
                  dtype: str = "float32", backend: str = "grid_pallas",
                  device="cuda", hotspot: bool = False,
                  hotspot_origin=(10.0, 10.0), fused_spills: bool = False,
                  event_capacity: int = 128):
    """The streaming scene of :func:`build_streams` as a
    :class:`Simulation` on ``device`` (the card unless the caller names
    another device), built through the session's API: the bench crowd by
    ``add_agents`` (``ParityVelocity``, ``Zanlungo``, eyesight 2; uids
    and priorities 0..n-1), then the ``n_sources`` SourceSinks by
    ``add_source_sink``, whose agents follow an ``RMFPlanner`` over the
    world's four boundary walls, a building of one square room (scale
    0.5, radius 0.3, room for two legs a source).  Each leg is a
    straight shot, so the planned routes are :func:`stream_routes`' and
    the session steps as the rollout of :func:`build_streams` does.  ``event_capacity``: the config's
    ``event_stream_capacity``.  The legs are planned at the session's
    first step, or by the caller before it (``plan_source_legs``).
    Returns (session, planner, SourceSinks)."""
    config = dataclasses.replace(
        stream_config(n_agents, capacity, dtype=dtype, backend=backend,
                      fused_spills=fused_spills),
        event_stream_capacity=event_capacity)
    side = config.grid.width
    sim = Simulation(config, device=device)
    lp = bench_zanlungo()
    sim.add_agents(bench_positions(n_agents, side, hotspot=hotspot,
                                   hotspot_origin=hotspot_origin),
                   ParityVelocity((1.0, 0.0)), lp, 2.0)
    h = side / 2
    planner = RMFPlanner([(-h, -h), (h, -h), (h, h), (-h, h)],
                         [(0, 1), (1, 2), (2, 3), (3, 0)], scale=0.5,
                         radius=0.3, max_routes=2 * n_sources,
                         dtype=config.tdtype)
    sources = stream_sinks(stream_sources(n_sources, side), planner, lp)
    for ss in sources:
        sim.add_source_sink(ss)
    return sim, planner, sources


def build_world_bench(n_agents: int, d: int, invariance: str = "bitwise",
                      capacity: int = 0, device="cuda",
                      hotspot: bool = False, hotspot_origin=(10.0, 10.0)):
    """The bench scene of :func:`build_bench` on the world-sharded engine
    over a ``ThreadMesh`` of ``d`` shards on ``device`` (the card unless
    the caller names another device), in ``sharding_invariance`` mode
    ``invariance``, with ``capacity`` slots (default: ``n_agents`` rounded
    up to a multiple of ``d``).  A region's crowd must fit a shard's
    ``capacity / d`` slots: raise the capacity for that, the crowd stays.
    Returns (rollout, params, shards, mesh)."""
    from .parallel.comm import make_thread_mesh
    from .parallel.worldstep import build_world_rollout, shard_state_by_region

    cap = capacity or -(-n_agents // d) * d
    config = dataclasses.replace(bench_config(n_agents), capacity=cap,
                                 sharding_invariance=invariance)
    mesh = make_thread_mesh(d, device)
    hl = ParityVelocity((1.0, 0.0))
    lp = bench_zanlungo()
    pos = bench_positions(n_agents, config.grid.width, hotspot=hotspot,
                          hotspot_origin=hotspot_origin)
    shards = shard_state_by_region(
        config, mesh, _crowd_state(config, n_agents, pos, "cpu"))
    params = SimParams(hl=(hl.init_params(mesh.device),),
                       lp=(lp.init_params(mesh.device),), sources=None)
    return (build_world_rollout(config, [hl], [lp], mesh), params, shards,
            mesh)


def build_shard_proxy(d: int = 10, invariance: str = "bitwise",
                      device="cuda"):
    """One shard of the ``d``-shard bench world at full width
    (bench.py:162-260 ``time_shard_proxy``): the 1M bench world's tiles
    split over ``d`` shards, a world as wide as one shard's extended
    block (its ``cols_per`` columns and two halo columns a side) and as
    high as the bench world, fully populated at the bench density
    (uniform, seed 0), on the world engine over one shard on ``device``
    (the card unless the caller names another device), so a step is a
    shard's whole body with its collectives degenerate.  Returns
    (rollout, params, shards, mesh)."""
    from .parallel.comm import make_thread_mesh
    from .parallel.worldstep import build_world_rollout, shard_state_by_region

    n_world = 1_000_000
    world = bench_config(n_world)
    bcfg = bench_bucket_config(n_world)
    tx = bcfg.tx + (-bcfg.tx) % d
    width = (tx // d + 2 * 2) * bcfg.tile_size
    height = world.grid.height
    n = int(round(n_world * (width * height)
                  / (world.grid.width * world.grid.height)))
    n = (n + 7) // 8 * 8
    config = dataclasses.replace(
        world, capacity=n,
        grid=GridConfig(width=width, height=height, cell_size=2.0,
                        offset=(0.0, world.grid.offset[1])),
        spill_capacity=max(128, n // 4096), sharding_invariance=invariance)
    rng = np.random.default_rng(0)
    y0, h = config.grid.offset[1], config.grid.height
    pos = np.stack([rng.uniform(1.0, config.grid.width - 1.0, n),
                    rng.uniform(y0 + 1.0, y0 + h - 1.0, n)], axis=-1)
    mesh = make_thread_mesh(1, device)
    hl = ParityVelocity((1.0, 0.0))
    lp = bench_zanlungo()
    shards = shard_state_by_region(config, mesh,
                                   _crowd_state(config, n, pos, "cpu"))
    params = SimParams(hl=(hl.init_params(mesh.device),),
                       lp=(lp.init_params(mesh.device),), sources=None)
    return (build_world_rollout(config, [hl], [lp], mesh), params, shards,
            mesh)


RMF_HALL_GOAL = (190.0, 90.0)


def build_rmf_hall(n_agents: int = 10_000, backend: str = "grid_pallas",
                   device="cuda"):
    """bench.py:299-390 ``time_rmf_routing``'s scene on ``device`` (the
    card unless the caller names another device): a 200 x 100 m hall with
    four inner walls at x = 40, 80, 120, 160, each with a 12 m door gap
    from y = 40 + 5i; ``n_agents`` uniform in ``[2, 198] x [2, 98]``
    (seed 0), every agent routed by an ``RMFPlanner`` (scale 2, radius
    0.4, 8,192 routes of up to 64 waypoints, arrival tolerance 0.5) from
    its own position to ``RMF_HALL_GOAL``; ``Zanlungo(1, 1, 0, 1, 2,
    0.25, force_cap=10)``; bench.py's SimConfig (a 208 x 108 m grid,
    tiles of 5.3 m with buckets of 32, 256 spill slots, truncation
    counted, not raised).  bench.py steps it at dt 0.25.  The per-agent
    planning runs here, on the host clock.  Returns (rollout, params,
    state, planner, route ids [N] int64 with -1 for an agent without a
    route, planning seconds)."""
    verts = [(0.0, 0.0), (200.0, 0.0), (200.0, 100.0), (0.0, 100.0)]
    walls = [(0, 1), (1, 2), (2, 3), (3, 0)]
    for i, x in enumerate((40.0, 80.0, 120.0, 160.0)):
        b = len(verts)
        gap_lo = 40.0 + 5.0 * i
        verts += [(x, 0.0), (x, gap_lo), (x, gap_lo + 12.0), (x, 100.0)]
        walls += [(b, b + 1), (b + 2, b + 3)]
    planner = RMFPlanner(verts, walls, scale=2.0, radius=0.4,
                         max_routes=8192, max_route_len=64,
                         arrival_tolerance=0.5)
    lp = Zanlungo(1.0, 1.0, 0.0, 1.0, 2.0, 0.25, force_cap=10.0)
    config = SimConfig(
        capacity=n_agents,
        grid=GridConfig(width=208.0, height=108.0, cell_size=2.0,
                        offset=(-4.0, -4.0)),
        neighbor_backend=backend,
        max_per_cell=32,
        max_eyesight=2.0,
        bucket_capacity=32,
        sub_tiles=2,
        strip_tiles=96,
        bucket_tile_size=5.3,
        use_pack_kernel=(backend == "grid_pallas"),
        spill_capacity=256,
        on_truncation="ignore",
        dtype="float32",
    )
    rng = np.random.default_rng(0)
    pos = np.stack([rng.uniform(2.0, 198.0, n_agents),
                    rng.uniform(2.0, 98.0, n_agents)], axis=-1)
    t0 = time.perf_counter()
    route_ids = np.asarray([
        -1 if (rid := planner.plan_route_cached(
            (float(p[0]), float(p[1])), RMF_HALL_GOAL)) is None else rid
        for p in pos], np.int64)
    plan_s = time.perf_counter() - t0
    state = _crowd_state(config, n_agents, pos, device)
    state = state.replace(route_id=torch.as_tensor(
        route_ids, dtype=torch.int32).to(device))
    params = SimParams(hl=(planner.init_params(device),),
                       lp=(lp.init_params(device),), sources=None)
    rollout = build_rollout(config, [planner], [lp])
    return rollout, params, state, planner, route_ids, plan_s


def crossing_scene(capacity: int = 128, dual_row: bool = False,
                   invariance: str = "bitwise", tile: float = 0.0,
                   spill: int = 0, device="cuda"):
    """tests/test_worldstep.py:34-76 on ``device`` (the card unless the
    caller names another device): three ``MonotonicCrowd(1.0)`` sources at
    x = 2 with sinks at x = 45 in a 48 m world of 3 m tiles, agents at
    1.5 m/s (``ConstantVelocity``) with Zanlungo forces, the state empty
    (seed 3).  Returns (config, hl, lp, params, state)."""
    cfg = SimConfig(
        capacity=capacity,
        grid=GridConfig(width=48.0, height=48.0, cell_size=3.0,
                        offset=(0.0, 0.0)),
        neighbor_backend="grid_pallas", max_eyesight=3.0,
        bucket_capacity=16, strip_tiles=6, sub_tiles=6, dtype="float32",
        on_truncation="ignore", dual_row=dual_row,
        sharding_invariance=invariance, bucket_tile_size=tile,
        spill_capacity=spill)
    hl = ConstantVelocity((1.5, 0.0))
    lp = Zanlungo(agent_scale=1.0, obstacle_scale=1.0, reaction_time=0.0,
                  force_distance=1.0, agent_mass=2.0, agent_radius=0.25,
                  force_cap=10.0)
    sources = [SourceSink(source=(2.0, y), waypoints=[(45.0, y)],
                          radius_sink=1.5,
                          crowd_generator=MonotonicCrowd(1.0),
                          high_level_planner=hl, local_planner=lp,
                          agent_eyesight_range=3.0)
               for y in (12.0, 24.0, 36.0)]
    sp = stack_source_params(sources, [0] * 3, [0] * 3, [[-1]] * 3,
                             cfg.tdtype, device=device)
    params = SimParams(hl=(hl.init_params(device),),
                       lp=(lp.init_params(device),), sources=sp)
    return cfg, hl, lp, params, make_state(cfg, seed=3, device=device)


# ---------------------------------------------------------------------------
# The randomized differential sweep (tests/test_fuzz_step.py) as plain data
# ---------------------------------------------------------------------------

# rtol = atol of each fast backend against ``brute``
# (tests/test_fuzz_step.py:79-85, 124, 244).
FUZZ_TOL = {"grid": 2e-5, "grid_pallas": 2e-4, "grid_dense": 2e-4}
# The rollout counters a ``run()`` case holds equal to brute's
# (tests/test_fuzz_step.py:254-259).
FUZZ_RUN_COUNTERS = ("n_alive", "n_spawned", "n_destroyed",
                     "n_waypoint_reached")
# The sweep draws its config from ``10_000 + seed`` and its scene from
# ``20_000 + seed`` (tests/test_fuzz_step.py:211, 225); the wide cases from
# their own two bases, so wide seed s is no relative of sweep seed s.
FUZZ_SEED_BASES = (10_000, 20_000)
WIDE_SEED_BASES = (50_000, 60_000)
# The wide cases: capacity, uniform crowd, hotspots (each in a 2 m square,
# as in bench_positions), sources, rows of tiles a column at least, and
# the tiles a K1 / K4 block takes (K1_TILES_PER_BLOCK, K4_TILES_PER_BLOCK).
WIDE_CAPACITY = 4096
WIDE_CROWD = (1500, 3000)
WIDE_HOTSPOTS = (2, 6)
WIDE_HOTSPOT_AGENTS = (48, 96)
WIDE_SOURCES = (0, 8)
WIDE_MIN_TILES = 31
WIDE_BLOCK_TILES = 15
WIDE_STEPS = 5
WIDE_DT = 1.0 / 60.0


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """One SourceSink as plain data: ``generator`` is ``"poisson"``
    (``PoissonCrowd(rate)``) or ``"monotonic"`` (``MonotonicCrowd(rate)``);
    ``eyesight`` is its agents' eyesight."""

    source: tuple
    waypoints: tuple
    radius_sink: float
    generator: str
    rate: float
    eyesight: float
    loop_forever: bool = False


@dataclasses.dataclass(frozen=True)
class FuzzCase:
    """One case of the randomized differential sweep as plain data, which
    either package can build into a ``Simulation``.

    ``fast``: the backends held against ``brute``, each to ``tol[b]``
    (rtol = atol).  ``config``: the ``SimConfig`` fields but
    ``neighbor_backend``, with ``grid`` a dict of ``GridConfig`` fields.
    ``hl_velocity``: ``ParityVelocity``'s; ``lp``: ``Zanlungo``'s keyword
    arguments; one planner of each serves the agents and every source.
    ``positions`` [n, 2] and ``eyesight`` [n] (float64): the agents added
    by ``add_agents``, in uid order.  ``mode``: ``"step"`` (``n_steps``
    calls of ``step(dt)``, compared after each) or ``"run"`` (one
    ``run(n_steps, dt)``, its counters compared too).  ``churn``: after
    every third ``step()`` one agent alive on every backend is removed,
    drawn from ``rng`` (:func:`drive_fuzz` draws from a copy, so a case
    can be driven again)."""

    name: str
    seed: int
    fast: tuple
    config: dict
    hl_velocity: tuple
    lp: dict
    positions: np.ndarray
    eyesight: np.ndarray
    sources: tuple
    mode: str
    dt: float
    n_steps: int
    churn: bool
    rng: np.random.Generator
    tol: dict


def _fuzz_config(rng, wide: bool):
    """``_random_config``'s draws (tests/test_fuzz_step.py:133-175), in
    its order; ``wide``: a 120-200 m world grown, where needed, until a
    column holds at least ``WIDE_MIN_TILES`` tiles and its last K1 and K4
    block is partial, capacity ``WIDE_CAPACITY`` and ``spill_capacity``
    the capacity.  Returns (config fields, world, eyesight)."""
    bucket = int(rng.choice([16, 32]))
    sub = 128 // bucket - 2
    strip = sub * int(rng.integers(1, 3))
    eye = float(rng.uniform(1.8, 3.2))
    world = float(rng.uniform(*((120.0, 200.0) if wide else (26.0, 44.0))))
    cell = float(rng.uniform(2.0, 4.0))
    tile_size = (0.0 if rng.random() < 0.5
                 else eye * float(rng.uniform(1.0, 1.7)))
    capacity = WIDE_CAPACITY if wide else 64
    fields = dict(
        capacity=capacity,
        max_per_cell=64,
        max_eyesight=eye,
        bucket_capacity=bucket,
        strip_tiles=strip,
        sub_tiles=sub,
        bucket_tile_size=tile_size,
        use_pack_kernel=bool(rng.random() < 0.5),
        presort=bool(rng.random() < 0.5),
        spill_capacity=int(rng.choice([64, 128])),
        fused_spills=bool(rng.random() < 0.5),
        dual_row=bool(rng.random() < 0.5),
        dense_col_headroom=float(rng.uniform(1.5, 2.5)),
        commit_preferred_vel=bool(rng.random() < 0.5),
        integer_priorities=bool(rng.random() < 0.5),
        pallas_interpret=True,
        dtype="float32",
        on_truncation="raise",
    )
    if wide:
        fields["spill_capacity"] = capacity
        tile = max(tile_size, eye)
        n = max(WIDE_MIN_TILES, math.ceil(world / tile))
        while True:
            world = n * tile - 0.1
            bcfg = zb.BucketConfig.create(world, world, (0.0, 0.0), eye,
                                          bucket=bucket, strip_tiles=strip,
                                          sub_tiles=sub,
                                          tile_size=tile_size or None)
            if n % WIDE_BLOCK_TILES and bcfg.ty % WIDE_BLOCK_TILES:
                break
            n += 1
    fields["grid"] = dict(width=world, height=world, cell_size=cell,
                          offset=(0.0, 0.0))
    return fields, world, eye


def _fuzz_planners(rng):
    """``_build_pair``'s planner draws (tests/test_fuzz_step.py:215-222):
    (ParityVelocity's velocity, Zanlungo's keyword arguments)."""
    hl = (float(rng.uniform(0.5, 1.3)), float(rng.uniform(-0.6, 0.6)))
    lp = dict(agent_scale=float(rng.uniform(0.8, 2.0)), obstacle_scale=1.0,
              reaction_time=0.0, force_distance=float(rng.uniform(1.0, 2.0)),
              agent_mass=float(rng.uniform(1.0, 3.0)),
              agent_radius=float(rng.uniform(0.15, 0.35)),
              force_cap=float(rng.uniform(20.0, 200.0)))
    return hl, lp


def _fuzz_sources(rng, world, eye, n_sources, rates, margin):
    """``_random_scene``'s SourceSink draws (tests/test_fuzz_step.py:
    189-205); ``rates``: the Poisson and the monotonic rate ranges."""
    out = []
    for _ in range(n_sources):
        if rng.random() < 0.5:
            gen, rate = "poisson", float(rng.uniform(*rates[0]))
        else:
            gen, rate = "monotonic", float(rng.uniform(*rates[1]))
        wps = tuple(tuple(float(v) for v in
                          rng.uniform(margin, world - margin, (2,)))
                    for _ in range(int(rng.integers(1, 4))))
        src = tuple(float(v) for v in rng.uniform(margin, world - margin,
                                                  (2,)))
        out.append(SourceSpec(
            source=src, waypoints=wps,
            radius_sink=float(rng.uniform(0.8, 1.8)), generator=gen,
            rate=rate, eyesight=float(rng.uniform(1.2, eye)),
            loop_forever=bool(rng.random() < 0.3)))
    return tuple(out)


def _fuzz_scene(rng, world, eye):
    """``_random_scene`` (tests/test_fuzz_step.py:178-205): 8-25 agents,
    in 40% of seeds half of them packed into a 1.2 m square; 0-2
    sources.  Returns (positions, eyesight, sources)."""
    n = int(rng.integers(8, 26))
    margin = 3.0
    pts = rng.uniform(margin, world - margin, (n, 2))
    if rng.random() < 0.4:
        center = rng.uniform(world * 0.3, world * 0.7, (2,))
        pts[: n // 2] = center + rng.uniform(-0.6, 0.6, (n // 2, 2))
    eyesight = np.full((n,), float(rng.uniform(1.2, eye)))
    sources = _fuzz_sources(rng, world, eye, int(rng.integers(0, 3)),
                            ((0.5, 3.0), (0.5, 1.5)), margin)
    return pts, eyesight, sources


def _wide_scene(rng, world, eye):
    """The wide scene: ``WIDE_CROWD`` agents uniform in the interior, then
    ``WIDE_HOTSPOTS`` hotspots of ``WIDE_HOTSPOT_AGENTS`` agents, each in
    a 2 m square, one a band of x and at least 6 m (more than a tile)
    apart, so that no dense column holds two; every agent sees at least
    1.8 m, so each hotspot agent has more than ``K1_LIST_CAP``
    neighbours.  ``WIDE_SOURCES`` sources at 30-180 (Poisson) or 30-90
    (monotonic) agents/s, which spawn at dt = 1/60.  Returns (positions
    with the hotspots first, eyesight, sources)."""
    margin = 3.0
    crowd = rng.uniform(margin, world - margin,
                        (int(rng.integers(WIDE_CROWD[0], WIDE_CROWD[1] + 1)),
                         2))
    n_hot = int(rng.integers(WIDE_HOTSPOTS[0], WIDE_HOTSPOTS[1] + 1))
    band = (world - 2 * margin) / n_hot
    hot = []
    for h in range(n_hot):
        k = int(rng.integers(WIDE_HOTSPOT_AGENTS[0],
                             WIDE_HOTSPOT_AGENTS[1] + 1))
        corner = (margin + band * h + rng.uniform(0.0, band - 8.0),
                  rng.uniform(margin, world - margin - 2.0))
        hot.append(rng.uniform(0.0, 2.0, (k, 2)) + np.asarray(corner))
    pts = np.concatenate(hot + [crowd])
    eyesight = np.full((pts.shape[0],), float(rng.uniform(1.8, eye)))
    sources = _fuzz_sources(
        rng, world, eye, int(rng.integers(WIDE_SOURCES[0],
                                          WIDE_SOURCES[1] + 1)),
        ((30.0, 180.0), (30.0, 90.0)), margin)
    return pts, eyesight, sources


def fuzz_case(seed: int, backend: str = "grid_pallas",
              wide: bool = False) -> FuzzCase:
    """Seed ``seed`` of the randomized sweep on ``backend``
    (``grid_pallas``: ``test_randomized_config_sweep``, ``grid_dense``:
    ``..._dense``), drawn as ``_build_pair`` and ``_run_sweep`` draw it
    (tests/test_fuzz_step.py:208-279): the config, then the planners,
    then dt (0.12-0.28 s) and the stepping mode (``run()`` of 4-8 steps in 35%
    of seeds, else 8 ``step()`` calls with churn) from ``10_000 + seed``;
    the scene from ``20_000 + seed``.  ``wide``: the same draws at the
    card's scale (:func:`_fuzz_config`, :func:`_wide_scene`), from
    ``WIDE_SEED_BASES``, ``WIDE_STEPS`` steps at ``WIDE_DT``."""
    bases = WIDE_SEED_BASES if wide else FUZZ_SEED_BASES
    rng = np.random.default_rng(bases[0] + seed)
    fields, world, eye = _fuzz_config(rng, wide)
    hl, lp = _fuzz_planners(rng)
    scene_rng = np.random.default_rng(bases[1] + seed)
    pts, eyesight, sources = (_wide_scene if wide else _fuzz_scene)(
        scene_rng, world, eye)
    if wide:
        dt = WIDE_DT
        use_run = rng.random() < 0.35
        n_steps = WIDE_STEPS
    else:
        dt = float(rng.uniform(0.12, 0.28))
        use_run = rng.random() < 0.35
        n_steps = int(rng.integers(4, 9)) if use_run else 8
    family = "wide" if wide else "randomized_config_sweep"
    return FuzzCase(
        name=f"{family}[{backend} {seed}]", seed=seed, fast=(backend,),
        config=fields, hl_velocity=hl, lp=lp, positions=pts,
        eyesight=eyesight, sources=sources,
        mode="run" if use_run else "step", dt=dt, n_steps=n_steps,
        churn=not use_run, rng=rng, tol={backend: FUZZ_TOL[backend]})


# The fixed families' Zanlungo (tests/test_fuzz_step.py:49-51, 110).
_FIXED_ZANLUNGO = dict(agent_scale=1.2, obstacle_scale=1.0,
                       reaction_time=0.0, force_distance=1.5,
                       agent_mass=2.0, agent_radius=0.25, force_cap=100.0)


def agree_case(seed: int) -> FuzzCase:
    """``test_backends_agree_on_random_scenes`` (tests/test_fuzz_step.py:
    32-85): ``build(backend, seed)`` on ``brute``, ``grid`` and
    ``grid_pallas``, 12 steps of 0.2 s, no churn."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(3.0, 33.0, (rng.integers(10, 30), 2))
    eyesight = np.full((pts.shape[0],), float(rng.uniform(1.0, 3.0)))
    config = dict(
        capacity=64,
        grid=dict(width=36.0, height=36.0, cell_size=3.0, offset=(0.0, 0.0)),
        max_per_cell=64, max_eyesight=3.0, bucket_capacity=16,
        strip_tiles=6, sub_tiles=6, pallas_interpret=True, dtype="float32")
    gen = ("poisson", 2.0) if seed % 2 else ("monotonic", 1.0)
    source = SourceSpec(source=(2.0, 18.0),
                        waypoints=((18.0, 18.0), (34.0, 18.0)),
                        radius_sink=1.5, generator=gen[0], rate=gen[1],
                        eyesight=2.0)
    return FuzzCase(
        name=f"backends_agree[{seed}]", seed=seed,
        fast=("grid", "grid_pallas"), config=config,
        hl_velocity=(1.0, 0.4), lp=_FIXED_ZANLUNGO, positions=pts,
        eyesight=eyesight, sources=(source,), mode="step", dt=0.2,
        n_steps=12, churn=False, rng=rng,
        tol={b: FUZZ_TOL[b] for b in ("grid", "grid_pallas")})


def bucket32_case(seed: int) -> FuzzCase:
    """``test_big_tile_bucket32_matches`` (tests/test_fuzz_step.py:
    88-125): 24 agents, buckets of 32 on 6 m tiles, ``grid_pallas``
    against ``brute``, 10 steps of 0.2 s."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(3.0, 33.0, (24, 2))
    config = dict(
        capacity=64,
        grid=dict(width=36.0, height=36.0, cell_size=3.0, offset=(0.0, 0.0)),
        max_per_cell=64, max_eyesight=3.0, bucket_capacity=32,
        strip_tiles=4, sub_tiles=2, bucket_tile_size=6.0,
        pallas_interpret=True, dtype="float32")
    return FuzzCase(
        name=f"big_tile_bucket32[{seed}]", seed=seed, fast=("grid_pallas",),
        config=config, hl_velocity=(1.0, 0.4), lp=_FIXED_ZANLUNGO,
        positions=pts, eyesight=np.full((24,), 3.0), sources=(),
        mode="step", dt=0.2, n_steps=10, churn=False, rng=rng,
        tol={"grid_pallas": FUZZ_TOL["grid_pallas"]})


def fuzz_cases() -> list:
    """The 43 cases of tests/test_fuzz_step.py in its order: backends
    agree (seeds 0-4), bucket 32 (0, 2), the sweep on ``grid_pallas``
    (0-23) and on ``grid_dense`` (0-11)."""
    return ([agree_case(s) for s in range(5)]
            + [bucket32_case(s) for s in (0, 2)]
            + [fuzz_case(s) for s in range(24)]
            + [fuzz_case(s, "grid_dense") for s in range(12)])


def monotonic_sources(case: FuzzCase) -> FuzzCase:
    """``case`` with every ``PoissonCrowd`` source replaced by a
    ``MonotonicCrowd`` of the same rate: the two packages draw Poisson
    counts from different generators, so a case held across packages
    takes this form."""
    return dataclasses.replace(case, sources=tuple(
        dataclasses.replace(s, generator="monotonic") for s in case.sources))


def populate_fuzz_session(sim, case: FuzzCase, pkg) -> None:
    """Add ``case``'s agents and sources to ``sim``, a ``Simulation`` of
    ``pkg`` (a package with the session's API: ``ParityVelocity``,
    ``Zanlungo``, ``SourceSink``, ``PoissonCrowd``, ``MonotonicCrowd``),
    as the sweep does: one planner of each kind for every agent and
    source, the agents in runs of equal eyesight."""
    hl = pkg.ParityVelocity(case.hl_velocity)
    lp = pkg.Zanlungo(**case.lp)
    eye = case.eyesight
    cuts = [0] + [i for i in range(1, eye.shape[0]) if eye[i] != eye[i - 1]]
    for lo, hi in zip(cuts, cuts[1:] + [eye.shape[0]]):
        sim.add_agents([tuple(p) for p in case.positions[lo:hi]], hl, lp,
                       agent_eyesight_range=float(eye[lo]))
    gens = {"poisson": pkg.PoissonCrowd, "monotonic": pkg.MonotonicCrowd}
    for s in case.sources:
        sim.add_source_sink(pkg.SourceSink(
            source=s.source, waypoints=list(s.waypoints),
            radius_sink=s.radius_sink,
            crowd_generator=gens[s.generator](s.rate),
            high_level_planner=hl, local_planner=lp,
            agent_eyesight_range=s.eyesight, loop_forever=s.loop_forever))


def fuzz_config(case: FuzzCase, backend: str, pkg=None):
    """``case``'s ``SimConfig`` on ``backend``, of ``pkg`` (this
    package by default)."""
    if pkg is None:
        grid_cls, cfg_cls = GridConfig, SimConfig
    else:
        grid_cls, cfg_cls = pkg.GridConfig, pkg.SimConfig
    fields = dict(case.config)
    grid = grid_cls(**fields.pop("grid"))
    return cfg_cls(grid=grid, neighbor_backend=backend, **fields)


def build_fuzz_session(case: FuzzCase, backend: str,
                       device="cuda") -> Simulation:
    """The port's ``Simulation`` of ``case`` on ``backend`` and ``device``
    (the card unless the caller names another device), seeded with the
    case's seed."""
    sim = Simulation(fuzz_config(case, backend), seed=case.seed,
                     device=device)
    populate_fuzz_session(sim, case, sys.modules[__package__])
    return sim


def fuzz_spills(sim: Simulation) -> int:
    """The bucket overflows (``n_bucket_over``, the spills) of a
    ``grid_pallas`` session's state as its step would bin it afresh."""
    bcfg = bucket_config(sim.config)
    key = zb.tile_key(bcfg, sim.state.position, sim.state.alive)
    _, _, over = zb.rank_from_sorted_key(bcfg, torch.sort(key).values)
    return int(over)


def _fetch(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _by_uid(sim):
    """(sorted uids, positions [n, 2] in that order) of a session."""
    agents = sim.agents
    uids = sorted(agents)
    pos = np.asarray([agents[u].position for u in uids], np.float64)
    return uids, pos.reshape(len(uids), 2)


def _match(case: FuzzCase, snaps: dict, label: str, out: dict) -> None:
    """Every fast backend's live agents against brute's: the same uids,
    positions by uid within the backend's tolerance
    (tests/test_fuzz_step.py:236-245); records each backend's largest
    absolute error and largest share of its allowance ``tol + tol *
    |brute|``."""
    uids, ref = snaps["brute"]
    for b in case.fast:
        got_uids, got = snaps[b]
        if got_uids != uids:
            raise AssertionError(
                f"{case.name} {label}: alive sets differ (brute-only "
                f"{sorted(set(uids) - set(got_uids))}, {b}-only "
                f"{sorted(set(got_uids) - set(uids))})")
        tol = case.tol[b]
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol,
                                   err_msg=f"{case.name} {label}: {b}")
        if uids:
            d = np.abs(got - ref)
            out["err"][b] = max(out["err"][b], float(d.max()))
            out["share"][b] = max(out["share"][b], float(
                (d / (tol + tol * np.abs(ref))).max()))


def drive_fuzz(case: FuzzCase, sims: dict) -> dict:
    """Drive ``sims`` ({"brute": oracle, fast backend: session, ...}, of
    either package) through ``case`` as ``_run_sweep`` does
    (tests/test_fuzz_step.py:248-279) and hold each fast backend against
    brute; raises at the first difference.  Each port ``grid_pallas``
    session's spills are read before every step (before the rollout
    under ``run()``).  Returns {"steps", "err": {backend: max
    abs err}, "share": {backend: largest share of the allowance},
    "max_occ" (the port's fast sessions' largest tile or cell occupancy),
    "max_spills", "truncated"}."""
    rng = copy.deepcopy(case.rng)
    port = {b: s for b, s in sims.items()
            if b != "brute" and isinstance(s, Simulation)}
    out = dict(steps=0, err={b: 0.0 for b in case.fast},
               share={b: 0.0 for b in case.fast}, max_occ=0, max_spills=0,
               truncated=0)

    def spills():
        for s in port.values():
            if s.config.neighbor_backend == "grid_pallas":
                out["max_spills"] = max(out["max_spills"], fuzz_spills(s))

    if case.mode == "run":
        spills()
        counters = {b: s.run(case.n_steps, case.dt) for b, s in sims.items()}
        for b in case.fast:
            for field in FUZZ_RUN_COUNTERS:
                np.testing.assert_array_equal(
                    _fetch(getattr(counters[b], field)),
                    _fetch(getattr(counters["brute"], field)),
                    err_msg=f"{case.name}: {b} rollout counter {field}")
        for b in port:
            c = counters[b]
            out["max_occ"] = max(out["max_occ"],
                                 int(_fetch(c.max_cell_occupancy).max()))
            out["truncated"] += int(_fetch(c.neighbor_truncated).sum())
        _match(case, {b: _by_uid(s) for b, s in sims.items()},
               f"after run({case.n_steps})", out)
        out["steps"] = case.n_steps
        return out
    for step in range(case.n_steps):
        spills()
        for s in sims.values():
            s.step(case.dt)
        for b, s in port.items():
            ev = s.last_events
            out["max_occ"] = max(out["max_occ"],
                                 int(ev.max_cell_occupancy))
            out["truncated"] += int(ev.neighbor_truncated)
        snaps = {b: _by_uid(s) for b, s in sims.items()}
        _match(case, snaps, f"step {step}", out)
        out["steps"] += 1
        if case.churn and step % 3 == 2:
            common = sorted(set.intersection(
                *(set(uids) for uids, _ in snaps.values())))
            if common:
                victim = common[int(rng.integers(0, len(common)))]
                for s in sims.values():
                    s.remove_agents(victim)
    return out


def run_fuzz_case(case: FuzzCase, device="cuda") -> dict:
    """``case`` through the port's sessions on ``device`` (the card unless
    the caller names another device): ``brute`` and each fast backend,
    held against each other by :func:`drive_fuzz`, whose result it
    returns."""
    sims = {b: build_fuzz_session(case, b, device)
            for b in ("brute",) + tuple(case.fast)}
    return drive_fuzz(case, sims)


def wide_cases() -> list:
    """The 16 wide cases of ``chip_smoke.py`` phase 10b: on
    ``grid_pallas`` the first four seeds that draw ``fused_spills`` and
    the first four that draw the spill patch, in seed order; on
    ``grid_dense`` seeds 0-7."""
    half = 4
    pallas = {True: [], False: []}
    seed = 0
    while min(len(v) for v in pallas.values()) < half:
        case = fuzz_case(seed, "grid_pallas", wide=True)
        picked = pallas[case.config["fused_spills"]]
        if len(picked) < half:
            picked.append(case)
        seed += 1
    return (pallas[True] + pallas[False]
            + [fuzz_case(s, "grid_dense", wide=True) for s in range(8)])
