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
"""

from __future__ import annotations

import dataclasses
import math
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


def bench_bucket_config(n_agents: int) -> zb.BucketConfig:
    """The bucketed layout of the ``grid_pallas`` bench scene."""
    c = bench_config(n_agents)
    return zb.BucketConfig.create(
        c.grid.width, c.grid.height, c.grid.offset, c.max_eyesight,
        bucket=c.bucket_capacity, strip_tiles=c.strip_tiles,
        sub_tiles=c.sub_tiles, tile_size=c.bucket_tile_size)


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
