"""The bench scene, rebuilt without JAX.

Counterpart of ``bench.py:31-123`` (``_bench_config`` and ``build_bench``)
and of the hotspot of ``compiled_parity_check`` (``bench.py:138-143``):
a uniform dense Zanlungo crowd (~1.6 m^2 per agent, eyesight 2 m) with
``ParityVelocity`` + ``Zanlungo``, no sources, built from the same numpy
seeds so both packages start from the same positions.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.config import GridConfig, SimConfig
from .core.state import make_state
from .core.step import SimParams, build_rollout, payload_sort_by_key
from .models.highlevel import ParityVelocity
from .models.local import Zanlungo
from .ops import zanlungo_bucketed as zb
from .ops.zanlungo_dense import DenseConfig

HOTSPOT_AGENTS = 48


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


def build_bench(n_agents: int, dtype: str = "float32",
                backend: str = "grid_pallas", device="cuda",
                hotspot: bool = False, hotspot_origin=(10.0, 10.0),
                fused_spills: bool = False):
    """The bench scene at ``n_agents`` on ``device`` (the card unless the
    caller names another device): returns (rollout, params, state) like
    bench.py's ``build_bench``."""
    config = bench_config(n_agents, dtype=dtype, backend=backend,
                          fused_spills=fused_spills)
    hl = ParityVelocity((1.0, 0.0))
    lp = Zanlungo(agent_scale=1.0, obstacle_scale=1.0, reaction_time=0.0,
                  force_distance=1.0, agent_mass=2.0, agent_radius=0.25,
                  force_cap=20.0)
    rollout = build_rollout(config, [hl], [lp])
    f = config.tdtype
    pos = bench_positions(n_agents, config.grid.width, hotspot=hotspot,
                          hotspot_origin=hotspot_origin)
    state = make_state(config, device=device)
    i32 = torch.int32
    state = state.replace(
        position=torch.as_tensor(pos, dtype=f).to(device),
        eyesight=torch.full((n_agents,), 2.0, dtype=f, device=device),
        alive=torch.ones((n_agents,), dtype=torch.bool, device=device),
        uid=torch.arange(n_agents, dtype=i32, device=device),
        hl_idx=torch.zeros((n_agents,), dtype=i32, device=device),
        lp_idx=torch.zeros((n_agents,), dtype=i32, device=device),
        priority=torch.arange(n_agents, dtype=f, device=device),
        next_uid=torch.full((), n_agents, dtype=i32, device=device),
    )
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


def bench_dense_config(n_agents: int) -> DenseConfig:
    """The dense layout of the ``grid_dense`` bench scene, as
    ``build_step`` derives it."""
    c = bench_config(n_agents, backend="grid_dense")
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
