"""rmf_crowdsim_tpu_torch — the crowd simulator ported to PyTorch and CUDA.

The port of ``rmf_crowdsim_tpu`` (the JAX package, which stays the
reference) to PyTorch on one NVIDIA Hopper GPU.  Module names follow the
JAX package's; each module's docstring names its counterpart.  Ported so
far: the step and ``build_rollout`` on all five neighbor backends
(``brute``, ``grid``, ``grid_pallas`` with or without fused spills,
``grid_dense`` and ``custom``), SourceSink streaming (spawn, sinks,
waypoint routes) with per-uid event streams, the spatial queries, the
``Simulation`` host session with ``EventListener`` delivery, the RMF route
planner (``RMFPlanner``, ``native.py``), and the checkpoint, validation
and profiling utilities, with the force, fused-spill force, dense force,
pack and spill-window kernels written in CUDA (``csrc/``) and built at
their first use, and the three multi-device engines (``parallel/``: the
agent-sharded step, the domain-decomposed force pass and the
world-sharded step with migration) over a mesh of shards: threads on one
device (``make_thread_mesh``) or one process per card
(``ProcessGroupComm``).  The package imports ``torch`` and never JAX.
"""

from .core.config import GridConfig, SimConfig
from .core.simulation import (
    AgentView,
    EventListener,
    NeighborTruncationError,
    OutOfBoundsError,
    Simulation,
)
from .core.state import SimState, StepEvents, make_state
from .core.step import (
    EventStream,
    RolloutCounters,
    SimParams,
    build_rollout,
    build_step,
)
from .models.highlevel import (
    ConstantVelocity,
    HighLevelPlanner,
    HLResult,
    ParityVelocity,
    RouteTable,
    WaypointFollow,
)
from .models.local import LocalPlanner, NoLocalPlan, Zanlungo, ZanlungoParams
from .models.rmf import RMFPlanner
from .models.source_sink import (
    GEN_CUSTOM,
    GEN_MONOTONIC,
    GEN_POISSON,
    MonotonicCrowd,
    PoissonCrowd,
    SourceParams,
    SourceSink,
    stack_source_params,
)
from .parallel import (
    ProcessGroupComm,
    ThreadMesh,
    WorldCounters,
    build_sharded_rollout,
    build_sharded_step,
    build_world_rollout,
    build_world_step,
    init_world_skin,
    make_thread_mesh,
    shard_state_by_region,
)
from .ops.neighbors import (
    NeighborSet,
    nearest_neighbors,
    nearest_neighbors_grid,
    nearest_neighbors_tiered,
    neighbors_in_radius,
)

__all__ = [
    "AgentView",
    "ConstantVelocity",
    "EventListener",
    "EventStream",
    "GEN_CUSTOM",
    "GEN_MONOTONIC",
    "GEN_POISSON",
    "GridConfig",
    "HighLevelPlanner",
    "HLResult",
    "LocalPlanner",
    "MonotonicCrowd",
    "NeighborSet",
    "NeighborTruncationError",
    "NoLocalPlan",
    "OutOfBoundsError",
    "ParityVelocity",
    "PoissonCrowd",
    "ProcessGroupComm",
    "RMFPlanner",
    "RolloutCounters",
    "RouteTable",
    "SimConfig",
    "SimParams",
    "SimState",
    "Simulation",
    "SourceParams",
    "SourceSink",
    "StepEvents",
    "ThreadMesh",
    "WaypointFollow",
    "WorldCounters",
    "Zanlungo",
    "ZanlungoParams",
    "build_rollout",
    "build_sharded_rollout",
    "build_sharded_step",
    "build_step",
    "build_world_rollout",
    "build_world_step",
    "init_world_skin",
    "make_state",
    "make_thread_mesh",
    "nearest_neighbors",
    "nearest_neighbors_grid",
    "nearest_neighbors_tiered",
    "neighbors_in_radius",
    "shard_state_by_region",
    "stack_source_params",
]
