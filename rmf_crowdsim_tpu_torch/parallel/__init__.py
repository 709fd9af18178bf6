"""The multi-device engines: the agent-sharded step, the domain-decomposed
force pass and the world-sharded step with migration, over a mesh of
shards (``comm.py``).  Counterpart of ``rmf_crowdsim_tpu/parallel/``."""

from .comm import (
    AGENT_AXIS,
    WORLD_AXIS,
    Comm,
    Mesh,
    ProcessGroupComm,
    ThreadComm,
    ThreadMesh,
    make_thread_mesh,
)
from .domain import forces_domain_sharded, zanlungo_fused_domain
from .sharding import (
    build_sharded_rollout,
    build_sharded_step,
    gather_shards,
    make_mesh,
    replicate_params,
    shard_state,
)
from .worldstep import (
    WorldCounters,
    WorldDiag,
    build_world_rollout,
    build_world_step,
    init_world_skin,
    shard_state_by_region,
)

__all__ = [
    "AGENT_AXIS", "WORLD_AXIS", "Comm", "Mesh", "ProcessGroupComm",
    "ThreadComm", "ThreadMesh", "WorldCounters", "WorldDiag",
    "build_sharded_rollout", "build_sharded_step", "build_world_rollout",
    "build_world_step", "forces_domain_sharded", "gather_shards",
    "init_world_skin", "make_mesh", "make_thread_mesh", "replicate_params",
    "shard_state", "shard_state_by_region", "zanlungo_fused_domain",
]
