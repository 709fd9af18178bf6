"""rmf_crowdsim_tpu_torch — the crowd simulator ported to PyTorch and CUDA.

The port of ``rmf_crowdsim_tpu`` (the JAX package, which stays the
reference) to PyTorch on one NVIDIA Hopper GPU.  Module names follow the
JAX package's; each module's docstring names its counterpart.  The slice
ported so far is the bench path: ``build_rollout`` on the ``brute``,
``grid_pallas`` (with or without fused spills) and ``grid_dense``
backends, with the force, fused-spill force, dense force, pack and
spill-window kernels written in CUDA (``csrc/``) and built at their
first use.  The package imports ``torch`` and never JAX.
"""

from .core.config import GridConfig, SimConfig
from .core.state import SimState, StepEvents, make_state
from .core.step import SimParams, build_rollout, build_step
from .models.highlevel import (
    ConstantVelocity,
    HighLevelPlanner,
    HLResult,
    ParityVelocity,
)
from .models.local import LocalPlanner, NoLocalPlan, Zanlungo, ZanlungoParams

__all__ = [
    "ConstantVelocity",
    "GridConfig",
    "HighLevelPlanner",
    "HLResult",
    "LocalPlanner",
    "NoLocalPlan",
    "ParityVelocity",
    "SimConfig",
    "SimParams",
    "SimState",
    "StepEvents",
    "Zanlungo",
    "ZanlungoParams",
    "build_rollout",
    "build_step",
    "make_state",
]
