"""The port's entry points put their tensors on the card unless the caller
names another device.

Without a card each entry point raises, as torch does for a CUDA tensor;
with one, it lands on the card.  Whether there is a card is decided inside
each test, never while the module is imported.  The CPU tests elsewhere
pass ``device="cpu"``.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu_torch
from rmf_crowdsim_tpu_torch import ConstantVelocity, ParityVelocity, Zanlungo
from rmf_crowdsim_tpu_torch import make_state, scenes
from rmf_crowdsim_tpu_torch.core.config import SimConfig
from rmf_crowdsim_tpu_torch.core.state import STATE_TENSOR_FIELDS
from rmf_crowdsim_tpu_torch.models.local import ZanlungoParams
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb
from rmf_crowdsim_tpu_torch.parallel import (
    init_world_skin,
    make_thread_mesh,
    shard_state_by_region,
)
from rmf_crowdsim_tpu_torch.utils import convert


# A world the world-sharded engine takes (grid_pallas, 2 shards).
_WORLD = scenes.bench_config(64)


def _state_arrays():
    st = make_state(SimConfig(capacity=4), device="cpu")
    return {name: getattr(st, name).numpy() for name in STATE_TENSOR_FIELDS}


def _tensor_of(result):
    """One tensor that the entry point made."""
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        return next(iter(result.values()))
    if isinstance(result, tuple):          # (rollout, params, state, ...)
        st = result[2]                     # build_world_bench: shards
        return (st[0] if isinstance(st, list) else st).position
    if isinstance(result, torch.device):   # a mesh's device
        return torch.zeros((), device=result)
    if isinstance(result, ZanlungoParams):
        return result.agent_mass
    return result.position                 # SimState


ENTRY_POINTS = {
    "make_state": lambda: make_state(SimConfig(capacity=4)),
    "build_bench": lambda: scenes.build_bench(64),
    "state_from_numpy": lambda: convert.state_from_numpy(_state_arrays()),
    "zanlungo_params_from_numpy": lambda: convert.zanlungo_params_from_numpy(
        {f: np.float32(1.0) for f in ("agent_scale", "obstacle_scale",
                                      "reaction_time", "force_distance",
                                      "agent_mass", "agent_radius",
                                      "force_cap")}),
    "hl_params_from_numpy": lambda: convert.hl_params_from_numpy(
        {"vel": np.ones(2, np.float32)}),
    "Zanlungo.init_params": lambda: Zanlungo(
        1.0, 1.0, 0.0, 1.0, 2.0, 0.25).init_params(),
    "ConstantVelocity.init_params": lambda: ConstantVelocity(
        (1.0, 0.0)).init_params(),
    "ParityVelocity.init_params": lambda: ParityVelocity(
        (1.0, 0.0)).init_params(),
    "sentinel_rows": lambda: tzb.sentinel_rows(8),
    "make_thread_mesh": lambda: make_thread_mesh(2).device,
    "shard_state_by_region": lambda: shard_state_by_region(
        _WORLD, make_thread_mesh(2), make_state(_WORLD, device="cpu"))[0],
    "init_world_skin": lambda: init_world_skin(_WORLD,
                                               make_thread_mesh(2))[0],
    "build_world_bench": lambda: scenes.build_world_bench(64, 2),
    "build_rmf_hall": lambda: scenes.build_rmf_hall(64),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    call = ENTRY_POINTS[name]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    else:
        assert _tensor_of(call()).device.type == "cuda"


def _public_callables():
    """Every public function and method of every module of the port."""
    pkg = rmf_crowdsim_tpu_torch
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__",
                                               None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield f"{info.name}.{name}", obj
            elif inspect.isclass(obj):
                for m_name, m in vars(obj).items():
                    if inspect.isfunction(m) and not m_name.startswith("_"):
                        yield f"{info.name}.{name}.{m_name}", m


def test_no_public_function_defaults_to_the_cpu():
    seen, cpu = 0, []
    for name, fn in _public_callables():
        for p in inspect.signature(fn).parameters.values():
            if p.default is inspect.Parameter.empty:
                continue
            seen += 1
            if str(p.default) == "cpu":
                cpu.append(f"{name}({p.name})")
    assert seen > 50
    assert cpu == []
