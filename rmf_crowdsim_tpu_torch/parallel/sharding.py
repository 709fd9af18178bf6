"""The agent-sharded engine: the agent arrays split over a mesh of shards.

Counterpart of ``rmf_crowdsim_tpu/parallel/sharding.py``: every per-agent
tensor ([N] or [N, 2]) is split along N into the mesh's shards, the
parameters and the scalars of the state are replicated, and
``build_sharded_step`` / ``build_sharded_rollout`` return the step and the
rollout over such shards.

The JAX engine jits the single-device step with sharded inputs and lets
XLA's SPMD partitioner insert the all-gathers that the neighbour pass
needs.  PyTorch has no partitioner, so here each shard all-gathers the
per-agent tensors, runs the single-device :func:`~..core.step.build_step`
on the whole state, and keeps its own ``[N/D]`` block.  This engine
replicates the step's work on every shard and keeps only the contract:
per-agent tensors sharded between calls, parameters replicated, results
equal to one device's.  The engine that scales is the world-sharded one
(``parallel/worldstep.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch

from ..core.config import SimConfig
from ..core.state import STATE_TENSOR_FIELDS, SimState
from ..core.step import SimParams, build_rollout, build_step
from .comm import Mesh, ThreadMesh, make_thread_mesh


def make_mesh(n_shards: int, device="cuda") -> ThreadMesh:
    """A 1D mesh of ``n_shards`` shards along the agent axis, in one
    process on ``device`` (the card unless the caller names another
    device).  A process-group mesh is a ``comm.ProcessGroupComm``."""
    return make_thread_mesh(n_shards, device)


def per_agent_fields(state: SimState) -> List[str]:
    """The state's per-agent tensor fields (leading dim == capacity): the
    fields the JAX ``state_sharding`` splits over the mesh; the rest are
    replicated."""
    n = state.capacity
    return [f for f in STATE_TENSOR_FIELDS
            if getattr(state, f).dim() >= 1 and getattr(state, f).shape[0] == n]


def clone_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` in ``gen``'s state, so replicated shards
    draw the same numbers; from a generator of another device type, one
    seeded with its initial seed."""
    device = torch.device(device)
    out = torch.Generator(device=device)
    if gen.device.type == device.type:
        out.set_state(gen.get_state())
    else:
        out.manual_seed(gen.initial_seed())
    return out


def _block(x, lo: int, hi: int, n: int):
    """The rows [lo, hi) of every field of dataclass ``x`` whose leading
    dim is ``n``; other fields as they are."""
    def cut(v):
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == n:
            return v[lo:hi].clone()
        return v
    return dataclasses.replace(x, **{f.name: cut(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


def shard_state(mesh: Mesh, state: SimState) -> List[SimState]:
    """The state's local shards on ``mesh``: shard ``r`` holds the rows
    ``[r*m, (r+1)*m)`` (``m = capacity / D``) of every per-agent tensor,
    the scalars, and a copy of the generator."""
    n, d = state.capacity, mesh.size
    if n % d:
        raise ValueError(f"capacity {n} must divide over {d} shards")
    m = n // d
    dev = mesh.device
    out = []
    for r in mesh.local_ranks:
        sh = _block(state, r * m, (r + 1) * m, n)
        sh = sh.replace(**{f: getattr(sh, f).to(dev)
                           for f in STATE_TENSOR_FIELDS},
                        generator=clone_generator(state.generator, dev))
        out.append(sh)
    return out


def gather_shards(shards: Sequence[Any]):
    """The global value of all D shards of a :class:`ThreadMesh` (a
    state, events, or any dataclass of tensors): per-agent tensors
    (leading dim == the shards' common row count) concatenated in shard
    order, the rest from shard 0."""
    first = shards[0]
    m = first.position.shape[0] if isinstance(first, SimState) else \
        first.spawned.shape[0]

    def cat(name):
        v = getattr(first, name)
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == m:
            return torch.cat([getattr(s, name) for s in shards])
        return v
    return dataclasses.replace(first, **{f.name: cat(f.name)
                                         for f in dataclasses.fields(first)})


def replicate_params(mesh: Mesh, params: SimParams) -> SimParams:
    """The parameters on the mesh's device; every shard reads the one
    object (a shard never writes its parameters)."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(mesh.device)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(move(v) for v in x)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        return x
    return move(params)


def _whole(comm, shard: SimState) -> SimState:
    """The global state from every shard's block (one all-gather)."""
    fields = per_agent_fields(shard)
    full = comm.all_gather({f: getattr(shard, f) for f in fields})
    return shard.replace(**full)


def build_sharded_step(config: SimConfig, hl_planners, lp_planners,
                       mesh: Mesh):
    """``step(params, shards, dt) -> (shards, events)`` over ``mesh``'s
    local shards (lists, one entry a shard; events keep their per-agent
    masks sharded).  The capacity must divide over the mesh."""
    d = mesh.size
    if config.capacity % d:
        raise ValueError(f"capacity {config.capacity} must divide over "
                         f"{d} shards")
    m = config.capacity // d
    step = build_step(config, hl_planners, lp_planners)

    def body(comm, params, shard, dt):
        new, ev = step(params, _whole(comm, shard), dt)
        r = comm.axis_index()
        n = config.capacity
        return (_block(new, r * m, (r + 1) * m, n),
                _block(ev, r * m, (r + 1) * m, n))

    def sharded_step(params, shards, dt):
        k = len(shards)
        res = mesh.run(body, [params] * k, shards, [dt] * k)
        return [r[0] for r in res], [r[1] for r in res]

    return sharded_step


def build_sharded_rollout(config: SimConfig, hl_planners, lp_planners,
                          mesh: Mesh):
    """``rollout(params, shards, dt, n_steps) -> (shards, counters)``: the
    single-device rollout (with its skin-deferred presort) on the whole
    state on every shard, each keeping its block; ``counters`` are
    replicated, so one shard's are returned."""
    d = mesh.size
    if config.capacity % d:
        raise ValueError(f"capacity {config.capacity} must divide over "
                         f"{d} shards")
    m = config.capacity // d
    rollout = build_rollout(config, hl_planners, lp_planners)

    def body(comm, params, shard, dt, n_steps):
        st, counters = rollout(params, _whole(comm, shard), dt, n_steps)
        r = comm.axis_index()
        return _block(st, r * m, (r + 1) * m, config.capacity), counters

    def run(params, shards, dt, n_steps: int):
        k = len(shards)
        res = mesh.run(body, [params] * k, shards, [dt] * k,
                       [n_steps] * k)
        return [r[0] for r in res], res[0][1]

    return run
