"""Carry the JAX package's parameters and state across, as numpy arrays.

No counterpart in the JAX package.  Callers turn JAX values into numpy
first (``jax.tree.map(np.asarray, ...)`` or ``np.asarray`` per field), so
this module, like the rest of the port, never imports JAX.  Both packages
then compute from identical inputs.  Like every entry point of the port,
the converters put their tensors on the card unless the caller names
another device (a caller that wants the CPU passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..core.state import STATE_TENSOR_FIELDS, SimState
from ..models.highlevel import RouteTable
from ..models.local import ZanlungoParams
from ..models.source_sink import SourceParams


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _tensor(value, device):
    return torch.as_tensor(np.array(value)).to(device)


def _has_fields(src, names) -> bool:
    if isinstance(src, Mapping):
        return all(n in src for n in names)
    return all(hasattr(src, n) for n in names)


def state_from_numpy(arrays, device="cuda", seed: int = 0) -> SimState:
    """A :class:`SimState` from the JAX state's fields as numpy arrays
    (a mapping or an object with the field attributes).  The JAX
    ``rng_key`` has no counterpart: the state gets a fresh generator
    seeded with ``seed``."""
    fields = {
        name: torch.as_tensor(np.array(_field(arrays, name))).to(device)
        for name in STATE_TENSOR_FIELDS
    }
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return SimState(**fields, generator=gen)


def state_to_numpy(state: SimState) -> dict:
    """The state's tensor fields as numpy arrays (the inverse of
    :func:`state_from_numpy`, without the generator)."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in STATE_TENSOR_FIELDS}


def zanlungo_params_from_numpy(arrays, device="cuda") -> ZanlungoParams:
    """:class:`ZanlungoParams` from the JAX ZanlungoParams' fields (0-d
    arrays), kept in float64 like the port's own ``init_params``."""
    return ZanlungoParams(**{
        f.name: torch.tensor(float(np.asarray(_field(arrays, f.name))),
                             dtype=torch.float64, device=device)
        for f in dataclasses.fields(ZanlungoParams)
    })


def route_table_from_numpy(arrays, device="cuda") -> RouteTable:
    """A :class:`RouteTable` from the JAX RouteTable's ``points`` [R, L,
    2] and ``lengths`` [R] as numpy arrays."""
    return RouteTable(points=_tensor(_field(arrays, "points"), device),
                      lengths=_tensor(_field(arrays, "lengths"), device))


def hl_params_from_numpy(arrays: Mapping, device="cuda") -> dict:
    """A high-level planner's parameter dict: ``{"vel": [2]}``, or
    ``WaypointFollow``'s ``{"routes": RouteTable, "tol": []}``, whose
    route table is converted whole."""
    return {k: (route_table_from_numpy(v, device)
                if _has_fields(v, ("points", "lengths"))
                else _tensor(v, device))
            for k, v in arrays.items()}


def source_params_from_numpy(arrays, device="cuda") -> SourceParams:
    """:class:`SourceParams` from the JAX SourceParams' fields as numpy
    arrays, dtypes kept."""
    return SourceParams(**{f.name: _tensor(_field(arrays, f.name), device)
                           for f in dataclasses.fields(SourceParams)})
