"""SourceSink agent streaming: declarative spawn and despawn.

Counterpart of ``rmf_crowdsim_tpu/models/source_sink.py`` (copied, since
that module imports JAX through ``flax``): a source point, a waypoint chain
whose last element is the sink, a sink radius, a crowd generator, the
planners new agents are wired to, a loop flag and the eyesight new agents
get (source_sink.rs:36-60).  Host-side they are plain Python objects; for
the step they are stacked into one :class:`SourceParams` of tensors padded
to the largest waypoint count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.state import TensorDataclass

GEN_MONOTONIC = 0
GEN_POISSON = 1
# Custom host-side generator: any object with ``get_number_to_spawn(dt)``
# (the reference's CrowdGenerator trait, source_sink.rs:30-33).  The step
# never calls it: it reads ``SourceParams.custom_count``, which the host
# refreshes before each step.
GEN_CUSTOM = 2


@dataclasses.dataclass(frozen=True)
class MonotonicCrowd:
    """Requests ``floor(rate * dt + 0.5)`` agents per step in the config
    dtype, Rust's ``f64::round`` for non-negative counts
    (source_sink.rs:96-101)."""

    rate: float
    kind: int = GEN_MONOTONIC


@dataclasses.dataclass(frozen=True)
class PoissonCrowd:
    """Samples ``Poisson(rate * dt)`` per step (source_sink.rs:75-82) from
    the state's ``torch.Generator``."""

    rate: float
    kind: int = GEN_POISSON


@dataclasses.dataclass
class SourceSink:
    """Host-side SourceSink description (source_sink.rs:36-60).
    ``high_level_planner`` / ``local_planner`` are planner objects; the
    caller resolves them to registry indices."""

    source: Tuple[float, float]
    waypoints: Sequence[Tuple[float, float]]
    radius_sink: float
    crowd_generator: object  # MonotonicCrowd | PoissonCrowd | custom
    high_level_planner: object
    local_planner: object
    agent_eyesight_range: float
    loop_forever: bool = False


@dataclasses.dataclass(frozen=True)
class SourceParams(TensorDataclass):
    """All SourceSinks stacked into tensors (S sources, padded to W
    waypoints)."""

    source: torch.Tensor  # [S, 2]
    waypoints: torch.Tensor  # [S, W, 2]
    n_waypoints: torch.Tensor  # [S] int32
    radius_sink: torch.Tensor  # [S]
    rate: torch.Tensor  # [S]
    gen_kind: torch.Tensor  # [S] int32
    loop_forever: torch.Tensor  # [S] bool
    eyesight: torch.Tensor  # [S]
    hl_idx: torch.Tensor  # [S] int32 — planner registry index
    lp_idx: torch.Tensor  # [S] int32
    # leg_route[s, w]: the route id of the leg that ends at waypoints[s, w]
    # (leg 0 runs source -> waypoints[0]); -1 for planners without routes.
    leg_route: torch.Tensor  # [S, W] int32
    active: torch.Tensor  # [S] bool — removed sources request nothing
    custom_count: torch.Tensor  # [S] int32 — GEN_CUSTOM requests


def stack_source_params(
    sources: Sequence[SourceSink],
    hl_indices: Sequence[int],
    lp_indices: Sequence[int],
    leg_routes: Sequence[Sequence[int]],
    dtype: torch.dtype,
    device="cuda",
) -> Optional[SourceParams]:
    """Stack host SourceSink descriptions into a :class:`SourceParams` on
    ``device`` (the card unless the caller names another device)."""
    if not sources:
        return None
    s = len(sources)
    w = max(len(ss.waypoints) for ss in sources)
    waypoints = torch.zeros((s, w, 2), dtype=torch.float64)
    leg = torch.full((s, w), -1, dtype=torch.int32)
    for i, ss in enumerate(sources):
        waypoints[i, :len(ss.waypoints)] = torch.tensor(
            [tuple(p) for p in ss.waypoints], dtype=torch.float64)
        lr = list(leg_routes[i])
        leg[i, :len(lr)] = torch.tensor(lr, dtype=torch.int32)
    # Duck-typed generator classification (source_sink.rs:30-33): objects
    # with the built-in ``kind``/``rate`` run on the device; anything else
    # with ``get_number_to_spawn(dt)`` is a GEN_CUSTOM host generator.
    kinds, rates = [], []
    for ss in sources:
        g = ss.crowd_generator
        kind = getattr(g, "kind", GEN_CUSTOM)
        if kind not in (GEN_MONOTONIC, GEN_POISSON):
            kind = GEN_CUSTOM
        if kind == GEN_CUSTOM and not callable(
            getattr(g, "get_number_to_spawn", None)
        ):
            raise TypeError(
                f"crowd generator {g!r} has neither the built-in "
                f"kind/rate attributes nor get_number_to_spawn(dt)"
            )
        kinds.append(kind)
        rates.append(float(getattr(g, "rate", 0.0)))

    def t(values, dt):
        return torch.tensor(values, dtype=dt).to(device)

    return SourceParams(
        source=t([tuple(ss.source) for ss in sources], torch.float64).to(
            dtype),
        waypoints=waypoints.to(dtype=dtype, device=device),
        n_waypoints=t([len(ss.waypoints) for ss in sources], torch.int32),
        radius_sink=t([ss.radius_sink for ss in sources], torch.float64).to(
            dtype),
        rate=t(rates, torch.float64).to(dtype),
        gen_kind=t(kinds, torch.int32),
        loop_forever=t([bool(ss.loop_forever) for ss in sources], torch.bool),
        eyesight=t([ss.agent_eyesight_range for ss in sources],
                   torch.float64).to(dtype),
        hl_idx=t(list(hl_indices), torch.int32),
        lp_idx=t(list(lp_indices), torch.int32),
        leg_route=leg.to(device),
        active=torch.ones((s,), dtype=torch.bool, device=device),
        custom_count=torch.zeros((s,), dtype=torch.int32, device=device),
    )
