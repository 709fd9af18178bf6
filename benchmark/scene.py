"""The one generator: builds a cell from its configuration file and its
traffic file through the program's public API.

Every ``kind`` that a traffic file names is a module of its own, found by
name (:func:`part`); an unknown kind raises:

- ``driver``: ``drivers/<kind>.py``, which steps the measured window
  (``rollout``: ``core.step.build_rollout`` in episodes; ``session``: a
  ``Simulation`` one ``step()`` at a time);
- ``crowd.placement``: ``placements/<kind>.py``, the crowd's start
  positions, drawn on the device from the seed;
- ``sources.layout``: ``layouts/<kind>.py``, the SourceSinks' points and
  waypoints (:class:`SourcePlan`), drawn from the seed;
- ``sources.generator``: ``generators/<kind>.py``, each source's crowd
  generator and the reference's view of it;
- ``crowd.planner`` and ``sources.planner``: ``planners/<kind>.py``, the
  program's high-level planner and the reference's routes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
from typing import List

import numpy as np
import torch

from .reference import crowd as ref

HERE = os.path.dirname(os.path.abspath(__file__))
ROLES = ("drivers", "placements", "layouts", "generators", "planners")
KIND = re.compile(r"^[a-z][a-z0-9_]{0,63}$")


def load(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def part(role: str, kind: str):
    """The module ``<role>/<kind>.py``; ValueError where there is none."""
    if role not in ROLES or not isinstance(kind, str) or not KIND.match(kind):
        raise ValueError(f"unknown {role} kind {kind!r}")
    name = f"{__package__}.{role}.{kind}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"unknown {role} kind {kind!r}: no "
                         f"{role}/{kind}.py") from None


def sim_config(cfg: dict):
    from rmf_crowdsim_tpu_torch import GridConfig, SimConfig

    sim = dict(cfg["sim"])
    g = sim.pop("grid")
    grid = GridConfig(width=g["width"], height=g["height"],
                      cell_size=g["cell_size"], offset=tuple(g["offset"]))
    return SimConfig(grid=grid, **sim)


def float_dtype(cfg: dict) -> torch.dtype:
    return {"float32": torch.float32,
            "float64": torch.float64}[cfg["sim"]["dtype"]]


# ---------------------------------------------------------------------------
# SourceSinks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SourcePlan:
    """The SourceSinks of a cell, in the order the program holds them."""

    pos: np.ndarray         # [S, 2]
    waypoints: List[list]   # per source, its waypoints
    phase: np.ndarray       # [S] in [0, 1): each generator's phase
    spec: dict


LOOPS = {"odd": lambda s: bool(s % 2), "none": lambda s: False}


def loops(spec: dict, s: int) -> bool:
    if spec["loop"] not in LOOPS:
        raise ValueError(f"unknown loop rule {spec['loop']!r}")
    return LOOPS[spec["loop"]](s)


def source_plan(traffic: dict, cfg: dict, seed: int) -> SourcePlan:
    spec = traffic["sources"]
    return part("layouts", spec["layout"]["kind"]).plan(spec, cfg, seed)


def make_sinks(plan: SourcePlan, hl, lp) -> list:
    from rmf_crowdsim_tpu_torch import SourceSink

    spec = plan.spec
    gen = part("generators", spec["generator"]["kind"])
    return [SourceSink(source=(float(x), float(y)), waypoints=plan.waypoints[s],
                       radius_sink=spec["sink_radius"],
                       crowd_generator=gen.program(spec["generator"],
                                                   plan.phase[s]),
                       high_level_planner=hl, local_planner=lp,
                       agent_eyesight_range=spec["eyesight"],
                       loop_forever=loops(spec, s))
            for s, (x, y) in enumerate(plan.pos)]


def straight_legs(plan: SourcePlan):
    """Route ``s * W + w`` runs from source ``s``'s point before waypoint
    ``w`` to waypoint ``w``: points [S * W, 2, 2] float64."""
    legs = []
    for s, p in enumerate(plan.pos):
        prev = (float(p[0]), float(p[1]))
        for w in plan.waypoints[s]:
            legs.append((prev, tuple(w)))
            prev = tuple(w)
    return np.asarray(legs, np.float64)


def zanlungo(cfg: dict):
    from rmf_crowdsim_tpu_torch import Zanlungo

    z = cfg["zanlungo"]
    return Zanlungo(z["agent_scale"], z["obstacle_scale"], z["reaction_time"],
                    z["force_distance"], z["agent_mass"], z["agent_radius"],
                    force_cap=z["force_cap"])


def reference_world(cfg: dict, planners: tuple, sources=None) -> ref.World:
    z = cfg["zanlungo"]
    return ref.World(
        dt=float(cfg["dt"]), capacity=int(cfg["sim"]["capacity"]),
        clearance=float(cfg["sim"]["spawn_clearance"]),
        commit_pref=bool(cfg["sim"]["commit_preferred_vel"]),
        zanlungo=ref.Zanlungo(**z), planners=planners, sources=sources)


def reference_sources(plan: SourcePlan, legs: np.ndarray, hl: int, dt: float,
                      device) -> ref.Sources:
    """The reference's view of the SourceSinks: the benchmark's own
    inputs, and ``legs`` [S, W] route ids into the route table that the
    reference judged or made."""
    spec = plan.spec
    s = plan.pos.shape[0]
    w = max(len(x) for x in plan.waypoints)
    wp = np.zeros((s, w, 2))
    for i, x in enumerate(plan.waypoints):
        wp[i, :len(x)] = x
    gen = part("generators", spec["generator"]["kind"])
    rate, requests = gen.reference(spec["generator"], plan.phase, dt)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return ref.Sources(
        pos=t(plan.pos), waypoints=t(wp),
        n_wp=t([len(x) for x in plan.waypoints], torch.long),
        radius=t([spec["sink_radius"]] * s),
        loop=t([loops(spec, i) for i in range(s)], torch.bool),
        eye=t([spec["eyesight"]] * s), hl=t([hl] * s, torch.long),
        lp=t([0] * s, torch.long), legs=t(legs, torch.long),
        rate=t([rate] * s), requests=requests)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


STATE_FIELDS = ("position", "velocity", "preferred_vel", "next_waypoint",
                "eyesight", "alive", "uid", "source_id", "hl_idx", "lp_idx",
                "route_id", "route_wp", "priority")


def fields(state) -> dict:
    """A ``SimState``'s tensors by name, with ``next_uid``."""
    out = {f: getattr(state, f) for f in STATE_FIELDS}
    out["next_uid"] = state.next_uid
    return out


def crowd_state(config, cfg: dict, crowd: dict, seed: int, device):
    """``crowd["agents"]`` agents placed by ``crowd["placement"]``'s kind
    from ``seed``; uids and priorities 0..n-1, planners 0."""
    from rmf_crowdsim_tpu_torch import make_state

    n = int(crowd["agents"])
    f = config.tdtype
    st = make_state(config, seed=seed, device=device)
    placement = crowd["placement"]
    pos = part("placements", placement["kind"]).positions(
        config, placement, n, seed, device)
    body = dict(position=pos,
                eyesight=torch.full((n,), cfg["eyesight"], dtype=f,
                                    device=device),
                alive=torch.ones((n,), dtype=torch.bool, device=device),
                uid=torch.arange(n, dtype=torch.int32, device=device),
                hl_idx=torch.zeros((n,), dtype=torch.int32, device=device),
                lp_idx=torch.zeros((n,), dtype=torch.int32, device=device),
                priority=torch.arange(n, dtype=f, device=device))
    out = {}
    for name, value in body.items():
        full = getattr(st, name).clone()
        full[:n] = value
        out[name] = full
    return st.replace(next_uid=torch.full((), n, dtype=torch.int32,
                                          device=device), **out)


def copy_state(state):
    return state.replace(**{f: getattr(state, f).clone()
                            for f in STATE_FIELDS + ("sim_time", "next_uid")})
