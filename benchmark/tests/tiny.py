"""Cells cut to a size the CPU steps in seconds, for the benchmark's own
tests: the configuration's and the traffic's files with the crowd, the
world, the slots and the episodes made small.  Nothing else changes."""

from __future__ import annotations

import math
import os

import torch

from benchmark import harness, scene

# Every cell that the benchmark holds files for (``limits/<cell>.json``):
# those of BENCHMARK.json and those kept for a later PR to list.
CELLS = sorted(f[:-5] for f in os.listdir(os.path.join(scene.HERE, "limits"))
               if f.endswith(".json"))
N_AGENTS = 2000
N_SOURCES = 16
EPISODE = 12


def tiny(workload: str, n_agents: int = N_AGENTS):
    """(manifest, configuration, traffic) of ``workload``, named
    ``<config>.<traffic>`` (a cell of ``BENCHMARK.json`` or one kept under
    ``limits/`` for a later PR), cut small."""
    man = harness.manifest()
    config, mix = workload.split(".", 1)
    cfg = scene.load("configs", config)
    traffic = scene.load("traffic", mix)
    if traffic["driver"] == "rollout":
        side = math.ceil(math.sqrt(n_agents * 1.6) / 2) * 2.0
        cfg["sim"]["grid"] = {"width": side, "height": side,
                              "cell_size": 2.0,
                              "offset": [-side / 2, -side / 2]}
        cfg["sim"]["capacity"] = n_agents + 256
        cfg["sim"]["spill_capacity"] = 128
        traffic["crowd"]["agents"] = n_agents
        traffic["episode_steps"] = EPISODE
        if traffic["sources"]:
            traffic["sources"]["layout"]["count"] = N_SOURCES
    else:
        # Two rooms of 40 x 40 m joined by one 12 m door.
        cfg["sim"]["capacity"] = 1024
        cfg["sim"]["grid"] = {"width": 88.0, "height": 48.0,
                              "cell_size": 2.0, "offset": [-4.0, -4.0]}
        cfg["rmf"]["vertices"] = [[0.0, 0.0], [80.0, 0.0], [80.0, 40.0],
                                  [0.0, 40.0], [40.0, 0.0], [40.0, 14.0],
                                  [40.0, 26.0], [40.0, 40.0]]
        cfg["rmf"]["walls"] = [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5],
                               [6, 7]]
        layout = traffic["sources"]["layout"]
        layout["x_walls"] = [0.0, 40.0, 80.0]
        layout["y_range"] = [0.0, 40.0]
        traffic["warmup_steps"] = 20
    return man, cfg, traffic


def run(workload: str, seed: int = 1_234_567_890_123, seconds: float = 0.0,
        trace: bool = False, **kw):
    """One run on the CPU: (record, result line)."""
    man, cfg, traffic = tiny(workload, **kw)
    torch.manual_seed(0)
    rec = harness.measure(cfg, traffic, seed, seconds, trace, "cpu")
    out = harness.result(man, workload, rec, trace,
                         harness.limits(workload), "cpu")
    return rec, out
