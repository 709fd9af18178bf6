"""``session``: a ``Simulation`` with the traffic's SourceSinks added by
``add_source_sink`` and a listener that records every event, filled by
``warmup_steps`` steps and then stepped one ``step()`` at a time.  The
steps that the check compares are drawn from the seed over the whole
window, as it runs (a reservoir of ``compare_steps``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import compare_step, control_step, span
from .. import scene
from ..reference import compare


class Recorder:
    """The application's EventListener: records every event in memory,
    with the index of the step that delivered it."""

    def __init__(self, timed: bool = False):
        self.step = -1
        self.timed = timed
        self.busy_s = 0.0
        self.spawned, self.reached, self.destroyed = [], [], []
        self.count = [0, 0, 0]

    def _put(self, kind, record):
        t0 = time.perf_counter() if self.timed else 0.0
        getattr(self, kind).append(record)
        self.count[("spawned", "reached", "destroyed").index(kind)] += 1
        if self.timed:
            self.busy_s += time.perf_counter() - t0

    def agent_spawned(self, position, agent_id):
        self._put("spawned", (self.step, agent_id, float(position[0]),
                              float(position[1])))

    def waypoint_reached(self, position, agent_id):
        self._put("reached", (self.step, agent_id, float(position[0]),
                              float(position[1])))

    def agent_destroyed(self, agent_id):
        self._put("destroyed", (self.step, agent_id))

    def of_step(self, k: int) -> dict:
        return {"spawned": [r[1:] for r in self.spawned if r[0] == k],
                "reached": [r[1:] for r in self.reached if r[0] == k],
                "destroyed": [r[1] for r in self.destroyed if r[0] == k]}


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        from rmf_crowdsim_tpu_torch import Simulation

        if traffic.get("crowd"):
            raise ValueError("the session driver places no crowd")
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.dt = float(cfg["dt"])
        self.sim = Simulation(scene.sim_config(cfg), seed=seed,
                              device=self.device)
        spec = traffic["sources"]
        self.plan = scene.source_plan(traffic, cfg, seed)
        self.planner = scene.part("planners", spec["planner"]["kind"]).Planner(
            cfg, spec["planner"], self.plan, self.device)
        lp = scene.zanlungo(cfg)
        self.sinks = scene.make_sinks(self.plan, self.planner.hl, lp)
        for ss in self.sinks:
            self.sim.add_source_sink(ss)
        self.listener = Recorder(trace)
        self.sim.add_event_listener(self.listener)
        self.calls = 0                  # steps taken, warm-up included
        self.window_start = None
        self.times = []
        self.diag = []
        self.n_keep = int(traffic["compare_steps"])
        self.kept = [None] * self.n_keep    # (step, pre, post)
        self.rng = np.random.default_rng([seed, 1])
        self.min_units = self.n_keep

    def _step(self, trace: bool = False):
        self.listener.step = self.calls
        before = list(self.listener.count)
        with span(trace, "bench.session_step"):
            t0 = time.perf_counter()
            self.sim.step(self.dt)
            t1 = time.perf_counter()
        self.calls += 1
        spawned = self.listener.count[0] - before[0]
        destroyed = self.listener.count[2] - before[2]
        return t1 - t0, spawned, destroyed

    def population(self) -> int:
        return self.listener.count[0] - self.listener.count[2]

    def warm_up(self):
        for _ in range(int(self.traffic["warmup_steps"])):
            self._step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _slot(self, i: int):
        """The reservoir's slot for the window's ``i``-th step, or None:
        every step of the window is kept with the same chance."""
        if i < self.n_keep:
            return i
        j = int(self.rng.integers(i + 1))
        return j if j < self.n_keep else None

    def unit(self, trace: bool = False):
        if self.window_start is None:
            self.window_start = self.calls
            self.listener.busy_s = 0.0
        slot = None if trace else self._slot(self.calls - self.window_start)
        pre = self.sim.state if slot is not None else None
        dt_s, spawned, destroyed = self._step(trace)
        ev = self.sim.last_events
        if not trace:
            self.times.append(dt_s)
            self.diag.append((ev.neighbor_truncated, ev.max_cell_occupancy,
                              ev.out_of_bounds, ev.spawn_dropped))
        if slot is not None:
            self.kept[slot] = (self.calls - 1, pre, self.sim.state)
        return 1, self.population() + destroyed

    def traced_unit(self):
        return self.unit(trace=True)

    def counters(self) -> dict:
        trunc, occ, oob, drop = zip(*self.diag)
        trunc = torch.stack(list(trunc)).cpu().numpy()
        occ = torch.stack(list(occ)).cpu().numpy()
        oob = torch.stack([o.sum() for o in oob]).cpu().numpy()
        drop = torch.stack(list(drop)).cpu().numpy()
        d = self.listener
        w0 = self.window_start
        per_step = np.zeros((3, self.calls - w0), np.int64)
        for j, recs in enumerate((d.spawned, d.reached, d.destroyed)):
            for r in recs:
                if r[0] >= w0:
                    per_step[j, r[0] - w0] += 1
        return {"steps": int(len(self.times)),
                "truncated": int(trunc.sum()),
                "max_occupancy": int(occ.max()),
                "out_of_bounds": [int(oob.min()), int(oob.max())],
                "spawn_dropped": int(drop.sum()),
                "spawned_per_step": [int(per_step[0].min()),
                                     float(per_step[0].mean()),
                                     int(per_step[0].max())],
                "destroyed_per_step": [int(per_step[2].min()),
                                       float(per_step[2].mean()),
                                       int(per_step[2].max())],
                "population_end": self.population()}

    def _kept(self):
        return sorted(k for k in self.kept if k is not None)

    def reference_world(self):
        """The reference's world, with the routes the program planned,
        once each passes the judge.  Returns (world, routes_off, worst
        length ratio)."""
        legs = self.planner.legs(self.sinks)
        entry, off, worst = self.planner.reference(self.sinks, legs,
                                                   self.device)
        sources = scene.reference_sources(self.plan, legs, 0, self.dt,
                                          self.device)
        return scene.reference_world(self.cfg, (entry,), sources), off, worst

    def check(self, seed: int) -> dict:
        world, routes_off, worst = self.reference_world()
        self.world = world
        verdict = compare.Verdict()
        for k, pre, post in self._kept():
            verdict.add(compare_step(world, scene.fields(pre),
                                     scene.fields(post), k,
                                     self.listener.of_step(k)))
        alive = int(self.sim.state.alive.sum())
        spawned_uids = [r[1] for r in self.listener.spawned]
        lost = abs(alive - self.population()) + (
            len(spawned_uids) - len(set(spawned_uids)))
        return {"verdict": verdict, "routes_off": routes_off,
                "route_ratio_max": worst, "events_lost": lost,
                "steps": [k for k, _, _ in self._kept()]}

    def k1_states(self):
        return []

    def control(self, seed: int, dtype) -> compare.Verdict:
        v = compare.Verdict()
        for k, pre, _ in self._kept():
            v.add(control_step(self.world, scene.fields(pre), k, dtype,
                               seed + k))
        return v

    def free(self):
        self.kept = [None] * self.n_keep
