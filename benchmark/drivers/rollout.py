"""``rollout``: an optional placed crowd (``crowd``) and optional
SourceSinks (``sources``), stepped by ``core.step.build_rollout`` in
back-to-back episodes of ``episode_steps`` steps, each from the seeded
start state, restored by a device copy, so that each episode begins with
the presort's full re-sort, as a fresh rollout does."""

from __future__ import annotations

import numpy as np
import torch

from . import COUNTERS, compare_step, control_step, span
from .. import scene
from ..reference import compare


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        from rmf_crowdsim_tpu_torch import (SimParams, build_rollout,
                                            stack_source_params)

        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.dt = float(cfg["dt"])
        self.episode_steps = int(traffic["episode_steps"])
        config = scene.sim_config(cfg)
        lp = scene.zanlungo(cfg)
        crowd, spec = traffic.get("crowd"), traffic.get("sources")
        if not crowd and not spec:
            raise ValueError("a rollout needs a crowd or sources")
        hl, entries = [], []
        self.routes_off = 0
        if crowd:
            p = scene.part("planners", crowd["planner"]["kind"]).Planner(
                cfg, crowd["planner"], None, self.device)
            hl.append(p.hl)
            entries.append(p.reference(None, None, self.device)[0])
        sp = ref_sources = None
        if spec:
            plan = scene.source_plan(traffic, cfg, seed)
            p = scene.part("planners", spec["planner"]["kind"]).Planner(
                cfg, spec["planner"], plan, self.device)
            hl.append(p.hl)
            sinks = scene.make_sinks(plan, p.hl, lp)
            legs = p.legs(sinks)
            s = len(sinks)
            sp = stack_source_params(sinks, [len(hl) - 1] * s, [0] * s,
                                     legs.tolist(), config.tdtype,
                                     device=self.device)
            entry, self.routes_off, _ = p.reference(sinks, legs, self.device)
            entries.append(entry)
            ref_sources = scene.reference_sources(plan, legs, len(hl) - 1,
                                                  self.dt, self.device)
        self.world = scene.reference_world(cfg, tuple(entries), ref_sources)
        self.rollout = build_rollout(config, hl, [lp])
        if crowd:
            self.start = scene.crowd_state(config, cfg, crowd, seed,
                                           self.device)
        else:
            from rmf_crowdsim_tpu_torch import make_state

            self.start = make_state(config, seed=seed, device=self.device)
        self.params = SimParams(hl=tuple(h.init_params(self.device)
                                         for h in hl),
                                lp=(lp.init_params(self.device),),
                                sources=sp)
        self.rows = []
        self.final = None
        self.states = {}
        self.min_units = 1

    def _episode(self, steps: int):
        return self.rollout(self.params, scene.copy_state(self.start),
                            self.dt, steps)

    def warm_up(self):
        st, rec = self._episode(self.episode_steps)
        torch.stack([getattr(rec, c) for c in COUNTERS]).cpu()

    def unit(self, trace: bool = False):
        with span(trace, "bench.episode"):
            st, rec = self._episode(self.episode_steps)
        with span(trace, "bench.read_counters"):
            c = torch.stack([getattr(rec, k) for k in COUNTERS]).cpu().numpy()
        self.rows.append(c)
        self.final = st
        return self.episode_steps, int(c[0].sum() + c[1].sum())

    def traced_unit(self):
        return self.unit(trace=True)

    def counters(self) -> dict:
        rows = np.stack(self.rows)          # [episodes, 8, steps]
        per = {
            "alive_end": rows[:, 0, -1], "destroyed": rows[:, 1].sum(1),
            "spawned": rows[:, 2].sum(1), "spawn_dropped": rows[:, 3].sum(1),
            "out_of_bounds_end": rows[:, 4, -1],
            "max_occupancy": rows[:, 5].max(1),
            "truncated": rows[:, 6].sum(1),
            "waypoints": rows[:, 7].sum(1),
        }
        out = {"episodes": int(rows.shape[0])}
        for k, v in per.items():
            out[k] = [int(v.min()), int(v.max())]
        return out

    def check(self, seed: int) -> dict:
        """Three steps of the window's episode, each against the
        reference from the program's own state before it: the first, the
        last (whose result is the window's own final state) and one drawn
        from the seed; the states before them are replayed through the
        same rollout, and the replayed final state must equal the
        window's bit for bit."""
        e = self.episode_steps
        rng = np.random.default_rng([seed, 1])
        ks = sorted({0, e - 1} | set(
            (1 + rng.choice(e - 2, self.traffic["compare_steps"] - 2,
                            replace=False)).tolist()))
        verdict = compare.Verdict()
        self.states = {}
        for k in ks:
            pre = (self.start if k == 0 else self._episode(k)[0])
            post = self.final if k == e - 1 else self._episode(k + 1)[0]
            self.states[k] = pre
            verdict.add(compare_step(self.world, scene.fields(pre),
                                     scene.fields(post), k))
        replay = self._episode(e)[0]
        diff = sum(int((getattr(replay, f) != getattr(self.final, f)).sum())
                   for f in scene.STATE_FIELDS)
        return {"verdict": verdict, "replay_off": diff, "steps": ks,
                "routes_off": self.routes_off}

    def k1_states(self):
        return [scene.fields(s) for s in self.states.values()]

    def control(self, seed: int, dtype) -> compare.Verdict:
        v = compare.Verdict()
        for k, pre in self.states.items():
            v.add(control_step(self.world, scene.fields(pre), k, dtype,
                               seed + k))
        return v

    def free(self):
        self.final = None
        self.states = {}
