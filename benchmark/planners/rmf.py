"""``rmf``: the configuration's ``RMFPlanner`` (its ``rmf`` walls and
parameters), which plans each leg around the walls.  Its routes are the
program's output: the reference judges each one (``reference/routes.py``)
and then follows it."""

import numpy as np
import torch

from ..reference import crowd as ref, routes as ref_routes


def rmf_planner(cfg: dict):
    from rmf_crowdsim_tpu_torch import RMFPlanner

    r = cfg["rmf"]
    return RMFPlanner([tuple(v) for v in r["vertices"]],
                      [tuple(w) for w in r["walls"]], scale=r["scale"],
                      radius=r["radius"], max_routes=r["max_routes"],
                      max_route_len=r["max_route_len"],
                      arrival_tolerance=r["arrival_tolerance"],
                      dtype=cfg["sim"]["dtype"])


class Planner:
    def __init__(self, cfg: dict, spec: dict, plan, device):
        self.rcfg = cfg["rmf"]
        self.hl = rmf_planner(cfg)

    def legs(self, sinks):
        return np.asarray([self.hl.plan_source_legs(ss) for ss in sinks])

    def reference(self, sinks, legs, device):
        walls = ref_routes.wall_segments(self.rcfg["vertices"],
                                         self.rcfg["walls"])
        table = self.hl.init_params(device)["routes"]
        pts = table.points.cpu().numpy()
        lens = table.lengths.cpu().numpy()
        off, worst = 0, 0.0
        for s, ss in enumerate(sinks):
            prev = ss.source
            for w, rid in enumerate(legs[s]):
                goal = ss.waypoints[w]
                ok = rid >= 0
                if ok:
                    ok, ratio = ref_routes.judge(pts[rid, :lens[rid]], prev,
                                                 goal, walls)
                    worst = max(worst, ratio)
                off += int(not ok)
                prev = goal
        routes = ref.Routes(points=torch.as_tensor(pts, device=device),
                            lengths=torch.as_tensor(lens, device=device)
                            .long(),
                            tol=float(self.rcfg["arrival_tolerance"]))
        return ("routes", routes), off, worst
