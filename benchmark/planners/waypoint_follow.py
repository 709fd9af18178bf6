"""``waypoint_follow``: ``WaypointFollow`` over straight legs, route ``s *
W + w`` from source ``s``'s point before waypoint ``w`` to waypoint
``w``; the reference makes the same legs from the benchmark's points."""

import numpy as np
import torch

from .. import scene
from ..reference import crowd as ref


class Planner:
    def __init__(self, cfg: dict, spec: dict, plan, device):
        from rmf_crowdsim_tpu_torch import RouteTable, WaypointFollow

        self.points = scene.straight_legs(plan)
        self.w = len(plan.waypoints[0])
        self.tol = float(spec["arrival_tolerance"])
        n = self.points.shape[0]
        table = RouteTable(
            points=torch.as_tensor(self.points, dtype=scene.float_dtype(cfg))
            .to(device),
            lengths=torch.full((n,), 2, dtype=torch.int32, device=device))
        self.hl = WaypointFollow(table, arrival_tolerance=self.tol)

    def legs(self, sinks):
        s = len(sinks)
        return np.arange(s * self.w).reshape(s, self.w)

    def reference(self, sinks, legs, device):
        n = self.points.shape[0]
        routes = ref.Routes(
            points=torch.as_tensor(self.points, dtype=torch.float32,
                                   device=device),
            lengths=torch.full((n,), 2, device=device), tol=self.tol)
        return ("routes", routes), 0, 1.0
