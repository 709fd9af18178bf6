"""RMF-world high-level planner: host-side route planning + device-side
waypoint following.

Counterpart of ``rmf_crowdsim_tpu/models/rmf.py`` (``RMFPlanner``,
:35-167).  The reference's ``RMFPlanner`` (rmf/mod.rs:82-242) couples
three things:

1. a native route planner (the Rust ``mapf`` crate: visibility graph + A*
   over a Bresenham-rasterized wall grid, rmf/mod.rs:99-133, 160-192),
2. a route cache keyed by cell-rounded (start, end) hashes
   (``SpatialHash`` with ``round(x/scale)``, rmf/mod.rs:65-78, 217-236),
3. per-tick waypoint chasing (unit vector toward the current route
   waypoint, advance within 1e-1, rmf/mod.rs:197-215).

(1) and (2) stay on the host (the C++ planner behind ctypes, the port's
``native.py``) and fill a padded float64 route store of ``(max_routes,
max_route_len)``; (3) is the ``WaypointFollow`` pass this class inherits,
which reads a :class:`RouteTable` of tensors.  ``init_params(device)``
builds that table from the host store each time it is called, because
routes are planned between steps (``Simulation`` calls it after every
change), and its shape never changes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..native import make_route_planner
from .highlevel import RouteTable, WaypointFollow


class RMFPlanner(WaypointFollow):
    """Visibility-style route planner over an RMF building's walls.

    Args mirror the reference constructor (rmf/mod.rs:99-103): wall
    ``vertices`` + ``walls`` index pairs, the raster ``scale`` (cell size,
    also the route-cache hash resolution), and the ``radius`` obstacles are
    inflated by.  ``arrival_tolerance`` is the reference's hard-coded 1e-1
    waypoint-advance radius (rmf/mod.rs:202).  ``dtype``: the route
    table's dtype (a ``torch.dtype`` or its name), the state's.
    """

    def __init__(
        self,
        vertices: Sequence[Tuple[float, float]],
        walls: Sequence[Tuple[int, int]],
        scale: float,
        radius: float,
        *,
        max_routes: int = 256,
        max_route_len: int = 64,
        arrival_tolerance: float = 1e-1,
        dtype=torch.float32,
        prefer_native: bool = True,
    ):
        self._scale = float(scale)
        self._dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self._max_routes = int(max_routes)
        self._max_len = int(max_route_len)
        self._backend = make_route_planner(
            vertices, walls, cell_size=scale, inflation=radius,
            prefer_native=prefer_native, max_waypoints=max_route_len,
        )
        # Padded host-side route storage, copied to the device by
        # init_params.
        self._points = np.zeros((max_routes, max_route_len, 2), np.float64)
        self._lengths = np.zeros((max_routes,), np.int32)
        self._n_routes = 0
        # (start_hash, end_hash) -> route index (rmf/mod.rs:90-91).
        self._cache: dict = {}
        super().__init__(self._route_table("cpu"),
                         arrival_tolerance=arrival_tolerance)

    # -- construction helpers ------------------------------------------------

    @classmethod
    def from_yaml(cls, yaml_str: str, inflation: float, scale: float,
                  agent_radius: float, level: str = "L1",
                  **kw) -> "RMFPlanner":
        """Parse an RMF building YAML (schema: ``levels.<level>.vertices``
        = [[x, y, ...], ...], ``levels.<level>.walls`` = [[i, j, ...], ...]
        — rmf/mod.rs:137-158; the reference hard-codes level "L1", which
        stays the default here).  Like the reference, the ``inflation``
        parameter is accepted but unused (reference quirk, rmf/mod.rs:137);
        obstacles are inflated by ``agent_radius``."""
        import yaml

        doc = yaml.safe_load(yaml_str)
        level = doc["levels"][level]
        vertices = [(float(v[0]), float(v[1])) for v in level["vertices"]]
        walls = [(int(w[0]), int(w[1])) for w in level["walls"]]
        return cls(vertices, walls, scale=scale, radius=agent_radius, **kw)

    # -- host-side planning (off the hot path) -------------------------------

    def _hash(self, p) -> Tuple[int, int]:
        # SpatialHash::new rounds to the nearest cell (rmf/mod.rs:72-77).
        return (int(round(p[0] / self._scale)), int(round(p[1] / self._scale)))

    def plan_route_cached(self, start, goal) -> Optional[int]:
        """Route id from ``start`` to ``goal``, planning on a cache miss
        (rmf/mod.rs:217-236).  None when no route exists — the reference
        prints and leaves the agent planless (rmf/mod.rs:233-235)."""
        key = (self._hash(start), self._hash(goal))
        if key in self._cache:
            return self._cache[key]
        route = self._backend.plan(tuple(start), tuple(goal))
        if route is None:
            # Cache the failure too: re-running full A* for every call
            # against the same unreachable pair is a host-side stall.
            self._cache[key] = None
            return None
        if self._n_routes >= self._max_routes:
            raise RuntimeError(
                f"route table full ({self._max_routes}); raise max_routes"
            )
        if len(route) > self._max_len:
            raise RuntimeError(
                f"route with {len(route)} waypoints exceeds max_route_len "
                f"{self._max_len}"
            )
        idx = self._n_routes
        self._points[idx, : len(route)] = np.asarray(route, np.float64)
        self._lengths[idx] = len(route)
        self._n_routes += 1
        self._cache[key] = idx
        return idx

    def plan_source_legs(self, source_sink) -> List[int]:
        """Plan one route leg per SourceSink waypoint: leg 0 runs
        source -> waypoints[0] (the spawn-time set_target, lib.rs:242-249),
        leg i runs waypoints[i-1] -> waypoints[i] (the waypoint-advance
        set_target, lib.rs:325-334).  -1 for unplannable legs."""
        legs: List[int] = []
        prev = tuple(source_sink.source)
        for wp in source_sink.waypoints:
            rid = self.plan_route_cached(prev, tuple(wp))
            legs.append(-1 if rid is None else rid)
            prev = tuple(wp)
        return legs

    def occupied(self, x: float, y: float) -> bool:
        """Debug probe into the inflated occupancy grid."""
        return self._backend.occupied(x, y)

    @property
    def n_routes(self) -> int:
        return self._n_routes

    def route(self, route_id: int) -> List[Tuple[float, float]]:
        n = int(self._lengths[route_id])
        return [tuple(p) for p in self._points[route_id, :n]]

    # -- params for the step ---------------------------------------------------

    def _route_table(self, device) -> RouteTable:
        # torch.tensor copies: the table must not alias the host store,
        # which grows as routes are planned.
        return RouteTable(
            points=torch.tensor(self._points).to(self._dtype).to(device),
            lengths=torch.tensor(self._lengths, device=device),
        )

    def init_params(self, device="cuda"):
        return {
            "routes": self._route_table(device),
            "tol": torch.tensor(self._tol, dtype=torch.float64,
                                device=device),
        }
