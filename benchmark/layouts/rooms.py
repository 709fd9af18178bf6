"""``rooms``: a hall of rooms side by side between the walls at
``x_walls``, each with an ``nx`` x ``ny`` lattice of sources ``inset``
metres inside its walls, every point rounded to a multiple of ``snap``
(the route planner's cache cell).  Each source has one waypoint, which is
also its sink, drawn from the seed:

- across each door, in each direction, ``cross_per_door`` sources of the
  room on that side walk to a lattice point of the room on the other
  side, so that every seed loads every door alike;
- every other source walks to a lattice point of its own room at least
  ``min_distance`` away.

The seed also draws each generator's phase and the order in which the
program holds the sources (and so the agents' uids and right of way)."""

import numpy as np

from ..scene import SourcePlan


def lattices(layout: dict) -> list:
    """Per room, its lattice points [P, 2]."""
    nx, ny = layout["lattice"]
    inset, snap = layout["inset"], layout["snap"]
    y0, y1 = layout["y_range"]
    xw = layout["x_walls"]
    ys = np.round(np.linspace(y0 + inset, y1 - inset, ny) / snap) * snap
    rooms = []
    for x0, x1 in zip(xw[:-1], xw[1:]):
        xs = np.round(np.linspace(x0 + inset, x1 - inset, nx) / snap) * snap
        rooms.append(np.stack(np.meshgrid(xs, ys, indexing="ij"),
                              -1).reshape(-1, 2))
    return rooms


def plan(spec: dict, cfg: dict, seed: int) -> SourcePlan:
    layout = spec["layout"]
    rooms = lattices(layout)
    rng = np.random.default_rng([seed, 2])
    k = int(layout["cross_per_door"])
    target = {}
    for door in range(len(rooms) - 1):
        for a, b in ((door, door + 1), (door + 1, door)):
            free = [i for i in range(rooms[a].shape[0])
                    if (a, i) not in target]
            for i in rng.choice(free, k, replace=False):
                pts = rooms[b]
                target[(a, int(i))] = pts[rng.integers(pts.shape[0])]
    pos, wps = [], []
    for r, pts in enumerate(rooms):
        for i, p in enumerate(pts):
            q = target.get((r, i))
            if q is None:
                far = pts[np.linalg.norm(pts - p, axis=1)
                          >= layout["min_distance"]]
                q = far[rng.integers(far.shape[0])]
            pos.append(p)
            wps.append([(float(q[0]), float(q[1]))])
    phase = rng.uniform(size=len(pos))
    order = rng.permutation(len(pos))
    return SourcePlan(np.asarray(pos)[order], [wps[i] for i in order],
                      phase[order], spec)
