"""Judge the routes a route planner made, against the building's walls.

A route passes when it starts at its leg's start and ends at its goal
(within ``END_TOL``), none of its segments meets a wall, and it is at most
``LENGTH_SLACK`` times as long as the shortest path that this module finds
itself: Dijkstra over the visibility graph of the start, the goal and the
walls' end points, each wall taken as a segment without width (a lower
bound on any route that keeps clear of the walls).
"""

from __future__ import annotations

import heapq
import math

import numpy as np

END_TOL = 1e-3
LENGTH_SLACK = 2.0
_EPS = 1e-9


def _orient(a, b, c):
    v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
    return 0 if abs(v) <= _EPS else (1 if v > 0 else -1)


def _on(a, b, c):
    return (min(a[0], b[0]) - _EPS <= c[0] <= max(a[0], b[0]) + _EPS
            and min(a[1], b[1]) - _EPS <= c[1] <= max(a[1], b[1]) + _EPS)


def meets(p, q, a, b) -> bool:
    """Segments pq and ab share a point."""
    o1, o2 = _orient(p, q, a), _orient(p, q, b)
    o3, o4 = _orient(a, b, p), _orient(a, b, q)
    if o1 != o2 and o3 != o4 and 0 not in (o1, o2, o3, o4):
        return True
    return ((o1 == 0 and _on(p, q, a)) or (o2 == 0 and _on(p, q, b))
            or (o3 == 0 and _on(a, b, p)) or (o4 == 0 and _on(a, b, q)))


def wall_segments(vertices, walls):
    return [(tuple(map(float, vertices[i])), tuple(map(float, vertices[j])))
            for i, j in walls]


def _shrunk(walls, eps=1e-6):
    out = []
    for a, b in walls:
        length = math.dist(a, b)
        ux, uy = (b[0] - a[0]) / length, (b[1] - a[1]) / length
        out.append(((a[0] + eps * ux, a[1] + eps * uy),
                    (b[0] - eps * ux, b[1] - eps * uy)))
    return out


def shortest(start, goal, walls) -> float:
    """Length of the shortest path from ``start`` to ``goal`` that crosses
    no wall (it may pass through a wall's end point)."""
    thin = _shrunk(walls)
    nodes = [tuple(start), tuple(goal)]
    nodes += sorted({p for w in walls for p in w})
    free = [[all(not meets(u, v, a, b) for a, b in thin) for v in nodes]
            for u in nodes]
    dist = [math.inf] * len(nodes)
    dist[0] = 0.0
    heap = [(0.0, 0)]
    while heap:
        d, u = heapq.heappop(heap)
        if u == 1:
            return d
        if d > dist[u]:
            continue
        for v in range(len(nodes)):
            if v != u and free[u][v]:
                nd = d + math.dist(nodes[u], nodes[v])
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(heap, (nd, v))
    return math.inf


def judge(points: np.ndarray, start, goal, walls) -> tuple:
    """(passes, length / shortest) of one route ``points`` [n, 2]."""
    pts = [tuple(map(float, p)) for p in np.asarray(points, np.float64)]
    if len(pts) < 2:
        return False, math.inf
    ends = (math.dist(pts[0], start) <= END_TOL
            and math.dist(pts[-1], goal) <= END_TOL)
    clear = all(not meets(pts[k], pts[k + 1], a, b)
                for k in range(len(pts) - 1) for a, b in walls)
    length = sum(math.dist(pts[k], pts[k + 1]) for k in range(len(pts) - 1))
    best = shortest(start, goal, walls)
    ratio = length / best if best > 0 else math.inf
    return bool(ends and clear and ratio <= LENGTH_SLACK), ratio
