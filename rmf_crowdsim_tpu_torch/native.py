"""ctypes bindings for the native route planner (native/crowdsim_native.cpp)
plus a pure-Python fallback with identical semantics.

The reference's route planning is native Rust (the external ``mapf`` crate,
consumed at rmf/mod.rs:12-30); here the native component is C++ behind a C
ABI.  ``RoutePlannerBackend`` is the shared interface:

    plan(start, goal) -> list[(x, y)] | None   (None = no route,
                                                mapf Status::Impossible)

The C++ library is auto-built with g++ on first use if missing or stale;
the ``NumpyRoutePlanner`` fallback (same algorithm: Bresenham
rasterization, disc inflation, and EXACT shortest-path planning over the
convex-corner visibility graph — the reference's mapf optimality,
rmf/mod.rs:126/160-192 — with grid A* + line-of-sight string-pulling as
the legacy mode and in-plan fallback) keeps the framework functional
without a toolchain and serves as the oracle in native-vs-fallback
parity tests.

A copy of ``rmf_crowdsim_tpu/native.py`` (numpy and ctypes only; the JAX
package's copy cannot be imported without its ``__init__``, which imports
JAX).  It builds the same ``native/crowdsim_native.cpp`` at the repository
root, but into the port's git-ignored ``_build/`` directory, so that it
never touches the library the JAX package's copy owns.  The compiler
writes a temporary file that ``os.replace`` moves into place, so that two
processes building at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import heapq
import math
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libcrowdsim_native.so")

_lib = None
_lib_error: Optional[str] = None


def _load_lib():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        src = os.path.join(_NATIVE_DIR, "crowdsim_native.cpp")
        stale = (
            not os.path.exists(_SO_PATH)
            or (os.path.exists(src)
                and os.path.getmtime(src) > os.path.getmtime(_SO_PATH))
        )
        if stale:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                     "-o", tmp, src],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, _SO_PATH)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(_SO_PATH)
        lib.cs_create.restype = ctypes.c_void_p
        lib.cs_create.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_double, ctypes.c_double,
        ]
        lib.cs_destroy.argtypes = [ctypes.c_void_p]
        lib.cs_plan.restype = ctypes.c_int
        lib.cs_plan.argtypes = [
            ctypes.c_void_p,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.cs_occupied.restype = ctypes.c_int
        lib.cs_occupied.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                    ctypes.c_double]
        lib.cs_grid_dims.restype = ctypes.c_int
        lib.cs_grid_dims.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_double)]
        lib.cs_set_mode.restype = None
        lib.cs_set_mode.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
    except Exception as e:  # toolchain missing / build failure
        _lib_error = repr(e)
        _lib = None
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeRoutePlanner:
    """C++ planner behind ctypes (native/crowdsim_native.cpp)."""

    def __init__(self, vertices: Sequence[Tuple[float, float]],
                 walls: Sequence[Tuple[int, int]],
                 cell_size: float, inflation: float,
                 max_waypoints: int = 512, mode: str = "visibility"):
        assert mode in ("visibility", "grid"), mode
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native planner unavailable: {_lib_error}")
        self._lib = lib
        self._max = int(max_waypoints)
        v = np.ascontiguousarray(np.asarray(vertices, np.float64).reshape(-1, 2))
        w = np.ascontiguousarray(np.asarray(walls, np.int32).reshape(-1, 2))
        self._v = v  # keep alive
        self._w = w
        self._h = lib.cs_create(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(w),
            ctypes.c_double(cell_size), ctypes.c_double(inflation),
        )
        if not self._h:
            raise RuntimeError("cs_create failed")
        self.mode = mode
        lib.cs_set_mode(self._h, 0 if mode == "visibility" else 1)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cs_destroy(h)
            self._h = None

    def occupied(self, x: float, y: float) -> bool:
        return bool(self._lib.cs_occupied(self._h, x, y))

    def plan(self, start, goal) -> Optional[List[Tuple[float, float]]]:
        buf = np.empty((self._max * 2,), np.float64)
        n = self._lib.cs_plan(
            self._h, start[0], start[1], goal[0], goal[1],
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), self._max,
        )
        if n == -2:
            raise RuntimeError("route longer than max_waypoints")
        if n < 0:
            return None
        pts = buf[: 2 * n].reshape(n, 2)
        return [tuple(p) for p in pts]


class NumpyRoutePlanner:
    """Pure-Python planner with the same semantics as the C++ one; the
    parity oracle and the no-toolchain fallback.

    ``mode`` selects the algorithm, mirroring ``cs_set_mode``:
    "visibility" (default) = exact shortest path over the convex-corner
    visibility graph (the reference's mapf semantics, rmf/mod.rs:126,
    160-192); "grid" = legacy grid A* + string-pulling (also the in-plan
    fallback when the graph can't connect the endpoints)."""

    def __init__(self, vertices, walls, cell_size: float, inflation: float,
                 max_waypoints: int = 512, mode: str = "visibility"):
        assert mode in ("visibility", "grid"), mode
        self.mode = mode
        self._graph = None  # lazily built (nodes, csr) visibility graph
        self._goal_cache: dict = {}
        self.cell = float(cell_size)
        v = np.asarray(vertices, np.float64).reshape(-1, 2)
        w = np.asarray(walls, np.int64).reshape(-1, 2)
        if len(v):
            minx, miny = v.min(0)
            maxx, maxy = v.max(0)
        else:
            minx = miny = maxx = maxy = 0.0
        margin = inflation + 4.0 * cell_size
        self.ox = minx - margin
        self.oy = miny - margin
        self.nx = max(1, int(math.ceil((maxx + margin - self.ox) / cell_size)))
        self.ny = max(1, int(math.ceil((maxy + margin - self.oy) / cell_size)))
        occ = np.zeros((self.nx, self.ny), bool)
        for a, b in w:
            if not (0 <= a < len(v) and 0 <= b < len(v)):
                continue
            for cx, cy in self._bresenham(
                self._cx(v[a, 0]), self._cy(v[a, 1]),
                self._cx(v[b, 0]), self._cy(v[b, 1]),
            ):
                if 0 <= cx < self.nx and 0 <= cy < self.ny:
                    occ[cx, cy] = True
        self.occ = occ
        r = int(math.ceil(inflation / cell_size))
        inflated = occ.copy()
        if r > 0:
            disc = [
                (dx, dy)
                for dx in range(-r, r + 1)
                for dy in range(-r, r + 1)
                if dx * dx + dy * dy <= r * r
            ]
            xs, ys = np.nonzero(occ)
            for dx, dy in disc:
                xx = xs + dx
                yy = ys + dy
                ok = (xx >= 0) & (xx < self.nx) & (yy >= 0) & (yy < self.ny)
                inflated[xx[ok], yy[ok]] = True
        self.inflated = inflated

    def _cx(self, x):
        return int(math.floor((x - self.ox) / self.cell))

    def _cy(self, y):
        return int(math.floor((y - self.oy) / self.cell))

    @staticmethod
    def _bresenham(x0, y0, x1, y1):
        dx, sx = abs(x1 - x0), 1 if x0 < x1 else -1
        dy, sy = -abs(y1 - y0), 1 if y0 < y1 else -1
        err = dx + dy
        x, y = x0, y0
        while True:
            yield x, y
            if x == x1 and y == y1:
                return
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x += sx
            if e2 <= dx:
                err += dx
                y += sy

    def _blocked(self, cx, cy) -> bool:
        if not (0 <= cx < self.nx and 0 <= cy < self.ny):
            return False  # outside the grid is free space
        return bool(self.inflated[cx, cy])

    def occupied(self, x, y) -> bool:
        return self._blocked(self._cx(x), self._cy(y))

    def _line_of_sight(self, ax, ay, bx, by) -> bool:
        x0 = (ax - self.ox) / self.cell
        y0 = (ay - self.oy) / self.cell
        x1 = (bx - self.ox) / self.cell
        y1 = (by - self.oy) / self.cell
        cx, cy = math.floor(x0), math.floor(y0)
        gx, gy = math.floor(x1), math.floor(y1)
        dx, dy = x1 - x0, y1 - y0
        sx = 1 if dx > 0 else -1
        sy = 1 if dy > 0 else -1
        if dx != 0:
            t_max_x = ((cx + 1 if sx > 0 else cx) - x0) / dx
            t_dx = abs(1.0 / dx)
        else:
            t_max_x, t_dx = 2.0, 2.0
        if dy != 0:
            t_max_y = ((cy + 1 if sy > 0 else cy) - y0) / dy
            t_dy = abs(1.0 / dy)
        else:
            t_max_y, t_dy = 2.0, 2.0
        if self._blocked(cx, cy):
            return False
        # Exact bound: the walk advances >= 1 cell toward the goal per
        # iteration (cell Manhattan distance; a grid-size cap would
        # spuriously fail long free segments whose endpoints lie far
        # outside the raster — out-of-grid cells are traversable).
        for _ in range(abs(gx - cx) + abs(gy - cy) + 8):
            if cx == gx and cy == gy:
                return True
            if t_max_x < t_max_y:
                t_max_x += t_dx
                cx += sx
            elif t_max_y < t_max_x:
                t_max_y += t_dy
                cy += sy
            else:
                if self._blocked(cx + sx, cy) and self._blocked(cx, cy + sy):
                    return False
                t_max_x += t_dx
                t_max_y += t_dy
                cx += sx
                cy += sy
            if self._blocked(cx, cy):
                return False
        return cx == gx and cy == gy

    # -- exact visibility-graph planning (mirrors the C++ build_graph /
    # -- goal_tree / plan_visibility; tie-breaks are (dist, idx) in both) --

    def _build_graph(self):
        if self._graph is not None:
            return self._graph
        eps = 0.03 * self.cell
        # Convex lattice corners: pad the inflated grid with a free border,
        # then a corner (i, j) is convex iff exactly one of its 4 touching
        # cells is blocked (identical to tests/visibility_oracle.py).
        occ = np.zeros((self.nx + 2, self.ny + 2), bool)
        occ[1:-1, 1:-1] = self.inflated
        q0 = occ[:-1, :-1]  # cell (i-1, j-1)
        q1 = occ[1:, :-1]   # cell (i,   j-1)
        q2 = occ[:-1, 1:]   # cell (i-1, j)
        q3 = occ[1:, 1:]    # cell (i,   j)
        total = q0.astype(np.int8) + q1 + q2 + q3
        ii, jj = np.nonzero(total == 1)
        sx = np.where(q1[ii, jj] | q3[ii, jj], -1.0, 1.0)
        sy = np.where(q2[ii, jj] | q3[ii, jj], -1.0, 1.0)
        nx_ = self.ox + ii * self.cell + sx * eps
        ny_ = self.oy + jj * self.cell + sy * eps
        nodes = list(zip(nx_.tolist(), ny_.tolist()))
        v = len(nodes)
        adj: List[List[Tuple[int, float]]] = [[] for _ in range(v)]
        for a in range(v):
            ax, ay = nodes[a]
            for b in range(a + 1, v):
                bx, by = nodes[b]
                if self._line_of_sight(ax, ay, bx, by):
                    w = math.sqrt((bx - ax) ** 2 + (by - ay) ** 2)
                    adj[a].append((b, w))
                    adj[b].append((a, w))
        self._graph = (nodes, adj)
        return self._graph

    def _goal_tree(self, gx, gy):
        key = (gx, gy)
        t = self._goal_cache.get(key)
        if t is not None:
            return t
        nodes, adj = self._build_graph()
        v = len(nodes)
        dist = [math.inf] * v
        nxt = [-1] * v
        heap = []
        for c, (cx_, cy_) in enumerate(nodes):
            if self._line_of_sight(gx, gy, cx_, cy_):
                dist[c] = math.sqrt((cx_ - gx) ** 2 + (cy_ - gy) ** 2)
                heapq.heappush(heap, (dist[c], c))
        done = [False] * v
        while heap:
            d, u = heapq.heappop(heap)
            if done[u]:
                continue
            done[u] = True
            for b, w in adj[u]:
                nd = d + w
                if nd < dist[b]:
                    dist[b] = nd
                    nxt[b] = u
                    heapq.heappush(heap, (nd, b))
        t = (dist, nxt)
        self._goal_cache[key] = t
        return t

    def _plan_visibility(self, sx, sy, gx, gy):
        """Exact shortest route, or None when the corner graph can't
        connect the endpoints (caller falls back to grid A*)."""
        nodes, _ = self._build_graph()
        if not nodes:
            return None
        dist, nxt = self._goal_tree(gx, gy)
        # Candidates by |s->c| + dist(c->goal) ascending: that sum is the
        # total route cost when c is visible, so the first visible
        # candidate is the exact optimum.
        cand = sorted(
            (math.sqrt((cx_ - sx) ** 2 + (cy_ - sy) ** 2) + dist[c], c)
            for c, (cx_, cy_) in enumerate(nodes)
            if dist[c] < math.inf
        )
        for _, c in cand:
            if not self._line_of_sight(sx, sy, *nodes[c]):
                continue
            out = [(sx, sy)]
            cur = c
            while cur != -1:
                out.append(nodes[cur])
                cur = nxt[cur]
            out.append((gx, gy))
            return out
        return None

    def plan(self, start, goal) -> Optional[List[Tuple[float, float]]]:
        sx, sy = float(start[0]), float(start[1])
        gx, gy = float(goal[0]), float(goal[1])
        if self._line_of_sight(sx, sy, gx, gy):
            return [(sx, sy), (gx, gy)]
        if (self.mode == "visibility"
                and not self._blocked(self._cx(sx), self._cy(sy))
                and not self._blocked(self._cx(gx), self._cy(gy))):
            route = self._plan_visibility(sx, sy, gx, gy)
            if route is not None:
                return route
            # fall through: grid A* decides reachability
        scx = min(max(self._cx(sx), 0), self.nx - 1)
        scy = min(max(self._cy(sy), 0), self.ny - 1)
        gcx = min(max(self._cx(gx), 0), self.nx - 1)
        gcy = min(max(self._cy(gy), 0), self.ny - 1)
        if self._blocked(scx, scy) or self._blocked(gcx, gcy):
            return None

        sq2 = math.sqrt(2.0)

        def heur(x, y):
            ddx, ddy = abs(x - gcx), abs(y - gcy)
            return (ddx + ddy) + (sq2 - 2.0) * min(ddx, ddy)

        start_id = (scx, scy)
        goal_id = (gcx, gcy)
        dist = {start_id: 0.0}
        parent = {}
        open_heap = [(heur(scx, scy), start_id)]
        moves = [
            (1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
            (1, 1, sq2), (1, -1, sq2), (-1, 1, sq2), (-1, -1, sq2),
        ]
        found = start_id == goal_id
        while open_heap:
            f, cur = heapq.heappop(open_heap)
            if cur == goal_id:
                found = True
                break
            cx, cy = cur
            if f > dist[cur] + heur(cx, cy) + 1e-9:
                continue
            for mdx, mdy, mc in moves:
                nx2, ny2 = cx + mdx, cy + mdy
                if not (0 <= nx2 < self.nx and 0 <= ny2 < self.ny):
                    continue
                if self._blocked(nx2, ny2):
                    continue
                if mdx and mdy and (
                    self._blocked(cx + mdx, cy) or self._blocked(cx, cy + mdy)
                ):
                    continue
                nd = dist[cur] + mc
                nid = (nx2, ny2)
                if nd < dist.get(nid, 1e18):
                    dist[nid] = nd
                    parent[nid] = cur
                    heapq.heappush(open_heap, (nd + heur(nx2, ny2), nid))
        if not found:
            return None

        def center(c):
            return (self.ox + (c[0] + 0.5) * self.cell,
                    self.oy + (c[1] + 0.5) * self.cell)

        path = [(gx, gy)]
        cur = parent.get(goal_id)
        while cur is not None and cur != start_id:
            path.append(center(cur))
            cur = parent.get(cur)
        path.append((sx, sy))
        path.reverse()

        out = [path[0]]
        anchor = 0
        while anchor + 1 < len(path):
            far = anchor + 1
            for j in range(len(path) - 1, anchor, -1):
                if self._line_of_sight(path[anchor][0], path[anchor][1],
                                       path[j][0], path[j][1]):
                    far = j
                    break
            out.append(path[far])
            anchor = far
        return out


def make_route_planner(vertices, walls, cell_size: float, inflation: float,
                       prefer_native: bool = True, max_waypoints: int = 512,
                       mode: str = "visibility"):
    """Factory: native C++ planner when the toolchain/lib is available,
    NumPy fallback otherwise."""
    if prefer_native and native_available():
        return NativeRoutePlanner(vertices, walls, cell_size, inflation,
                                  max_waypoints, mode=mode)
    return NumpyRoutePlanner(vertices, walls, cell_size, inflation,
                             max_waypoints, mode=mode)
