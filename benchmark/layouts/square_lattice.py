"""``square_lattice``: ``count`` sources on a square lattice over the
world's interior (``margin`` inside its edges), each with the same
``waypoints`` as offsets from its point; scenes.py's stream scene."""

import math

import numpy as np

from ..scene import SourcePlan


def plan(spec: dict, cfg: dict, seed: int) -> SourcePlan:
    layout = spec["layout"]
    m = math.isqrt(layout["count"])
    if m * m != layout["count"]:
        raise ValueError(f"{layout['count']} sources are not a square")
    g = cfg["sim"]["grid"]
    if g["width"] != g["height"] or g["offset"][0] != -g["width"] / 2 or \
            g["offset"][1] != -g["height"] / 2:
        raise ValueError("a square lattice needs a square world about 0")
    lim = g["width"] / 2 - layout["margin"]
    c = -lim + (np.arange(m) + 0.5) * (2 * lim / m)
    pos = np.stack(np.meshgrid(c, c, indexing="ij"), -1).reshape(-1, 2)
    wps = [[(float(x) + dx, float(y) + dy) for dx, dy in spec["waypoints"]]
           for x, y in pos]
    return SourcePlan(pos, wps, np.zeros(pos.shape[0]), spec)
