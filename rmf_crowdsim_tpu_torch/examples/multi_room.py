"""Multi-room routing demo on the port — BASELINE.md config 4: an RMF
building + Zanlungo avoidance, agents streaming between rooms through
doorways.

Counterpart of ``examples/multi_room.py``.  A 40x20 building with two
internal walls leaving door gaps; SourceSinks stream agents from the left
room to the right room and back.  Routes come from the native C++ planner
(``RMFPlanner``); avoidance from the Zanlungo model (the CUDA kernels when
``--backend grid_pallas`` on the card).  The building is given by its
vertex and wall lists (the JAX example's ``BUILDING_YAML``, level L1), so
no YAML parser is needed; ``RMFPlanner.from_yaml`` reads the same
building from YAML.  ``--png`` (matplotlib) draws the walls and the
agents' trails.

Usage:
    python -m rmf_crowdsim_tpu_torch.examples.multi_room [--agents-rate 0.6]
        [--steps 400] [--backend grid] [--device cuda] [--png rooms.png]
"""

from __future__ import annotations

import argparse

from rmf_crowdsim_tpu_torch import (
    EventListener,
    GridConfig,
    PoissonCrowd,
    RMFPlanner,
    SimConfig,
    Simulation,
    SourceSink,
    Zanlungo,
)

VERTICES = [
    (0.0, 0.0), (40.0, 0.0), (40.0, 20.0), (0.0, 20.0),  # outer box
    (14.0, 0.0), (14.0, 8.0),    # wall A bottom (door gap 8..12 high)
    (14.0, 12.0), (14.0, 20.0),
    (27.0, 0.0), (27.0, 10.0),   # wall B bottom (door gap 10..14 high)
    (27.0, 14.0), (27.0, 20.0),
]
WALLS = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (6, 7), (8, 9), (10, 11)]


class Counter(EventListener):
    """Counts the session's events."""

    def __init__(self):
        self.spawned = self.destroyed = self.waypoints = 0

    def agent_spawned(self, position, agent_id):
        self.spawned += 1

    def agent_destroyed(self, agent_id):
        self.destroyed += 1

    def waypoint_reached(self, position, agent_id):
        self.waypoints += 1


def make_planner() -> RMFPlanner:
    return RMFPlanner(VERTICES, WALLS, scale=0.5, radius=0.3,
                      arrival_tolerance=0.4)


def build(agents_rate: float = 0.6, backend: str = "grid", device="cuda",
          planner: RMFPlanner | None = None,
          crowd=PoissonCrowd) -> Simulation:
    """The session: two SourceSinks of ``crowd(agents_rate)`` routed by
    ``planner`` (:func:`make_planner` when None) through both doors."""
    planner = planner or make_planner()
    # force_cap: the reference's 1e15 clamp flings overlapping agents to
    # ~1e14 positions (see ZanlungoParams).
    lp = Zanlungo(agent_scale=2.0, obstacle_scale=1.0, reaction_time=0.0,
                  force_distance=1.0, agent_mass=2.0, agent_radius=0.3,
                  force_cap=6.0)
    cfg = SimConfig(
        capacity=256,
        grid=GridConfig(width=48.0, height=28.0, cell_size=2.0,
                        offset=(-4.0, -4.0)),
        neighbor_backend=backend,
        max_per_cell=32,
        max_eyesight=2.0,
    )
    sim = Simulation(cfg, device=device)
    # Left room -> far right room, via both doors; and the reverse flow.
    for source, waypoints in (((4.0, 4.0), [(20.0, 10.0), (36.0, 16.0)]),
                              ((36.0, 4.0), [(20.0, 10.0), (4.0, 16.0)])):
        sim.add_source_sink(SourceSink(
            source=source, waypoints=waypoints, radius_sink=1.0,
            crowd_generator=crowd(agents_rate), high_level_planner=planner,
            local_planner=lp, agent_eyesight_range=2.0))
    return sim


def _draw(trail, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=100)
    for a, b in WALLS:
        ax.plot([VERTICES[a][0], VERTICES[b][0]],
                [VERTICES[a][1], VERTICES[b][1]], "k-", lw=2)
    for i, pts in enumerate(trail):
        if not pts:
            continue
        p = np.asarray(pts)
        ax.scatter(p[:, 0], p[:, 1], s=4,
                   alpha=min(1.0, 0.1 + 0.9 * i / max(1, len(trail) - 1)),
                   c="#7B3FF2", edgecolors="none")
    ax.set_aspect("equal")
    ax.set_title("multi-room routing (trails lighten with time)")
    fig.savefig(path, bbox_inches="tight")
    print(f"wrote {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents-rate", type=float, default=0.6)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--dt", type=float, default=0.25)
    ap.add_argument("--backend", default="grid")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--png", default=None)
    args = ap.parse_args()

    planner = make_planner()
    sim = build(args.agents_rate, args.backend, args.device, planner)
    counter = Counter()
    sim.add_event_listener(counter)

    trail = []
    for step in range(args.steps):
        sim.step(args.dt)
        if step % 40 == 0:
            print(f"t={sim.sim_time:6.1f}s agents={sim.num_agents:4d} "
                  f"spawned={counter.spawned} arrived={counter.destroyed}")
        if args.png and step % 4 == 0:
            trail.append([v.position for v in sim.agents.values()])

    print(f"done: {counter.spawned} spawned, {counter.destroyed} arrived, "
          f"{counter.waypoints} waypoint hits, {planner.n_routes} routes "
          f"planned")
    if args.png:
        _draw(trail, args.png)


if __name__ == "__main__":
    main()
