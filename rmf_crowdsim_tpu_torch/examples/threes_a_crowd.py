"""The reference viz demo on the port: three agents converge head-on and
Zanlungo forces deflect them ("threes-a-crowd",
rmf_crowdsim_viz/src/main.rs).

Counterpart of ``examples/threes_a_crowd.py``.  The reference renders with
a nannou window and steps with wall-clock dt (main.rs:104-110).  Here the
session steps at a fixed 60 Hz on the card (``--device cpu`` for the
CPU), headless; ``--out`` writes PNG frames and ``--gif`` an animated GIF
with matplotlib, which only those options import.

Scene per main.rs:64-94, but with a sane agent radius: the reference's
radius-20 agents spawned 2 apart start overlapped, so its own demo params
produce a TTC of zero and a force clamped at 1e15 (zanlungo.rs:163-167)
that flings agents to infinity in one step.  Pass --reference-params to
reproduce that faithfully.

Usage:
    python -m rmf_crowdsim_tpu_torch.examples.threes_a_crowd --frames 240
    python -m rmf_crowdsim_tpu_torch.examples.threes_a_crowd --gif crowd.gif
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rmf_crowdsim_tpu_torch import (
    GridConfig,
    ParityVelocity,
    SimConfig,
    Simulation,
    Zanlungo,
)


def build(reference_params: bool = False, device="cuda") -> Simulation:
    cfg = SimConfig(
        capacity=8,
        grid=GridConfig(width=1000.0, height=1000.0, cell_size=20.0,
                        offset=(-500.0, -500.0)),  # main.rs:65-69
        neighbor_backend="grid",
        max_per_cell=8,
        max_eyesight=100.0,
    )
    sim = Simulation(cfg, device=device)
    hl = ParityVelocity((0.0, 10.0))  # main.rs:75: speed (0, 10), even ids
    #                                   down, odd up (main.rs:26-29)
    if reference_params:
        lp = Zanlungo(1.0, 1.0, 0.0, 40.0, 2.0, 20.0)  # main.rs:76-78
    else:
        lp = Zanlungo(agent_scale=20.0, obstacle_scale=1.0, reaction_time=0.0,
                      force_distance=40.0, agent_mass=2.0, agent_radius=5.0)
    # main.rs:69-73: agents 0 and 1 converge head-on on x=100; agent 2
    # follows 0 down from (60, 100).
    sim.add_agents([(100.0, 100.0), (100.0, -100.0), (60.0, 100.0)],
                   hl, lp, agent_eyesight_range=100.0)
    return sim


def _frame(sim: Simulation):
    """One rendered frame (a matplotlib figure) of the session."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5), dpi=80)
    ax.set_facecolor("#6495ED")  # cornflower blue (main.rs:117)
    pts = np.asarray([v.position for v in sim.agents.values()])
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], s=200, c="#DDA0DD",  # plum
                   edgecolors="none")
    ax.set_xlim(-150, 150)
    ax.set_ylim(-150, 150)
    ax.set_title(f"t = {sim.sim_time:.2f} s")
    return fig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for PNG frames")
    ap.add_argument("--gif", default=None, help="write an animated GIF")
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--every", type=int, default=4, help="render cadence")
    ap.add_argument("--reference-params", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    sim = build(args.reference_params, device=args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    images = []
    for frame in range(args.frames):
        sim.step(1.0 / 60.0)
        if frame % args.every or not (args.out or args.gif):
            continue
        import matplotlib.pyplot as plt

        fig = _frame(sim)
        if args.out:
            fig.savefig(os.path.join(args.out, f"frame_{frame:04d}.png"))
        if args.gif:
            fig.canvas.draw()
            images.append(np.asarray(fig.canvas.buffer_rgba()).copy())
        plt.close(fig)

    if args.gif and images:
        import PIL.Image

        frames = [PIL.Image.fromarray(im) for im in images]
        frames[0].save(args.gif, save_all=True, append_images=frames[1:],
                       duration=1000 * args.every // 60, loop=0)
        print(f"wrote {args.gif} ({len(frames)} frames)")

    final = {k: tuple(round(float(c), 1) for c in v.position)
             for k, v in sim.agents.items()}
    print("final positions:", final)


if __name__ == "__main__":
    main()
