"""Real-time viewer on the port: the reference's windowed demo app
(rmf_crowdsim_viz/src/main.rs:96-129).

Counterpart of ``examples/live_viewer.py``.  Each frame steps the session
by the wall-clock time since the last frame (``update.since_last``,
main.rs:104-110) and draws the agents as plum discs on cornflower blue
(main.rs:112-129), in a matplotlib animation window.  The scene is the
port's "threes-a-crowd" demo (``examples.threes_a_crowd.build``) with its
sane agent radius, on the card (``--device cpu`` for the CPU).

With no ``$DISPLAY`` matplotlib draws off screen (Agg); ``--seconds N
--gif out.gif`` runs the same wall-clock-dt loop off screen for N seconds
and saves the frames with PIL.  Needs matplotlib and PIL, which only this
module imports.

Usage:
    python -m rmf_crowdsim_tpu_torch.examples.live_viewer
    python -m rmf_crowdsim_tpu_torch.examples.live_viewer --seconds 5 \\
        --gif live.gif
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .threes_a_crowd import build

CORNFLOWER = "#6495ED"
PLUM = "#DDA0DD"


def main(argv=None):
    """Runs the viewer; returns the session."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="run headless for N wall-clock seconds")
    ap.add_argument("--gif", default=None, help="save the headless run")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--lim", type=float, default=60.0,
                    help="view half-extent (world units)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sim = build(reference_params=False, device=args.device)
    headless = matplotlib.get_backend().lower() == "agg"

    fig, ax = plt.subplots(figsize=(6, 6))
    fig.patch.set_facecolor(CORNFLOWER)
    ax.set_facecolor(CORNFLOWER)
    ax.set_xlim(-args.lim, args.lim)
    ax.set_ylim(-args.lim, args.lim)
    ax.set_aspect("equal")
    ax.set_title("rmf_crowdsim_tpu_torch — live (wall-clock dt)")
    scat = ax.scatter([], [], s=120, c=PLUM, edgecolors="none")

    last = time.perf_counter()

    def frame(_i):
        nonlocal last
        now = time.perf_counter()
        dt = now - last  # update.since_last (main.rs:107)
        last = now
        sim.step(max(dt, 1e-6))
        pts = np.asarray([a.position for a in sim.agents.values()])
        scat.set_offsets(pts.reshape(-1, 2))
        return (scat,)

    if headless or args.seconds:
        frames = []
        t_end = time.perf_counter() + (args.seconds or 3.0)
        while time.perf_counter() < t_end:
            frame(0)
            if args.gif:
                fig.canvas.draw()
                frames.append(np.asarray(fig.canvas.buffer_rgba()).copy())
            time.sleep(1.0 / args.fps)
        plt.close(fig)
        print(f"ran {len(frames) or 'headless'} frames; "
              f"{sim.num_agents} agents alive at t={sim.sim_time:.2f}s")
        if args.gif and frames:
            from PIL import Image

            imgs = [Image.fromarray(f) for f in frames]
            imgs[0].save(args.gif, save_all=True, append_images=imgs[1:],
                         duration=int(1000 / args.fps), loop=0)
            print(f"wrote {args.gif}")
        return sim

    from matplotlib.animation import FuncAnimation

    _anim = FuncAnimation(fig, frame, interval=1000.0 / args.fps,
                          cache_frame_data=False)
    plt.show()
    return sim


if __name__ == "__main__":
    main()
