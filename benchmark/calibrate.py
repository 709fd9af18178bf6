"""The readings that the limits of ``limits/<cell>.json`` are set from, at
the cell's own size on the card, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> ... \
        [--control 3] [--seconds 2] [--fault <name>]

For each seed: a run with a short window at the cell's own load and its
check (the program's readings), and for the first ``--control`` seeds the
control, the reference computed in bfloat16 (the precision below the
float32 the configuration states) in the program's place, read at the
same steps.  With ``--fault``, one of ``faults.py``'s faults is planted
in the program first, and no control runs.  One JSON line a seed.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from . import faults, harness, scene


def readings(verdict, check) -> dict:
    out = harness.numbers(check)
    out.update(worst_velocity_gap=verdict.worst_vel, ties=verdict.ties,
               off=verdict.off_uids, compared=verdict.compared)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    man = harness.manifest()
    w = harness.cell(man, args.workload)
    try:
        harness.require_card(int(w["chips"]))
    except harness.NoCard as e:
        print(f"calibrate: {e}", file=sys.stderr)
        return 2
    cfg = scene.load("configs", w["config"])
    traffic = scene.load("traffic", w["traffic"])
    lim = harness.limits(args.workload)
    if args.fault:
        faults.FAULTS[args.fault](setattr)
        args.control = 0
    for i, seed in enumerate(args.seeds):
        rec = harness.measure(cfg, traffic, seed, args.seconds, False)
        got = harness.numbers(rec["check"])
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": all(got[k] <= v for k, v in lim.items()),
                "program": readings(rec["check"]["verdict"], rec["check"])}
        if i < args.control:
            v = rec["driver"].control(seed, torch.bfloat16)
            line["control"] = {"agents_off": v.agents_off,
                               "events_off": v.events_off,
                               "compared": v.compared,
                               "worst_velocity_gap": v.worst_vel}
        print(json.dumps(line), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
