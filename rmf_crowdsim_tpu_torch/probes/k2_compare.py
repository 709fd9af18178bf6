"""K2's call time against its device time: this checkout's port beside
another checkout's, in turns, in one process on one card.

    python -m rmf_crowdsim_tpu_torch.probes.k2_compare --other DIR

``DIR`` holds another checkout of the repo (for example the parent
commit, unpacked by ``git archive``).  Its ``rmf_crowdsim_tpu_torch`` is
loaded under the name ``other_port``: it builds its kernels into its own
``_build/`` and launches them through its own ``utils/cuda_build.py``.
Each side makes the K2 inputs of ``chip_smoke.py``'s phase 3 with its own
package (the 1M bench scene with its hotspot, K3's planes, the spill
list); the two sides' inputs and K2 outputs are held bitwise equal.
Then, for ``int_prio`` on and off, ``ROUNDS`` rounds of turns (this,
other, other, this) of ``REPS`` back-to-back K2 calls give each side's
time a call on CUDA events (as phase 3 takes it) and host µs a call (the
host clock over the same calls, before the closing synchronize); after
every such timing, ``DEVICE_ROUNDS`` rounds of turns of
``utils.profile_step.kernel_device_ms`` give each side's device time of
the K2 kernel, one function for both sides.  Printed: each turn's
numbers, then each side's means and its call time minus its device time.
Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from ..utils.profile_step import card_line, kernel_device_ms
from . import require_card

N_AGENTS = 1_000_000   # the main path's bench scene, as in chip_smoke.py
REPS = 10              # back-to-back calls a timed turn, as phase 3
ROUNDS = 8             # rounds of turns this, other, other, this
DEVICE_REPS = 20       # profiled calls a device-time turn, as phase 3
DEVICE_ROUNDS = 2
KERNEL = "spill_window_kernel"


def load_port(root, name: str = "other_port"):
    """The ``rmf_crowdsim_tpu_torch`` package under ``root``, loaded as
    the top-level package ``name`` (its relative imports resolve inside
    it), once a process; returns the package."""
    pkg = Path(root).resolve() / "rmf_crowdsim_tpu_torch"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    if spec is None:
        raise FileNotFoundError(f"no package at {pkg}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def k2_case(port, device, n_agents: int) -> dict:
    """K2's inputs on ``port`` (a loaded port package) as phase 3 makes
    them, and ``call(int_prio)``, one K2 call into a velocity scratch."""
    scenes = importlib.import_module(f"{port.__name__}.scenes")
    pack = importlib.import_module(f"{port.__name__}.ops.pack")
    spill = importlib.import_module(f"{port.__name__}.ops.spill")
    zb = importlib.import_module(f"{port.__name__}.ops.zanlungo_bucketed")
    config, bcfg, params, st, rec, feat_t, bpos, bucket_pos = (
        scenes.bench_bucketed(n_agents, device=device))
    packed_t, packed_T, _ = pack.pack_rows(feat_t, bpos, bcfg.slots)
    zp5 = zb.zparams5(params.lp[0])
    c_sp, rows, sp_tcx, sp_tcy = spill.spill_rows(
        bcfg, st.position, st.velocity, rec, st.preferred_vel, st.priority,
        st.eyesight, st.alive, rec, bucket_pos, config.spill_capacity)
    vel = rec.clone()

    def call(int_prio: bool):
        spill.spill_window(bcfg, zp5, packed_t, packed_T, rows, sp_tcx,
                           sp_tcy, vel, int_prio=int_prio)

    return dict(call=call, vel=vel, rec=rec, n_spill=int(c_sp.count),
                inputs=(packed_t, packed_T, rows, sp_tcx, sp_tcy, zp5))


def check_equal(a: dict, b: dict) -> None:
    """Raise unless the two sides' K2 inputs, and their K2 outputs with
    ``int_prio`` on and off, are bitwise equal."""
    for x, y in zip(a["inputs"], b["inputs"]):
        if not torch.equal(x, y):
            raise AssertionError("the two ports made different K2 inputs")
    for int_prio in (True, False):
        for case in (a, b):
            case["vel"].copy_(case["rec"])
            case["call"](int_prio)
        if not torch.equal(a["vel"], b["vel"]):
            raise AssertionError(f"the two ports' K2 outputs differ "
                                 f"(int_prio={int_prio})")


def host_and_call(fn, reps: int) -> tuple:
    """(µs a call on the host clock before the closing synchronize, ms a
    call on CUDA events) over ``reps`` back-to-back calls of ``fn``, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    end.record()
    end.synchronize()
    return 1e6 * (t1 - t0) / reps, start.elapsed_time(end) / reps


def compare(sides: dict) -> dict:
    """``sides``: {"this": case, "other": case} from :func:`k2_case`.
    For ``int_prio`` on and off, the turns of each side: ``host_us``,
    ``call_ms`` (all timed before the first profiler session), then
    ``device_ms``; and their means with ``gap_ms`` = call - device."""
    order = ("this", "other", "other", "this")
    out = {}
    for int_prio in (True, False):
        fns = {k: (lambda c=c: c["call"](int_prio))
               for k, c in sides.items()}
        out[int_prio] = {k: dict(host_us=[], call_ms=[], device_ms=[])
                         for k in sides}
        for _ in range(ROUNDS):
            for k in order:
                h, c = host_and_call(fns[k], REPS)
                out[int_prio][k]["host_us"].append(h)
                out[int_prio][k]["call_ms"].append(c)
    for int_prio in (True, False):
        fns = {k: (lambda c=c: c["call"](int_prio))
               for k, c in sides.items()}
        for _ in range(DEVICE_ROUNDS):
            for k in order:
                out[int_prio][k]["device_ms"].append(
                    kernel_device_ms(fns[k], DEVICE_REPS, KERNEL))
    for r in out.values():
        for s in r.values():
            for key in ("host_us", "call_ms", "device_ms"):
                s[f"mean_{key}"] = sum(s[key]) / len(s[key])
            s["gap_ms"] = s["mean_call_ms"] - s["mean_device_ms"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    dev = require_card()
    this = importlib.import_module(__package__.rsplit(".", 1)[0])
    other = load_port(args.other)
    sides = {"this": k2_case(this, dev, N_AGENTS),
             "other": k2_case(other, dev, N_AGENTS)}
    check_equal(sides["this"], sides["other"])
    res = compare(sides)
    print(f"K2 spill_window on '{card_line()}', {N_AGENTS} agents, "
          f"{sides['this']['n_spill']} spills; this {Path.cwd()}, other "
          f"{Path(args.other).resolve()}; outputs bitwise equal; {REPS} "
          f"calls a timed turn, {ROUNDS} rounds of turns this, other, "
          f"other, this; device time {DEVICE_ROUNDS} rounds of "
          f"{DEVICE_REPS} profiled calls:")
    for int_prio, r in res.items():
        for k, s in r.items():
            turns = ", ".join(f"{c:.4f}/{h:.1f}" for c, h in
                              zip(s["call_ms"], s["host_us"]))
            dev_ms = ", ".join(f"{d:.5f}" for d in s["device_ms"])
            print(f"  int_prio={int_prio} {k:5s}: call ms / host us a "
                  f"call: {turns}; device ms: {dev_ms}")
            print(f"  int_prio={int_prio} {k:5s}: mean call "
                  f"{s['mean_call_ms']:.5f} ms, device "
                  f"{s['mean_device_ms']:.5f} ms, call - device "
                  f"{s['gap_ms']:.5f} ms, host {s['mean_host_us']:.2f} us "
                  f"a call")
    print(json.dumps({f"int_prio_{p}": r for p, r in res.items()}))


if __name__ == "__main__":
    main()
