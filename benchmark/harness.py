"""One run of one cell: set-up, the measured window, the traced unit, the
check, and the result line.

The run refuses to measure without a card.  It prints, on standard
output, the window's steadiness counters on one line and the result as
the last line; on standard error, the numbers that decide ``correct``,
each beside its limit, as its last lines.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time
import types

import numpy as np
import torch

from . import drivers, scene, trace as tr, yardstick

ROOT = os.path.dirname(scene.HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rmf_crowdsim_tpu")


class NoCard(RuntimeError):
    pass


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def limits(workload: str) -> dict:
    with open(os.path.join(scene.HERE, "limits", workload + ".json")) as f:
        return json.load(f)["limits"]


def cell(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"unknown workload {workload!r}")


def metrics_of(man: dict, workload: str, key: str) -> list:
    return [m for m in man[key]
            if "workloads" not in m or workload in m["workloads"]]


def require_card(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures only on a card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"needs {chips}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(cfg: dict, traffic: dict, seed: int, seconds: float,
            trace: bool, device="cuda", t_start: float | None = None) -> dict:
    """Set up, warm up, measure, trace, check.  Returns the run's record
    (everything the result line and the readers need)."""
    t_start = time.perf_counter() if t_start is None else t_start
    driver = drivers.make(cfg, traffic, seed, device, trace)
    driver.warm_up()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    steps = agent_steps = units = 0
    ends = []
    w0 = time.perf_counter()
    while True:
        s, a = driver.unit()
        steps += s
        agent_steps += a
        units += 1
        ends.append((time.perf_counter(), agent_steps))
        if (time.perf_counter() - w0 >= seconds
                and units >= driver.min_units):
            break
    _sync(device)
    window_s = time.perf_counter() - w0
    counters = driver.counters()
    step_times = list(getattr(driver, "times", []))
    listener = getattr(driver, "listener", None)
    listener_s = listener.busy_s if (listener is not None and trace) else None

    traced = None
    if trace:
        n = int(traffic.get("trace_units", 1))

        def run():
            return sum(driver.traced_unit()[0] for _ in range(n))

        prof, t_steps = tr.profile(run)
        traced = tr.reduce(prof, t_steps)
        del prof
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)

    check = driver.check(seed)
    spills = []
    k1_ms = []
    geo = yardstick.TileGeometry.of_config(cfg["sim"])
    for st in driver.k1_states():
        slot, n_live = yardstick.k1_inputs(
            geo, st["position"], st["velocity"], st["eyesight"], st["alive"])
        spills.append(int(st["alive"].sum()) - n_live)
        if trace:
            work = yardstick.k1_work(geo, st["position"], st["velocity"],
                                     st["eyesight"], st["alive"],
                                     cfg["zanlungo"]["agent_radius"])
            k1_ms.append(yardstick.bound_ms(
                yardstick.k1_bytes(geo, n_live),
                work.ops(cfg["sim"]["integer_priorities"])))
    return dict(setup_s=setup_s, window_s=window_s, steps=steps,
                pace=_pace(w0, ends),
                units=units, agent_steps=agent_steps, counters=counters,
                step_times=step_times, listener_s=listener_s,
                trace=traced, memory_peak_bytes=peak, check=check,
                spills=spills, k1_bound_ms=(float(np.mean(k1_ms))
                                            if k1_ms else None),
                k1_bounds_ms=k1_ms,
                driver=driver)


def _pace(w0: float, ends: list) -> dict:
    """How steady the window ran: its units' durations (ms; quartiles and
    extremes) and the agent-steps a second of each quarter of it."""
    t = np.asarray([w0] + [e[0] for e in ends])
    a = np.asarray([0] + [e[1] for e in ends], np.float64)
    unit_ms = np.diff(t) * 1e3
    quarters = []
    for q in range(4):
        lo, hi = np.searchsorted(t, w0 + (t[-1] - w0) * np.array([q, q + 1]) / 4)
        hi = min(hi, t.shape[0] - 1)
        if hi > lo:
            quarters.append(float((a[hi] - a[lo]) / (t[hi] - t[lo])))
    return {"unit_ms": np.percentile(unit_ms, [0, 25, 50, 75, 100]).tolist(),
            "rate_by_quarter": quarters}


def numbers(check: dict) -> dict:
    """The compared numbers of a run, by name."""
    v = check["verdict"]
    out = {"agents_off": v.agents_off, "events_off": v.events_off}
    for k in ("routes_off", "events_lost", "replay_off"):
        if k in check:
            out[k] = check[k]
    return out


def result(man: dict, workload: str, rec: dict, trace: bool, lim: dict,
           device="cuda") -> dict:
    got = numbers(rec["check"])
    nums = {k: got[k] for k in lim}
    checks = {k: {"value": v, "limit": lim[k]} for k, v in nums.items()}
    correct = all(v <= lim[k] for k, v in nums.items())
    v = rec["check"]["verdict"]
    metrics = {}
    if trace:
        ctx = types.SimpleNamespace(
            trace=rec["trace"], step_times=rec["step_times"],
            listener_s=rec["listener_s"], window_steps=rec["steps"],
            k1_bound_ms=rec["k1_bound_ms"],
            memory_peak_bytes=rec["memory_peak_bytes"])
        for m in metrics_of(man, workload, "per_layer"):
            mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
            value = mod.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = {"agent_steps_per_s": rec["agent_steps"] / rec["window_s"],
               "setup_s": rec["setup_s"]}
        if rec["step_times"]:
            e2e["step_ms_p95"] = yardstick.step_percentiles(
                rec["step_times"])["p95_ms"]
        for m in metrics_of(man, workload, "end_to_end"):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    dev = torch.device(device)
    out = {"correct": bool(correct), "attempted": int(v.compared),
           "failed": int(sum(nums.values())), "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(0)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1,
                      "memory_peak_bytes": int(rec["memory_peak_bytes"])}}
    if trace and rec["trace"] is not None:
        t = rec["trace"]
        out["device"]["busy_s"] = t.busy_s
        out["device"]["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.top_ops(),
                            "idle_gaps": t.top_gaps()}
    out["checks"] = checks
    return out


def window_line(rec: dict) -> dict:
    line = {"window_s": rec["window_s"], "steps": rec["steps"],
            "units": rec["units"], "agent_steps": rec["agent_steps"],
            "setup_s": rec["setup_s"], "pace": rec["pace"],
            "counters": rec["counters"],
            "spills_at_checked_steps": rec["spills"],
            "checked_steps": rec["check"]["steps"]}
    if rec["k1_bounds_ms"]:
        line["k1_bound_ms_at_checked_steps"] = rec["k1_bounds_ms"]
    if "route_ratio_max" in rec["check"]:
        line["route_ratio_max"] = rec["check"]["route_ratio_max"]
    v = rec["check"]["verdict"]
    line["ties"] = v.ties
    line["worst_velocity_gap"] = v.worst_vel
    line["off_uids"] = v.off_uids
    t = rec["trace"]
    if t is not None:
        line["trace"] = {"steps": t.steps, "launches": t.launches,
                         "device_ops": t.device_ops,
                         "kernels": sum(1 for _, _, k in t.ops
                                        if k == "kernel"),
                         "busy_s": t.busy_s, "window_s": t.window_s}
    return line


def main(argv=None, t_start=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    man = manifest()
    w = cell(man, args.workload)
    try:
        require_card(int(w["chips"]))
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    cfg = scene.load("configs", w["config"])
    traffic = scene.load("traffic", w["traffic"])
    lim = limits(args.workload)
    # One process with one intra-op thread: the host's work is launches
    # and Python, and idle pool threads only take cores from them.
    torch.set_num_threads(1)
    rec = measure(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                  "cuda", t_start=t_start)
    out = result(man, args.workload, rec, bool(args.trace), lim)
    print(json.dumps(window_line(rec)), flush=True)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
