"""Where a step of the port's bench rollout spends its time, on one GPU.

    python -m rmf_crowdsim_tpu_torch.utils.profile_step --n 1000000 100000
    python -m rmf_crowdsim_tpu_torch.utils.profile_step --backend grid_dense
    python -m rmf_crowdsim_tpu_torch.utils.profile_step --fused-spills

For each agent count: the bench scene (``scenes.build_bench``, on
``--backend``, with ``--fused-spills`` setting that SimConfig field) runs a
warm-up, then ``--steps`` steps timed on the host clock around
``torch.cuda.synchronize()``; after all timings, each count runs the
same number of steps under ``torch.profiler``.  Printed per count:
ms/step and steps/s (unprofiled), the device's busy time per step and its
idle share (kernel time over the unprofiled wall time), kernel launches
per step, and the kernels that take the most device time.  Needs a CUDA
device; raises without one.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time

import torch

from .. import scenes

DT = 1.0 / 60.0
PROFILE_TRIES = 3   # profiler sessions kernel_device_ms takes at most


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _bench(n: int, **scene):
    """The bench scene at ``n`` on the card, after a 3-step warm-up;
    ``scene``: ``backend`` and ``fused_spills`` for ``build_bench``."""
    rollout, params, st = scenes.build_bench(n, device=torch.device("cuda"),
                                             **scene)
    st, _ = rollout(params, st, DT, 3)
    torch.cuda.synchronize()
    return rollout, params, st


def time_steps(n: int, steps: int, **scene) -> dict:
    """ms/step on the host clock around synchronized steps, no profiler."""
    rollout, params, st = _bench(n, **scene)
    t0 = time.perf_counter()
    st, counters = rollout(params, st, DT, steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    return dict(wall_ms=wall_ms, steps_per_s=1e3 / wall_ms,
                truncated=int(counters.neighbor_truncated.max()))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_in_turns(a, b, reps: int, rounds: int = 1) -> tuple:
    """(ms a call of ``a``, of ``b``) on CUDA events, from ``rounds``
    rounds of turns a, b, b, a of ``reps`` calls each, averaged: both
    sides see the same drift of a shared host."""
    ms_a = ms_b = 0.0
    for _ in range(rounds):
        ms_a += cuda_ms(a, reps)
        ms_b += cuda_ms(b, reps) + cuda_ms(b, reps)
        ms_a += cuda_ms(a, reps)
    return ms_a / (2 * rounds), ms_b / (2 * rounds)


def kernel_device_ms(fn, reps: int, kernel: str) -> float:
    """Device time a call of ``fn`` of the one kernel whose name holds
    ``kernel`` ('': any) and which each call launches once, over ``reps``
    calls under ``torch.profiler`` (after one warm-up call): its own time
    where a launch is shorter than the host time of the call that makes
    it.  The profiler on the H100 loses a session's first launch at
    times, and now and then most or all of them, so the mean is taken
    over the launches it recorded, and a session that recorded fewer
    than half of them is taken again, up to ``PROFILE_TRIES`` sessions in
    all; raises if none did.  Raises as well if the calls launch more
    than one kernel so named, or one more than once a call: a mean over
    launches is then no time a call."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    for _ in range(PROFILE_TRIES):
        top = device_kernels(run, reps, top=1 << 30)["top"]
        hits = [(ms, n, name) for ms, n, name in top if kernel in name]
        if len(hits) > 1 or (hits and hits[0][1] > 1):
            raise AssertionError(
                f"{reps} calls launched more than one kernel named "
                f"{kernel!r} a call: {[(n, name) for _, n, name in hits]}")
        if hits and 2 * hits[0][1] >= 1:
            return hits[0][0] / hits[0][1]
    raise AssertionError(f"{PROFILE_TRIES} profiles recorded fewer than "
                         f"half of the {reps} launches of {kernel!r}")


def device_kernels(run, steps: int, top: int = 15) -> dict:
    """Calls ``run()`` (``steps`` steps, ending in a synchronize) under
    ``torch.profiler``: device time and kernel launches per step, and the
    ``top`` kernels by device time (ms/step, launches/step, name)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    return dict(
        device_busy_ms=sum(v[1] for v in by_name.values()) / steps,
        launches_per_step=len(kernels) / steps,
        top=sorted(((v[1] / steps, v[0] / steps, k)
                    for k, v in by_name.items()), reverse=True)[:top],
    )


def profile(n: int, steps: int, top: int, **scene) -> dict:
    """Device time per step by kernel, from ``torch.profiler``."""
    rollout, params, st = _bench(n, **scene)

    def run():
        rollout(params, st, DT, steps)
        torch.cuda.synchronize()

    return device_kernels(run, steps, top)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1_000_000])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--backend", default="grid_pallas",
                    choices=("grid_pallas", "grid_dense"))
    ap.add_argument("--fused-spills", action="store_true",
                    help="SimConfig.fused_spills (grid_pallas: kernel K1b)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    scene = dict(backend=args.backend, fused_spills=args.fused_spills)
    print(f"card: {card_line()}; {scene}")
    # Every timing runs before the first profiler session: the profiler's
    # tracing can stay attached and slow later launches.
    timed = {n: time_steps(n, args.steps, **scene) for n in args.n}
    for n in args.n:
        r = {**timed[n], **profile(n, args.steps, args.top, **scene)}
        print(f"n={n}: {r['wall_ms']:.3f} ms/step = {r['steps_per_s']:.2f} "
              f"steps/s; device busy {r['device_busy_ms']:.3f} ms/step, "
              f"idle share {1 - r['device_busy_ms'] / r['wall_ms']:.3f}; "
              f"{r['launches_per_step']:.1f} kernel launches/step; "
              f"truncated {r['truncated']}")
        for ms, count, name in r["top"]:
            print(f"  {ms:8.4f} ms/step  {count:6.1f}/step  {name[:100]}")


if __name__ == "__main__":
    main()
