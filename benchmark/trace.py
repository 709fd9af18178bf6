"""The traced window: a ``torch.profiler`` session (host and device) over
one unit of work, reduced to what the per-layer metrics read.

Times come from the profiler's own clock.  The traced window is the
benchmark's ``bench.window`` span; the device is busy where a kernel, a
copy or a set runs (the union of their intervals); a launch is a
``cudaLaunchKernel`` call on the host (or its driver form).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List

import numpy as np
import torch

WINDOW_SPAN = "bench.window"
# The program's own CUDA kernels (csrc/): K1/K1b, K2, K3, K4.
CSRC_KERNELS = ("zanlungo_bucketed_kernel", "spill_window_kernel",
                "pack_inverse_kernel", "pack_slots_kernel",
                "zanlungo_dense_kernel")
K1_KERNEL = "zanlungo_bucketed_kernel"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    launches: int
    device_ops: int
    ops: List[tuple]        # (name, seconds, kind) of every device op
    gaps: List[tuple]       # (host activity, seconds) of the longest gaps

    def seconds(self, pred) -> float:
        return sum(s for name, s, _ in self.ops if pred(name))

    def top_ops(self):
        by = collections.defaultdict(float)
        for name, s, _ in self.ops:
            by[name[:120]] += s
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]

    def top_gaps(self):
        by = collections.defaultdict(float)
        for name, s in self.gaps:
            by[name[:120]] += s
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]


def profile(run):
    """Run ``run()`` (returns the steps it took) inside the window span
    under the profiler; returns (profiler, steps)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            steps = run()
            sync()
    return prof, steps


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted, merged [k, 2] intervals."""
    if intervals.shape[0] == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [iv[0].tolist()]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def _kind(e) -> str:
    """'kernel', 'gpu_memcpy', 'gpu_memset', 'launch' or 'host'."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "launch" if name in LAUNCH_CALLS else "host"


def reduce(prof, steps: int, label_gaps: int = 2000) -> Trace:
    events = prof.profiler.kineto_results.events()
    win = None
    host, dev, launches = [], [], 0
    for e in events:
        kind = _kind(e)
        name = e.name()
        if kind in DEVICE_KINDS:
            dev.append((e.start_ns(), e.end_ns(), name, kind))
            continue
        launches += kind == "launch"
        if name == WINDOW_SPAN:
            win = (e.start_ns(), e.end_ns())
        else:
            host.append((e.start_ns(), e.end_ns(), name))
    if win is None:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = win
    # The profiler mirrors host annotations onto the device's timeline;
    # those are spans, not device work.
    names = {h[2] for h in host} | {WINDOW_SPAN}
    dev = [d for d in dev if d[1] > w0 and d[0] < w1 and d[2] not in names]
    iv = np.asarray([(max(a, w0), min(b, w1)) for a, b, _, _ in dev],
                    np.int64).reshape(-1, 2)
    merged = _union(iv)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-9
    ops = [(name, (b - a) * 1e-9, kind) for a, b, name, kind in dev]
    # Idle gaps inside the window, labelled by the innermost host activity
    # at the gap's start.
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    gap_len = edges[:, 1] - edges[:, 0]
    longest = np.argsort(-gap_len)[:label_gaps]
    hs = np.asarray([h[0] for h in host], np.int64)
    he = np.asarray([h[1] for h in host], np.int64)
    gaps = []
    for g in longest:
        if gap_len[g] <= 0:
            continue
        t = edges[g, 0]
        inside = np.nonzero((hs <= t) & (he > t))[0]
        label = host[inside[np.argmax(hs[inside])]][2] if inside.size else \
            "(no host op)"
        gaps.append((label, float(gap_len[g]) * 1e-9))
    return Trace(steps=int(steps), window_s=(w1 - w0) * 1e-9, busy_s=busy,
                 launches=int(launches), device_ops=len(dev), ops=ops,
                 gaps=gaps)


def is_csrc(name: str) -> bool:
    return any(k in name for k in CSRC_KERNELS)
