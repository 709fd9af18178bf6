"""Tracing / profiling hooks.

Counterpart of ``rmf_crowdsim_tpu/utils/profiling.py``.  The reference's
only observability is debug ``println!`` in the hot path (SURVEY.md §5).
Here:

- :class:`StepTimer`: host-side wall-clock stats over step calls,
  steps/sec and p50/p95/max.  PyTorch returns before the card finishes,
  so a timed step passes a tensor of the state (``sync_leaf``), and
  :meth:`StepTimer.sync` waits for the card before the clock stops.
- :func:`trace`: a ``torch.profiler`` session around a block of steps,
  written to ``log_dir`` as a Chrome trace (``chrome://tracing``,
  Perfetto).
- :func:`annotate`: a named region inside a trace
  (``torch.profiler.record_function``).

``utils/profile_step.py`` (the per-kernel profile of the bench rollout)
stays beside this module.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


class StepTimer:
    def __init__(self):
        self._times: List[float] = []

    @staticmethod
    def sync(leaf: torch.Tensor) -> None:
        """A true barrier: wait until the card has finished all work
        queued on ``leaf``'s device (a CPU tensor is ready already)."""
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)

    @contextlib.contextmanager
    def step(self, sync_leaf: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        yield
        if sync_leaf is not None:
            self.sync(sync_leaf)
        self._times.append(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self._times.append(seconds)

    @property
    def count(self) -> int:
        return len(self._times)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        t = np.asarray(self._times)
        return {
            "steps": int(t.size),
            "steps_per_sec": float(t.size / t.sum()),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "max_ms": float(t.max() * 1e3),
            "total_s": float(t.sum()),
        }

    def reset(self) -> None:
        self._times.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (the host, and the card when there is
    one) and write it to ``log_dir/trace.json`` as a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
