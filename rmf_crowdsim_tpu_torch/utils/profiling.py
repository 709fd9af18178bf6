"""Tracing / profiling hooks.

Counterpart of ``rmf_crowdsim_tpu/utils/profiling.py``.  The reference's
only observability is debug ``println!`` in the hot path (SURVEY.md §5).
Here:

- :func:`span`: a named phase of the program (``crowdsim.*``, placed in
  ``core/step.py`` and ``core/simulation.py``).  It is on exactly while a
  ``torch.profiler`` session is active, and that is its only switch: with
  no profiler it returns one shared null context after a single check
  (``torch._C._autograd._profiler_enabled``, ~0.2 µs), so the program's
  untraced path pays nothing else.  When on, it enters
  ``torch.profiler.record_function(name)`` (the span is then an event on
  the profiler's clock, above the kernels in the Chrome trace) and keeps
  a :class:`SpanRecord` in the store: its name, the enclosing span, the
  step it belongs to and its host start and end
  (``time.perf_counter_ns``).  A span opened with ``device=True`` also
  records a pair of timing events on the current stream once CUDA is in
  use (only a span whose device interval is read asks for them: a pair
  costs ~28 µs of host under the CUDA profiler).  A span that opens a
  step (``new_step=True``) starts the next step index; the spans after
  it belong to that step until the next one opens.
- :func:`count`: a named counter, on under the same switch, in the same
  store.
- :func:`capturing`: while a CUDA graph is captured (``core/graphs.py``)
  spans and counters are off, since the captured ops run at each replay
  and not now; a span opened with ``device=True`` then records external
  timing events into the graph instead, and :func:`replayed_span` stores
  their interval after each replay as that span (no host interval).
- :func:`records`, :func:`counters`, :func:`reset`: read and clear the
  store.  The store fills while any profiler session runs and is
  cleared only by :func:`reset` and at the start of :func:`trace`: a
  caller that profiles with ``torch.profiler`` itself reads the store
  after its block and then calls :func:`reset`.  It holds at most
  ``MAX_RECORDS`` spans; a span past that is still a profiler event but
  is not stored, and is counted under ``DROPPED``.  Nothing is read from
  the device while the program runs: :func:`records` turns the event
  pairs into device ms when it is called, after the profiled block's
  closing synchronize.  A span and a counter add no kernel launch and no
  host read, on or off.
- :class:`StepTimer`: host-side wall-clock stats over step calls,
  steps/sec and p50/p95/max.  PyTorch returns before the card finishes,
  so a timed step passes a tensor of the state (``sync_leaf``), and
  :meth:`StepTimer.sync` waits for the card before the clock stops.
- :func:`trace`: a ``torch.profiler`` session around a block of steps,
  written to ``log_dir`` as a Chrome trace (``chrome://tracing``,
  Perfetto); the store is cleared as it starts and holds the block's
  spans after it.

``utils/profile_step.py`` (the per-kernel profile of the bench rollout)
stays beside this module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"
# The most spans the store holds (a 120-step rollout stores ~1,200), and
# the counter of those past it.
MAX_RECORDS = 1 << 16
DROPPED = "crowdsim.spans_dropped"


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
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class SpanRecord:
    """One span.  ``parent`` is the index (in :func:`records`) of the
    span that enclosed it, -1 at the top; ``step`` the index of the step
    it belongs to, -1 before the first; ``t1_ns`` 0 while it is open;
    ``device_ms`` the interval between its two timing events on the
    device, None where it recorded none (not opened with ``device=True``,
    or without CUDA)."""

    name: str
    parent: int
    step: int
    t0_ns: int
    t1_ns: int = 0
    device_ms: Optional[float] = None
    # The (start, end) timing events until :func:`records` reads them.
    events: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6


class _Store:
    """What the spans and counters of this process recorded, and the
    indices of the spans open now."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.counters: Dict[str, int] = {}
        self.step = -1
        self.open: List[int] = []


_store = _Store()


class _Span:
    __slots__ = ("name", "new_step", "device", "rec", "fn")

    def __init__(self, name: str, new_step: bool, device: bool):
        self.name = name
        self.new_step = new_step
        self.device = device

    def __enter__(self):
        st = _store
        if self.new_step:
            st.step += 1
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.rec = None
        if len(st.records) >= MAX_RECORDS:
            st.counters[DROPPED] = st.counters.get(DROPPED, 0) + 1
            return self
        events = None
        if self.device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self.rec = SpanRecord(self.name, st.open[-1] if st.open else -1,
                              st.step, time.perf_counter_ns(), events=events)
        st.open.append(len(st.records))
        st.records.append(self.rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            rec.t1_ns = time.perf_counter_ns()
            if _store.open:
                _store.open.pop()
            if rec.events is not None:
                rec.events[1].record()
        self.fn.__exit__(*exc)
        return False


class _CapturedSpan:
    """A device span inside a CUDA graph capture: a pair of external
    timing events, which the graph records at each replay."""

    __slots__ = ("events",)

    def __init__(self, name: str):
        self.events = (torch.cuda.Event(enable_timing=True, external=True),
                       torch.cuda.Event(enable_timing=True, external=True))
        _captured.append((name, self.events))

    def __enter__(self):
        self.events[0].record()
        return self

    def __exit__(self, *exc):
        self.events[1].record()
        return False


# The device spans of the capture in progress; None outside a capture.
_captured: Optional[list] = None


@contextlib.contextmanager
def capturing():
    """Spans and counters off for a CUDA graph capture; yields the list of
    (name, (start, end) events) of the device spans the graph records."""
    global _captured
    outer, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = outer


def span(name: str, new_step: bool = False, device: bool = False):
    """A named span of the program, recorded while a ``torch.profiler``
    session is active; otherwise a shared null context.  ``new_step``:
    the span opens the next step index; ``device``: it also records its
    interval on the device (CUDA events)."""
    if _captured is not None:
        return _CapturedSpan(name) if device else _NULL
    if not _profiling():
        return _NULL
    return _Span(name, new_step, device)


def replayed_span(name: str, events: tuple) -> None:
    """Store a device span of a replayed CUDA graph, while a
    ``torch.profiler`` session is active: its device ms from the graph's
    timing events (waiting for the end one), no host interval, in the
    open span and step."""
    if not _profiling():
        return
    st = _store
    if len(st.records) >= MAX_RECORDS:
        st.counters[DROPPED] = st.counters.get(DROPPED, 0) + 1
        return
    events[1].synchronize()
    t = time.perf_counter_ns()
    st.records.append(SpanRecord(name, st.open[-1] if st.open else -1,
                                 st.step, t, t,
                                 device_ms=events[0].elapsed_time(events[1])))


def count(name: str, n=1) -> None:
    """Add ``n`` (a host number) to the counter ``name`` while a
    ``torch.profiler`` session is active (never inside a capture)."""
    if _captured is None and _profiling():
        _store.counters[name] = _store.counters.get(name, 0) + int(n)


def records() -> List[SpanRecord]:
    """Every span in the order it opened, each closed span's event pair
    turned into device ms (waiting for the device where it has not
    reached the span's end)."""
    for r in _store.records:
        if r.events is not None and r.t1_ns:
            r.events[1].synchronize()
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return list(_store.records)


def counters() -> Dict[str, int]:
    return dict(_store.counters)


def reset() -> None:
    """Clear the store: spans, counters and the step index."""
    global _store
    _store = _Store()
