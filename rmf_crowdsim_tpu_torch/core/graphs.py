"""The rollout's step replayed as captured CUDA graphs.

Issued op by op, a step on the card is ~445 launches from the host, and
the device waits on them.  Every op of the step has static shapes, and
the step reads the device once, at its skin decision (``build_step``'s
``read``).  So the step is one fixed sequence before that read (``pre``:
the spawn phase and ``need``) and one of two fixed sequences after it
(``post``: the re-sort or the carried binning, then the planners, the
force pass, the finish and the rollout's record).  :class:`StepGraphs`
captures each half once as a CUDA graph and replays it: the host issues
a step as the ``pre`` replay, the read and the branch's replay.  The
kernels and their order are the eager step's, so the results are too,
bit for bit.

Buffers.  A graph reads and writes fixed addresses, so a set of graphs
keeps its own copy of the state, the skin carry, the records (``[T]``
rows, written at a step index held on the device) and that index, and
the ``post`` graph ends by copying the step's new state and skin carry
over them.  A call copies the caller's state in and returns copies of
the final state and of the records, which own their memory.  With
sources the set draws from a generator of its own, registered with the
``pre`` graph so that replays advance it as eager steps do; a call sets
it to the caller's generator's state and hands the advanced state back,
so the caller's generator ends where the eager rollout leaves it.

Capture.  Each half first runs eagerly (its warm-up, a step like any
other) and is captured on a side stream (``capture_error_mode=
"thread_local"``) the next time it runs, then replayed; each ``post``
branch is captured the second time it is taken, so a rollout that never
carries its binning never captures the carry.  Spans and counters are
off inside a capture (``utils/profiling.capturing``); the gate's device
span records external timing events into the ``pre`` graph, stored after
each replay (``profiling.replayed_span``).  Each ``csrc/`` wrapper's
``.launches`` counts what the capture launched at every replay.

Keys.  A capture bakes in addresses and Python numbers, so the set of
graphs and buffers belongs to a key: the state's device, dtype and
capacity, ``dt``, every tensor of ``params`` by address, shape, dtype and
strides and every other leaf by value, and whether the state has a
generator.  A call with another key, or with more steps than the set's
records hold, replaces the set and captures anew; a new call with the
same key does not.

Where it engages: ``build_rollout`` on CUDA states with any backend but
``custom`` (a user's ``neighbor_fn`` may read the host).  A capture that
fails, because an op of the step reads the host, leaves the set eager
until another key replaces it (``StepGraphs.failure``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..utils import profiling
from ..utils.profiling import count, span
from .state import STATE_TENSOR_FIELDS

# The fewest steps a set's records hold.
MIN_STEPS = 128

_cupti_ready = False


def _launch_counted():
    """The ``csrc/`` wrappers that count their launches (``.launches``)."""
    from ..ops import pack, spawn_gate, spill
    from ..ops import zanlungo_bucketed as zb
    from ..ops import zanlungo_dense as zd

    return (pack.pack_rows, spawn_gate.spawn_blocked, spill.spill_window,
            zb.zanlungo_forces_bucketed, zb.zanlungo_forces_bucketed_spill,
            zd.zanlungo_forces_dense)


class Graph:
    """One captured half.  Calling it replays the graph, adds what the
    capture launched to each wrapper's ``.launches`` and returns the
    half's outputs, which every replay rewrites in place."""

    def __init__(self, graph, out, launches, spans):
        self.graph = graph
        self.out = out
        self.launches = launches
        self.spans = spans

    def __call__(self):
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n
        return self.out


def capture(body, owner, generator=None) -> Graph:
    """Capture ``body()`` into a CUDA graph on a side stream of
    ``owner.device``, its memory from ``owner.pool`` (one pool a set),
    with ``generator`` registered."""
    global _cupti_ready
    if not _cupti_ready and not profiling._profiling():
        # The profiler sees a graph's kernels only if CUPTI was up before
        # the graph was captured.
        from torch.profiler._utils import _init_for_cuda_graphs

        _init_for_cuda_graphs()
        _cupti_ready = True
    fns = _launch_counted()
    before = [fn.launches for fn in fns]
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    if owner.pool is None:
        owner.pool = torch.cuda.graph_pool_handle()
    main = torch.cuda.current_stream(owner.device)
    side = torch.cuda.Stream(device=owner.device)
    side.wait_stream(main)
    try:
        with torch.cuda.stream(side), profiling.capturing() as spans:
            graph.capture_begin(pool=owner.pool,
                                capture_error_mode="thread_local")
            try:
                out = body()
            finally:
                graph.capture_end()
    finally:
        # capture_begin resets each registered generator's seed and offset
        # on the device from the side stream, behind the eager work before
        # it; a replay's own reset must land after that one.
        main.wait_stream(side)
        launched = [(fn, fn.launches - n) for fn, n in zip(fns, before)]
        for fn, n in zip(fns, before):
            fn.launches = n
    return Graph(graph, out, [(fn, n) for fn, n in launched if n], spans)


def _signature(x):
    """What a capture bakes in of ``x``: each tensor's address, shape,
    dtype and strides, every other leaf by value."""
    if isinstance(x, torch.Tensor):
        return (x.data_ptr(), tuple(x.shape), x.dtype, x.stride(), x.device)
    if dataclasses.is_dataclass(x):
        return tuple(_signature(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return x


def _map(fn, rec):
    """``fn`` over the tensors of a record (a tensor or a dataclass)."""
    if isinstance(rec, torch.Tensor):
        return fn(rec)
    return type(rec)(**{f.name: _map(fn, getattr(rec, f.name))
                        for f in dataclasses.fields(rec)})


def _zip(fn, a, b):
    """``fn(x, y)`` over the paired tensors of two records."""
    if isinstance(a, torch.Tensor):
        fn(a, b)
        return
    for f in dataclasses.fields(a):
        _zip(fn, getattr(a, f.name), getattr(b, f.name))


class _Set:
    """The buffers and graphs of one key."""

    def __init__(self, key, state, sources: bool, skin, steps: int):
        self.key = key
        self.device = state.device
        self.generator = None
        if sources and state.generator is not None:
            self.generator = torch.Generator(device=state.device)
        self.state = state.replace(
            **{f: torch.empty_like(getattr(state, f))
               for f in STATE_TENSOR_FIELDS}, generator=self.generator)
        self.skin = skin
        self.steps = steps
        self.t = torch.zeros((1,), dtype=torch.long, device=self.device)
        self.records = None
        self.pool = None
        self.graphs = {}
        self.warm = set()
        self.failed = None

    def load(self, state) -> None:
        for f in STATE_TENSOR_FIELDS:
            getattr(self.state, f).copy_(getattr(state, f))
        if self.generator is not None:
            self.generator.set_state(state.generator.get_state())
        if self.skin is not None:
            self.skin["valid"].zero_()
        self.t.zero_()

    def half(self, key, body, owner):
        """Run one half: replayed from its graph, captured first if it
        has run before, else eagerly.  Returns (outputs, graph or None)."""
        g = self.graphs.get(key)
        if g is None:
            if (key in self.warm and self.failed is None
                    and (key == "pre" or "pre" in self.graphs)):
                try:
                    g = capture(body, self,
                                self.generator if key == "pre" else None)
                except RuntimeError as e:   # the step reads the host
                    self.failed = owner.failure = e
                else:
                    self.graphs[key] = g
                    owner.captures += 1
                    count("crowdsim.graph_captures")
            if g is None:
                self.warm.add(key)
                return body(), None
        return g(), g

    def write(self, row) -> None:
        """Write one step's record at the step index and advance it."""
        if self.records is None:
            self.records = _map(
                lambda r: torch.zeros((self.steps, *r.shape), dtype=r.dtype,
                                      device=r.device), row)
        _zip(lambda buf, r: buf.index_copy_(0, self.t, r.unsqueeze(0)),
             self.records, row)
        self.t.add_(1)

    def keep(self, state, skin) -> None:
        """Copy a step's new state (and skin carry) over the buffers."""
        for f in STATE_TENSOR_FIELDS:
            getattr(self.state, f).copy_(getattr(state, f))
        if skin is not None:
            for name in ("valid", "key", "bpos", "max_occ", "n_over", "ref"):
                self.skin[name].copy_(skin[name])

    def result(self, generator, n_steps: int):
        if self.generator is not None:
            generator.set_state(self.generator.get_state())
        st = self.state.replace(
            **{f: getattr(self.state, f).clone()
               for f in STATE_TENSOR_FIELDS}, generator=generator)
        return st, _map(lambda b: b[:n_steps].clone(), self.records)


class StepGraphs:
    """The graphed rollout of one ``build_step`` step (see the module):
    ``run(params, state, dt, n_steps)`` is ``eager(...)``, bit for bit.
    ``captures`` counts the graphs captured, ``graphed_steps`` the steps
    replayed from graphs (both halves), over every call; ``failure`` is
    the last capture's error, where one failed."""

    def __init__(self, step, empty_skin, emit, eager):
        self.step = step
        self.empty_skin = empty_skin
        self.emit = emit
        self.eager = eager
        self.set = None
        self.captures = 0
        self.graphed_steps = 0
        self.failure = None

    @staticmethod
    def engages(state) -> bool:
        return state.device.type == "cuda"

    def _set(self, params, state, dt: float, n_steps: int) -> _Set:
        key = (state.device, state.position.dtype, state.capacity, dt,
               _signature(params), state.generator is None)
        s = self.set
        if s is None or s.key != key or s.steps < n_steps:
            self.set = None     # frees the old set's buffers and graphs
            skin = (self.empty_skin(state.device) if self.step.skin_mode
                    else None)
            s = self.set = _Set(key, state, params.sources is not None, skin,
                                max(MIN_STEPS,
                                    1 << (n_steps - 1).bit_length()))
        return s

    def _post(self, s: _Set, params, mid, dt: float, resort: bool) -> None:
        """The ``post`` half: the step after its read, its record, and the
        new state and skin carry copied over the set's buffers."""
        out = self.step.post(params, *mid[:3], dt, s.skin, resort)
        s.write(self.emit(out[1], out[0]))
        s.keep(out[0], out[2] if self.step.skin_mode else None)

    def run(self, params, state, dt: float, n_steps: int):
        dt = float(dt)
        if n_steps <= 0:
            return self.eager(params, state, dt, n_steps)
        s = self._set(params, state, dt, n_steps)
        if s.failed is not None:
            return self.eager(params, state, dt, n_steps)
        s.load(state)
        step = self.step
        pre = functools.partial(step.pre, params, s.state, dt, s.skin)
        for _ in range(n_steps):
            with span("crowdsim.step", new_step=True):
                mid, g_pre = s.half("pre", pre, self)
                resort = step.read(mid[3])
                _, g_post = s.half(("post", resort), functools.partial(
                    self._post, s, params, mid, dt, resort), self)
                with span("crowdsim.rollout.record"):
                    pass
                if g_pre is not None:
                    for name, events in g_pre.spans:
                        profiling.replayed_span(name, events)
            if g_pre is not None and g_post is not None:
                self.graphed_steps += 1
                count("crowdsim.graphed_steps")
        return s.result(state.generator, n_steps)
