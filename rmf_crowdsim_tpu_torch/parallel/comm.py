"""The mesh of the multi-device engines: D shards and their collectives.

Counterpart of the ``jax.sharding.Mesh`` (axis ``"world_x"`` or
``"agents"``) under which the JAX package's engines run their bodies with
``shard_map``.  PyTorch has no SPMD partitioner, so each engine writes its
body once, per shard, against :class:`Comm`: the shard's index and the
collectives the JAX bodies use (``axis_index``, ``ppermute`` to a
neighbour, ``psum``, ``pmax``), plus ``all_gather`` where XLA's
partitioner would have inserted one.  A mesh runs a body on each of its
shards with :meth:`Mesh.run`.

Two meshes:

- :class:`ThreadMesh` (:func:`make_thread_mesh`): D shards in one process,
  each body in its own Python thread, all on one device and one CUDA
  stream (each thread's current stream is the device's default stream).
  A collective is a barrier plus a device-to-device copy: each shard
  publishes a copy of what it sends before the barrier and never touches
  that copy again, so a peer may read it after the barrier while the
  sender goes on, in stream order on a card and without a host sync.  The
  published copies alternate between two tables, so a shard that runs
  ahead to the next collective cannot overwrite what a slower peer has
  yet to read.  On a card the shards take turns: one runs between two
  collectives while the others wait on a lock.  PyTorch releases the
  interpreter lock in every op, so shards that launch kernels at once
  would hand it back and forth at every launch, each handover a context
  switch (``chip_smoke.py`` phase 8c times the 1M world both ways);
  taking turns keeps one thread runnable.  On the CPU an op computes in
  its own thread, so the shards run at once there.  Every barrier has a
  timeout; a
  shard that raises aborts the barrier, so its peers raise instead of
  waiting, and :meth:`run` raises the first exception.  This is the
  counterpart of the JAX package's virtual CPU devices; the CPU tests use
  it, and one card runs D shards with it.
- :class:`ProcessGroupComm`: one shard per process over
  ``torch.distributed`` (NCCL on CUDA tensors, gloo where the caller asks
  for the CPU), for a machine with one card per rank.  ``ppermute`` is
  ``batch_isend_irecv`` over the neighbour pairs, ``psum``/``pmax`` are
  ``all_reduce``.  NCCL takes one rank per device, so D shards on one
  card run on :class:`ThreadMesh`.

A payload is a tensor or a dict of tensors; a shard that receives nothing
in a ``ppermute`` gets zeros, as ``jax.lax.ppermute`` gives.
"""

from __future__ import annotations

import datetime
import threading
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

WORLD_AXIS = "world_x"
AGENT_AXIS = "agents"

# Seconds a shard waits at a collective for its peers before it raises.
BARRIER_TIMEOUT = 120.0

Payload = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _map(fn, x: Payload) -> Payload:
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    return fn(x)


def _zeros_like(x: Payload) -> Payload:
    return _map(torch.zeros_like, x)


def neighbour_pairs(d: int, step: int) -> List[Tuple[int, int]]:
    """The (source, destination) pairs of a shift by ``step`` (+1: to the
    right neighbour, -1: to the left) over ``d`` shards, without wrap."""
    return [(j, j + step) for j in range(d) if 0 <= j + step < d]


class Comm:
    """One shard's view of its mesh: ``rank`` (the shard's index along the
    mesh axis), ``size`` (the number of shards) and the collectives.
    Every shard of the mesh calls the same collectives in the same
    order."""

    rank: int
    size: int
    device: torch.device

    def axis_index(self) -> int:
        """The shard's index along the mesh axis (``jax.lax.axis_index``),
        a Python int."""
        return self.rank

    def ppermute(self, x: Payload,
                 perm: Sequence[Tuple[int, int]]) -> Payload:
        """``jax.lax.ppermute``: shard ``src`` sends ``x`` to ``dst`` for
        each pair; a shard that is no destination gets zeros."""
        raise NotImplementedError

    def exchange(self, to_right: Payload,
                 to_left: Payload) -> Tuple[Payload, Payload]:
        """Both neighbour shifts in one collective: returns (what the left
        neighbour sent right, what the right neighbour sent left), zeros
        at the ends of the mesh."""
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``jax.lax.psum``: the sum over shards, in shard order."""
        raise NotImplementedError

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``jax.lax.pmax``: the elementwise maximum over shards."""
        raise NotImplementedError

    def all_gather(self, x: Payload) -> Payload:
        """Every shard's ``x`` concatenated along dim 0, in shard order."""
        raise NotImplementedError


class Mesh:
    """D shards along one axis.  ``local_ranks``: the shards this process
    holds (all of them for :class:`ThreadMesh`, its own rank for
    :class:`ProcessGroupComm`)."""

    size: int
    device: torch.device
    local_ranks: Sequence[int]

    def run(self, fn: Callable, *per_shard: Sequence) -> list:
        """``[fn(comm_r, a[k], b[k], ...) for the k-th local shard r]``:
        each argument sequence holds one entry per local shard."""
        raise NotImplementedError


class _NoTurn:
    """The turn of shards that run at once: taken and given back freely."""

    def acquire(self) -> bool:
        return True

    def release(self) -> None:
        pass


class _ThreadGroup:
    """The barrier, the two tables of published payloads and the turn
    (held by the one shard that runs) that the shards of one
    :meth:`ThreadMesh.run` share."""

    def __init__(self, d: int, timeout: float, turns: bool):
        self.barrier = threading.Barrier(d, timeout=timeout)
        self.tables = ([None] * d, [None] * d)
        self.turn = threading.Lock() if turns else _NoTurn()
        self.lock = threading.Lock()
        self.error = None

    def fail(self, err: BaseException) -> None:
        with self.lock:
            if self.error is None:
                self.error = err
        self.barrier.abort()


class ThreadComm(Comm):
    """A shard of a :class:`ThreadMesh` (see the module docstring)."""

    def __init__(self, group: _ThreadGroup, rank: int, size: int,
                 device: torch.device):
        self._group = group
        self._gen = 0
        self.rank = rank
        self.size = size
        self.device = device

    def _publish(self, value) -> list:
        """Publish ``value`` (copies that nobody writes again), wait for
        every peer, and return the table of all shards' values."""
        table = self._group.tables[self._gen & 1]
        self._gen += 1
        table[self.rank] = value
        self._group.turn.release()
        try:
            self._group.barrier.wait()
        finally:
            self._group.turn.acquire()
        return table

    def ppermute(self, x, perm):
        dst = {s: t for s, t in perm}
        src = {t: s for s, t in perm}
        table = self._publish(_map(torch.clone, x) if self.rank in dst
                              else None)
        if self.rank in src:
            return table[src[self.rank]]
        return _zeros_like(x)

    def exchange(self, to_right, to_left):
        r = self.rank
        table = self._publish((
            _map(torch.clone, to_right) if r + 1 < self.size else None,
            _map(torch.clone, to_left) if r > 0 else None))
        from_left = table[r - 1][0] if r > 0 else _zeros_like(to_right)
        from_right = (table[r + 1][1] if r + 1 < self.size
                      else _zeros_like(to_left))
        return from_left, from_right

    def psum(self, x):
        table = self._publish(x.clone())
        out = table[0].clone()
        for v in table[1:]:
            out = out + v
        return out

    def pmax(self, x):
        table = self._publish(x.clone())
        return torch.stack(list(table)).amax(0)

    def all_gather(self, x):
        table = list(self._publish(_map(torch.clone, x)))
        if isinstance(x, dict):
            return {k: torch.cat([t[k] for t in table]) for k in x}
        return torch.cat(table)


class ThreadMesh(Mesh):
    """D shards in one process on one device, each run in its own thread
    (see the module docstring).  ``timeout``: seconds a shard waits at a
    collective."""

    def __init__(self, d: int, device="cuda",
                 timeout: float = BARRIER_TIMEOUT):
        if d < 1:
            raise ValueError(f"a mesh needs at least one shard, got {d}")
        self.size = int(d)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.local_ranks = tuple(range(self.size))
        self.timeout = float(timeout)
        # Whether the shards take turns (see the module docstring).
        self.turns = self.device.type == "cuda"

    def run(self, fn, *per_shard):
        d = self.size
        for a in per_shard:
            if len(a) != d:
                raise ValueError(f"{len(a)} arguments for {d} shards")
        group = _ThreadGroup(d, self.timeout, self.turns)
        results = [None] * d

        def work(r: int) -> None:
            group.turn.acquire()
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                comm = ThreadComm(group, r, d, self.device)
                results[r] = fn(comm, *(a[r] for a in per_shard))
            except BaseException as err:  # handed to the caller below
                group.fail(err)
            finally:
                group.turn.release()

        threads = [threading.Thread(target=work, args=(r,),
                                    name=f"shard-{r}", daemon=True)
                   for r in range(d)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if group.error is not None:
            raise group.error
        return results


def make_thread_mesh(d: int, device="cuda",
                     timeout: float = BARRIER_TIMEOUT) -> ThreadMesh:
    """A :class:`ThreadMesh` of ``d`` shards on ``device`` (the card
    unless the caller names another device)."""
    return ThreadMesh(d, device, timeout)


class ProcessGroupComm(Comm, Mesh):
    """This process's shard of a ``torch.distributed`` process group: one
    rank per process and device.  The caller initialises the group
    (``init_process_group`` with NCCL for CUDA tensors, gloo for CPU
    ones) before and destroys it after; tensors go over it as they are,
    on ``device`` (the card unless the caller names another device)."""

    def __init__(self, device="cuda", group=None):
        import torch.distributed as dist

        self._dist = dist
        self._group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        self.local_ranks = (self.rank,)

    def run(self, fn, *per_shard):
        for a in per_shard:
            if len(a) != 1:
                raise ValueError(f"{len(a)} arguments for one local shard")
        return [fn(self, *(a[0] for a in per_shard))]

    def _p2p(self, sends, recvs) -> None:
        """Post ``sends`` [(tensor, dst)] and ``recvs`` [(tensor, src)] as
        one batch and wait for all of them."""
        dist = self._dist
        ops = [dist.P2POp(dist.isend, t.contiguous(), peer, self._group)
               for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, peer, self._group)
                for t, peer in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    @staticmethod
    def _leaves(x):
        return list(x.values()) if isinstance(x, dict) else [x]

    def ppermute(self, x, perm):
        out = _zeros_like(x)
        sends = [(t, dst) for s, dst in perm if s == self.rank
                 for t in self._leaves(x)]
        recvs = [(t, s) for s, dst in perm if dst == self.rank
                 for t in self._leaves(out)]
        self._p2p(sends, recvs)
        return out

    def exchange(self, to_right, to_left):
        r, d = self.rank, self.size
        from_left, from_right = _zeros_like(to_right), _zeros_like(to_left)
        sends, recvs = [], []
        if r + 1 < d:
            sends += [(t, r + 1) for t in self._leaves(to_right)]
            recvs += [(t, r + 1) for t in self._leaves(from_right)]
        if r > 0:
            sends += [(t, r - 1) for t in self._leaves(to_left)]
            recvs += [(t, r - 1) for t in self._leaves(from_left)]
        self._p2p(sends, recvs)
        return from_left, from_right

    def psum(self, x):
        out = x.clone()
        self._dist.all_reduce(out, self._dist.ReduceOp.SUM, self._group)
        return out

    def pmax(self, x):
        out = x.clone()
        self._dist.all_reduce(out, self._dist.ReduceOp.MAX, self._group)
        return out

    def all_gather(self, x):
        def gather(t):
            parts = [torch.empty_like(t) for _ in range(self.size)]
            self._dist.all_gather(parts, t.contiguous(), self._group)
            return torch.cat(parts)
        return _map(gather, x)


def init_process_group(backend: str, rank: int, world_size: int,
                       init_method: str,
                       timeout: float = BARRIER_TIMEOUT) -> None:
    """``torch.distributed.init_process_group`` with an explicit address
    (``tcp://localhost:<port>`` or ``file://<path>``), rank, world size
    and timeout in seconds: nothing on a machine tells a process of its
    peers."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
