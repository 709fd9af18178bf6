"""Helpers of the port's multi-device tests (no JAX here: spawned worker
processes import this module).

- ``exercise(comm)``: every collective of a ``Comm`` once, on data made
  from the shard's rank, and ``expected(r, d)``: what shard ``r`` of ``d``
  must get back.
- ``world_scene``: the port's copy of tests/test_worldstep.py:34-76
  (sources on the left, sinks on the right, agents crossing every region
  boundary).
- ``run_process_group``: ``fn(comm, *args)`` on ``d`` gloo processes with
  a ``FileStore`` under a given directory, each process's result back as
  numpy.
"""

from __future__ import annotations

import multiprocessing
import queue as queue_mod
import time

import numpy as np
import torch

from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.parallel.comm import (
    ProcessGroupComm,
    init_process_group,
    neighbour_pairs,
)
from rmf_crowdsim_tpu_torch.parallel.worldstep import (
    build_world_rollout,
    shard_state_by_region,
)

PROCESS_TIMEOUT = 120.0


def exercise(comm) -> dict:
    """Each collective once; numpy results."""
    r, d = comm.axis_index(), comm.size
    x = torch.arange(4, dtype=torch.float32) + 10.0 * r
    right = comm.ppermute(x, neighbour_pairs(d, +1))
    left = comm.ppermute({"a": x, "b": x.to(torch.int32)},
                         neighbour_pairs(d, -1))
    from_left, from_right = comm.exchange(x, -x)
    s = comm.psum(torch.tensor([r + 1], dtype=torch.int32))
    mx = comm.pmax(torch.tensor([1.5 * r, -float(r)]))
    g = comm.all_gather(torch.full((2,), r, dtype=torch.int32))
    return {k: v.numpy() for k, v in dict(
        rank=torch.tensor(r), right=right, left_a=left["a"],
        left_b=left["b"], from_left=from_left, from_right=from_right,
        psum=s, pmax=mx, gather=g).items()}


def expected(r: int, d: int) -> dict:
    def x(k):
        return np.arange(4, dtype=np.float32) + 10.0 * k
    zero = np.zeros(4, np.float32)
    return dict(
        rank=np.asarray(r),
        right=x(r - 1) if r > 0 else zero,
        left_a=x(r + 1) if r < d - 1 else zero,
        left_b=(x(r + 1) if r < d - 1 else zero).astype(np.int32),
        from_left=x(r - 1) if r > 0 else zero,
        from_right=-x(r + 1) if r < d - 1 else zero,
        psum=np.asarray([d * (d + 1) // 2], np.int32),
        pmax=np.asarray([1.5 * (d - 1), 0.0], np.float32),
        gather=np.repeat(np.arange(d, dtype=np.int32), 2))


def world_scene(capacity=128, dual_row=False, invariance="bitwise",
                tile=0.0, spill=0):
    """tests/test_worldstep.py:34-76 in the port, on the CPU: (config,
    hl, lp, params, state)."""
    return scenes.crossing_scene(capacity, dual_row, invariance, tile,
                                 spill, device="cpu")


def world_rollout_shard(comm, n_steps: int) -> dict:
    """The world scene's rollout on this process's shard: its state's
    per-agent fields and the counters, as numpy."""
    cfg, hl, lp, params, st = world_scene()
    shards = shard_state_by_region(cfg, comm, st)
    shards, c = build_world_rollout(cfg, [hl], [lp], comm)(
        params, shards, 1.0, n_steps)
    st = shards[0]
    out = {k: getattr(st, k).numpy() for k in ("position", "velocity",
                                               "alive", "uid")}
    out.update({f"c_{k}": v.numpy() for k, v in vars(c).items()})
    return out


def _worker(rank, d, store, fn, args, results):
    torch.set_num_threads(1)
    init_process_group("gloo", rank, d, f"file://{store}")
    try:
        results.put((rank, fn(ProcessGroupComm(device="cpu"), *args)))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def run_process_group(d: int, tmp_dir, fn, *args) -> list:
    """``fn(comm, *args)`` on ``d`` gloo processes (spawned); returns
    their results in rank order.  Raises if a process fails or any of
    them outlasts ``PROCESS_TIMEOUT``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = f"{tmp_dir}/store"
    procs = [ctx.Process(target=_worker,
                         args=(r, d, store, fn, args, results))
             for r in range(d)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + PROCESS_TIMEOUT
    try:
        while len(got) < d:
            try:
                r, v = results.get(timeout=1.0)
                got[r] = v
            except queue_mod.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise AssertionError(f"process exit codes {codes}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"{d - len(got)} of {d} processes "
                                         f"returned nothing in "
                                         f"{PROCESS_TIMEOUT} s") from None
    finally:
        for p in procs:
            p.join(timeout=PROCESS_TIMEOUT)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"process exit codes {codes}")
    return [got[r] for r in range(d)]
