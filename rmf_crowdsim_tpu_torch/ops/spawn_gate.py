"""The spawn clearance gate (G1): which sources an alive agent blocks.

A source spawns only if no alive agent of the pre-spawn state lies
strictly within ``spawn_clearance`` of it (lib.rs:212-214):
``sqrt(dx*dx + dy*dy) < clearance`` in the position dtype, the clearance
rounded to it.  The JAX package computes this in plain ``jnp`` over
[64, N] planes (core/step.py:100-125) and has no kernel for it; the
port's plain version, :func:`spawn_blocked_plain`, does the same in
PyTorch.  On a card the gate is one hand-written kernel,
``csrc/spawn_gate.cu``, that keeps every intermediate in registers.

The kernel compares the squared distance with a threshold in place of
the square root: :func:`clearance_threshold` is the least value ``t`` of
the dtype whose correctly rounded square root is not below the
clearance, so ``sqrt(d2) < c`` exactly when ``d2 < t`` (``sqrt`` rounded
to nearest is monotone).  Both versions round every other operation
alike, so their decisions are equal bit for bit.
"""

from __future__ import annotations

import functools
import math

import torch

from ..utils import cuda_build

# Sources per pass of the plain gate, as the JAX package chunks it
# (core/step.py:119): its temporaries stay [64, N].
SPAWN_CHUNK = 64


def spawn_blocked_plain(position: torch.Tensor, alive: torch.Tensor,
                        sources: torch.Tensor,
                        clearance: float) -> torch.Tensor:
    """[S] bool: an alive agent lies strictly within ``clearance`` of the
    source (lib.rs:212-214), ``sqrt(dx*dx + dy*dy) < clearance`` in the
    position dtype.  Dense over [64, N] planes per pass of 64 sources;
    dead agents are moved to infinity, where no distance passes."""
    inf = torch.full((), float("inf"), dtype=position.dtype,
                     device=position.device)
    far = torch.where(alive[:, None], position, inf)
    px, py = far[:, 0], far[:, 1]
    out = []
    for lo in range(0, sources.shape[0], SPAWN_CHUNK):
        src = sources[lo:lo + SPAWN_CHUNK]
        dx = px[None, :] - src[:, 0:1]
        dy = py[None, :] - src[:, 1:2]
        d2 = dx.mul_(dx).add_(dy.mul_(dy))
        out.append((d2.sqrt_() < clearance).any(1))
    return torch.cat(out)


@functools.lru_cache(maxsize=None)
def clearance_threshold(clearance: float, dtype: torch.dtype) -> float:
    """The least ``t`` of ``dtype`` (float32 or float64) with
    ``sqrt(t) >= c``, ``c`` the clearance rounded to ``dtype`` and the
    square root rounded to nearest in it: for every squared distance
    ``d2`` of ``dtype``, ``sqrt(d2) < c`` exactly when ``d2 < t``.  NaN
    for a NaN clearance (nothing passes either test)."""
    if math.isnan(clearance):
        return math.nan
    c = torch.tensor(clearance, dtype=dtype)
    if c <= 0:
        return 0.0
    zero = torch.zeros((), dtype=dtype)
    inf = torch.full((), math.inf, dtype=dtype)
    t = c * c
    while t > 0 and torch.sqrt(torch.nextafter(t, zero)) >= c:
        t = torch.nextafter(t, zero)
    while torch.sqrt(t) < c:
        t = torch.nextafter(t, inf)
    return float(t)


def spawn_blocked(position: torch.Tensor, alive: torch.Tensor,
                  sources: torch.Tensor, clearance: float) -> torch.Tensor:
    """[S] bool: whether an alive agent blocks each source, as
    :func:`spawn_blocked_plain` decides.

    position: [N, 2] float32 or float64; alive: [N] bool; sources: [S, 2]
    of the position dtype.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/spawn_gate.cu`` after zeroing the [S] result
    (two launches)."""
    if position.device.type == "cpu":
        return spawn_blocked_plain(position, alive, sources, clearance)
    n, s = position.shape[0], sources.shape[0]
    f = torch.float64 if position.dtype == torch.float64 else torch.float32
    cuda_build.check_tensors(
        "spawn_blocked",
        position=(position, f, (n, 2)),
        alive=(alive, torch.bool, (n,)),
        sources=(sources, f, (s, 2)),
    )
    row = 2 * position.element_size()
    if position.data_ptr() % row or sources.data_ptr() % row:
        raise ValueError(f"spawn_blocked: position and sources rows must "
                         f"start on {row}-byte boundaries")
    blocked = torch.zeros((s,), dtype=torch.uint8, device=position.device)
    cuda_build.launch("crowdsim_spawn_gate", position, alive, sources,
                      blocked, n, s, int(f == torch.float64),
                      clearance_threshold(clearance, f))
    spawn_blocked.launches += 1
    return blocked.view(torch.bool)


spawn_blocked.launches = 0
