"""Measurement probes: the port's counterparts of the JAX package's TPU
probes, each a hand-written CUDA kernel beside its plain version.

- :mod:`.k1_stages` (P1, P2; ``perf/kvar.py``, ``perf/kvar2.py``): K1
  cut after each of its own stages, timed stage by stage.
- :mod:`.mma_chain` (P3; ``perf/onehot_int8_probe.py``): a chained 0/1
  matrix product on the tensor cores (bf16, s8, tf32) and off them (FFMA).
- :mod:`.planes` (P4; ``perf/transpose_probe.py``): shared-memory
  transposes and the writers of the ``[slots, 16]`` feature plane.

Each runs on the card from the command line (``python -m
rmf_crowdsim_tpu_torch.probes.<name>``) and raises without one; no code
path of the simulator runs them.  On CPU tensors each wrapper runs its
plain version, as the kernel modules' wrappers do.
"""

from __future__ import annotations

import torch


def require_card() -> torch.device:
    """The first CUDA device; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the card: "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def timed(fn, reps: int, wrapper=None):
    """(mean device time of ``fn`` over ``reps`` back-to-back calls, ms;
    the last call's result; the launches ``wrapper`` counted over those
    calls and ``cuda_ms``'s warm-up call, None without one)."""
    from ..utils.profile_step import cuda_ms

    last = [None]

    def call():
        last[0] = fn()

    n0 = 0 if wrapper is None else wrapper.launches
    ms = cuda_ms(call, reps)
    return ms, last[0], None if wrapper is None else wrapper.launches - n0


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the entries finite on both sides; inf
    where a non-finite entry differs."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if bool((~fin & ~same).any()):
        return float("inf")
    return float((got[fin] - want[fin]).abs().max()) if bool(
        fin.any()) else 0.0
