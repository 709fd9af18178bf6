"""The launch floor of the ``csrc/`` kernels, and what a launch costs the
host.

    python -m rmf_crowdsim_tpu_torch.probes.launch

``csrc/noop.cu``'s empty kernel (``<<<1, 32>>>``) through
``utils/cuda_build.launch``: its device time (profiler) is the least any
launch takes on the card, and its host time a call, over ``CALLS`` calls,
is what the binding adds to every ``csrc/`` kernel's call.  Beside it, in
turns: the same kernel through :func:`launch_unbound`, the launch path as
it stood before the entry points were bound, kept as the yardstick; and
``torch.empty(0, device=dev)``, one of PyTorch's cheapest calls on the
card.  Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..utils import cuda_build
from ..utils.profile_step import cuda_ms, kernel_device_ms
from . import require_card

CALLS = 10_000      # host-timed calls a measurement
DEVICE_REPS = 200   # profiled calls for the device time


def noop(device: torch.device) -> None:
    """Launch the empty kernel on ``device``'s current stream."""
    cuda_build.launch("crowdsim_noop", device=device.index)
    noop.launches += 1


noop.launches = 0


def launch_unbound(name: str, *args, device=None) -> None:
    """``cuda_build.launch`` as it was before its entry points were bound:
    the library through its cache, the device from a generator over the
    arguments (or ``device``), the device guard entered on every call, a
    ``torch.cuda.Stream`` object built for its raw stream, and the entry
    point looked up on the ``CDLL``."""
    lib = cuda_build.library()
    if device is None:
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor)
             else None if a is None else int(a) for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*cargs, stream)
    if err != 0:
        msg = lib.crowdsim_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def host_us(fn, calls: int = CALLS) -> tuple:
    """(host µs a call of ``fn`` over ``calls`` calls, µs a call on CUDA
    events over the same calls), after one warm-up call.  Where the two
    agree, the launch queue was full and the host waited on the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    end.record()
    end.synchronize()
    return 1e6 * (t1 - t0) / calls, 1e3 * start.elapsed_time(end) / calls


def measure(device: torch.device) -> dict:
    """The launch floor on ``device``: host µs a call through the launcher,
    through :func:`launch_unbound` and of ``torch.empty(0)``, each the
    mean of two turns (launcher, unbound, empty, empty, unbound,
    launcher), with their CUDA-event µs; then the empty kernel's CUDA-event
    ms a call and its device ms (profiler).  ``launches``: the launcher's
    noop launches, its warm-ups included."""
    paths = {
        "launcher": lambda: noop(device),
        "unbound": lambda: launch_unbound("crowdsim_noop", device=device),
        "torch_empty": lambda: torch.empty(0, device=device),
    }
    n0 = noop.launches
    turns = {k: [] for k in paths}
    for k in (*paths, *reversed(paths)):
        turns[k].append(host_us(paths[k]))
    out = {}
    for k, runs in turns.items():
        out[f"host_us_{k}"] = sum(h for h, _ in runs) / len(runs)
        out[f"event_us_{k}"] = sum(e for _, e in runs) / len(runs)
    out["ms"] = cuda_ms(paths["launcher"], DEVICE_REPS)
    out["device_ms"] = kernel_device_ms(paths["launcher"], DEVICE_REPS,
                                        "noop_kernel")
    out["launches"] = noop.launches - n0
    return out


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    dev = require_card()
    from ..utils.profile_step import card_line

    r = measure(dev)
    print(f"launch floor on '{card_line()}', {CALLS} calls a turn:")
    for k in ("launcher", "unbound", "torch_empty"):
        print(f"  {k:12s}: {r[f'host_us_{k}']:.3f} us a call on the host, "
              f"{r[f'event_us_{k}']:.3f} us a call on CUDA events")
    print(f"  empty kernel: {r['ms']:.5f} ms a call (CUDA events), "
          f"{r['device_ms']:.5f} ms on the device (profiler)")


if __name__ == "__main__":
    main()
