"""P4: shared-memory transposes, and writing the ``[slots, 16]`` feature
plane.

    python -m rmf_crowdsim_tpu_torch.probes.planes

Counterpart of the TPU probe ``perf/transpose_probe.py``: its in-kernel
``[8, 128] -> [128, 8]`` and ``[8, 64] -> [64, 8]`` transposes
(``probe_kernel_transpose``), and the refresh of K columns of a row-major
``[slots, 16]`` plane from K ``[slots]`` vectors against its rebuild by a
stack (``probe_column_updates``: ``upd8``, ``upd4``, ``rebuild``,
``rows4_T``), each value times 1.0000001 as there.  The kernels are
``csrc/plane_probe.cu``.  The writers run at the 1M bucketed plane's
1,835,520 slots (the TPU probe's) and at the dense path's 2,019,072
padded rows, whose ``[N, 16]`` stack ``dense_prep`` writes every step.
Printed for each: the CUDA-event time, its bound
(``utils/roofline.plane_bytes``; for ``columns x4`` also against the
32-byte sectors its layout forces, ``plane_sector_bytes``), the plain
version's time and, where one ``torch`` call does the same, that call's.
A transpose's call is host time, so the transposes are timed in
``TRANSPOSE_ROUNDS`` rounds of turns (kernel, library call, library call,
kernel), ``TRANSPOSE_REPS`` calls a turn.  Each time a call is printed
beside the kernel's device time (profiler).  Every kernel is first held
bitwise against its plain version.  Needs a CUDA device; raises without
one.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from ..utils import cuda_build
from ..utils import roofline as rl
from ..utils.profile_step import (cuda_ms, cuda_ms_in_turns,
                                  kernel_device_ms)
from . import max_abs_err, require_card, timed

SCALE = 1.0000001
PLANE_F = 16
SLOTS = {"bucketed": 1_835_520, "dense": 2_019_072}
TRANSPOSES = ((8, 128), (8, 64))   # (rows, columns) of the source block
# Checked, not timed: another transpose shape (the runtime-shape kernel),
# a slot count that ends in a part of a 128-slot chunk (the float4
# writers' ragged edge) and one that is no multiple of 4 (the per-slot
# writers).
OTHER_TRANSPOSE = (16, 48, 40)     # rows, ld, columns
OTHER_SLOTS = (3000, 1001)
REPS = 20                          # timed calls a writer row
TRANSPOSE_REPS = 250               # timed calls a transpose turn
TRANSPOSE_ROUNDS = 4               # rounds of turns kernel, library,
                                   # library, kernel


def _vectors(cols, k: int, slots: int, caller: str):
    if len(cols) != k:
        raise ValueError(f"{caller}: {k} vectors needed, got {len(cols)}")
    shape = (slots,)
    for c in cols:
        if c.shape != shape or c.dtype != torch.float32:
            raise ValueError(f"{caller}: each vector must be [{slots}] "
                             f"float32, got {tuple(c.shape)} {c.dtype}")


def transpose_plain(x: torch.Tensor, cols: int) -> torch.Tensor:
    """The plain version of :func:`transpose`: the block copied out
    element by element."""
    y = torch.empty((cols, x.shape[0]), dtype=x.dtype, device=x.device)
    y.copy_(x[:, :cols].t())
    return y


def transpose(x: torch.Tensor, cols: int) -> torch.Tensor:
    """The first ``cols`` columns of ``x`` [R, ld] f32, transposed: [cols,
    R].  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/plane_probe.cu`` (one block, through shared memory)."""
    shape = x.shape
    if len(shape) != 2 or x.dtype != torch.float32 or not (
            1 <= cols <= shape[1]) or shape[0] * (cols + 1) > 12288:
        raise ValueError(f"transpose: x [R, ld] float32 with 1 <= cols <= "
                         f"ld and R (cols + 1) <= 12288 needed, got "
                         f"{tuple(shape)} {x.dtype}, cols {cols}")
    if x.is_cpu:
        return transpose_plain(x, cols)
    if not (x.is_cuda and x.is_contiguous()):
        # dtype and shape hold already: this raises with check_tensors'
        # message for the layout or the device.
        cuda_build.check_tensors("transpose", x=(x, torch.float32, shape))
    y = x.new_empty((cols, shape[0]))
    cuda_build.launch("crowdsim_transpose", x, y, shape[0], cols, shape[1])
    transpose.launches += 1
    return y


transpose.launches = 0


_COLS = tuple(f"c{j}" for j in range(8))


def _launch_writer(dst, cols, mode: int):
    specs = {"dst": (dst, torch.float32, dst.shape)}
    for name, c in zip(_COLS, cols):
        specs[name] = (c, torch.float32, c.shape)
    cuda_build.check_tensors("plane writer", **specs)
    cuda_build.launch("crowdsim_plane_write", dst, *cols,
                      *(None,) * (8 - len(cols)), cols[0].shape[0],
                      len(cols), mode)


def columns_plain(plane, cols):
    """The plain version of :func:`write_columns`."""
    for j, c in enumerate(cols):
        plane[:, j] = c * SCALE
    return plane


def rebuild_plain(cols):
    """The plain version of :func:`rebuild`: a stack of the scaled
    vectors, twice."""
    cs = [c * SCALE for c in cols]
    return torch.stack(cs + cs, -1)


def rows_plain(t, cols):
    """The plain version of :func:`write_rows`."""
    for j, c in enumerate(cols):
        t[j] = c * SCALE
    return t


def write_columns(plane: torch.Tensor, cols) -> torch.Tensor:
    """``plane[:, j] = cols[j] * 1.0000001`` for j < K (K = 4 or 8), in
    place, on a row-major ``[slots, 16]`` f32 plane (the TPU probe's
    ``upd8``/``upd4``).  Returns ``plane``."""
    k = len(cols)
    shape = plane.shape
    if k not in (4, 8) or len(shape) != 2 or shape[1] != PLANE_F:
        raise ValueError(f"write_columns: 4 or 8 vectors and a [slots, 16] "
                         f"plane needed, got {k} and {tuple(shape)}")
    _vectors(cols, k, shape[0], "write_columns")
    if plane.is_cpu:
        return columns_plain(plane, cols)
    _launch_writer(plane, cols, 0)
    write_columns.launches += 1
    return plane


write_columns.launches = 0


def rebuild(cols) -> torch.Tensor:
    """A new ``[slots, 16]`` plane whose columns j and j + 8 are ``cols[j]
    * 1.0000001`` (the TPU probe's ``rebuild``: the 8 vectors twice)."""
    if len(cols) != 8:
        raise ValueError(f"rebuild: 8 vectors needed, got {len(cols)}")
    slots = cols[0].shape[0]
    _vectors(cols, 8, slots, "rebuild")
    if cols[0].is_cpu:
        return rebuild_plain(cols)
    plane = cols[0].new_empty((slots, PLANE_F))
    _launch_writer(plane, cols, 1)
    rebuild.launches += 1
    return plane


rebuild.launches = 0


def write_rows(t: torch.Tensor, cols) -> torch.Tensor:
    """``t[j] = cols[j] * 1.0000001`` for j < K (K = 4 or 8), in place, on
    an ``[8, slots]`` f32 plane (the TPU probe's ``rows4_T``).  Returns
    ``t``."""
    k = len(cols)
    shape = t.shape
    if k not in (4, 8) or len(shape) != 2 or shape[0] != 8:
        raise ValueError(f"write_rows: 4 or 8 vectors and an [8, slots] "
                         f"plane needed, got {k} and {tuple(shape)}")
    _vectors(cols, k, shape[1], "write_rows")
    if t.is_cpu:
        return rows_plain(t, cols)
    _launch_writer(t, cols, 2)
    write_rows.launches += 1
    return t


write_rows.launches = 0


def probe_vectors(slots: int, device="cuda"):
    """(plane [slots, 16], 8 vectors [slots], t [8, slots]) f32, uniform
    in [0, 1) from numpy seed 0, as the TPU probe draws its plane and
    vectors."""
    rng = np.random.default_rng(0)
    plane = torch.as_tensor(rng.random((slots, PLANE_F), np.float32),
                            device=device)
    cols = [torch.as_tensor(rng.random(slots, np.float32), device=device)
            for _ in range(8)]
    t = torch.as_tensor(rng.random((8, slots), np.float32), device=device)
    return plane, cols, t


def _writers(plane, cols, t):
    """{name: (wrapper, kernel call, plain call, library call or None,
    Bound)} for the writers at ``plane``'s slots; the in-place calls write
    ``plane`` and ``t`` (kernel) and copies of them (plain version)."""
    slots = plane.shape[0]
    pre = [c * SCALE for c in cols]
    p, q = plane.clone(), t.clone()
    c4 = cols[:4]
    return {
        "columns x8": (write_columns, lambda: write_columns(plane, cols),
                       lambda: columns_plain(p, cols), None,
                       rl.Bound(rl.plane_bytes("columns", slots, 8))),
        "columns x4": (write_columns, lambda: write_columns(plane, c4),
                       lambda: columns_plain(p, c4), None,
                       rl.Bound(rl.plane_bytes("columns", slots, 4))),
        "rebuild": (rebuild, lambda: rebuild(cols),
                    lambda: rebuild_plain(cols),
                    lambda: torch.stack(pre + pre, -1),
                    rl.Bound(rl.plane_bytes("rebuild", slots))),
        "rows x4": (write_rows, lambda: write_rows(t, c4),
                    lambda: rows_plain(q, c4), None,
                    rl.Bound(rl.plane_bytes("rows", slots, 4))),
    }


def check(device) -> int:
    """Every kernel against its plain version, bitwise: the two probe
    transposes and ``OTHER_TRANSPOSE``, and each writer at both plane
    sizes and at ``OTHER_SLOTS`` (the in-place ones on two copies of one
    plane).  Returns the number of comparisons; raises on a mismatch."""
    n = 0
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.random((8, 128), np.float32), device=device)
    rows, ld, cols = OTHER_TRANSPOSE
    y = torch.as_tensor(rng.random((rows, ld), np.float32), device=device)
    for src, cols in [(x[:r], c) for r, c in TRANSPOSES] + [(y, cols)]:
        if not torch.equal(transpose(src, cols), transpose_plain(src, cols)):
            raise AssertionError(f"transpose {list(src.shape)} -> "
                                 f"[{cols},{src.shape[0]}] differs")
        n += 1
    for slots in (*SLOTS.values(), *OTHER_SLOTS):
        writers = _writers(*probe_vectors(slots, device=device))
        for name, (_, kernel, plain, _, _) in writers.items():
            got, want = kernel(), plain()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at {slots} slots differs from "
                                     f"its plain version on "
                                     f"{int((got != want).sum())} values")
            n += 1
    return n


def measure(device) -> list:
    """Rows (name, size label, ms, plain ms, library ms or None, Bound,
    launches, max abs err, extra).  ``launches`` counts the row's calls,
    its warm-ups included; the error is that of the last timed output
    against the last plain one.  ``extra``: the kernel's ``device_ms``
    (profiler, taken after every CUDA-event timing), where there is a
    library call its ``library_device_ms``, and for ``columns x4`` its
    bound and share against the sectors its layout forces."""
    rows, device_calls = [], []
    x = torch.as_tensor(np.random.default_rng(1).random((8, 128), np.float32),
                        device=device)
    for r, c in TRANSPOSES:
        src = x[:r].contiguous()
        n0 = transpose.launches
        kern = functools.partial(transpose, src, c)
        lib = functools.partial(_library_transpose, src, c)
        ms, lib_ms = cuda_ms_in_turns(kern, lib, TRANSPOSE_REPS,
                                      TRANSPOSE_ROUNDS)
        got = kern()
        pms, want, _ = timed(lambda: transpose_plain(src, c), TRANSPOSE_REPS)
        extra = {}
        device_calls += [(extra, "device_ms", kern, "transpose"),
                         (extra, "library_device_ms", lib, "")]
        rows.append((f"transpose [{r},{c}]", "block", ms, pms, lib_ms,
                     rl.Bound(rl.transpose_bytes(r, c)),
                     transpose.launches - n0, max_abs_err(got, want), extra))
    for label, slots in SLOTS.items():
        plane, cols, t = probe_vectors(slots, device=device)
        for name, (fn, kern, plain, lib, bound) in _writers(plane, cols,
                                                            t).items():
            ms, got, n = timed(kern, REPS, fn)
            pms, want, _ = timed(plain, REPS)
            extra = {}
            if name == "columns x4":
                sec = rl.Bound(rl.plane_sector_bytes(slots, 4))
                extra = dict(sector_bound_ms=sec.ms,
                             sector_share=sec.ms / ms)
            device_calls.append((extra, "device_ms", kern, "plane_"))
            if lib is not None:
                device_calls.append((extra, "library_device_ms", lib, ""))
            rows.append((name, f"{label} {slots}", ms, pms,
                         None if lib is None else cuda_ms(lib, REPS), bound,
                         n, max_abs_err(got, want), extra))
    for extra, key, fn, kernel in device_calls:
        extra[key] = kernel_device_ms(fn, REPS, kernel)
    return rows


def _library_transpose(src, c):
    return src[:, :c].t().contiguous()


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    dev = require_card()
    from ..utils.profile_step import card_line

    print(f"checked bitwise against the plain versions: {check(dev)} cases")
    print(f"transposes and plane writers on '{card_line()}':")
    for name, size, ms, pms, lib, bound, _, _, extra in measure(dev):
        lib_text = "none" if lib is None else f"{lib:.4f} ms"
        if "library_device_ms" in extra:
            lib_text += f" ({extra['library_device_ms']:.5f} ms on the device)"
        sec = "" if "sector_share" not in extra else (
            f", {100 * extra['sector_share']:.1f}% of its sector bound")
        print(f"  {name:18s} {size:18s}: {ms:.4f} ms a call "
              f"({extra['device_ms']:.5f} ms on the device), bound "
              f"{bound.ms:.6f} ms ({bound.bytes} B), "
              f"{100 * bound.ms / ms:.1f}% of bound{sec}; plain {pms:.4f} "
              f"ms; one torch call {lib_text}")


if __name__ == "__main__":
    main()
