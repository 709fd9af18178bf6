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
(``utils/roofline.plane_bytes``), the plain version's time and, where one
``torch`` call does the same, that call's.  Every kernel is first held
bitwise against its plain version.  Needs a CUDA device; raises without
one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils import roofline as rl
from ..utils.profile_step import cuda_ms
from . import max_abs_err, require_card, timed

SCALE = 1.0000001
PLANE_F = 16
SLOTS = {"bucketed": 1_835_520, "dense": 2_019_072}
TRANSPOSES = ((8, 128), (8, 64))   # (rows, columns) of the source block
REPS = 20                          # timed calls a row


def _vectors(cols, k: int, slots: int, caller: str):
    if len(cols) != k:
        raise ValueError(f"{caller}: {k} vectors needed, got {len(cols)}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != slots or c.dtype != torch.float32:
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
    if x.dim() != 2 or x.dtype != torch.float32 or not (
            1 <= cols <= x.shape[1]) or x.shape[0] * (cols + 1) > 12288:
        raise ValueError(f"transpose: x [R, ld] float32 with 1 <= cols <= "
                         f"ld and R (cols + 1) <= 12288 needed, got "
                         f"{tuple(x.shape)} {x.dtype}, cols {cols}")
    if x.device.type == "cpu":
        return transpose_plain(x, cols)
    from ..utils import cuda_build

    rows, ld = x.shape
    cuda_build.check_tensors("transpose", x=(x, torch.float32, (rows, ld)))
    y = torch.empty((cols, rows), dtype=torch.float32, device=x.device)
    cuda_build.launch("crowdsim_transpose", x, y, rows, cols, ld)
    transpose.launches += 1
    return y


transpose.launches = 0


def _launch_writer(dst, cols, mode: int):
    from ..utils import cuda_build

    cuda_build.check_tensors(
        "plane writer", dst=(dst, torch.float32, tuple(dst.shape)),
        **{f"c{j}": (c, torch.float32, tuple(c.shape))
           for j, c in enumerate(cols)})
    ptrs = list(cols) + [None] * (8 - len(cols))
    cuda_build.launch("crowdsim_plane_write", dst, *ptrs, cols[0].shape[0],
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
    if k not in (4, 8) or plane.dim() != 2 or plane.shape[1] != PLANE_F:
        raise ValueError(f"write_columns: 4 or 8 vectors and a [slots, 16] "
                         f"plane needed, got {k} and {tuple(plane.shape)}")
    _vectors(cols, k, plane.shape[0], "write_columns")
    if plane.device.type == "cpu":
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
    _vectors(cols, 8, cols[0].shape[0], "rebuild")
    if cols[0].device.type == "cpu":
        return rebuild_plain(cols)
    plane = torch.empty((cols[0].shape[0], PLANE_F), dtype=torch.float32,
                        device=cols[0].device)
    _launch_writer(plane, cols, 1)
    rebuild.launches += 1
    return plane


rebuild.launches = 0


def write_rows(t: torch.Tensor, cols) -> torch.Tensor:
    """``t[j] = cols[j] * 1.0000001`` for j < K (K = 4 or 8), in place, on
    an ``[8, slots]`` f32 plane (the TPU probe's ``rows4_T``).  Returns
    ``t``."""
    k = len(cols)
    if k not in (4, 8) or t.dim() != 2 or t.shape[0] != 8:
        raise ValueError(f"write_rows: 4 or 8 vectors and an [8, slots] "
                         f"plane needed, got {k} and {tuple(t.shape)}")
    _vectors(cols, k, t.shape[1], "write_rows")
    if t.device.type == "cpu":
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
    return {
        "columns x8": (write_columns, lambda: write_columns(plane, cols),
                       lambda: columns_plain(p, cols), None,
                       rl.Bound(rl.plane_bytes("columns", slots, 8))),
        "columns x4": (write_columns, lambda: write_columns(plane, cols[:4]),
                       lambda: columns_plain(p, cols[:4]), None,
                       rl.Bound(rl.plane_bytes("columns", slots, 4))),
        "rebuild": (rebuild, lambda: rebuild(cols),
                    lambda: rebuild_plain(cols),
                    lambda: torch.stack(pre + pre, -1),
                    rl.Bound(rl.plane_bytes("rebuild", slots))),
        "rows x4": (write_rows, lambda: write_rows(t, cols[:4]),
                    lambda: rows_plain(q, cols[:4]), None,
                    rl.Bound(rl.plane_bytes("rows", slots, 4))),
    }


def check(device) -> int:
    """Every kernel against its plain version, bitwise: the two
    transposes, and each writer at both plane sizes (the in-place ones
    on two copies of one plane).  Returns the number of comparisons;
    raises on a mismatch."""
    n = 0
    x = torch.as_tensor(np.random.default_rng(1).random((8, 128), np.float32),
                        device=device)
    for rows, cols in TRANSPOSES:
        if not torch.equal(transpose(x[:rows], cols),
                           transpose_plain(x[:rows], cols)):
            raise AssertionError(f"transpose [{rows},{cols}] differs")
        n += 1
    for slots in SLOTS.values():
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
    launches, max abs err).  ``launches`` counts the row's calls, its
    warm-up included; the error is that of the last timed output against
    the last plain one."""
    rows = []
    x = torch.as_tensor(np.random.default_rng(1).random((8, 128), np.float32),
                        device=device)
    for r, c in TRANSPOSES:
        src = x[:r].contiguous()
        ms, got, n = timed(lambda: transpose(src, c), REPS, transpose)
        pms, want, _ = timed(lambda: transpose_plain(src, c), REPS)
        rows.append((f"transpose [{r},{c}]", "block", ms, pms,
                     cuda_ms(lambda: src[:, :c].t().contiguous(), REPS),
                     rl.Bound(rl.transpose_bytes(r, c)), n,
                     max_abs_err(got, want)))
    for label, slots in SLOTS.items():
        plane, cols, t = probe_vectors(slots, device=device)
        for name, (fn, kern, plain, lib, bound) in _writers(plane, cols,
                                                            t).items():
            ms, got, n = timed(kern, REPS, fn)
            pms, want, _ = timed(plain, REPS)
            rows.append((name, f"{label} {slots}", ms, pms,
                         None if lib is None else cuda_ms(lib, REPS), bound,
                         n, max_abs_err(got, want)))
        del plane, cols, t
    return rows


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    dev = require_card()
    from ..utils.profile_step import card_line

    print(f"checked bitwise against the plain versions: {check(dev)} cases")
    print(f"transposes and plane writers on '{card_line()}':")
    for name, size, ms, pms, lib, bound, *_ in measure(dev):
        lib_text = "none" if lib is None else f"{lib:.4f} ms"
        print(f"  {name:18s} {size:18s}: {ms:.4f} ms, bound {bound.ms:.4f} "
              f"ms ({bound.bytes} B), {100 * bound.ms / ms:.1f}% of bound; "
              f"plain {pms:.4f} ms; one torch call {lib_text}")


if __name__ == "__main__":
    main()
