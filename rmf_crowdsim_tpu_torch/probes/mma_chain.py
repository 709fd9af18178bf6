"""P3: a dependency-chained 0/1 matrix product on the tensor cores.

    python -m rmf_crowdsim_tpu_torch.probes.mma_chain [--iters 4000]

Counterpart of the TPU probe ``perf/onehot_int8_probe.py``: ``iters``
chained products ``x <- tile(x @ w > 64)`` at the TPU kernel's
compaction shapes, the prefix triangle ``[64, 128] @ [128, 128]`` and the
one-hot ``[8, 384] @ [384, 128]``, with inputs drawn as that probe draws
them (uniform < 0.5, numpy seed 0).  The kernel (``csrc/mma_chain.cu``)
runs the chain in one block with ``mma.sync`` in bf16, s8 and tf32, and as
an FFMA loop in f32 (the analog of the TPU's f32 -> f32).  Printed, for
each shape and type: ns per product, its bound (``utils/roofline.
mma_bound``: the card's dense peak for the type, not the chain's
latency), and one ``torch.matmul`` link in the same type (``torch._int_mm``
for s8 where its shape rules allow).  Every type is first held bitwise
against the plain chain at ``iters`` 1, 2 and 3.  Needs a CUDA device;
raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils import cuda_build
from ..utils import roofline as rl
from ..utils.profile_step import cuda_ms
from . import max_abs_err, require_card, timed

DTYPES = ("bf16", "s8", "tf32", "f32")
SHAPES = {"prefix-tri": (64, 128, 128), "one-hot": (8, 384, 128)}
THRESH = 64
ITERS = 4000
PLAIN_ITERS = 50       # steps a timed call of the plain chain
REPS = 3               # timed calls of the kernel a row
SMEM_LIMIT = 232_448
_ELEM = {"bf16": 2, "s8": 1, "tf32": 4}


def probe_inputs(m: int, k: int, n: int, device="cuda"):
    """x [m, k] and w [k, n] f32 of 0/1, drawn as the TPU probe draws
    them (``time_variant``: uniform < 0.5, x first, numpy seed 0)."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(m, k)) < 0.5).astype(np.float32)
    w = (rng.uniform(size=(k, n)) < 0.5).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(w, device=device))


def smem_bytes(m: int, k: int, n: int, dtype: str) -> int:
    """Shared memory of the kernel's block (``mma_layout`` and
    ``ffma_bytes`` in the ``.cu``)."""
    def a16(v):
        return (v + 15) // 16 * 16
    if dtype == "f32":
        return a16(4 * m * k) + 4 * k * n
    e = _ELEM[dtype]
    mp = -(-m // 16) * 16
    ld = k + 16 // e
    return a16(e * mp * ld) + a16(e * n * ld)


def mma_chain_plain(x, w, iters: int):
    """The chain in float64 (exact for 0/1): (x[:, :n] after ``iters``
    steps, the last step's product), both [m, n] f32."""
    n = w.shape[1]
    copies = x.shape[1] // n
    xd, wd = x.double(), w.double()
    acc = None
    for _ in range(iters):
        acc = xd @ wd
        xd = (acc > THRESH).double().repeat(1, copies)
    return xd[:, :n].float(), acc.float()


def mma_chain(x: torch.Tensor, w: torch.Tensor, iters: int, dtype: str):
    """``iters`` >= 1 chained steps ``acc = x @ w; x = tile(acc > 64)``
    with the product in ``dtype`` (``bf16``, ``s8``, ``tf32`` on
    the tensor cores, ``f32`` on the FFMA units).  ``x`` [m, k] and ``w``
    [k, n] f32 hold 0 or 1; 1 <= m <= 64, n a multiple of 8, k a multiple
    of n and of 32.  Returns (x[:, :n], the last product), both [m, n]
    f32.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/mma_chain.cu``."""
    if dtype not in DTYPES:
        raise ValueError(f"mma_chain: dtype must be one of {DTYPES}, got "
                         f"{dtype!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"mma_chain: x [m, k] and w [k, n] needed, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if not (1 <= m <= 64 and n >= 8 and n % 8 == 0 and k % n == 0
            and k % 32 == 0 and int(iters) >= 1):
        raise ValueError(f"mma_chain: m {m} in 1..64, n {n} a multiple of "
                         f"8, k {k} a multiple of n and of 32, iters "
                         f"{iters} >= 1 needed")
    if x.device.type == "cpu":
        if x.dtype != torch.float32 or w.dtype != torch.float32:
            raise ValueError("mma_chain: x and w must be float32")
        return mma_chain_plain(x, w, iters)
    cuda_build.check_tensors("mma_chain", x=(x, torch.float32, (m, k)),
                             w=(w, torch.float32, (k, n)))
    if dtype == "f32" and (256 % n or m > 256 // n * 32):
        raise ValueError(f"mma_chain: f32 takes n dividing 256 and at most "
                         f"256 / n * 32 rows, got m {m}, n {n}")
    smem = smem_bytes(m, k, n, dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"mma_chain: {smem} bytes of shared memory exceed "
                         f"{SMEM_LIMIT}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    acc = torch.empty_like(out)
    cuda_build.launch("crowdsim_mma_chain", x, w, out, acc, m, k, n,
                      int(iters), DTYPES.index(dtype))
    mma_chain.launches += 1
    return out, acc


mma_chain.launches = 0


def check(device, iters=(1, 2, 3)) -> int:
    """Every shape and type against the plain chain, bitwise, at each of
    ``iters``; returns the number of comparisons; raises on a mismatch."""
    n_checks = 0
    for shape, (m, k, n) in SHAPES.items():
        x, w = probe_inputs(m, k, n, device=device)
        for it in iters:
            want = mma_chain_plain(x, w, it)
            for dtype in DTYPES:
                got = mma_chain(x, w, it, dtype)
                for g, p, what in zip(got, want, ("bits", "product")):
                    if not torch.equal(g, p):
                        raise AssertionError(
                            f"mma_chain {shape} {dtype} iters={it}: the "
                            f"{what} differ from the plain chain on "
                            f"{int((g != p).sum())} entries")
                n_checks += 1
    return n_checks


def _library_ms(x, w, dtype: str):
    """One ``torch`` call computing one link's product in ``dtype``, ms;
    None where no such call takes the shape (``torch._int_mm`` needs more
    than 16 rows)."""
    if dtype == "bf16":
        a, b = x.bfloat16(), w.bfloat16()
        return cuda_ms(lambda: torch.matmul(a, b), 20)
    if dtype == "s8":
        if x.shape[0] <= 16:
            return None
        a, b = x.to(torch.int8), w.to(torch.int8)
        return cuda_ms(lambda: torch._int_mm(a, b), 20)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = dtype == "tf32"
    try:
        return cuda_ms(lambda: torch.matmul(x, w), 20)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def measure(device, iters: int = ITERS) -> list:
    """Rows (shape, dtype, ms a product, plain ms a product, library ms
    a link or None, bound ms a product, Bound of the whole call, launches,
    max abs err).  ``launches`` counts the row's calls, its warm-up
    included; the error is that of the last timed call's (bits, product)
    against the plain chain at the same ``iters``."""
    rows = []
    for shape, (m, k, n) in SHAPES.items():
        x, w = probe_inputs(m, k, n, device=device)
        want = torch.cat(mma_chain_plain(x, w, iters), 1)
        for dtype in DTYPES:
            ms, got, launches = timed(lambda: mma_chain(x, w, iters, dtype),
                                      REPS, mma_chain)
            pms = cuda_ms(lambda: mma_chain_plain(x, w, PLAIN_ITERS),
                          1) / PLAIN_ITERS
            lib = _library_ms(x, w, dtype)
            bound = rl.mma_bound(m, k, n, dtype, iters)
            rows.append((shape, dtype, ms / iters, pms, lib, bound.ms / iters,
                         bound, launches,
                         max_abs_err(torch.cat(got, 1), want)))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args()
    dev = require_card()
    from ..utils.profile_step import card_line

    print(f"checked bitwise against the plain chain: {check(dev)} cases")
    print(f"chained 0/1 products on '{card_line()}', iters {args.iters}:")
    for shape, dtype, ms, pms, lib, bms, *_ in measure(dev, args.iters):
        m, k, n = SHAPES[shape]
        lib_text = "none" if lib is None else f"{1e6 * lib:.1f} ns"
        print(f"  [{shape} {m}x{k}x{n}] {dtype}: {1e6 * ms:.1f} ns/product "
              f"(bound {1e6 * bms:.3f} ns at the {dtype} peak); plain "
              f"{1e6 * pms:.1f} ns; one torch link {lib_text}")


if __name__ == "__main__":
    main()
