"""P3: a dependency-chained 0/1 matrix product on the tensor cores.

    python -m rmf_crowdsim_tpu_torch.probes.mma_chain [--iters 4000]
        [--other DIR]

Counterpart of the TPU probe ``perf/onehot_int8_probe.py``: ``iters``
chained products ``x <- tile(x @ w > 64)`` at the TPU kernel's
compaction shapes, the prefix triangle ``[64, 128] @ [128, 128]`` and the
one-hot ``[8, 384] @ [384, 128]``, timed with inputs drawn as that probe
draws them (uniform < 0.5, numpy seed 0).  The kernel
(``csrc/mma_chain.cu``) runs each 16-row tile as its own chain with
``mma.sync`` in bf16, s8 and tf32, and each row as its own FFMA chain in
f32 (the analog of the TPU's f32 -> f32).

Printed, for each shape and type: ns a product; with ``--other``,
the ns a product of the port in ``DIR`` (another checkout, for example the
parent commit, loaded as ``other_port``) from turns other, this, this,
other; ns a link of the type (``mma_link``: one warp, ``LINKS`` dependent
links of the smallest product whose A operand is the threshold of the
one before; a lower bound on a link, which runs several such products
one after another); the latency bound (``iters`` links) and the rate bound (the
type's dense peak), each with the share of it the kernel reaches; the
plain chain's ns a product and one ``torch`` link (``torch.matmul``,
``torch._int_mm`` for s8 where its shape rules allow); the kernel's
registers, spills and shared memory from ``ptxas -v``.  Every type is
first held bitwise against the plain chain on both input sets
at ``CHECK_ITERS`` steps.  Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import importlib
import time

import numpy as np
import torch

from ..utils import cuda_build
from ..utils import roofline as rl
from ..utils.profile_step import cuda_ms, cuda_ms_in_turns
from . import max_abs_err, require_card

DTYPES = ("bf16", "s8", "tf32", "f32")
SHAPES = {"prefix-tri": (64, 128, 128), "one-hot": (8, 384, 128)}
# The (k, n) that the kernel takes as template parameters; other accepted
# shapes take its generic one-block kernels.
TEMPLATED = ((128, 128), (384, 128))
# Lanes a column group of the FFMA form, by (k, n) (``launch_prefix``,
# ``launch_one_hot`` in the .cu).
FFMA_SEG = {(128, 128): 2, (384, 128): 8}
THRESH = 64
ITERS = 4000
CHECK_ITERS = (1, 2, 3, 256)
LINKS = 200_000        # links a timed mma_link launch
LINK_C = 2 * THRESH    # mma_link_kernel's C operand (csrc/mma_chain.cu)
PLAIN_ITERS = 50       # steps a timed call of the plain chain
REPS = 3               # timed calls of the kernel a turn
SMEM_LIMIT = 232_448
_ELEM = {"bf16": 2, "s8": 1, "tf32": 4}
# (k of one mma, elements of A a 32-bit register)
FRAG = {"bf16": (16, 2), "s8": (32, 4), "tf32": (8, 1)}
# byte_perm selectors of the s8 repack, by t >> 1 (csrc/mma_chain.cu).
S8_SELECT = (0x5410, 0x7632)


def probe_inputs(m: int, k: int, n: int, device="cuda"):
    """x [m, k] and w [k, n] f32 of 0/1, drawn as the TPU probe draws
    them (``time_variant``: uniform < 0.5, x first, numpy seed 0).  The
    chain settles after one step: the prefix bits are all 0 from step 1
    on, the one-hot bits all 1."""
    return _draw(m, k, n, 0.5, 0.5, device)


def straddle_inputs(m: int, k: int, n: int, device="cuda"):
    """x [m, k] and w [k, n] f32 of 0/1 whose first product centres on
    the threshold, so that the bits vary from step to step: numpy seed 0,
    x first at density 2/3, w at 3/4 where k = n (the prefix) and 1/4
    where k = 3 n (the one-hot); either gives a mean product of ~64."""
    return _draw(m, k, n, 2 / 3, 0.75 if k == n else 0.25, device)


def _draw(m, k, n, x_density, w_density, device):
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(m, k)) < x_density).astype(np.float32)
    w = (rng.uniform(size=(k, n)) < w_density).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(w, device=device))


INPUTS = {"probe": probe_inputs, "straddle": straddle_inputs}


# ---------------------------------------------------------------------------
# Fragments: where each lane's registers sit in the tiles
# ---------------------------------------------------------------------------


def fragment_map(dtype: str, operand: str) -> np.ndarray:
    """(row, column) of each (lane, register, element) of one ``mma.sync``
    fragment of ``dtype`` (PTX ISA, "Matrix Fragments for mma.m16n8k*";
    lane = 4 g + t), as an int array [32, 4, e, 2]: ``"a"`` the A
    fragment of one k step, [16, K] (register r holds EA elements of row
    g + 8 (r & 1), columns (K / 2) (r >> 1) + EA t + e); ``"c"`` the C
    fragment of one n tile, [16, 8], one element a register (c0, c1 at
    row g, columns 2t, 2t + 1; c2, c3 at row g + 8)."""
    kk, ea = FRAG[dtype]
    g, t = np.arange(32) // 4, np.arange(32) % 4
    r = np.arange(4)
    if operand == "c":
        row = g[:, None] + 8 * (r >> 1)
        col = 2 * t[:, None] + (r & 1)
        return np.stack([row, col], -1)[:, :, None, :]
    if operand != "a":
        raise ValueError(f"fragment_map: operand 'a' or 'c', got {operand!r}")
    e = np.arange(ea)
    row = g[:, None, None] + 8 * (r[:, None] & 1) + 0 * e
    col = (kk // 2) * (r[:, None] >> 1) + ea * t[:, None, None] + e
    return np.stack([row, col], -1)


def repack_sources(dtype: str) -> np.ndarray:
    """For each (lane, register, element) of the A fragment of k step u,
    the (source lane, n tile - the k step's first tile, C register) whose
    bit the kernel's repack (``Mma<TYPE>::repack`` in
    ``csrc/mma_chain.cu``) puts there, followed step by step: an int array
    [32, 4, EA, 3].  bf16 takes the lane's own C registers; s8 and tf32
    shuffle inside each quad."""
    kk, ea = FRAG[dtype]
    out = np.zeros((32, 4, ea, 3), dtype=np.int64)
    for lane in range(32):
        t, quad = lane & 3, lane & ~3
        if dtype == "bf16":
            for r in range(4):
                for e in range(2):
                    out[lane, r, e] = (lane, r >> 1, 2 * (r & 1) + e)
        elif dtype == "s8":
            lo = quad | (2 * (t & 1))
            sel = S8_SELECT[t >> 1]
            for r in range(4):
                h, p = r & 1, r >> 1

                def word(src):   # the bytes lane src packs, low byte first
                    return [(src, 2 * p, 2 * h), (src, 2 * p, 2 * h + 1),
                            (src, 2 * p + 1, 2 * h),
                            (src, 2 * p + 1, 2 * h + 1)]
                pool = word(lo) + word(lo + 1)     # __byte_perm's 8 bytes
                for e in range(4):
                    out[lane, r, e] = pool[(sel >> (4 * e)) & 0xF]
        else:
            src = quad | ((t & 1) << 1) | (t >> 1)
            for h in range(2):
                # shuffle 1: lane s sends c[2h + (s >> 1)]; shuffle 2 (read
                # from src ^ 2): c[2h + 1 - (s >> 1)].
                s1 = (src, 0, 2 * h + ((src & 3) >> 1))
                s2 = (src ^ 2, 0, 2 * h + 1 - (((src ^ 2) & 3) >> 1))
                out[lane, h, 0] = s2 if t & 1 else s1
                out[lane, h + 2, 0] = s1 if t & 1 else s2
    return out


# The C register each A element takes in ``mma_link_kernel``, [4, EA].
LINK_FEED = {"bf16": np.array([[0, 1], [2, 3], [0, 1], [2, 3]]),
             "s8": np.tile(np.arange(4), (4, 1)),
             "tf32": np.arange(4)[:, None]}


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


def smem_bytes(m: int, k: int, n: int, dtype: str) -> int:
    """Shared memory of the kernel's block: at the templated shapes
    ``ffma_rows_kernel``'s two x rows (``FFMA_SEG`` segments of k / SEG
    + 4 floats) or ``mma_rows_kernel``'s two exchange buffers; elsewhere
    the generic kernels' ``mma_layout`` and ``ffma_bytes``."""
    def a16(v):
        return (v + 15) // 16 * 16
    if (k, n) in TEMPLATED:
        if dtype == "f32":
            seg = FFMA_SEG[k, n]
            return 4 * 2 * seg * (k // seg + 4)
        kk, _ = FRAG[dtype]
        return 4 * 2 * (n // kk) * 32 * (2 if dtype == "tf32" else 4)
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
    of n and of 32.  Returns (x[:, :n], the last
    product), both [m, n] f32.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/mma_chain.cu``."""
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
    if (dtype == "f32" and (k, n) not in TEMPLATED
            and (256 % n or m > 256 // n * 32)):
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


# ---------------------------------------------------------------------------
# One link: the latency every link of a chain pays at least once
# ---------------------------------------------------------------------------


def mma_link_plain(links: int, dtype: str) -> torch.Tensor:
    """[32, 4] f32: each lane's last result of ``links`` dependent links of
    ``mma_link_kernel`` (f32: ``fma_link_kernel``), in float64, every link
    computed.  A starts as ones, every B element is -LINK_C / K and the C
    operand is LINK_C; each link's A is the threshold of the last result,
    placed by ``LINK_FEED`` and :func:`fragment_map`.  The bits alternate:
    an odd count of links gives 0 (f32: 0.5), an even one LINK_C (65.5)."""
    if dtype == "f32":
        v = 65.5
        for _ in range(links):
            v = (1.0 if v > THRESH else 0.0) * -65.0 + 65.5
        return torch.full((32, 4), v, dtype=torch.float32)
    kk, _ = FRAG[dtype]
    amap, cmap = fragment_map(dtype, "a"), fragment_map(dtype, "c")
    c_at = cmap[..., 0, 0] * 8 + cmap[..., 0, 1]         # [32, 4] into [16, 8]
    a_at = amap[..., 0] * kk + amap[..., 1]              # [32, 4, EA] into A
    feed = LINK_FEED[dtype]
    a, b = np.ones(16 * kk), np.full((kk, 8), -LINK_C / kk)
    d = None
    for _ in range(links):
        d = LINK_C + (a.reshape(16, kk) @ b).ravel()[c_at]
        a = np.zeros(16 * kk)
        a[a_at] = (d > THRESH)[:, feed]
    return torch.as_tensor(d, dtype=torch.float32)


def mma_link(out: torch.Tensor, links: int, dtype: str) -> torch.Tensor:
    """``links`` >= 1 dependent links of ``dtype`` in one warp, each
    lane's last result written into ``out`` [32, 4] f32 and returned.  A
    CPU ``out`` takes the plain version; a CUDA one launches
    ``crowdsim_mma_link``."""
    if dtype not in DTYPES:
        raise ValueError(f"mma_link: dtype must be one of {DTYPES}, got "
                         f"{dtype!r}")
    if int(links) < 1:
        raise ValueError(f"mma_link: links {links} >= 1 needed")
    if out.device.type == "cpu":
        if out.dtype != torch.float32 or out.shape != (32, 4):
            raise ValueError("mma_link: out must be [32, 4] float32")
        out.copy_(mma_link_plain(int(links), dtype))
        return out
    cuda_build.check_tensors("mma_link", out=(out, torch.float32, (32, 4)))
    cuda_build.launch("crowdsim_mma_link", out, int(links),
                      DTYPES.index(dtype))
    mma_link.launches += 1
    return out


mma_link.launches = 0


def link_ns(device, dtype: str, links: int = LINKS) -> dict:
    """One warm-up launch of ``mma_link``, then one launch of ``links``
    links between CUDA events, so that the launch is under 1% of the
    time: ``ns`` a link, ``ms`` the launch, ``err`` its result against the
    plain version, ``plain_ms`` the plain version's host time at the same
    ``links`` (every link computed), ``launches`` (2)."""
    out = torch.empty((32, 4), dtype=torch.float32, device=device)
    n0 = mma_link.launches
    mma_link(out, 1000, dtype)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    mma_link(out, links, dtype)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    launches = mma_link.launches - n0
    t0 = time.perf_counter()
    want = mma_link_plain(links, dtype)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    return dict(ns=1e6 * ms / links, ms=ms, err=max_abs_err(out.cpu(), want),
                plain_ms=plain_ms, launches=launches)


# ---------------------------------------------------------------------------
# Checks and timing
# ---------------------------------------------------------------------------


def check(device, iters=CHECK_ITERS) -> int:
    """Every shape and type against the plain chain, bitwise, on
    both input sets (``INPUTS``) at each of ``iters``, and each type's
    link at 1, 2 and 3 links; returns the number of comparisons; raises on
    a mismatch."""
    n_checks = 0
    for shape, (m, k, n) in SHAPES.items():
        for name, draw in INPUTS.items():
            x, w = draw(m, k, n, device=device)
            for it in iters:
                want = mma_chain_plain(x, w, it)
                for dtype in DTYPES:
                    got = mma_chain(x, w, it, dtype)
                    for g, p, what in zip(got, want, ("bits", "product")):
                        if not torch.equal(g, p):
                            raise AssertionError(
                                f"mma_chain {shape} {dtype} "
                                f"{name} inputs iters={it}: the {what} "
                                f"differ from the plain chain on "
                                f"{int((g != p).sum())} entries")
                    n_checks += 1
    out = torch.empty((32, 4), dtype=torch.float32, device=device)
    for dtype in DTYPES:
        for links in (1, 2, 3):
            got = mma_link(out, links, dtype).cpu()
            if not torch.equal(got, mma_link_plain(links, dtype)):
                raise AssertionError(f"mma_link {dtype} links={links}: "
                                     f"differs from the plain version")
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


def unit(dtype: str) -> str:
    """What runs the product: ``ffma`` or ``mma`` (``mma.sync``)."""
    return "ffma" if dtype == "f32" else "mma"


def kernel_symbol(k: int, n: int, dtype: str) -> str:
    """A piece of the mangled name of the kernel that (k, n, dtype)
    launches, to find its lines in the ``ptxas -v`` log."""
    if (k, n) not in TEMPLATED:
        return ("ffma_chain_kernel" if dtype == "f32" else
                f"mma_chain_kernelILi{DTYPES.index(dtype)}E")
    if unit(dtype) == "ffma":
        return f"ffma_rows_kernelILi{k}ELi{n}E"
    return f"mma_rows_kernelILi{DTYPES.index(dtype)}ELi{k}ELi{n}E"


def measure(device, iters: int = ITERS, other=None) -> list:
    """One dict a (shape, dtype): ``ms`` a
    product (the mean of two turns of ``REPS`` calls, each after a warm-up
    call); ``parent_ms`` a product of ``other`` (a loaded port package, or
    None), with ``ms``, from the turns other, this, this, other;
    ``plain_ms`` a product; ``library_ms`` a link or None; ``link_ns`` and
    ``link`` (:func:`link_ns`'s dict); ``bound`` (``mma_chain_bound`` of
    the whole call) with ``latency_ms`` and ``rate_ms`` a product;
    ``launches``, the calls of this port's kernel the row made (warm-ups
    included); ``err``, the last timed call's (bits, product) against the
    plain chain at the same ``iters``; ``ptxas``, the kernel's line of the
    build log."""
    links = {d: link_ns(device, d) for d in DTYPES}
    log = cuda_build.build_log()
    om = (None if other is None else
          importlib.import_module(f"{other.__name__}.probes.mma_chain"))
    rows = []
    for shape, (m, k, n) in SHAPES.items():
        x, w = probe_inputs(m, k, n, device=device)
        want = torch.cat(mma_chain_plain(x, w, iters), 1)
        for dtype in DTYPES:
            last = [None]

            def call():
                last[0] = mma_chain(x, w, iters, dtype)

            n0 = mma_chain.launches
            parent = None
            if om is None:
                ms = (cuda_ms(call, REPS) + cuda_ms(call, REPS)) / 2
            else:
                def other_call():
                    om.mma_chain(x, w, iters, dtype)

                parent, ms = cuda_ms_in_turns(other_call, call, REPS)
            launches = mma_chain.launches - n0
            pms = cuda_ms(lambda: mma_chain_plain(x, w, PLAIN_ITERS),
                          1) / PLAIN_ITERS
            ns = links[dtype]["ns"]
            bound = rl.mma_chain_bound(m, k, n, dtype, iters, ns)
            usage = cuda_build.ptxas_usage(
                log, kernel_symbol(k, n, dtype))
            rows.append(dict(
                shape=shape, dtype=dtype, form=unit(dtype), ms=ms / iters,
                parent_ms=None if parent is None else parent / iters,
                plain_ms=pms, library_ms=_library_ms(x, w, dtype),
                link_ns=ns, link=links[dtype], bound=bound,
                latency_ms=bound.latency_ms / iters,
                rate_ms=max(bound.bytes_ms, bound.ops_ms) / iters,
                launches=launches,
                err=max_abs_err(torch.cat(last[0], 1), want),
                ptxas="; ".join(sorted(usage.values())) or "not in the log"))
    return rows


def row_text(r: dict) -> str:
    """One printed line of a :func:`measure` row."""
    ms, lat, rate = r["ms"], r["latency_ms"], r["rate_ms"]
    lib = r["library_ms"]
    par = ("" if r["parent_ms"] is None else
           f" (parent {1e6 * r['parent_ms']:.1f}, "
           f"{r['parent_ms'] / ms:.2f}x)")
    return (f"  {r['shape']:10s} {r['dtype']:4s} {r['form']:5s}: "
            f"{1e6 * ms:.1f} ns/product{par}; link {r['link_ns']:.2f} ns; "
            f"latency bound {1e6 * lat:.2f} ns ({100 * lat / ms:.1f}%), "
            f"rate bound {1e6 * rate:.3f} ns ({100 * rate / ms:.2f}%); "
            f"plain {1e6 * r['plain_ms']:.1f} ns; one torch link "
            f"{'none' if lib is None else f'{1e6 * lib:.1f} ns'}; "
            f"ptxas {r['ptxas']}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--other", default=None,
                    help="another checkout, timed in turns beside this one")
    args = ap.parse_args()
    dev = require_card()
    from ..utils.profile_step import card_line
    from .k2_compare import load_port

    other = None if args.other is None else load_port(args.other)
    print(f"checked bitwise against the plain chain: {check(dev)} cases")
    print(f"chained 0/1 products on '{card_line()}', iters {args.iters}:")
    for r in measure(dev, args.iters, other):
        print(row_text(r))


if __name__ == "__main__":
    main()
