"""Build and launch the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At the first CUDA
call each one is compiled with ``nvcc``, all at once in parallel, and the
objects are linked into one shared library in ``_build/`` inside the
package (listed in ``.gitignore``), named by a hash of the sources and
flags, and loaded with ``ctypes``.  Nothing is built at import time, so
the kernel modules import on machines without CUDA.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and ``-fmad=false`` so
the kernels round every operation as the plain PyTorch versions do (see
``csrc/zanlungo_pair.cuh``).

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``;
:func:`launch` raises if that is not ``cudaSuccess``.  Loading the library
binds every entry point of :data:`SIGNATURES` once, with its ctypes
argument types, so that a launch costs a dict lookup, the raw stream
(``torch._C._cuda_getCurrentRawStream``, the call PyTorch's own generated
launchers make) and, only when the tensors' device is not the current one,
a device guard.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
    "-Xptxas", "-v",
)

# C entry points: one code per argument before the trailing stream
# ("p" = device pointer, None for NULL; "i" = int).
SIGNATURES = {
    "crowdsim_pack_rows": "pppiipp",
    "crowdsim_zanlungo_bucketed": "pppppiiiiii",
    "crowdsim_zanlungo_bucketed_spill": "pppppppiiiiiiii",
    "crowdsim_spill_window": "ppppppppppiiiiii",
    "crowdsim_zanlungo_dense": "pppppiiiiiii",
    # The measurement probes (probes/).
    "crowdsim_k1_stage": "pppppiiiiiii",
    "crowdsim_mma_chain": "ppppiiiii",
    "crowdsim_transpose": "ppiii",
    "crowdsim_plane_write": "pppppppppiii",
    # An empty <<<1, 32>>> kernel: the launch floor (probes/launch.py).
    "crowdsim_noop": "",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}

# name -> the bound ctypes function; filled when the library is loaded.
_LAUNCHERS: dict = {}


def argtypes(sig: str) -> list:
    """The ctypes argument types of a ``SIGNATURES`` code: ``c_void_p``
    for each pointer and the trailing stream, ``c_int`` for each int."""
    return [_CTYPES[c] for c in sig] + [ctypes.c_void_p]


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the kernels' shared library for the current sources goes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcrowdsim_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library: one
    ``nvcc -c`` per source, all started together, then one link.  The
    compilers' output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library in a ``.log`` file."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        sources = sorted(CSRC_DIR.glob("*.cu"))
        objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
        nvcc = _nvcc()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(p)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(sources, objs)]
        log, failed = [], []
        for p, proc in zip(sources, procs):
            log.append(f"== nvcc -c {p.name}\n{proc.communicate()[0]}")
            if proc.returncode != 0:
                failed.append(p.name)
        tmp = so.with_name(f"{tag}.tmp")
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        for o in objs:
            o.unlink(missing_ok=True)
        so.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               + "".join(log))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.crowdsim_error_string.argtypes = [ctypes.c_int]
    lib.crowdsim_error_string.restype = ctypes.c_char_p
    for name, sig in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes(sig)
        fn.restype = ctypes.c_int
        _LAUNCHERS[name] = fn
    return lib


def build_log() -> str:
    """The compiler output of the current library's build ('' if it was
    built by an earlier process and its log is gone)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_tensors(caller: str, **specs) -> None:
    """Raise unless every ``name=(tensor, dtype, shape)`` is a contiguous
    CUDA tensor of that dtype and shape (a tuple), all on one device.
    Checked in the order dtype, shape, contiguity, CUDA, one device."""
    device = None
    for name, (t, dtype, shape) in specs.items():
        if t.dtype != dtype:
            raise ValueError(f"{caller}: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{caller}: {name} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous")
        if not t.is_cuda:
            raise ValueError(f"{caller}: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if device is None:
            device = t.get_device()
        elif t.get_device() != device:
            devices = {s[0].device for s in specs.values()}
            raise ValueError(f"{caller}: tensors on several devices "
                             f"{devices}")


def _launcher(name: str):
    """The bound entry point ``name``, loading (and building) the library
    at the first call; raises for a name not in ``SIGNATURES``."""
    library()
    if name not in _LAUNCHERS:
        raise ValueError(f"launch: no C entry point {name!r} in SIGNATURES")
    return _LAUNCHERS[name]


def launch(name: str, *args, device: int | None = None) -> None:
    """Call C entry point ``name`` with tensors passed as device pointers,
    None as a null pointer and ints as ints, on the current stream of the
    first argument's device (a tensor's; ``device``, a CUDA index, for an
    entry point that takes no tensor).  The device guard is entered only
    where that device is not the current one."""
    fn = _LAUNCHERS.get(name) or _launcher(name)
    if device is None:
        first = args[0] if args else None
        device = first.get_device() if isinstance(first, torch.Tensor) else -1
    if device < 0:
        raise ValueError(f"{name}: launch needs a CUDA tensor as its first "
                         f"argument or a device index")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if device == torch._C._cuda_getDevice():
        err = fn(*cargs, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*cargs, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        msg = library().crowdsim_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
