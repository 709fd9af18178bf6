"""The P3 and P4 probes (``probes/mma_chain.py``, ``probes/planes.py``)
against the JAX package's TPU probes, on the CPU.

P3: the plain chain of 0/1 products, bitwise, against ``_probe_kernel`` of
``perf/onehot_int8_probe.py`` run through ``pl.pallas_call(...,
interpret=True)`` at 1-3 steps, both shapes, each of the port's types
beside the JAX type it stands for (tf32 and f32 both for JAX's f32); and
the chain's last product against numpy's.  P4: the plain transposes
against the TPU probe's two transpose kernels (``perf/
transpose_probe.py:53-55`` and ``:67-69``, copied here: that module sets
a compilation cache on import) in interpret mode, and the plane writers
against ``.at[].set`` and ``jnp.stack`` as ``probe_column_updates``
writes them, at a few thousand slots, all bitwise.  Each wrapper refuses
a bad shape or type and, on CPU tensors, runs its plain version.  Each C
entry of ``csrc/`` takes the arguments its ``SIGNATURES`` code lists.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rmf_crowdsim_tpu_torch.probes import max_abs_err, mma_chain, planes
from rmf_crowdsim_tpu_torch.utils import cuda_build

REPO = Path(__file__).resolve().parent.parent
SLOTS = 3000


def _onehot_probe():
    spec = importlib.util.spec_from_file_location(
        "onehot_int8_probe", REPO / "perf" / "onehot_int8_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The port's product type -> (JAX input type, JAX accumulator type).
JAX_TYPES = {"bf16": (jnp.bfloat16, jnp.float32), "s8": (jnp.int8, jnp.int32),
             "tf32": (jnp.float32, jnp.float32),
             "f32": (jnp.float32, jnp.float32)}


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("dtype", mma_chain.DTYPES)
@pytest.mark.parametrize("shape", list(mma_chain.SHAPES))
def test_chain_matches_jax_probe_kernel(shape, dtype, iters):
    m, k, n = mma_chain.SHAPES[shape]
    x, w = mma_chain.probe_inputs(m, k, n, device="cpu")
    in_dtype, acc_dtype = JAX_TYPES[dtype]
    fn = pl.pallas_call(
        functools.partial(_onehot_probe()._probe_kernel, iters=iters,
                          in_dtype=in_dtype, acc_dtype=acc_dtype),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32), interpret=True)
    want = np.asarray(fn(jnp.asarray(x.numpy()), jnp.asarray(w.numpy())))
    got, _ = mma_chain.mma_chain(x, w, iters, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", list(mma_chain.SHAPES))
def test_chain_product_is_exact(shape):
    """The last product of one and two steps, against numpy's; a one-hot
    step saturates (every bit 1 after it), a prefix step clears."""
    m, k, n = mma_chain.SHAPES[shape]
    x, w = mma_chain.probe_inputs(m, k, n, device="cpu")
    xn, wn = x.numpy().astype(np.float64), w.numpy().astype(np.float64)
    bits, acc = mma_chain.mma_chain(x, w, 1, "bf16")
    np.testing.assert_array_equal(acc.numpy(), xn @ wn)
    np.testing.assert_array_equal(bits.numpy(), (xn @ wn) > 64)
    _, acc2 = mma_chain.mma_chain(x, w, 2, "s8")
    x1 = np.tile((xn @ wn) > 64, (1, k // n)).astype(np.float64)
    np.testing.assert_array_equal(acc2.numpy(), x1 @ wn)


@pytest.mark.parametrize("m,k,n,dtype", [
    (65, 128, 128, "bf16"),     # more rows than a block's tiles
    (8, 384, 100, "bf16"),      # n not a multiple of 8
    (8, 120, 40, "s8"),         # k not a multiple of 32
    (8, 128, 96, "tf32"),       # k not a multiple of n
    (8, 128, 128, "fp8"),       # no such type
])
def test_chain_refuses_bad_shapes(m, k, n, dtype):
    with pytest.raises(ValueError, match="mma_chain"):
        mma_chain.mma_chain(torch.zeros(m, k), torch.zeros(k, n), 1, dtype)


def test_chain_refuses_bad_types_and_steps():
    x, w = torch.zeros(8, 128), torch.zeros(128, 128)
    with pytest.raises(ValueError, match="float32"):
        mma_chain.mma_chain(x.double(), w, 1, "f32")
    with pytest.raises(ValueError, match="iters"):
        mma_chain.mma_chain(x, w, 0, "f32")


def test_chain_smem_fits_the_h100():
    """Every probe shape and type fits one block's shared memory; the
    one-hot shape's f32 w alone takes 196,608 bytes."""
    for m, k, n in mma_chain.SHAPES.values():
        for dtype in mma_chain.DTYPES:
            assert mma_chain.smem_bytes(m, k, n, dtype) <= mma_chain.SMEM_LIMIT
    assert mma_chain.smem_bytes(8, 384, 128, "tf32") == 16 * 388 * 4 + (
        128 * 388 * 4)


def _transpose_128(x_ref, o_ref):
    x = x_ref[...]                      # [8, 128]
    o_ref[...] = x.T                    # [128, 8]


def _transpose_64(x_ref, o_ref):
    x = x_ref[:, 0:64]                  # [8, 64] slice
    o_ref[...] = x.T                    # [64, 8]


@pytest.mark.parametrize("kernel,cols", [(_transpose_128, 128),
                                         (_transpose_64, 64)])
def test_transpose_matches_jax_probe_kernel(kernel, cols):
    x = np.random.default_rng(0).random((8, 128)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((cols, 8), jnp.float32),
        interpret=True)(jnp.asarray(x)))
    got = planes.transpose(torch.as_tensor(x), cols)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_transpose_takes_other_shapes():
    """A block the probe does not time, [16, 48] -> its first 40 columns
    transposed, through the plain version on the CPU (the runtime-shape
    kernel on the card)."""
    rows, ld, cols = planes.OTHER_TRANSPOSE
    x = np.random.default_rng(2).random((rows, ld)).astype(np.float32)
    got = planes.transpose(torch.as_tensor(x), cols)
    assert got.shape == (cols, rows) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), x[:, :cols].T)


def _jax_vectors():
    plane, cols, t = planes.probe_vectors(SLOTS, device="cpu")
    return (plane, cols, t, jnp.asarray(plane.numpy()),
            [jnp.asarray(c.numpy()) for c in cols], jnp.asarray(t.numpy()))


@pytest.mark.parametrize("k", [8, 4])
def test_column_writer_matches_at_set(k):
    plane, cols, _, jp, jcols, _ = _jax_vectors()
    for j, c in enumerate(jcols[:k]):
        jp = jp.at[:, j].set(c * 1.0000001)
    got = planes.write_columns(plane, cols[:k])
    assert got is plane
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp))


def test_rebuild_matches_stack():
    _, cols, _, _, jcols, _ = _jax_vectors()
    cs = [c * 1.0000001 for c in jcols]
    want = np.asarray(jnp.stack(cs + cs, axis=-1))
    np.testing.assert_array_equal(planes.rebuild(cols).numpy(), want)


@pytest.mark.parametrize("k", [4, 8])
def test_row_writer_matches_at_set(k):
    _, cols, t, _, jcols, jt = _jax_vectors()
    for j, c in enumerate(jcols[:k]):
        jt = jt.at[j, :].set(c * 1.0000001)
    np.testing.assert_array_equal(planes.write_rows(t, cols[:k]).numpy(),
                                  np.asarray(jt))


def test_plane_writers_refuse_bad_shapes():
    plane, cols, t = planes.probe_vectors(64, device="cpu")
    with pytest.raises(ValueError, match="write_columns"):
        planes.write_columns(plane, cols[:3])
    with pytest.raises(ValueError, match="write_columns"):
        planes.write_columns(plane[:, :8].contiguous(), cols)
    with pytest.raises(ValueError, match="rebuild"):
        planes.rebuild(cols[:4])
    with pytest.raises(ValueError, match="rebuild"):
        planes.rebuild([c.double() for c in cols])
    with pytest.raises(ValueError, match="write_rows"):
        planes.write_rows(t, [c[:32] for c in cols[:4]])
    with pytest.raises(ValueError, match="transpose"):
        planes.transpose(torch.zeros(8, 128), 129)
    with pytest.raises(ValueError, match="transpose"):
        planes.transpose(torch.zeros(8, 128, dtype=torch.float64), 64)


def test_cpu_tensors_take_the_plain_versions():
    """No launch is counted on CPU tensors."""
    plane, cols, t = planes.probe_vectors(64, device="cpu")
    fns = (planes.transpose, planes.write_columns, planes.rebuild,
           planes.write_rows, mma_chain.mma_chain)
    for fn in fns:
        fn.launches = 0
    planes.transpose(torch.zeros(8, 128), 64)
    planes.write_columns(plane, cols)
    planes.rebuild(cols)
    planes.write_rows(t, cols[:4])
    mma_chain.mma_chain(torch.zeros(8, 128), torch.zeros(128, 128), 1, "s8")
    assert [fn.launches for fn in fns] == [0] * len(fns)


def _c_entry_args(name):
    """The parameter types of ``extern "C" int name(...)`` in csrc/."""
    for src in cuda_build.CSRC_DIR.glob("*.cu"):
        text = src.read_text()
        at = text.find(f'extern "C" int {name}(')
        if at >= 0:
            params = text[text.index("(", at) + 1:text.index(")", at)]
            return [" ".join(p.split()[:-1]) for p in params.split(",")]
    raise AssertionError(f"no C entry {name} in {cuda_build.CSRC_DIR}")


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_c_entry_matches_its_signature(name):
    """One code a parameter before the trailing stream: "p" a pointer,
    "i" an int."""
    args = _c_entry_args(name)
    assert args[-1] == "void*"
    codes = "".join("p" if t.endswith("*") else "i" if t == "int" else "?"
                    for t in args[:-1])
    assert codes == cuda_build.SIGNATURES[name]


@pytest.mark.parametrize("got,want,err", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([1.0, 2.5], [1.0, 2.0], 0.5),
    ([float("inf"), 3.0], [float("inf"), 1.0], 2.0),
    ([float("nan"), 1.0], [float("nan"), 1.0], 0.0),
    ([float("inf"), 1.0], [5.0, 1.0], float("inf")),
    ([float("inf")], [float("inf")], 0.0),
])
def test_max_abs_err(got, want, err):
    assert max_abs_err(torch.tensor(got), torch.tensor(want)) == err
