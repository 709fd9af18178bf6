"""Checkpoint / resume in the port (``utils/checkpoint.py`` and
``Simulation.save``/``load``) against the JAX package's.

The scenarios of tests/test_checkpoint.py but the orbax one: a
``PoissonCrowd`` session saved mid-run resumes bitwise in a fresh session
(the ``torch.Generator``'s state is in the checkpoint), and a checkpoint of
another capacity is refused.  Then the dtype guard, and the port's saved
fields against the JAX package's ``save_state`` fields after the same
``MonotonicCrowd`` session, field for field (all but the JAX ``rng_key``
and the port's generator, which have no counterpart).
"""

import numpy as np
import pytest
import torch

import rmf_crowdsim_tpu as J
import rmf_crowdsim_tpu_torch as T
from rmf_crowdsim_tpu.utils import checkpoint as jckpt
from rmf_crowdsim_tpu_torch.core.state import STATE_TENSOR_FIELDS
from rmf_crowdsim_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: at these sizes it is about as fast as
    many, and far faster when the suite's parallel workers share the
    cores (each worker's thread pool would otherwise claim them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_sim(pkg, crowd, seed=3, capacity=32):
    cfg = pkg.SimConfig(
        capacity=capacity,
        grid=pkg.GridConfig(100.0, 100.0, 5.0, (-50.0, -50.0)),
        neighbor_backend="brute",
        dtype="float64",
    )
    sim = (pkg.Simulation(cfg, seed=seed, device="cpu") if pkg is T
           else pkg.Simulation(cfg, seed=seed))
    sim.add_source_sink(pkg.SourceSink(
        source=(0.0, 0.0), waypoints=[(10.0, 0.0)], radius_sink=1.0,
        crowd_generator=crowd(pkg), high_level_planner=pkg.ConstantVelocity(
            (1.0, 0.0)),
        local_planner=pkg.NoLocalPlan(), agent_eyesight_range=5.0))
    return sim


def poisson(pkg):
    return pkg.PoissonCrowd(1.5)


def snapshot(sim):
    return {k: v.position for k, v in sim.agents.items()}


def test_checkpoint_roundtrip_resumes_bitwise(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    sim = make_sim(T, poisson)
    for _ in range(7):
        sim.step(0.5)
    sim.save(path)
    t_saved = sim.sim_time
    uid_saved = int(sim.state.next_uid)
    for _ in range(5):
        sim.step(0.5)
    a = snapshot(sim)
    assert max(a) >= uid_saved  # the generator drew spawns after the save

    sim2 = make_sim(T, poisson, seed=11)
    sim2.load(path)
    assert sim2.sim_time == t_saved
    assert torch.equal(sim2.state.generator.get_state(),
                       torch.from_numpy(np.load(path)["generator"]))
    for _ in range(5):
        sim2.step(0.5)
    b = snapshot(sim2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))

    # Without the generator's state the same checkpoint draws other
    # spawns: the saved state is what makes the resume bitwise.
    sim3 = make_sim(T, poisson)
    sim3.load(path)
    sim3.state.generator.manual_seed(12345)
    for _ in range(5):
        sim3.step(0.5)
    assert snapshot(sim3).keys() != a.keys()


def test_capacity_mismatch_rejected(tmp_path):
    """Both packages refuse a checkpoint of another capacity."""
    for pkg, path in ((J, tmp_path / "j.npz"), (T, tmp_path / "t.npz")):
        sim = make_sim(pkg, poisson)
        sim.save(str(path))
        other = make_sim(pkg, poisson, capacity=64)
        with pytest.raises(ValueError, match="capacity"):
            other.load(str(path))


def _rewrite(path, out, **fields):
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays.update(fields)
    for k, v in list(arrays.items()):
        if v is None:
            del arrays[k]
    np.savez(out, **arrays)


@pytest.mark.parametrize("field,value,match", [
    ("uid", lambda a: a.astype(np.int64), "wrong dtype"),
    ("velocity", lambda a: a.astype(np.float32), "wrong dtype"),
    ("alive", lambda a: a.astype(np.int32), "wrong dtype"),
    ("generator", lambda a: a.astype(np.int64), "wrong dtype"),
    ("position", lambda a: a.astype(np.float16), "float32 or float64"),
    ("generator", lambda a: None, "missing"),
])
def test_dtype_guard_refuses_a_silent_dtype_change(tmp_path, field, value,
                                                   match):
    """A checkpoint whose fields would change the state's dtypes (torch
    promotes mixed dtypes without a word) or that lacks a field is
    refused; the unchanged checkpoint loads."""
    path = str(tmp_path / "ckpt.npz")
    sim = make_sim(T, poisson)
    sim.step(0.5)
    sim.save(path)
    tckpt.load_state(path, device="cpu")
    with np.load(path) as data:
        changed = value(data[field])
    bad = str(tmp_path / "bad.npz")
    _rewrite(path, bad, **{field: changed})
    with pytest.raises(ValueError, match=match):
        tckpt.load_state(bad, device="cpu")


def monotonic(pkg):
    return pkg.MonotonicCrowd(1.0)


def test_saved_fields_match_jax_save_state(tmp_path):
    """The same MonotonicCrowd session in both packages saves the same
    arrays, dtype and value, field for field."""
    saved = {}
    for pkg, path in ((J, tmp_path / "j.npz"), (T, tmp_path / "t.npz")):
        sim = make_sim(pkg, monotonic)
        for _ in range(15):
            sim.step(0.5)
        (jckpt if pkg is J else tckpt).save_state(str(path), sim.state)
        with np.load(path) as data:
            saved[pkg] = {k: data[k] for k in data.files}
    assert set(saved[J]) - set(saved[T]) == {"rng_key"}
    assert set(saved[T]) - set(saved[J]) == {"generator"}
    assert saved[T]["alive"].sum() > 5
    for name in STATE_TENSOR_FIELDS:
        assert saved[T][name].dtype == saved[J][name].dtype, name
        np.testing.assert_array_equal(saved[T][name], saved[J][name],
                                      err_msg=name)
    assert saved[T]["generator"].dtype == np.uint8
