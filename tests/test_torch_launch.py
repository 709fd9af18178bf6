"""The launch path of the port's CUDA kernels (``utils/cuda_build.py``), on
the CPU.

``check_tensors`` reaches each of its messages with CPU and meta tensors
(and, for the one-device check, stand-ins that report a CUDA device), in
the order dtype, shape, contiguity, CUDA, one device.  Every entry point
of ``SIGNATURES`` binds to ``c_void_p`` for each pointer and the trailing
stream, ``c_int`` for each int and ``c_double`` for each double.
``launch`` itself, with the library and torch's CUDA calls replaced by
recorders: the raw stream of the device, the device guard only off the
current device, a non-zero CUDA error raised, an unknown entry point
refused.  No kernel wrapper reaches
``check_tensors`` or ``launch`` on CPU tensors: the three bucketed and
dense rollouts and every probe run with both replaced by functions that
fail, and each wrapper's plain version runs instead.
``profile_step.kernel_device_ms``, with its profiler sessions replaced:
a mean over the launches recorded, short sessions retaken, and a refusal
where the calls launch more than one kernel; ``profile_step.kernel_stats``
on a made-up event list, the device mirrors of host annotations left out.
One test needs the card
and skips without one.
"""

import contextlib
import ctypes
import types

import pytest
import torch

from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.ops import pack, spill
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as zd
from rmf_crowdsim_tpu_torch.probes import k1_stages, launch, mma_chain, planes
from rmf_crowdsim_tpu_torch.utils import cuda_build, profile_step

N = 1024
DT = 1.0 / 60.0


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CudaStandIn:
    """What ``check_tensors`` reads of a contiguous f32 CUDA tensor on
    device ``index``."""

    dtype = torch.float32
    is_cuda = True

    def __init__(self, shape, index):
        self.shape = torch.Size(shape)
        self.index = index
        self.device = torch.device("cuda", index)

    def is_contiguous(self):
        return True

    def get_device(self):
        return self.index


@pytest.mark.parametrize("t,match", [
    (torch.zeros(4, dtype=torch.float64), r"a must be torch.float32, got "
                                          r"torch.float64"),
    (torch.zeros(5), r"a must have shape \(4,\), got \(5,\)"),
    (torch.zeros(8)[::2], "a must be contiguous"),
    (torch.zeros(4), "a must be a CUDA tensor, got cpu"),
    (torch.zeros(4, device="meta"), "a must be a CUDA tensor, got meta"),
])
def test_check_tensors_messages(t, match):
    with pytest.raises(ValueError, match=f"^caller: {match}"):
        cuda_build.check_tensors("caller", a=(t, torch.float32, (4,)))


def test_check_tensors_order():
    """A tensor wrong in dtype, shape, layout and device is refused for
    its dtype; given the right dtype, for its shape; then for its layout;
    then for its device."""
    bad = torch.zeros(6, dtype=torch.float64)[::2]
    for t, dtype, shape, match in (
            (bad, torch.float32, (4,), "must be torch.float32"),
            (bad, torch.float64, (4,), "must have shape"),
            (bad, torch.float64, (3,), "must be contiguous"),
            (bad.contiguous(), torch.float64, (3,), "must be a CUDA tensor")):
        with pytest.raises(ValueError, match=f"^c: a {match}"):
            cuda_build.check_tensors("c", a=(t, dtype, shape))


def test_check_tensors_one_device():
    cuda_build.check_tensors("c", a=(CudaStandIn((4,), 0), torch.float32,
                                     (4,)),
                             b=(CudaStandIn((2, 3), 0), torch.float32,
                                (2, 3)))
    with pytest.raises(ValueError, match="^c: tensors on several devices"):
        cuda_build.check_tensors(
            "c", a=(CudaStandIn((4,), 0), torch.float32, (4,)),
            b=(CudaStandIn((4,), 1), torch.float32, (4,)))


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_signature_argtypes(name):
    sig = cuda_build.SIGNATURES[name]
    got = cuda_build.argtypes(sig)
    assert len(got) == len(sig) + 1
    assert got[-1] is ctypes.c_void_p
    for code, t in zip(sig, got):
        assert t is {"p": ctypes.c_void_p, "i": ctypes.c_int,
                     "d": ctypes.c_double}[code]


def test_noop_binds_the_stream_alone():
    assert cuda_build.SIGNATURES["crowdsim_noop"] == ""
    assert cuda_build.argtypes("") == [ctypes.c_void_p]
    with pytest.raises(KeyError):
        cuda_build.argtypes("pf")


class Recorder:
    """A bound entry point that records its arguments and returns
    ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def fake_cuda(monkeypatch):
    """``launch`` with its library and torch's CUDA calls replaced: the
    current device 0, the raw stream 1000 + the device, and a recorded
    device guard."""
    guards = []

    @contextlib.contextmanager
    def guard(index):
        guards.append(index)
        yield

    class Lib:
        @staticmethod
        def crowdsim_error_string(err):
            return f"error {err}".encode()

    monkeypatch.setattr(cuda_build, "library", lambda: Lib)
    monkeypatch.setattr(cuda_build, "_LAUNCHERS", {})
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", guard)
    return guards


def test_launch_passes_the_raw_stream(fake_cuda):
    rec = Recorder()
    cuda_build._LAUNCHERS["crowdsim_noop"] = rec
    cuda_build.launch("crowdsim_noop", device=0)
    assert rec.calls == [(1000,)] and fake_cuda == []
    cuda_build.launch("crowdsim_noop", device=1)
    assert rec.calls[-1] == (1001,) and fake_cuda == [1]


def test_launch_passes_ints_and_nulls(fake_cuda):
    rec = Recorder()
    cuda_build._LAUNCHERS["crowdsim_transpose"] = rec
    cuda_build.launch("crowdsim_transpose", None, None, 8, 64, 128, device=0)
    assert rec.calls == [(None, None, 8, 64, 128, 1000)]


def test_launch_raises(fake_cuda):
    cuda_build._LAUNCHERS["crowdsim_noop"] = Recorder(err=700)
    with pytest.raises(RuntimeError, match=r"crowdsim_noop: CUDA error 700 "
                                           r"\(error 700\)"):
        cuda_build.launch("crowdsim_noop", device=0)
    with pytest.raises(ValueError, match="no C entry point 'crowdsim_nope'"):
        cuda_build.launch("crowdsim_nope", device=0)
    cuda_build._LAUNCHERS["crowdsim_transpose"] = Recorder()
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        cuda_build.launch("crowdsim_transpose", torch.zeros(4),
                          torch.zeros(4), 1, 1, 1)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        launch.noop(torch.device("cpu"))


def test_transpose_refuses_other_devices():
    """The transpose's inline check of a CUDA, contiguous block leaves a
    tensor that is neither on the CPU nor on a card to check_tensors,
    which refuses it with its own message."""
    with pytest.raises(ValueError, match="^transpose: x must be a CUDA "
                                         "tensor, got meta"):
        planes.transpose(torch.zeros(8, 128, device="meta"), 64)


def _refuse(*args, **kw):
    raise AssertionError("a wrapper reached the launch path on CPU tensors")


def _count(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)


def test_no_wrapper_reaches_the_launcher_on_cpu(monkeypatch):
    """The five simulator kernels through their rollouts (grid_pallas,
    fused spills, grid_dense; each wrapper's plain version counted) and
    every probe wrapper called directly, with ``check_tensors`` and
    ``launch`` failing: all on their plain versions, no launch counted."""
    monkeypatch.setattr(cuda_build, "check_tensors", _refuse)
    monkeypatch.setattr(cuda_build, "launch", _refuse)
    calls = {}
    for module, name in ((pack, "pack_rows_plain"),
                         (zb, "forces_bucketed_plain"),
                         (zb, "forces_bucketed_spill_plain"),
                         (spill, "spill_window_plain"),
                         (zd, "forces_dense_plain"),
                         (k1_stages, "k1_stage_plain"),
                         (mma_chain, "mma_chain_plain"),
                         (mma_chain, "mma_link_plain")):
        _count(monkeypatch, module, name, calls)
    wrappers = (pack.pack_rows, zb.zanlungo_forces_bucketed,
                zb.zanlungo_forces_bucketed_spill, spill.spill_window,
                zd.zanlungo_forces_dense, k1_stages.k1_stage,
                mma_chain.mma_chain, mma_chain.mma_link, planes.transpose,
                planes.write_columns, planes.rebuild, planes.write_rows,
                launch.noop)
    for fn in wrappers:
        fn.launches = 0

    for kw in (dict(backend="grid_pallas"),
               dict(backend="grid_pallas", fused_spills=True),
               dict(backend="grid_dense")):
        rollout, params, st = scenes.build_bench(N, device="cpu",
                                                 hotspot=True, **kw)
        st, c = rollout(params, st, DT, 2)
        assert bool(torch.isfinite(st.position).all())
        assert int(c.neighbor_truncated.max()) == 0

    _, cfg, params, *_, feat_t, bpos, _ = scenes.bench_bucketed(
        N, device="cpu")
    packed_t, packed_T, _ = pack.pack_rows(feat_t, bpos, cfg.slots)
    k1_stages.k1_stage(cfg, zb.zparams5(params.lp[0]), packed_t, packed_T,
                       "full")
    mma_chain.mma_chain(torch.zeros(8, 128), torch.zeros(128, 128), 1, "s8")
    mma_chain.mma_link(torch.empty(32, 4), 3, "bf16")
    plane, cols, t = planes.probe_vectors(64, device="cpu")
    planes.transpose(torch.zeros(8, 128), 64)
    planes.write_columns(plane, cols)
    planes.rebuild(cols)
    planes.write_rows(t, cols[:4])

    assert set(calls) == {"pack_rows_plain", "forces_bucketed_plain",
                          "forces_bucketed_spill_plain",
                          "spill_window_plain", "forces_dense_plain",
                          "k1_stage_plain", "mma_chain_plain",
                          "mma_link_plain"}, calls
    assert [fn.launches for fn in wrappers] == [0] * len(wrappers)


def _fake_profiles(monkeypatch, tops):
    """``kernel_device_ms`` with its profiler sessions replaced: the i-th
    session returns ``tops[i]`` as its (ms a call, launches a call, name)
    rows; returns the list of sessions taken."""
    sessions = []

    def device_kernels(run, steps, top=15):
        run()
        sessions.append(steps)
        return {"top": tops[len(sessions) - 1]}

    monkeypatch.setattr(profile_step, "device_kernels", device_kernels)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return sessions


def test_kernel_device_ms_is_a_time_a_call(monkeypatch):
    # 3 of 4 launches recorded: the mean over those; another kernel of
    # another name is left out.
    _fake_profiles(monkeypatch, [[(0.003, 0.75, "spill_window_kernel"),
                                  (0.5, 1.0, "elementwise")]])
    calls = []
    got = profile_step.kernel_device_ms(lambda: calls.append(1), 4,
                                        "spill_window")
    assert got == pytest.approx(0.004)
    assert len(calls) == 1 + 4   # a warm-up, then the profiled calls


def test_kernel_device_ms_retakes_short_sessions(monkeypatch):
    sessions = _fake_profiles(monkeypatch, [[], [(0.001, 0.25, "k")],
                                            [(0.002, 1.0, "k")]])
    assert profile_step.kernel_device_ms(lambda: None, 4, "k") == 0.002
    assert len(sessions) == profile_step.PROFILE_TRIES == 3
    _fake_profiles(monkeypatch, [[(0.001, 0.25, "k")]] * 3)
    with pytest.raises(AssertionError, match="fewer than half"):
        profile_step.kernel_device_ms(lambda: None, 4, "k")


@pytest.mark.parametrize("top", [
    [(0.002, 1.0, "copy_a"), (0.002, 1.0, "copy_b")],   # two kernels
    [(0.004, 2.0, "copy_a")],                          # twice a call
])
def test_kernel_device_ms_refuses_several_launches_a_call(monkeypatch,
                                                          top):
    # With '' (any kernel) a call that launches two kernels, or one
    # twice, has no single kernel's time a call: it raises rather than
    # return a mean over launches.
    _fake_profiles(monkeypatch, [top])
    with pytest.raises(AssertionError, match="more than one kernel"):
        profile_step.kernel_device_ms(lambda: None, 4, "")


def test_kernel_stats_leave_out_annotation_mirrors():
    """The profiler mirrors each ``record_function`` span onto the
    device's timeline as an event on CUDA; it is no kernel and no busy
    time.  Two steps: two launches of ``k1`` and one of ``k3``, under a
    ``crowdsim.step`` span and its phase."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, us, device=cuda, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=device, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(elapsed_us=lambda: us))

    events = [ev("crowdsim.step", 900.0, cpu, True),
              ev("crowdsim.step", 800.0, annotation=True),
              ev("crowdsim.step.force_pass", 500.0, annotation=True),
              ev("cudaLaunchKernel", 5.0, cpu),
              ev("k1", 400.0), ev("k1", 200.0), ev("k3", 100.0)]
    got = profile_step.kernel_stats(events, steps=2)
    assert got["launches_per_step"] == 1.5
    assert got["device_busy_ms"] == pytest.approx(0.35)
    assert [(n, k) for _, n, k in got["top"]] == [(1.0, "k1"), (0.5, "k3")]
    assert [ms for ms, _, _ in got["top"]] == pytest.approx([0.3, 0.05])


@pytest.mark.card
def test_launches_on_the_card():
    """On a card: the empty kernel and the three transpose kernels launch
    through the bound launcher, each transpose bitwise its plain version,
    and the writers at ``planes.OTHER_SLOTS`` (a ragged last chunk, and
    the per-slot kernel) bitwise theirs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    n0 = launch.noop.launches
    launch.noop(dev)
    torch.cuda.synchronize()
    assert launch.noop.launches == n0 + 1
    x = torch.rand((16, 128), device=dev)
    for rows, cols in ((8, 128), (8, 64), (16, 40)):
        src = x[:rows].contiguous()
        assert torch.equal(planes.transpose(src, cols),
                           planes.transpose_plain(src, cols))
    for slots in planes.OTHER_SLOTS:
        plane, vecs, t = planes.probe_vectors(slots, device=dev)
        for _, kernel, plain, _, _ in planes._writers(plane, vecs,
                                                      t).values():
            assert torch.equal(kernel(), plain())


@pytest.mark.card
def test_mma_chain_on_the_card():
    """On a card: P3 in every shape and type on the straddling
    inputs at 1, 2 and 3 steps, and each type's link at 1-3 links, bitwise
    their plain versions (``mma_chain.check``); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    n0, l0 = mma_chain.mma_chain.launches, mma_chain.mma_link.launches
    n = mma_chain.check(dev, iters=(1, 2, 3))
    per_set = len(mma_chain.SHAPES) * len(mma_chain.DTYPES)
    assert n == 2 * 3 * per_set + 3 * len(mma_chain.DTYPES)
    assert mma_chain.mma_chain.launches - n0 == 2 * 3 * per_set
    assert mma_chain.mma_link.launches - l0 == 3 * len(mma_chain.DTYPES)
