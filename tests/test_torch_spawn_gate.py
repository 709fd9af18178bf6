"""The spawn clearance gate (``ops/spawn_gate.py``, G1).

On the CPU, the plain version against a numpy oracle of the same
arithmetic (every pair at once, each operation rounded in the position
dtype): agents planted at a rounded distance of exactly the clearance
(not blocking) and one ulp inside (blocking) and outside it, a dead agent
on a source, an alive agent at NaN; S = 1, 63, 64, 65 and 1,025 sources
over a slot count that is no multiple of the kernel's block.  The
kernel's threshold against the square root over the floats around it,
for ordinary, tiny, huge and degenerate clearances.  The dispatch: CPU
tensors take the plain version and launch nothing; the wrapper's checks
refuse what the kernel does not take.

On a card (marker ``card``; skips without one), the kernel bit for bit
against the plain version on the card: seeded scenes with planted edges
in f32 and f64 (up to 4,100 sources, past the kernel's staged chunk),
the 1M streaming scene of ``scenes.build_streams`` (1,024 sources), the
world engine's psum path, one launch a gate call, misaligned rows
refused.  Run there with ``python -m pytest --noconftest -m card
tests/test_torch_spawn_gate.py -q``.

Kept apart from the JAX package: the card has none.  The gate's
decisions against JAX are ``tests/test_torch_sources.py``'s.
"""

import math
from decimal import Decimal, localcontext

import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu_torch import scenes
from rmf_crowdsim_tpu_torch.core import step as tstep
from rmf_crowdsim_tpu_torch.ops import spawn_gate as sg
from rmf_crowdsim_tpu_torch.utils import cuda_build

from test_torch_launch import CudaStandIn

CLEARANCE = 0.4
# Slots a block of csrc/spawn_gate.cu covers (256 threads x 8 slots).
BLOCK_SLOTS = 2048
N_SLOTS = 2 * BLOCK_SLOTS + 37
NP = {torch.float32: np.float32, torch.float64: np.float64}
KINDS = ("inside", "tie", "outside", "dead")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def edge_agent(sx, sy, r, c, f, exact=True):
    """An (x, y) of numpy type ``f`` whose distance to (sx, sy), in the
    plain arithmetic of ``f``, rounds to exactly ``r``: x a few ulps
    inside sx + r, y searched around the exact solution.  Far from the
    origin few distances near ``c`` can be reached; there, unless
    ``exact``, the point found whose rounded distance is nearest ``r``
    on its side of ``c`` (below it for r < c, else not below r)."""
    best = None
    with localcontext() as ctx:
        ctx.prec = 60
        x = f(sx + r)
        for _ in range(6):
            x = np.nextafter(x, f(-np.inf))
            dx = Decimal(float(x - sx))
            rest = Decimal(float(r)) ** 2 - dx * dx
            y0 = f(float(Decimal(float(sy)) + max(rest, Decimal(0)).sqrt()))
            ys = [y0]
            for end in (np.inf, -np.inf):
                y = y0
                for _ in range(16):
                    y = np.nextafter(y, f(end))
                    ys.append(y)
            ys = np.array(ys, f)
            got = np.sqrt((x - sx) * (x - sx) + (ys - sy) * (ys - sy))
            hit = np.flatnonzero(got == r)
            if len(hit):
                return x, ys[hit[0]]
            side = got < c if r < c else got >= r
            for i in np.flatnonzero(side):
                if best is None or abs(got[i] - r) < abs(best[2] - r):
                    best = (x, ys[i], got[i])
    if exact or best is None:
        raise AssertionError(f"no point at rounded distance {r} of {sx, sy}")
    return best[:2]


def oracle(pos, alive, src, clearance):
    """[S] bool in numpy: every (source, slot) pair in the type of
    ``pos``, dead slots left out."""
    c = pos.dtype.type(clearance)
    with np.errstate(invalid="ignore", over="ignore"):
        dx = pos[None, :, 0] - src[:, None, 0]
        dy = pos[None, :, 1] - src[:, None, 1]
        hit = np.sqrt(dx * dx + dy * dy) < c
    return (hit & alive[None, :]).any(1)


def plant(pos, alive, src, kinds, clearance, rng, exact=True):
    """One agent a source into distinct random slots: ``inside`` alive at
    a rounded distance one ulp below the clearance, ``tie`` at exactly
    it, ``outside`` one ulp above (``edge_agent``'s ``exact``), ``dead`` a
    dead agent on the source; and one alive agent at NaN."""
    f = pos.dtype.type
    c = f(clearance)
    radius = {"inside": np.nextafter(c, f(0)), "tie": c,
              "outside": np.nextafter(c, f(np.inf))}
    slots = rng.choice(len(pos), size=len(src) + 1, replace=False)
    for slot, (sx, sy), kind in zip(slots, src, kinds):
        if kind == "dead":
            pos[slot], alive[slot] = (sx, sy), False
        else:
            pos[slot] = edge_agent(sx, sy, radius[kind], c, f, exact)
            alive[slot] = True
    pos[slots[-1]], alive[slots[-1]] = (np.nan, np.nan), True


def random_scene(n, s, seed, f=np.float32, clearance=CLEARANCE):
    """``s`` sources and ``n`` slots (80% alive) uniform in a square where
    about one source in four is blocked by chance, then one planted
    agent a source, the kinds in turn: (position, alive, sources)."""
    rng = np.random.default_rng(seed)
    half = 0.5 * math.sqrt(n * math.pi * clearance**2 / 0.4)
    src = rng.uniform(-half, half, (s, 2)).astype(f)
    pos = rng.uniform(-half, half, (n, 2)).astype(f)
    alive = rng.random(n) < 0.8
    plant(pos, alive, src, [KINDS[i % 4] for i in range(s)], clearance, rng)
    return pos, alive, src


def lattice_scene(s, f, clearance):
    """``s`` sources 5 clearances apart, one planted agent each (kinds in
    turn), every other slot dead and far away: source i is blocked
    exactly when its kind is ``inside``."""
    rng = np.random.default_rng(7)
    i = np.arange(s)
    src = (5 * clearance * np.stack([i % 8, i // 8], 1) + 1.5).astype(f)
    pos = np.full((N_SLOTS, 2), -1e3, f)
    alive = np.zeros(N_SLOTS, bool)
    kinds = [KINDS[k % 4] for k in i]
    plant(pos, alive, src, kinds, clearance, rng)
    return (pos, alive, src), np.array([k == "inside" for k in kinds])


def gate(fn, scene, device="cpu", clearance=CLEARANCE):
    pos, alive, src = (torch.from_numpy(a).to(device) for a in scene)
    return fn(pos, alive, src, clearance).cpu().numpy()


@pytest.mark.parametrize("clearance", [0.4, 1.0, 2.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_at_the_edge(dtype, clearance):
    """An agent at exactly the clearance does not block (the test is
    strict), one ulp inside does, one ulp outside does not; a dead agent
    on the source and an alive one at NaN block nothing."""
    scene, want = lattice_scene(64, NP[dtype], clearance)
    got = gate(sg.spawn_blocked_plain, scene, clearance=clearance)
    assert got.dtype == bool and got.shape == (64,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(oracle(*scene, clearance), want)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 1025])
def test_plain_matches_the_oracle(s):
    """S around the plain version's 64-source passes, over 2 x 2,048 + 37
    slots, with the planted edges among random agents."""
    scene = random_scene(N_SLOTS, s, seed=s)
    want = oracle(*scene, CLEARANCE)
    np.testing.assert_array_equal(gate(sg.spawn_blocked_plain, scene), want)
    if s >= 63:
        assert 0 < want.sum() < s


def floats_around(t, dtype, k=64):
    """The 2k + 1 values of ``dtype`` nearest the positive finite ``t``,
    in order."""
    f, i = {torch.float32: (np.float32, np.int32),
            torch.float64: (np.float64, np.int64)}[dtype]
    bits = np.array(t, f).view(i) + np.arange(-k, k + 1, dtype=i)
    return torch.from_numpy(bits[bits >= 0].view(f))


@pytest.mark.parametrize("clearance", [0.4, 0.7, 1.0, 2.5, 1e-3, 3e-20,
                                       1e20, math.inf, 0.0, -1.0, math.nan])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_threshold_decides_as_the_square_root(dtype, clearance):
    """For every d2 among the floats around the threshold t, and at 0,
    the least subnormal, 1, the largest float, inf and NaN: ``sqrt(d2) <
    c`` (c the clearance rounded to the dtype) exactly when ``d2 < t``;
    and t is the least such value."""
    t = sg.clearance_threshold(clearance, dtype)
    info = torch.finfo(dtype)
    special = torch.tensor([0.0, info.smallest_normal * info.eps, 1.0,
                            info.max, math.inf, math.nan], dtype=dtype)
    d2 = special
    if 0 < t < math.inf:
        d2 = torch.cat([floats_around(t, dtype), special])
        c = torch.tensor(clearance, dtype=dtype)
        assert torch.sqrt(torch.tensor(t, dtype=dtype)) >= c
        below = torch.nextafter(torch.tensor(t, dtype=dtype),
                                torch.zeros((), dtype=dtype))
        assert torch.sqrt(below) < c
    assert torch.equal(torch.sqrt(d2) < clearance,
                       d2 < torch.tensor(t, dtype=dtype))


def test_threshold_at_the_configured_clearance():
    """The default clearance, 0.4, in f32: c = 0.4000000059604645; t is
    an f32 within an ulp of c * c."""
    t = sg.clearance_threshold(0.4, torch.float32)
    assert float(np.float32(t)) == t
    c = float(np.float32(0.4))
    assert abs(t - c * c) <= float(np.spacing(np.float32(c * c)))


def _refuse(*args, **kw):
    raise AssertionError("the gate reached the launch path on CPU tensors")


def _direct():
    scene = random_scene(N_SLOTS, 65, seed=3)
    got = gate(sg.spawn_blocked, scene)
    np.testing.assert_array_equal(got, oracle(*scene, CLEARANCE))
    return 1


def _streams_rollout():
    rollout, params, st = scenes.build_streams(4000, 4096, 16, device="cpu")
    st, c = rollout(params, st, 1.0 / 60.0, 3)
    assert int(c.n_spawned.sum()) > 0
    return 3


@pytest.mark.parametrize("caller", [_direct, _streams_rollout],
                         ids=["direct", "streams_rollout"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, caller):
    """On CPU tensors the wrapper (the one the step calls) runs the plain
    version once a call and never reaches ``check_tensors`` or
    ``launch``; its launch count stays 0."""
    assert tstep.spawn_blocked is sg.spawn_blocked
    monkeypatch.setattr(cuda_build, "check_tensors", _refuse)
    monkeypatch.setattr(cuda_build, "launch", _refuse)
    calls = []
    plain = sg.spawn_blocked_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(sg, "spawn_blocked_plain", counted)
    monkeypatch.setattr(sg.spawn_blocked, "launches", 0)
    assert len(calls) == 0
    assert caller() == len(calls)
    assert sg.spawn_blocked.launches == 0


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cuda(shape, dtype=torch.float32):
    """What the checks read of a contiguous CUDA tensor on device 0."""
    t = CudaStandIn(shape, 0)
    t.dtype = dtype
    return t


@pytest.mark.parametrize("args,match", [
    ((_meta((8, 2), torch.bfloat16), _meta(8, torch.bool), _meta((4, 2))),
     "position must be torch.float32, got torch.bfloat16"),
    ((_meta((8, 3)), _meta(8, torch.bool), _meta((4, 2))),
     r"position must have shape \(8, 2\), got \(8, 3\)"),
    ((_meta((2, 8)).t(), _meta(8, torch.bool), _meta((4, 2))),
     "position must be contiguous"),
    ((_meta((8, 2)), _meta(8, torch.bool), _meta((4, 2))),
     "position must be a CUDA tensor, got meta"),
    ((_cuda((8, 2)), _meta(8, torch.uint8), _meta((4, 2))),
     "alive must be torch.bool, got torch.uint8"),
    ((_cuda((8, 2)), _meta(7, torch.bool), _meta((4, 2))),
     r"alive must have shape \(8,\), got \(7,\)"),
    ((_cuda((8, 2), torch.float64), _cuda((8,), torch.bool), _meta((4, 2))),
     "sources must be torch.float64, got torch.float32"),
    ((_cuda((8, 2)), _cuda((8,), torch.bool), _meta((4, 3))),
     r"sources must have shape \(4, 2\), got \(4, 3\)"),
], ids=["dtype", "shape", "contiguous", "device", "alive_dtype",
        "alive_shape", "source_dtype", "source_shape"])
def test_wrapper_refuses(args, match):
    """Tensors that are not on the CPU go to the kernel's checks, which
    refuse what it does not take; nothing launches."""
    n0 = sg.spawn_blocked.launches
    with pytest.raises(ValueError, match=f"^spawn_blocked: {match}"):
        sg.spawn_blocked(*args, CLEARANCE)
    assert sg.spawn_blocked.launches == n0


# --- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _kernel_equals_plain(dev, pos, alive, src, clearance=CLEARANCE):
    n0 = sg.spawn_blocked.launches
    got = sg.spawn_blocked(pos, alive, src, clearance)
    assert sg.spawn_blocked.launches == n0 + 1
    want = sg.spawn_blocked_plain(pos, alive, src, clearance)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.device == dev
    assert torch.equal(got, want)
    return got


@pytest.mark.card
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1025, 4100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_the_card(dtype, s):
    """Seeded scenes with the planted edges over 3 x 2,048 + 37 slots, and
    the lattice of edges alone: the kernel's [S] bool equals the plain
    version's on the card and the oracle's."""
    dev = _card()
    scene = random_scene(3 * BLOCK_SLOTS + 37, s, seed=1000 + s, f=NP[dtype])
    got = _kernel_equals_plain(dev, *(torch.from_numpy(a).to(dev)
                                      for a in scene))
    np.testing.assert_array_equal(got.cpu().numpy(), oracle(*scene, CLEARANCE))
    for clearance in (0.4, 1.0, 2.5):
        scene, want = lattice_scene(64, NP[dtype], clearance)
        got = _kernel_equals_plain(
            dev, *(torch.from_numpy(a).to(dev) for a in scene), clearance)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.card
def test_kernel_at_the_streams_shapes():
    """The 1M streaming scene (1,024 sources, 1,048,576 slots): after a
    few steps, and with edge agents planted into it (the nearest that
    f32 reaches ~600 m from the origin), the kernel equals the plain
    version; the rollout launches the kernel once a step."""
    dev = _card()
    rollout, params, st = scenes.build_streams(1_000_000, 1_048_576, 1024,
                                               device=dev)
    n0 = sg.spawn_blocked.launches
    st, c = rollout(params, st, 1.0 / 60.0, 5)
    torch.cuda.synchronize()
    assert sg.spawn_blocked.launches == n0 + 5
    assert int(c.n_spawned.sum()) > 0 and int(c.spawn_dropped.sum()) > 0
    src = params.sources.source
    clear = scenes.stream_config(1_000_000, 1_048_576).spawn_clearance
    blocked = _kernel_equals_plain(dev, st.position, st.alive, src, clear)
    assert 0 < int(blocked.sum()) < 1024
    pos, alive = st.position.cpu().numpy(), st.alive.cpu().numpy()
    plant(pos, alive, src.cpu().numpy(),
          [KINDS[i % 4] for i in range(1024)], clear,
          np.random.default_rng(11), exact=False)
    _kernel_equals_plain(dev, torch.from_numpy(pos).to(dev),
                         torch.from_numpy(alive).to(dev), src, clear)


@pytest.mark.card
def test_world_engine_through_the_kernel(monkeypatch):
    """The world engine's spawn phase psums each shard's gate: the
    crossing scene at D = 2 on the card, 40 steps, ends by uid and with
    the counters bit for bit as the same run through the plain version;
    one launch a shard a step."""
    from rmf_crowdsim_tpu_torch.parallel import (
        build_world_rollout, gather_shards, make_thread_mesh,
        shard_state_by_region, worldstep)

    dev = _card()

    def run():
        cfg, hl, lp, params, st = scenes.crossing_scene(device=dev)
        mesh = make_thread_mesh(2, dev)
        shards, c = build_world_rollout(cfg, [hl], [lp], mesh)(
            params, shard_state_by_region(cfg, mesh, st), 1.0, 40)
        g = gather_shards(shards)
        order = torch.argsort(torch.where(g.alive, g.uid, 2**30))
        live = int(g.alive.sum())
        return g.uid[order][:live], g.position[order][:live], c

    n0 = sg.spawn_blocked.launches
    uid, pos, c = run()
    assert sg.spawn_blocked.launches == n0 + 2 * 40
    assert int(c.n_spawned.sum()) > 0
    monkeypatch.setattr(worldstep, "spawn_blocked", sg.spawn_blocked_plain)
    uid_p, pos_p, c_p = run()
    assert torch.equal(uid, uid_p) and torch.equal(pos, pos_p)
    for k in ("n_alive", "n_spawned", "spawn_dropped"):
        assert torch.equal(getattr(c, k), getattr(c_p, k)), k


@pytest.mark.card
def test_kernel_refuses_misaligned_rows():
    dev = _card()
    flat = torch.zeros(2 * 64 + 1, device=dev)
    alive = torch.ones(64, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="8-byte boundaries"):
        sg.spawn_blocked(flat[1:].view(64, 2), alive,
                         torch.zeros((4, 2), device=dev), CLEARANCE)
