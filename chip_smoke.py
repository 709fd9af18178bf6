#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``rmf_crowdsim_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits nonzero without one (or without the
repository beside it).  Phases, each printing its own line:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: compile the CUDA kernels from ``rmf_crowdsim_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card, at the
   1M-agent bench scene's shapes (with the 48-agent hotspot): K3 (pack)
   bitwise, K1 (force), K2 (the spill repair: window rows, own rows and
   the velocity rows it writes, and with its windows off), K1b (force
   with the fused spill segment) and K4 (the dense ``grid_dense`` force
   kernel) to rtol = atol = 2e-4 on live rows with integer priorities
   on and off; times of both on CUDA events over back-to-back calls
   (K2's launch is shorter than its wrapper's host time, so K2 also
   prints its kernel's device time from the profiler, ``device_ms`` in
   the JSON line), each kernel's bound
   (``utils/roofline.py``: the bytes and f32 operations that this run's
   inputs need) and its share of it; K1b bitwise K1 on unflagged slots;
   the 1M fused-spill pass against the spill-patch pass on the same
   state, exactly; then K1, K1b and K2 against their plain versions
   where queries overflow the neighbour list (the 1M scene one step in,
   while the hotspot is packed, and a 4,096-agent scene with the hotspot
   on a tile corner), each kernel's overflow count > 0 over them, so the
   re-walk runs on the card; K4 likewise on the 1M dense state with two
   crowds added, its list overflows and its blocks that read their
   candidates in place both > 0; then the fresh-dead scenes: the 1M
   streaming scene (``scenes.build_streams``) on ``grid_pallas`` and on
   ``grid_dense``, its sources switched off after a warm-up, stepped in
   skin mode until a sink despawns agents whose rows the carried binning
   still holds; on that carried binning K3 (bitwise), K1, K2 and K4
   against their plain versions on live rows, every fresh-dead row packed
   inert (id -1, position sentinel) and none in the spill list;
4. gates (the port of bench.py's ``compiled_parity_check``): the
   4,096-agent bench scene with the 48-agent hotspot, 5 steps at
   dt = 1/60, against ``brute`` by uid to 2e-4 with zero truncation:
   ``grid_pallas``, ``grid_pallas`` with ``fused_spills=True`` and
   ``grid_dense``; then the streaming gate: the same scene at capacity
   4,608 with 16 sources, 8 steps, on those three paths and ``grid``
   against ``brute``: the same uids alive, positions by uid to 2e-4,
   the counters equal step for step, zero truncation;
5. the 1M-agent bench scene through ``build_rollout`` on three paths:
   the main path (``grid_pallas``), path A (``grid_dense``) and path B
   (``grid_pallas`` with ``fused_spills=True``), then path C, the 1M
   streaming scene (1,024 sources, capacity 1,048,576) on
   ``grid_pallas``.  Each: a warm-up (30 steps on path C), then 20 timed
   steps with the launch counts set to 0 just before and read just
   after, replayed from the rollout's CUDA graphs (``core/graphs.py``),
   then the same 20 steps issued eagerly (``rollout.eager``) from the
   same state, timed beside them with the graphs captured, the launch
   counts of both equal; zero truncation, finite state, every kernel of the path
   launched, and no agent lost (path C: spawns, despawns, waypoints
   reached and dropped spawns all > 0, and the population conserved step
   by step); then its host syncs per step, counted, and its kernel
   launches and device time per step (``torch.profiler`` over 3 steps);
   the clearance gate kernel (G1) launches once a timed step on path C
   and never on the others, which have no sources; path C also checks
   it bitwise against ``spawn_blocked_plain`` on its last state, times
   both in turns (CUDA events) and the kernel alone on the device beside
   its bound, and runs 5 steps with per-uid event records (2,048 a
   kind), whose valid uids match the counters, with no overflow and
   every spawned uid new.  Last, the ``grid`` backend on the 1M bench
   scene, 3 timed steps;
6. the measurement probes (``rmf_crowdsim_tpu_torch/probes``), which no
   path of the simulator runs: each probe kernel against its plain
   version on the card (K1's stage cuts bitwise on the 1M plane, ``full``
   also bitwise the main K1 and at K4's thread rule; the chained 0/1
   product bitwise in bf16, s8, tf32 (``mma.sync``) and f32 (FFMA) at
   1, 2, 3 and 256 steps on the probe's inputs and on inputs
   whose bits are shown to vary, and each type's link at 1-3 links and,
   timed, at ``mma_chain.LINKS``, whose bits flip every link; the
   two probe transposes, a [16, 48] -> [40, 16] one and the feature-plane
   writers at both plane sizes and at 3,000 and 1,001 slots, bitwise),
   then the probes' own timing runs with their launch counts set to 0
   just before and read just after, every probe kernel launched: the
   launch floor first (``probes/launch.py``: the empty kernel
   ``csrc/noop.cu`` through ``cuda_build.launch``, host µs a call over
   10,000 calls beside the launch path before its entry points were bound
   and ``torch.empty(0)``, in turns; its device time), then the stage
   table, the product times (each beside one dependent link's time,
   the latency bound it makes and the rate bound; the links timed over
   one launch of ``mma_chain.LINKS``), and the transposes (a call, in
   turns with ``src[:r, :c].t().contiguous()``, and on the device beside that call's
   copy) and plane writers (a call and on the device, each beside its
   byte bound; ``columns x4`` also beside its 32-byte sectors), with the
   card's name and power limit;
7. the ``Simulation`` session (``core/simulation.py``), built through its
   public API by ``scenes.build_session``: the streaming scene's crowd by
   ``add_agents`` and its SourceSinks by ``add_source_sink``, their route
   legs planned by an ``RMFPlanner`` with the native planner.  First the
   session gate: the 4,096-agent streaming gate scene on ``brute``,
   ``grid_pallas``, ``grid_pallas`` with fused spills and ``grid_dense``,
   each through 8 ``step()`` calls and through ``run(8)`` with a
   recording listener: the same uids alive, positions by uid equal to
   ``brute``'s to 2e-4, and the same listener sequence from ``step()``
   as from ``run()`` on each backend.  Then path D, the 1M streaming
   scene as a session on ``grid_pallas`` with a counting listener: the
   planning time, 5 warm-up and 20 timed ``step()`` calls (K1, K2 and K3
   launched once a step, the listener's totals equal to the event masks'
   sums, every spawned uid new, the population conserved), its host
   syncs per step (at most 1) and profile, a timed ``run(20)`` (the
   listener's totals equal to its counters; the replay's host time
   apart), then its rollout alone from the session's state, replayed
   from its graphs and eagerly, ms/step side by side, launches equal, ``check_state``, the two spatial queries against brute at 4
   points, and a checkpoint: saved, loaded into a fresh session, and 3
   more steps of both bitwise equal by uid;
8. the multi-device engines (``rmf_crowdsim_tpu_torch/parallel``), D
   shards on the one card over ``ThreadMesh`` (NCCL takes one rank per
   device).  8a, gates: the world engine on the 4,096-agent bench scene
   with the 48-agent hotspot (capacity 8,192), 5 steps, at D = 1, 2 and 4
   in bitwise mode, equal bit for bit by uid, in tolerance mode within
   2e-4 of it, D = 1 against ``build_rollout`` and ``brute`` to 2e-4 by
   uid, truncation 0; the crossing scene (tests/test_worldstep.py) at
   D = 4 bitwise D = 1, counters equal, agents migrating, none lost; the
   agent-sharded step and the domain-sharded step at D = 4 against the
   single-device step.  8b, kernels on the extended blocks: one step of
   the 1M world at D = 4 with the hotspot in interior shard 2, whose K3,
   K1 and K2 inputs (the spliced plane with halo ids, the merged spill
   list, the velocity scratch of 3m + the list's rows) are held against
   the plain versions, K2's writes past row m counted.  8c, the 1M world
   (``scenes.build_world_bench(1M, 4)``, capacity 1,048,576, m = 262,144
   a shard): 5 steps of bitwise mode at D = 4 bit for bit D = 1, then in
   each mode 20 timed steps (ms/step; K1, K2 and K3 launched once a shard
   and step; no agent lost, stray, overflowing or dropped; migrations >
   0; truncation 0), its host syncs per step (at most one a shard) and
   its profile over 3 steps, beside the single-device main path's ms/step
   in the same call.  8d, the shard proxy (``scenes.build_shard_proxy``,
   bench.py:162-260): one shard of a 10-shard 1M world at full width, 20
   timed steps in each mode.  8e: ``ProcessGroupComm`` over NCCL at world
   size 1, the crossing scene's 40-step rollout bit for bit that over
   ``ThreadMesh``;
9. the entry points: 9a, the port's bench (``rmf_crowdsim_tpu_torch.bench``)
   at its defaults, in this process: its brute gate, the 1M
   ``grid_pallas`` headline, the three shard proxies (D = 10 in both
   modes, D = 16 in tolerance mode), the 10k-agent RMF hall with its host
   planning, and 1k and 100k agents, with the launch counts set to 0 just
   before and read just after (K1, K2 and K3 launched, K1b and K4 not),
   every cell a positive number; its JSON on the line that starts with
   ``phase 9 bench: ``.  9b, ``tools.validate_highD`` at D = 16: the
   halo table, then the crossing scene in bitwise mode equal to D = 1 bit
   for bit with migrations, and in tolerance mode within 1e-5 with the
   lifecycle counters equal;
10. the randomized differential sweep of tests/test_fuzz_step.py on the
   card, with the launch counts set to 0 just before and read just
   after: 10a, its 43 cases (``scenes.fuzz_cases``: backends agree,
   bucket 32, the sweep on ``grid_pallas`` and on ``grid_dense``), the
   CPU test ``tests/test_torch_fuzz_step.py`` on CUDA sessions; 10b, 16
   wide cases (``scenes.wide_cases``: 120-200 m worlds of 31 or more
   tiles a column, 1,500-3,000 agents and 2-6 hotspots of 48-96 in
   capacity 4,096, random configs, 5 steps at dt = 1/60).  Each case
   holds every fast backend against ``brute`` by uid at the JAX file's
   tolerances (2e-5 ``grid``, 2e-4 the kernel backends), the rollout
   counters equal, truncation 0; then K1, K1b, K2, K3 and K4 each
   launched, a fused-spill wide case past K1b's 128 spill lanes (K2's
   storm branch) and a ``grid_pallas`` case at ``SimConfig``'s default
   bucket, tile, presort, integer priorities, pack and spill repair; one
   line each for 10a and 10b (cases, steps, max error per backend
   against its tolerance, largest tile occupancy and spills, seconds).

Then one JSON line of per-kernel results (``library_ms`` is null for the
six simulator kernels, as no single PyTorch call computes any of them,
and for the probe kernels without one; the six simulator kernels
carry their launches in phase 10 as ``launches_fuzz``, and K1, K2, K3
and G1 their launches on path C, path D, the bitwise 1M world of 8c and
the bench of 9a, G1 also on each path of phase 5 as ``launches_phase5``;
each probe row also has its ``share`` of its bound, the P3 rows
their ``form`` (``mma`` or ``ffma``), ``link_ns``, ``latency_bound_ms``, ``rate_bound_ms`` and
``ptxas`` line (``bound_by`` ``latency`` where it binds), the
``mma_link`` rows their ``link_ns``, the P4 rows
their ``device_ms`` and ``device_share``, and the ``noop`` row the
launch floor's host µs a call; the empty kernel has no output and no
plain version, so its ``max_abs_err``, ``plain_ms``, ``bound_by`` and
``share`` are null and its ``bound_ms`` is 0), the card's line, and as
the last line
``{"ok": true, "device": {...}}``.  Any failure raises.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
import warnings

N_MAIN = 1_000_000
N_GATE = 4096
DT = 1.0 / 60.0
TOL = 2e-4
K4_REWALK_CLUSTER = 60
# The streaming scenes: 1,024 sources at 1M in 1,048,576 slots; 16 at the
# 4,096-agent gate in 4,608.
CAP_MAIN = 1_048_576
N_SOURCES = 1024
CAP_GATE = 4608
N_GATE_SOURCES = 16
STREAM_WARM = 30
EVENT_CAPACITY = 2048
FRESH_DEAD_WARM = 12
# Zanlungo's query chunk on the 1M grid backend (its [N, 144] table).
GRID_CHUNK = 131_072
STREAM_COUNTERS = ("n_alive", "n_spawned", "n_destroyed",
                   "n_waypoint_reached", "spawn_dropped", "out_of_bounds")
# Phase 8: shards of the 1M world, the gate world's slots, the shard that
# holds the hotspot (region 2 of 4 holds (10, 10)), the warm-up steps.
WORLD_D = 4
CAP_WORLD_GATE = 8192
WORLD_SHARD = 2
WORLD_WARM = 2
# The kernels of the main path (grid_pallas), which the bench also runs.
MAIN_KERNELS = ("pack_rows", "zanlungo_bucketed", "spill_window")
WORLD_COUNTERS = ("n_alive", "n_spawned", "n_destroyed",
                  "n_waypoint_reached", "spawn_dropped", "out_of_bounds")


def _dense_inputs(torch, dcfg, params, st):
    """K4's inputs on ``st`` as the dense pass builds them: the state
    sorted by tile key, then ``dense_prep``.  Returns (sorted state, feat,
    tile_start, the live rows' padded output rows, max tile occupancy);
    raises if a column holds more than ``col_cap`` rows."""
    from rmf_crowdsim_tpu_torch.core.step import payload_sort_by_key
    from rmf_crowdsim_tpu_torch.models.highlevel import ParityVelocity
    from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
    from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as zd

    st, _, key = payload_sort_by_key(
        st, zb.tile_key(dcfg, st.position, st.alive),
        torch.zeros_like(st.alive))
    rec = ParityVelocity((1.0, 0.0)).plan(params.hl[0], st).vel
    feat, tile_start, dbpos, n_col_over, occ = zd.dense_prep(
        dcfg, key, st.position, st.velocity, st.preferred_vel, rec,
        st.priority, st.eyesight, rec, st.alive)
    if int(n_col_over):
        raise AssertionError(f"K4: {int(n_col_over)} rows past col_cap")
    rows = dbpos[st.alive & (dbpos < dcfg.slots)].long()
    return st, feat, tile_start, rows, int(occ)


def _dense_clusters(torch, dcfg, st, tile_start, geo):
    """The tile-sorted ``st`` (``tile_start`` its tiles' first rows) with
    two crowds, each made of the first rows of one column so that no
    column grows.  ``geo.stage_rows // 2 + 1`` rows of column ``tx // 4``
    spread over the K4 block run that holds tile row ``ty // 2`` (about
    three times the bench density), so each block that stages those
    tiles holds more rows than its stage and reads them in place; and
    ``K4_REWALK_CLUSTER`` rows of column ``tx // 4 + 10`` in a 1.4 m disc
    in tile row ``ty // 2``, each with more neighbours than K4's 32-entry
    list, in blocks that fit their stage."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    ts = dcfg.tile_size
    pos = st.position.clone()

    c = dcfg.tx // 4
    k = geo.stage_rows // 2 + 1
    t0 = dcfg.ty // 2 // geo.tiles * geo.tiles
    t1 = min(t0 + geo.tiles, dcfg.ty)
    lo = torch.tensor([dcfg.offset[0] + c * ts, dcfg.offset[1] + t0 * ts])
    size = torch.tensor([ts, (t1 - t0) * ts])
    a = int(tile_start[c * dcfg.ty])
    pos[a:a + k] = (lo + size * torch.rand((k, 2), generator=gen)).to(pos)

    c += 10
    k = K4_REWALK_CLUSTER
    centre = torch.tensor([dcfg.offset[0] + (c + 0.5) * ts,
                           dcfg.offset[1] + (dcfg.ty // 2 + 0.5) * ts])
    ang = 2 * torch.pi * torch.rand(k, generator=gen)
    r = 0.7 * torch.sqrt(torch.rand(k, generator=gen))
    a = int(tile_start[c * dcfg.ty])
    pos[a:a + k] = (centre + torch.stack([r * torch.cos(ang),
                                          r * torch.sin(ang)], 1)).to(pos)
    return st.replace(position=pos)


def _k2_check(torch, spill, zb, cfg, zp5, packed_t, packed_T, rows, sp_tcx,
              sp_tcy, base, int_prio, overflow):
    """K2 against its plain version on one state, each writing into its
    own copy of ``base`` [N, 2]: the live window rows, the own rows and
    the whole velocity array, to ``TOL``; then with the windows off, where
    only the own rows may land.  Returns (max abs err, live window
    queries, velocity rows written)."""
    b9 = 9 * cfg.bucket
    vel_k, vel_p = base.clone(), base.clone()
    out_k = spill.spill_window(cfg, zp5, packed_t, packed_T, rows, sp_tcx,
                               sp_tcy, vel_k, int_prio=int_prio,
                               overflow=overflow)
    out_p = spill.spill_window_plain(cfg, zp5, packed_t, packed_T, rows,
                                     sp_tcx, sp_tcy, vel_p, int_prio)
    valid = rows[:, zb.ROW_ID] >= 0
    q_slots = spill.window_query_slots(cfg, sp_tcx, sp_tcy)
    q_live = valid[:, None] & (packed_t[q_slots, zb.ROW_ID] >= 0)
    off = torch.zeros((), dtype=torch.bool, device=base.device)
    vel_ko, vel_po = base.clone(), base.clone()
    spill.spill_window(cfg, zp5, packed_t, packed_T, rows, sp_tcx, sp_tcy,
                       vel_ko, int_prio=int_prio, windows=off)
    spill.spill_window_plain(cfg, zp5, packed_t, packed_T, rows, sp_tcx,
                             sp_tcy, vel_po, int_prio, windows=off)
    err = 0.0
    for k, p in ((out_k[:, :b9][q_live], out_p[:, :b9][q_live]),
                 (out_k[valid, b9], out_p[valid, b9]),
                 (vel_k, vel_p), (vel_ko, vel_po)):
        torch.testing.assert_close(k, p, rtol=TOL, atol=TOL)
        if k.numel():
            err = max(err, (k - p).abs().max().item())
    n_own = int(((vel_ko != base).any(1)).sum())
    if n_own > int(valid.sum()):
        raise AssertionError(f"K2 with windows off wrote {n_own} rows for "
                             f"{int(valid.sum())} spills")
    return err, int(q_live.sum()), int(((vel_p != base).any(1)).sum())


def _drive(torch, name, rollout, params, st, kernels, required, absent,
           card, n_steps=20, warm=2, check=None):
    """One 1M path of phase 5: ``warm`` steps, ``n_steps`` timed steps with
    every launch count of ``kernels`` ({name: wrapper}) set to 0 just
    before and read just after, checks (each kernel named in ``required``
    launched, none in ``absent``; ``check(counters, alive before)``, by
    default that no agent was lost), then the host syncs per step and,
    over 3 steps under the profiler, the kernel launches per step.
    Returns (launch counts, ms/step, profile, state)."""
    from rmf_crowdsim_tpu_torch.utils.profile_step import device_kernels

    st, _ = rollout(params, st, DT, warm)
    torch.cuda.synchronize()
    n_before = int(st.num_alive)
    shape = tuple(st.position.shape)
    torch.cuda.reset_peak_memory_stats()
    start = st

    def window(run):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = run(params, start, DT, n_steps)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {k: fn.launches
                                               for k, fn in kernels.items()}

    (st, c), wall, launches = window(rollout)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The same steps issued eagerly from the same state: the launch counts
    # of the graphs' replays must be the eager ones.
    _, wall_eager, launches_eager = window(rollout.eager)
    if launches_eager != launches:
        raise AssertionError(f"{name}: launches {launches} replayed, "
                             f"{launches_eager} eager")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} never launched {missing}")
    stray = [k for k in absent if launches[k]]
    if stray:
        raise AssertionError(f"{name} launched {stray}")
    truncated = int(c.neighbor_truncated.max())
    if truncated:
        raise AssertionError(f"{name} truncates {truncated}")
    if tuple(st.position.shape) != shape or not bool(
            torch.isfinite(st.position).all()):
        raise AssertionError(f"{name} state is not finite [N, 2]")
    if check is None:
        if int(c.n_alive.min()) != n_before:
            raise AssertionError(f"{name} lost agents")
    else:
        check(c, n_before)
    print(f"phase 5 {name}: {n_before} agents, {n_steps} steps in "
          f"{wall:.4f} s = {n_steps / wall:.2f} steps/s, "
          f"{1e3 * wall / n_steps:.3f} ms/step graphed vs "
          f"{1e3 * wall_eager / n_steps:.3f} eager on '{card}' "
          f"({rollout.graphs.captures} graphs captured, "
          f"{rollout.graphs.graphed_steps} steps replayed); launches "
          f"{launches}, the same eager; max tile occupancy "
          f"{int(c.max_cell_occupancy.max())}; truncated 0; peak "
          f"{peak_gb:.2f} GB", flush=True)

    n_sync_steps = 3

    def sync_steps():
        nonlocal st
        st, _ = rollout(params, st, DT, n_sync_steps)

    _host_syncs(torch, f"phase 5 {name}", sync_steps, n_sync_steps)

    def run():
        rollout(params, st, DT, n_sync_steps)
        torch.cuda.synchronize()

    prof = device_kernels(run, n_sync_steps)
    print(f"phase 5 {name} profile: {prof['launches_per_step']:.1f} kernel "
          f"launches/step, device busy {prof['device_busy_ms']:.3f} ms/step "
          f"({n_sync_steps} steps under torch.profiler)", flush=True)
    for ms, n, kname in prof["top"][:8]:
        print(f"  {ms:.4f} ms/step  {n:6.1f} launches/step  {kname[:90]}")
    return launches, 1e3 * wall / n_steps, prof, st


def _host_syncs(torch, label, run, n_steps, limit=1):
    """Calls ``run()`` (``n_steps`` steps) with CUDA's sync debug mode on,
    counts the host syncs it makes (one warning each), prints them by the
    Python line that made them, and fails above ``limit`` a step."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # Each warning names the Python line that called the synchronizing op.
    syncs = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    sites = {s: syncs.count(s) for s in sorted(set(syncs))}
    per_step = len(syncs) / n_steps
    print(f"{label} host syncs: {len(syncs)} in {n_steps} steps "
          f"({per_step:.2f} per step) at {sites}", flush=True)
    if per_step > limit:
        raise AssertionError(f"{label} makes {per_step} host syncs per step")


def _stream_check(torch, name):
    """Path C's check of its timed counters: spawns, despawns, waypoints
    reached and dropped spawns all happened, and the population after
    each step is the one before plus its spawns minus its despawns."""

    def check(c, n_before):
        sums = {k: int(getattr(c, k).sum()) for k in (
            "n_spawned", "n_destroyed", "n_waypoint_reached",
            "spawn_dropped")}
        idle = [k for k, v in sums.items() if v == 0]
        if idle:
            raise AssertionError(f"{name}: {idle} stayed 0 ({sums})")
        before = torch.cat([c.n_alive.new_tensor([n_before]),
                            c.n_alive[:-1]])
        if not torch.equal(c.n_alive, before + c.n_spawned - c.n_destroyed):
            raise AssertionError(f"{name}: the population is not conserved")
        print(f"phase 5 {name} counters over the timed steps: {sums}; "
              f"alive {n_before} -> {int(c.n_alive[-1])}, conserved step "
              f"by step", flush=True)

    return check


def _fresh_dead_state(torch, dev, backend, cfg):
    """The 1M streaming scene on ``backend``: ``FRESH_DEAD_WARM`` steps
    with its sources on, then every source off and skin-mode steps until
    one despawns agents whose rows the carried binning still holds (rows
    keyed into a tile of ``cfg`` at the last sort, dead now).  Returns
    (config, params, state after that step, skin, fresh-dead mask [N])."""
    from rmf_crowdsim_tpu_torch import scenes
    from rmf_crowdsim_tpu_torch.core.step import build_step, empty_skin

    rollout, params, st = scenes.build_streams(
        N_MAIN, CAP_MAIN, N_SOURCES, backend=backend, device=dev)
    st, _ = rollout(params, st, DT, FRESH_DEAD_WARM)
    sp = params.sources
    params = params.replace(sources=sp.replace(
        active=torch.zeros_like(sp.active)))
    config = scenes.stream_config(N_MAIN, CAP_MAIN, backend=backend)
    step = build_step(config, *scenes.stream_planners(params.hl[1]["routes"]),
                      skin_mode=True)
    skin = empty_skin(config, dev)
    for _ in range(10):
        st, ev, skin = step(params, st, DT, skin)
        dead = ~st.alive & (skin["key"] < cfg.n_tiles)
        if bool(dead.any()):
            return config, params, st, skin, dead
    raise AssertionError(f"fresh-dead {backend}: no sink fired in 10 steps")


def _fresh_dead(torch, dev):
    """Phase 3's fresh-dead scenes: K3, K1 and K2 on the carried bucketed
    binning, K4 on the carried dense key, each against its plain version
    on live rows; fresh-dead rows must be packed inert and never listed
    as spills."""
    from rmf_crowdsim_tpu_torch import scenes
    from rmf_crowdsim_tpu_torch.models.highlevel import ParityVelocity
    from rmf_crowdsim_tpu_torch.ops import pack, spill
    from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
    from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as zd

    bcfg = scenes.bench_bucket_config(N_MAIN)
    config, params, st, skin, dead = _fresh_dead_state(
        torch, dev, "grid_pallas", bcfg)
    zp5 = zb.zparams5(params.lp[0])
    rec = ParityVelocity((1.0, 0.0)).plan(params.hl[0], st).vel
    feat_t, bpos, bucket_pos, _, _ = zb.feature_rows(
        bcfg, st.position, st.velocity, st.preferred_vel, rec, st.priority,
        st.eyesight, rec, st.alive, use_pack_kernel=True, presorted=True,
        binning=(skin["bpos"], skin["max_occ"], skin["n_over"]))
    packed_t, packed_T, _ = pack.pack_rows(feat_t, bpos, bcfg.slots)
    plain_t, plain_T = pack.pack_rows_plain(feat_t, bpos, bcfg.slots)
    if not (torch.equal(packed_t, plain_t) and torch.equal(packed_T,
                                                           plain_T)):
        raise AssertionError("fresh-dead: K3 differs from its plain version")
    slot_dead = dead & (bpos < bcfg.slots)
    ds = bpos[slot_dead].long()
    if ds.numel() == 0:
        raise AssertionError("fresh-dead: no dead row holds a bucket slot")
    if not (bool((packed_t[ds, zb.ROW_ID] == -1).all()) and bool(
            (packed_t[ds, zb.ROW_PX] == zb.POS_SENTINEL).all())):
        raise AssertionError("fresh-dead: a dead row is packed live")
    live = packed_T[zb.ROW_ID] >= 0
    out_k = zb.zanlungo_forces_bucketed(bcfg, zp5, packed_t, packed_T,
                                        int_prio=True)
    out_p = zb.forces_bucketed_plain(bcfg, zp5, packed_t, packed_T, True)
    torch.testing.assert_close(out_k[live], out_p[live], rtol=TOL, atol=TOL)
    e1 = (out_k[live] - out_p[live]).abs().max().item()
    t_key = torch.clamp(skin["key"], 0, bcfg.n_tiles - 1)
    c_sp, rows, sp_tcx, sp_tcy = spill.spill_rows(
        bcfg, st.position, st.velocity, rec, st.preferred_vel, st.priority,
        st.eyesight, st.alive, rec, bucket_pos, config.spill_capacity,
        tile_xy=(t_key // bcfg.ty, t_key % bcfg.ty))
    ids = rows[c_sp.valid, zb.ROW_ID].long()
    if not bool(st.alive[ids].all()):
        raise AssertionError("fresh-dead: a dead row is in the spill list")
    e2, n_q, _ = _k2_check(torch, spill, zb, bcfg, zp5, packed_t, packed_T,
                           rows, sp_tcx, sp_tcy, rec, True, None)
    print(f"phase 3 fresh-dead grid_pallas: {int(dead.sum())} rows dead "
          f"under the carried binning ({ds.numel()} in bucket slots, "
          f"{int((dead & ~slot_dead).sum())} past their bucket), packed "
          f"inert; K3 bitwise; K1 max abs err {e1:.3g}; {int(c_sp.count)} "
          f"spills, all alive; K2 ({n_q} live window queries) max abs err "
          f"{e2:.3g} (tol {TOL})", flush=True)
    del packed_t, packed_T, plain_t, plain_T, feat_t, out_k, out_p, st

    dcfg = scenes.bench_dense_config(N_MAIN, CAP_MAIN)
    config, params, st, skin, dead = _fresh_dead_state(
        torch, dev, "grid_dense", dcfg)
    rec = ParityVelocity((1.0, 0.0)).plan(params.hl[0], st).vel
    feat, tile_start, dbpos, n_col_over, _ = zd.dense_prep(
        dcfg, skin["key"], st.position, st.velocity, st.preferred_vel, rec,
        st.priority, st.eyesight, rec, st.alive)
    if int(n_col_over):
        raise AssertionError(f"fresh-dead K4: {int(n_col_over)} rows past "
                             f"col_cap")
    if not (bool((feat[dead, zb.ROW_ID] == -1).all()) and bool(
            (feat[dead, zb.ROW_PX] == zb.POS_SENTINEL).all())):
        raise AssertionError("fresh-dead: a dead row is a live dense row")
    rows = dbpos[st.alive & (dbpos < dcfg.slots)].long()
    out_k = zd.zanlungo_forces_dense(dcfg, zp5, feat, tile_start,
                                     int_prio=True)
    out_p = zd.forces_dense_plain(dcfg, zp5, feat, tile_start, True)
    torch.testing.assert_close(out_k[rows], out_p[rows], rtol=TOL, atol=TOL)
    e4 = (out_k[rows] - out_p[rows]).abs().max().item()
    print(f"phase 3 fresh-dead grid_dense: {int(dead.sum())} rows dead "
          f"under the carried key, packed inert; K4 on {rows.shape[0]} live "
          f"rows max abs err {e4:.3g} (tol {TOL})", flush=True)


def _probes(torch, dev, card, rl) -> list:
    """Phase 6: the measurement probes.  Checks each probe kernel against
    its plain version, then runs the probes' timing entry points with the
    launch counts set to 0 just before and read just after.  Returns the
    rows of the kernels JSON line."""
    from rmf_crowdsim_tpu_torch import scenes
    from rmf_crowdsim_tpu_torch.ops import pack
    from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
    from rmf_crowdsim_tpu_torch.probes import k1_stages, mma_chain, planes
    from rmf_crowdsim_tpu_torch.probes import launch as launch_probe
    from rmf_crowdsim_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    regs = cuda_build.ptxas_usage(cuda_build.build_log(),
                                  "zanlungo_bucketed_kernel")
    for name, used in sorted(regs.items()):
        print(f"phase 6 ptxas {name}: {used}")
    _, cfg, params, *_, feat_t, bpos, _ = scenes.bench_bucketed(N_MAIN,
                                                                device=dev)
    packed_t, packed_T, _ = pack.pack_rows(feat_t, bpos, cfg.slots)
    zp5 = zb.zparams5(params.lp[0])
    n_live = int((packed_T[zb.ROW_ID] >= 0).sum())
    k4_threads = k1_stages.k4_rule_threads(cfg, n_live)
    errs = k1_stages.check(cfg, zp5, packed_t, packed_T, k4_threads)
    for stage, (err, differ) in errs.items():
        how = "bitwise" if not differ else (
            f"{differ} slots differ in the last bits (the plain TTC "
            f"rounds op by op), within 2e-4 relative")
        if stage == "full":
            how = (f"bitwise the main K1, also at {k4_threads} threads; "
                   f"max abs err {err:.3g} against the plain version (tol "
                   f"{TOL})")
        print(f"phase 6 P1/P2 k1_stage {stage}: {N_MAIN} agents, "
              f"{n_live} live slots of {cfg.slots}: {how}", flush=True)
    n_mma = mma_chain.check(dev)
    n_planes = planes.check(dev)
    print(f"phase 6 P3 mma_chain: {n_mma} cases bitwise (bf16, s8, tf32, "
          f"f32; both shapes; the probe's and the "
          f"straddling inputs; {mma_chain.CHECK_ITERS} steps; each type's "
          f"link at 1-3 links); P4 planes: {n_planes} cases bitwise",
          flush=True)
    for shape, (m, k, n) in mma_chain.SHAPES.items():
        x, w = mma_chain.straddle_inputs(m, k, n, device=dev)
        shares = [float(mma_chain.mma_chain_plain(x, w, it)[0].mean())
                  for it in (1, 2, 3, 4)]
        if not all(0.0 < v < 1.0 for v in shares):
            raise AssertionError(f"phase 6 P3 {shape}: the straddling "
                                 f"inputs' bits settle: {shares}")
        print(f"phase 6 P3 {shape} straddling inputs: share of bits set at "
              f"steps 1-4 {[round(v, 4) for v in shares]}", flush=True)

    wrappers = {"k1_stage": k1_stages.k1_stage,
                "mma_chain": mma_chain.mma_chain,
                "mma_link": mma_chain.mma_link,
                "transpose": planes.transpose,
                "write_columns": planes.write_columns,
                "rebuild": planes.rebuild, "write_rows": planes.write_rows,
                "noop": launch_probe.noop}
    for fn in wrappers.values():
        fn.launches = 0
    floor = launch_probe.measure(dev)
    k1_rows = k1_stages.measure(cfg, zp5, packed_t, packed_T)
    mma_rows = mma_chain.measure(dev)
    plane_rows = planes.measure(dev)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the probes never launched {missing}")
    print(k1_stages.stage_table(k1_rows, card))
    print(f"phase 6 P3 chained 0/1 products on '{card}', "
          f"{mma_chain.ITERS} steps a call; links of {mma_chain.LINKS}:")
    for r in mma_rows:
        print(mma_chain.row_text(r))
    print(f"phase 6 P4 transposes and plane writers on '{card}' (a call on "
          f"CUDA events; on the device from the profiler):")
    for name, size, ms, pms, lib, b, _, _, extra in plane_rows:
        lib_text = "none" if lib is None else f"{lib:.4f} ms"
        if "library_device_ms" in extra:
            lib_text += f" ({extra['library_device_ms']:.5f} ms on the device)"
        sec = "" if "sector_share" not in extra else (
            f", {100 * extra['sector_share']:.1f}% of its sector bound "
            f"{extra['sector_bound_ms']:.6f} ms")
        print(f"  {name:18s} {size:18s}: {ms:.4f} ms a call "
              f"({extra['device_ms']:.5f} ms on the device), bound "
              f"{b.ms:.6f} ms ({b.bytes} B), {100 * b.ms / ms:.1f}% of "
              f"bound ({100 * b.ms / extra['device_ms']:.1f}% on the "
              f"device){sec}; plain {pms:.4f} ms; one torch call {lib_text}")
    print(f"phase 6 launch floor on '{card}', {launch_probe.CALLS} calls a "
          f"turn, turns launcher, unbound, empty, empty, unbound, launcher: "
          f"host {floor['host_us_launcher']:.3f} us a call through "
          f"cuda_build.launch ({floor['event_us_launcher']:.3f} us on CUDA "
          f"events), {floor['host_us_unbound']:.3f} us through the unbound "
          f"path ({floor['event_us_unbound']:.3f}), "
          f"{floor['host_us_torch_empty']:.3f} us for torch.empty(0) "
          f"({floor['event_us_torch_empty']:.3f}); the empty kernel "
          f"{floor['ms']:.5f} ms a call (CUDA events), "
          f"{floor['device_ms']:.5f} ms on the device (profiler)",
          flush=True)
    print(f"phase 6 probes: launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def row(name, source, replaces, n, err, ms, pms, bms, by, lib, **extra):
        return {"name": name, "route": "cuda",
                "source": f"rmf_crowdsim_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": lib,
                "share": None if by is None else bms / ms, **extra}

    rows = []
    off = {(s, t): (ms, n, err)
           for s, p, t, ms, _, _, n, err in k1_rows if not p}
    for stage, int_prio, threads, ms, pms, b, n, err in k1_rows:
        if not int_prio:
            continue
        name = f"k1_stage_{stage}" + (f"_{threads}threads" if threads else "")
        ms_off, n_off, err_off = off[stage, threads]
        rows.append(row(name, "k1_stages.cu",
                        "perf/kvar.py:270; perf/kvar2.py:311",
                        n, err, ms, pms, b.ms, b.bound_by, None,
                        ms_int_prio_off=ms_off, launches_int_prio_off=n_off,
                        max_abs_err_int_prio_off=err_off))
    for r in mma_rows:
        name = f"mma_chain_{r['shape']}_{r['dtype']}"
        extra = {} if r["parent_ms"] is None else {"parent_ms":
                                                   r["parent_ms"]}
        rows.append(row(name, "mma_chain.cu", "perf/onehot_int8_probe.py:54",
                        r["launches"], r["err"], r["ms"], r["plain_ms"],
                        r["bound"].ms / mma_chain.ITERS, r["bound"].bound_by,
                        r["library_ms"], per="product", form=r["form"],
                        link_ns=r["link_ns"], latency_bound_ms=r["latency_ms"],
                        rate_bound_ms=r["rate_ms"], ptxas=r["ptxas"],
                        **extra))
    # The link kernel: a warm-up launch and one of LINKS links a type (the
    # checks aside); its plain version's time is host time (numpy), every
    # link computed.
    for d in mma_chain.DTYPES:
        lk = next(r for r in mma_rows if r["dtype"] == d)["link"]
        b = rl.mma_link_bound(d, mma_chain.LINKS)
        rows.append(row(f"mma_link_{d}", "mma_chain.cu",
                        "none: the latency bound of the chain of "
                        "perf/onehot_int8_probe.py:54", lk["launches"],
                        lk["err"], lk["ms"], lk["plain_ms"], b.ms, b.bound_by,
                        None, links=mma_chain.LINKS, link_ns=lk["ns"]))
    replaces = {"transpose [8,128]": "perf/transpose_probe.py:59",
                "transpose [8,64]": "perf/transpose_probe.py:73"}
    for name, size, ms, pms, lib, b, n, err, extra in plane_rows:
        rows.append(row(f"{name} {size}".replace(" ", "_"), "plane_probe.cu",
                        replaces.get(name, "perf/transpose_probe.py:83"),
                        n, err, ms, pms, b.ms, b.bound_by, lib,
                        device_share=b.ms / extra["device_ms"], **extra))
    # The empty kernel moves no byte and does no operation (bound 0 ms);
    # it has no output and no plain version, so nothing was compared or
    # timed beside it: error, plain time, bound type and share are null.
    rows.append(row("noop", "noop.cu", "none: the launch floor of every "
                    "csrc/ kernel", floor["launches"], None, floor["ms"],
                    None, 0.0, None, None, device_ms=floor["device_ms"],
                    **{k: v for k, v in floor.items()
                       if k.startswith(("host_us", "event_us"))}))
    # P3 and P4 are bitwise at the timed sizes too (P3 at 4,000 steps, the
    # links at LINKS).
    bad = [r["name"] for r in rows if r["max_abs_err"] is not None
           and r["max_abs_err"] != 0.0
           and not r["name"].startswith("k1_stage")]
    if bad:
        raise AssertionError(f"timed probe outputs differ from their plain "
                             f"versions: {bad}")
    del packed_t, packed_T, feat_t
    torch.cuda.empty_cache()
    return rows


def _listeners(T):
    """(Recorder, Counter): listener classes of the port's API.  Recorder
    keeps every event in order (kind, uid, and a spawn's position);
    Counter keeps the spawned uids and counts the rest."""

    class Recorder(T.EventListener):
        def __init__(self):
            self.events = []

        def agent_spawned(self, position, agent_id):
            self.events.append(("spawn", agent_id,
                                tuple(float(p) for p in position)))

        def waypoint_reached(self, position, agent_id):
            self.events.append(("waypoint", agent_id))

        def agent_destroyed(self, agent_id):
            self.events.append(("destroy", agent_id))

    class Counter(T.EventListener):
        def __init__(self):
            self.reset()

        def reset(self):
            self.spawned, self.reached, self.destroyed = [], 0, 0

        def agent_spawned(self, position, agent_id):
            self.spawned.append(agent_id)

        def waypoint_reached(self, position, agent_id):
            self.reached += 1

        def agent_destroyed(self, agent_id):
            self.destroyed += 1

    return Recorder, Counter


def _by_uid(torch, st):
    """(uids, positions, velocities) of the live agents, by uid."""
    uid = st.uid[st.alive]
    order = torch.argsort(uid)
    return (uid[order], st.position[st.alive][order],
            st.velocity[st.alive][order])


def _session_gate(torch, dev, card):
    """Phase 7a: the streaming gate scene (4,096 agents + hotspot, 16
    SourceSinks, capacity 4,608) as a ``Simulation`` session
    (``scenes.build_session``) on four backends, each once through 8
    ``step()`` calls and once through ``run(8)``, with a recording
    listener: the same uids alive everywhere, positions by uid equal to
    ``brute``'s ``step()`` session to ``TOL``, and on each backend the
    same listener sequence from ``step()`` and from ``run()``.  The
    sessions raise on any truncation (``on_truncation="raise"``)."""
    import rmf_crowdsim_tpu_torch as T
    from rmf_crowdsim_tpu_torch import scenes

    Recorder, _ = _listeners(T)
    variants = {"brute": dict(backend="brute"),
                "grid_pallas": dict(backend="grid_pallas"),
                "grid_pallas fused_spills": dict(backend="grid_pallas",
                                                 fused_spills=True),
                "grid_dense": dict(backend="grid_dense")}
    out = {}
    for name, kw in variants.items():
        for via in ("step", "run"):
            sim, _, _ = scenes.build_session(
                N_GATE, CAP_GATE, N_GATE_SOURCES, device=dev, hotspot=True,
                **kw)
            rec = Recorder()
            sim.add_event_listener(rec)
            if via == "step":
                for _ in range(8):
                    sim.step(DT)
            else:
                sim.run(8, DT)
            out[name, via] = (*_by_uid(torch, sim.state), rec.events)
    b_uid, b_pos, _, b_events = out["brute", "step"]
    kinds = {k: sum(e[0] == k for e in b_events)
             for k in ("spawn", "waypoint", "destroy")}
    if kinds["spawn"] == 0 or kinds["waypoint"] == 0:
        raise AssertionError(f"session gate: no spawns or no waypoints "
                             f"reached ({kinds})")
    for name in variants:
        errs = []
        for via in ("step", "run"):
            uid, pos, _, _ = out[name, via]
            if not torch.equal(uid, b_uid):
                raise AssertionError(f"session gate {name} {via}(): other "
                                     f"agents alive than on brute")
            torch.testing.assert_close(pos, b_pos, rtol=TOL, atol=TOL)
            errs.append((pos - b_pos).abs().max().item())
        if out[name, "step"][3] != out[name, "run"][3]:
            raise AssertionError(f"session gate {name}: step() and run() "
                                 f"deliver different events")
        print(f"phase 7 session gate {name}: {N_GATE} agents + hotspot, "
              f"{N_GATE_SOURCES} SourceSinks, capacity {CAP_GATE}, 8 "
              f"step() and run(8) on '{card}': {b_uid.shape[0]} uids "
              f"alive, the same as brute; max abs err vs brute step() "
              f"{errs[0]:.3g} / run() {errs[1]:.3g} (tol {TOL}); listener "
              f"sequences of step() and run() identical "
              f"({len(out[name, 'step'][3])} events: {kinds}); truncated 0",
              flush=True)


def _events_check(torch, name, counter, totals, n_alive, n_before,
                  next_uid):
    """The listener's totals equal the device's (``totals``: spawned,
    despawned, reached), each > 0; every spawned uid is new and unique;
    the population after each step is the one before plus its spawns
    minus its despawns (``n_alive`` [T], ``totals`` per step [T, 3])."""
    got = [len(counter.spawned), counter.destroyed, counter.reached]
    want = totals.sum(0).tolist()
    if got != want or min(want) == 0:
        raise AssertionError(f"{name}: listener totals {got} vs the "
                             f"device's {want} (spawned, despawned, "
                             f"reached)")
    if (len(set(counter.spawned)) != len(counter.spawned)
            or min(counter.spawned) < next_uid):
        raise AssertionError(f"{name}: a spawned uid is not new and unique")
    before = torch.cat([n_alive.new_tensor([n_before]), n_alive[:-1]])
    if not torch.equal(n_alive, before + totals[:, 0] - totals[:, 1]):
        raise AssertionError(f"{name}: the population is not conserved")
    return got


def _path_d(torch, dev, card, kernels) -> dict:
    """Phase 7b, path D: the 1M streaming scene as a ``Simulation``
    session on ``grid_pallas`` (``scenes.build_session``: the bench crowd
    by ``add_agents``, 1,024 SourceSinks whose legs an ``RMFPlanner``
    plans with the native planner) and a counting listener.  5 warm-up
    ``step()`` calls, 20 timed with the launch counts set to 0 just
    before and read just after, then its host syncs and profile over 3
    steps, then a timed ``run(20)``; the events, population, state,
    queries and a checkpoint resume are checked.  Returns the launch
    counts of the 20 ``step()`` calls."""
    import os
    import tempfile

    import rmf_crowdsim_tpu_torch as T
    from rmf_crowdsim_tpu_torch import native, scenes
    from rmf_crowdsim_tpu_torch.utils.profile_step import device_kernels
    from rmf_crowdsim_tpu_torch.utils.validate import check_state

    name = "path D session"
    if not native.native_available():
        raise AssertionError(f"{name}: the native route planner did not "
                             f"build")
    t0 = time.perf_counter()
    sim, planner, sources = scenes.build_session(
        N_MAIN, CAP_MAIN, N_SOURCES, device=dev,
        event_capacity=EVENT_CAPACITY)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    legs = [planner.plan_source_legs(ss) for ss in sources]
    plan_s = time.perf_counter() - t0
    if planner.n_routes != 2 * N_SOURCES or min(map(min, legs)) < 0:
        raise AssertionError(f"{name}: {planner.n_routes} routes planned")
    print(f"phase 7 {name}: {N_MAIN} agents by add_agents and {N_SOURCES} "
          f"SourceSinks in {CAP_MAIN} slots, built in {build_s:.2f} s; "
          f"RMFPlanner (native) planned {planner.n_routes} routes in "
          f"{plan_s:.3f} s", flush=True)
    _, Counter = _listeners(T)
    counter = Counter()
    sim.add_event_listener(counter)
    for _ in range(5):
        sim.step(DT)
    torch.cuda.synchronize()

    # The 1,024 sources run the gate (G1) at every step.
    required = ("pack_rows", "zanlungo_bucketed", "spill_window",
                "spawn_blocked")
    n_steps = 20

    def window(run):
        """Runs ``run()`` timed, with the launch counts set to 0 just
        before and read just after.  Returns (ms/step, launches)."""
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n_steps
        launches = {k: fn.launches for k, fn in kernels.items()}
        wrong = {k: n for k, n in launches.items()
                 if n != (n_steps if k in required else 0)}
        if wrong:
            raise AssertionError(f"{name}: launches {launches}, want "
                                 f"{n_steps} of each of {required}")
        return ms, launches

    counter.reset()
    next_uid, n_before = int(sim.state.next_uid), sim.num_agents
    kept = []

    def steps():
        for _ in range(n_steps):
            sim.step(DT)
            kept.append((sim.last_events, sim.state.alive))

    ms_step, launches = window(steps)
    totals = torch.stack([torch.stack([
        ev.spawned.sum(), ev.destroyed.sum(), ev.waypoint_reached.sum()])
        for ev, _ in kept])
    n_alive = torch.stack([a.sum() for _, a in kept])
    del kept
    got = _events_check(torch, f"{name} step()", counter, totals, n_alive,
                        n_before, next_uid)
    print(f"phase 7 {name} step(): {n_steps} steps, {ms_step:.3f} ms/step "
          f"on '{card}'; launches {launches}; listener spawned, despawned, "
          f"reached {got} = the event masks' sums, every spawned uid new; "
          f"alive {n_before} -> {int(n_alive[-1])}, conserved step by step",
          flush=True)

    def sync_steps():
        for _ in range(3):
            sim.step(DT)

    _host_syncs(torch, f"phase 7 {name} step()", sync_steps, 3)
    prof = device_kernels(sync_steps, 3)
    print(f"phase 7 {name} step() profile: {prof['launches_per_step']:.1f} "
          f"kernel launches/step, device busy {prof['device_busy_ms']:.3f} "
          f"ms/step (3 steps under torch.profiler)", flush=True)
    for ms, n, kname in prof["top"][:8]:
        print(f"  {ms:.4f} ms/step  {n:6.1f} launches/step  {kname[:90]}")

    counter.reset()
    next_uid, n_before = int(sim.state.next_uid), sim.num_agents
    replay_s = []
    replay = sim._replay_event_stream

    def timed_replay(*args):
        t0 = time.perf_counter()
        replay(*args)
        replay_s.append(time.perf_counter() - t0)

    sim._replay_event_stream = timed_replay
    counters = []
    ms_run, launches_run = window(
        lambda: counters.append(sim.run(n_steps, DT)))
    del sim._replay_event_stream
    c = counters[0]
    got = _events_check(
        torch, f"{name} run()", counter,
        torch.stack([c.n_spawned, c.n_destroyed, c.n_waypoint_reached], 1),
        c.n_alive, n_before, next_uid)
    # run()'s rollout from the session's state, replayed and eager, apart
    # from the listener: the same launches, ms/step side by side.
    (rollout,) = sim._rollouts.values()
    start = sim.state
    rollout(sim._params, start, DT, n_steps)
    ms_graphed, launches_graphed = window(
        lambda: rollout(sim._params, start, DT, n_steps))
    ms_eager, launches_eager = window(
        lambda: rollout.eager(sim._params, start, DT, n_steps))
    if launches_eager != launches_graphed:
        raise AssertionError(f"{name}: run()'s rollout launches "
                             f"{launches_graphed} replayed, "
                             f"{launches_eager} eager")
    print(f"phase 7 {name} run({n_steps}): {ms_run:.3f} ms/step on "
          f"'{card}', of which the listener replay {1e3 * replay_s[0]:.3f} "
          f"ms on the host ({1e3 * replay_s[0] / n_steps:.3f} ms/step); "
          f"launches {launches_run}; listener spawned, despawned, reached "
          f"{got} = the RolloutCounters, every spawned uid new; conserved "
          f"step by step; its rollout alone {ms_graphed:.3f} ms/step "
          f"graphed vs {ms_eager:.3f} eager ({rollout.graphs.captures} "
          f"graphs captured), launches the same; step() "
          f"{ms_step:.3f}", flush=True)

    check_state(sim.state)
    st = sim.state
    pts = [(0.0, 0.0), sources[0].source, (300.5, -200.25), (-600.0, 600.0)]
    n_found = 0
    for p in pts:
        pt = torch.tensor(p, dtype=torch.float64).to(st.position)
        diff = st.position - pt
        d = torch.sqrt((diff * diff).sum(-1))
        d = torch.where(st.alive, d, torch.full_like(d, float("inf")))
        knn = st.uid[torch.sort(d, stable=True).indices[:8]].tolist()
        near = st.uid[d < 2.0].tolist()
        if (sim.get_nearest_neighbours(8, p) != knn
                or sim.get_neighbours_in_radius(2.0, p) != near):
            raise AssertionError(f"{name}: the queries at {p} differ from "
                                 f"brute")
        n_found += len(near)
    print(f"phase 7 {name}: check_state clean; get_nearest_neighbours(8) "
          f"(tiered) and get_neighbours_in_radius(2.0) at {len(pts)} points "
          f"equal brute on the card ({n_found} agents within 2 m)",
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.npz")
        t0 = time.perf_counter()
        sim.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        resumed = T.Simulation(sim.config, device=dev)
        # The same registries: the crowd's planners first, then the
        # sources (their planner and legs are the first session's).
        resumed.add_agents([], T.ParityVelocity((1.0, 0.0)),
                           sources[0].local_planner, 2.0)
        for ss in sources:
            resumed.add_source_sink(ss)
        t0 = time.perf_counter()
        resumed.load(path)
        load_s = time.perf_counter() - t0
    for s in (sim, resumed):
        for _ in range(3):
            s.step(DT)
    a, b = _by_uid(torch, sim.state), _by_uid(torch, resumed.state)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: the resumed session differs from "
                             f"the first after 3 steps")
    print(f"phase 7 {name} checkpoint: {size / 1e6:.1f} MB saved in "
          f"{save_s:.2f} s, loaded in {load_s:.2f} s; 3 more step()s of "
          f"both sessions bitwise equal by uid ({a[0].shape[0]} agents)",
          flush=True)
    return launches


# ---- phase 8: the multi-device engines ---------------------------------


def _world_by_uid(torch, shards):
    """(uids, positions, velocities) of the live agents of all shards."""
    from rmf_crowdsim_tpu_torch.parallel import gather_shards

    return _by_uid(torch, gather_shards(shards))


def _world_clean(c, label, migrating=True):
    """No truncation, overflow, lost arrival or stray agent; migrations
    where ``migrating``."""
    bad = {k: int(getattr(c, k).sum()) for k in (
        "neighbor_truncated", "migration_overflow", "arrival_dropped",
        "stray")}
    if any(bad.values()):
        raise AssertionError(f"{label}: {bad}")
    if migrating and int(c.migrated.sum()) == 0:
        raise AssertionError(f"{label}: no agent migrated")


def _same(torch, a, b, label):
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        err = (a[1] - b[1]).abs().max().item() if a[0].shape == b[0].shape \
            else float("nan")
        raise AssertionError(f"{label}: not bit for bit (max abs position "
                             f"err {err})")


def _world_gates(torch, dev):
    """8a (see the module docstring)."""
    from rmf_crowdsim_tpu_torch import ParityVelocity, build_step, scenes
    from rmf_crowdsim_tpu_torch.parallel import (
        build_sharded_step, build_world_rollout, gather_shards,
        make_thread_mesh, shard_state, shard_state_by_region)

    res = {}
    for inv in ("bitwise", "tolerance"):
        for d in (1, 2, WORLD_D):
            rollout, params, shards, _ = scenes.build_world_bench(
                N_GATE, d, inv, capacity=CAP_WORLD_GATE, device=dev,
                hotspot=True)
            shards, c = rollout(params, shards, DT, 5)
            _world_clean(c, f"8a {inv} D={d}", migrating=False)
            if int(c.max_cell_occupancy.max()) <= 32:
                raise AssertionError("8a: the gate world overflows no bucket")
            res[inv, d] = (_world_by_uid(torch, shards), c)
    ref = res["bitwise", 1][0]
    for d in (2, WORLD_D):
        _same(torch, res["bitwise", d][0], ref, f"8a bitwise D={d}")
    errs = []
    for d in (1, 2, WORLD_D):
        u, p, _ = res["tolerance", d][0]
        if not torch.equal(u, ref[0]):
            raise AssertionError(f"8a tolerance D={d}: other uids alive")
        torch.testing.assert_close(p, ref[1], rtol=TOL, atol=TOL)
        errs.append((p - ref[1]).abs().max().item())
    print(f"phase 8a world gate: {N_GATE} agents + hotspot in "
          f"{CAP_WORLD_GATE} slots, 5 steps: bitwise D=2 and D={WORLD_D} "
          f"equal D=1 bit for bit by uid (positions and velocities); "
          f"tolerance D=1,2,{WORLD_D} vs bitwise D=1 max abs err "
          f"{max(errs):.3g} (tol {TOL}), resorted "
          f"{res['tolerance', WORLD_D][1].resorted.tolist()}; max tile "
          f"occupancy {int(res['bitwise', 1][1].max_cell_occupancy.max())};"
          f" truncated 0", flush=True)
    for backend in ("grid_pallas", "brute"):
        rollout, params, st = scenes.build_bench(N_GATE, backend=backend,
                                                 device=dev, hotspot=True)
        st, c = rollout(params, st, DT, 5)
        if int(c.neighbor_truncated.max()):
            raise AssertionError(f"8a: {backend} truncates")
        u, p, _ = _by_uid(torch, st)
        if not torch.equal(u, ref[0]):
            raise AssertionError(f"8a: {backend} has other uids alive")
        torch.testing.assert_close(ref[1], p, rtol=TOL, atol=TOL)
        print(f"phase 8a world D=1 vs build_rollout {backend}: max abs "
              f"err {(ref[1] - p).abs().max().item():.3g} (tol {TOL})",
              flush=True)

    crossing = {}
    for d in (WORLD_D, 1):
        cfg, hl, lp, params, st = scenes.crossing_scene(device=dev)
        mesh = make_thread_mesh(d, dev)
        shards, c = build_world_rollout(cfg, [hl], [lp], mesh)(
            params, shard_state_by_region(cfg, mesh, st), 1.0, 40)
        _world_clean(c, f"8a crossing D={d}", migrating=d > 1)
        crossing[d] = (_world_by_uid(torch, shards), c)
    _same(torch, crossing[WORLD_D][0], crossing[1][0], "8a crossing")
    for k in WORLD_COUNTERS:
        if not torch.equal(getattr(crossing[WORLD_D][1], k),
                           getattr(crossing[1][1], k)):
            raise AssertionError(f"8a crossing: {k} differs")
    cw = crossing[WORLD_D][1]
    print(f"phase 8a crossing scene, 40 steps: D={WORLD_D} bit for bit D=1 "
          f"by uid, counters equal (spawned {int(cw.n_spawned.sum())}, "
          f"despawned {int(cw.n_destroyed.sum())}), migrated "
          f"{int(cw.migrated.sum())}, no overflow, loss or stray",
          flush=True)

    config = scenes.bench_config(N_GATE)
    hl, lp = ParityVelocity((1.0, 0.0)), scenes.bench_zanlungo()
    _, params, st = scenes.build_bench(N_GATE, device=dev)
    s1, e1 = build_step(config, [hl], [lp])(params, st, DT)
    mesh = make_thread_mesh(WORLD_D, dev)
    shards, events = build_sharded_step(config, [hl], [lp], mesh)(
        params, shard_state(mesh, st), DT)
    s2 = gather_shards(shards)
    torch.testing.assert_close(s2.position, s1.position, rtol=1e-6,
                               atol=1e-6)
    if not (torch.equal(s2.alive, s1.alive) and torch.equal(
            gather_shards(events).spawned, e1.spawned)):
        raise AssertionError("8a agent-sharded: alive or spawned differ")
    err_a = (s2.position - s1.position).abs().max().item()
    s3, e3 = build_step(config, [hl], [lp], world_mesh=mesh)(params, st, DT)
    if int(e3.neighbor_truncated):
        raise AssertionError("8a domain-sharded step truncates")
    u3, p3, _ = _by_uid(torch, s3)
    u1, p1, _ = _by_uid(torch, s1)
    if not torch.equal(u3, u1):
        raise AssertionError("8a domain-sharded: other uids alive")
    torch.testing.assert_close(p3, p1, rtol=TOL, atol=TOL)
    print(f"phase 8a agent-sharded step D={WORLD_D} vs one device: max abs "
          f"err {err_a:.3g} (tol 1e-06), alive and spawned equal; "
          f"domain-sharded step D={WORLD_D} vs one device by uid: max abs "
          f"err {(p3 - p1).abs().max().item():.3g} (tol {TOL}), truncated "
          f"0", flush=True)


def _world_kernels(torch, dev):
    """8b: one step of the 1M world at D = 4 with the hotspot in interior
    shard WORLD_SHARD, its kernels' inputs captured and each kernel held
    against its plain version on them."""
    from rmf_crowdsim_tpu_torch import scenes
    from rmf_crowdsim_tpu_torch.ops import pack, spill
    from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
    from rmf_crowdsim_tpu_torch.parallel import worldstep

    rollout, params, shards, _ = scenes.build_world_bench(
        N_MAIN, WORLD_D, "bitwise", capacity=CAP_MAIN, device=dev,
        hotspot=True)
    m = CAP_MAIN // WORLD_D
    shards, _ = rollout(params, shards, DT, 1)
    got = {}

    def capture(name, fn, copy):
        def wrapped(*args, **kw):
            if (threading.current_thread().name == f"shard-{WORLD_SHARD}"
                    and name not in got):
                got[name] = copy(args, kw)
            return fn(*args, **kw)
        # pack_rows counts its launches on its module's name, this one.
        wrapped.launches = 0
        return wrapped

    def clone_all(args, kw):
        return ([a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args], dict(kw))

    patches = [(pack, "pack_rows"), (worldstep, "zanlungo_forces_bucketed"),
               (worldstep, "spill_window")]
    originals = [getattr(mod, name) for mod, name in patches]
    for (mod, name), fn in zip(patches, originals):
        setattr(mod, name, capture(name, fn, clone_all))
    try:
        shards, c = rollout(params, shards, DT, 1)
    finally:
        for (mod, name), fn in zip(patches, originals):
            setattr(mod, name, fn)
    _world_clean(c, "8b", migrating=False)
    if set(got) != {n for _, n in patches}:
        raise AssertionError(f"8b: captured only {sorted(got)}")

    (feat_t, bpos, slots), _ = got["pack_rows"]
    pk_t, pk_T, _ = pack.pack_rows(feat_t, bpos, slots)
    pl_t, pl_T = pack.pack_rows_plain(feat_t, bpos, slots)
    if not (torch.equal(pk_t, pl_t) and torch.equal(pk_T, pl_T)):
        raise AssertionError("8b: K3 differs from its plain version")
    (cfg, zp5, packed_t, packed_T), kw1 = got["zanlungo_forces_bucketed"]
    ip = kw1["int_prio"]
    ids = packed_t[:, zb.ROW_ID]
    live = ids >= 0
    n_halo = int((ids >= m).sum())
    out_k = zb.zanlungo_forces_bucketed(cfg, zp5, packed_t, packed_T,
                                        int_prio=ip)
    out_p = zb.forces_bucketed_plain(cfg, zp5, packed_t, packed_T, ip)
    torch.testing.assert_close(out_k[live], out_p[live], rtol=TOL, atol=TOL)
    err1 = (out_k[live] - out_p[live]).abs().max().item()
    (cfg2, zp5, packed_t, packed_T, rows, tcx, tcy, scratch), kw2 = \
        got["spill_window"]
    rid = rows[:, zb.ROW_ID]
    n_own, n_foreign = int(((rid >= 0) & (rid < m)).sum()), int(
        (rid >= 3 * m).sum())
    if n_own == 0 or n_foreign == 0:
        raise AssertionError(f"8b: shard {WORLD_SHARD} lists {n_own} own "
                             f"and {n_foreign} neighbour spills")
    over = torch.zeros((1,), dtype=torch.int32, device=dev)
    err2, n_q, n_written = _k2_check(torch, spill, zb, cfg2, zp5, packed_t,
                                     packed_T, rows, tcx, tcy, scratch,
                                     kw2["int_prio"], over)
    vel_k = scratch.clone()
    spill.spill_window(cfg2, zp5, packed_t, packed_T, rows, tcx, tcy, vel_k,
                       int_prio=kw2["int_prio"])
    written = (vel_k != scratch).any(1)
    n_tail = int(written[m:].sum())
    print(f"phase 8b kernels on shard {WORLD_SHARD}'s extended block "
          f"({cfg.tx} of the world's columns x {cfg.ty}, {cfg.slots} "
          f"slots; {feat_t.shape[1]} rows): K3 bitwise its plain version; "
          f"K1 on {int(live.sum())} live slots ({n_halo} of them halo rows, "
          f"ids >= m) max abs err {err1:.3g}; K2 on {n_own} own and "
          f"{n_foreign} neighbour spills of {rows.shape[0]}: {n_q} live "
          f"window queries, {n_written} scratch rows written, max abs err "
          f"{err2:.3g} (tol {TOL}); {n_tail} of them past row m = {m} "
          f"(halo queries, neighbour spills), which the shard drops, and "
          f"{int(written[:m].sum())} in [0, m), equal to the plain "
          f"version's", flush=True)


def _world_1m(torch, dev, card, kernels):
    """8c: the 1M world, bitwise D = 4 against D = 1, then each mode timed.
    Returns the launch counts of the timed bitwise steps."""
    from rmf_crowdsim_tpu_torch import scenes
    from rmf_crowdsim_tpu_torch.utils.profile_step import device_kernels

    outs = {}
    for d in (WORLD_D, 1):
        rollout, params, shards, _ = scenes.build_world_bench(
            N_MAIN, d, "bitwise", capacity=CAP_MAIN, device=dev)
        shards, c = rollout(params, shards, DT, 5)
        _world_clean(c, f"8c bitwise D={d}", migrating=d > 1)
        outs[d] = (_world_by_uid(torch, shards), c)
        del rollout, shards
        torch.cuda.empty_cache()
    _same(torch, outs[WORLD_D][0], outs[1][0], "8c 1M world")
    print(f"phase 8c 1M world, 5 steps: D={WORLD_D} ({CAP_MAIN // WORLD_D} "
          f"slots a shard) bit for bit D=1 by uid, positions and "
          f"velocities; migrated {outs[WORLD_D][1].migrated.tolist()}; max "
          f"tile occupancy {int(outs[1][1].max_cell_occupancy.max())}; "
          f"truncated 0", flush=True)
    del outs

    required = ("pack_rows", "zanlungo_bucketed", "spill_window")
    n_steps = 20
    result = {}
    for inv in ("bitwise", "tolerance"):
        rollout, params, shards, mesh = scenes.build_world_bench(
            N_MAIN, WORLD_D, inv, capacity=CAP_MAIN, device=dev)
        shards, _ = rollout(params, shards, DT, WORLD_WARM)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        shards, c = rollout(params, shards, DT, n_steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps
        launches = {k: fn.launches for k, fn in kernels.items()}
        want = {k: n_steps * WORLD_D if k in required else 0
                for k in kernels}
        if launches != want:
            raise AssertionError(f"8c {inv}: launches {launches}, not {want}")
        _world_clean(c, f"8c {inv}")
        if not torch.equal(c.n_alive, torch.full_like(c.n_alive, N_MAIN)):
            raise AssertionError(f"8c {inv}: population not conserved")
        if not all(bool(torch.isfinite(s.position).all()) for s in shards):
            raise AssertionError(f"8c {inv}: state not finite")
        print(f"phase 8c 1M world {inv} D={WORLD_D}: {n_steps} steps, "
              f"{1e3 * wall:.3f} ms/step on '{card}'; migrated "
              f"{int(c.migrated.sum())} ({c.migrated.float().mean():.1f} a "
              f"step), overflow 0, arrivals dropped 0, stray 0; population "
              f"{N_MAIN} every step; resorted {int(c.resorted.sum())} of "
              f"{WORLD_D * n_steps} shard-steps; truncated 0; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        state = {"s": shards}

        def steps():
            state["s"], _ = rollout(params, state["s"], DT, 3)

        _host_syncs(torch, f"phase 8c 1M world {inv}", steps, 3,
                    limit=WORLD_D)

        def run():
            steps()
            torch.cuda.synchronize()

        prof = device_kernels(run, 3)
        print(f"phase 8c 1M world {inv} profile: "
              f"{prof['launches_per_step']:.1f} kernel launches/step, device "
              f"busy {prof['device_busy_ms']:.3f} ms/step, idle share "
              f"{1 - prof['device_busy_ms'] / (1e3 * wall):.3f}", flush=True)
        for ms, n, kname in prof["top"][:8]:
            print(f"  {ms:.4f} ms/step  {n:6.1f} launches/step  {kname[:90]}")
        result[inv] = launches
        if inv == "bitwise":
            # The same steps with the shards' turns off (parallel/comm.py).
            mesh.turns = False
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["s"], _ = rollout(params, state["s"], DT, 5)
            torch.cuda.synchronize()
            print(f"phase 8c 1M world bitwise with the shards' turns off: "
                  f"{1e3 * (time.perf_counter() - t0) / 5:.3f} ms/step "
                  f"(5 steps)", flush=True)
            mesh.turns = True
        del rollout, shards, state
        torch.cuda.empty_cache()

    rollout, params, st = scenes.build_bench(N_MAIN, device=dev)
    st, _ = rollout(params, st, DT, WORLD_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = rollout(params, st, DT, n_steps)
    torch.cuda.synchronize()
    print(f"phase 8c the single-device main path in this call: "
          f"{1e3 * (time.perf_counter() - t0) / n_steps:.3f} ms/step",
          flush=True)
    del rollout, st
    torch.cuda.empty_cache()
    return result["bitwise"]


def _shard_proxy(torch, dev, card):
    """8d: one shard of the 10-shard 1M world (bench.py:162-260)."""
    from rmf_crowdsim_tpu_torch import scenes

    for inv in ("bitwise", "tolerance"):
        rollout, params, shards, _ = scenes.build_shard_proxy(10, inv,
                                                              device=dev)
        n = int(shards[0].num_alive)
        shards, _ = rollout(params, shards, DT, WORLD_WARM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards, c = rollout(params, shards, DT, 20)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 20
        if int(c.neighbor_truncated.sum()) or not bool(
                torch.isfinite(shards[0].position).all()):
            raise AssertionError(f"8d {inv}: truncated or not finite")
        print(f"phase 8d shard proxy {inv}: one shard of a 10-shard 1M "
              f"world, {n} agents on {shards[0].capacity} slots, 20 steps, "
              f"{1e3 * wall:.3f} ms/step on '{card}'; truncated 0",
              flush=True)


def _nccl_world(torch, dev):
    """8e: the crossing scene's world rollout over ``ProcessGroupComm`` on
    an NCCL group of one rank, against ``ThreadMesh``."""
    import torch.distributed as dist

    from rmf_crowdsim_tpu_torch import scenes
    from rmf_crowdsim_tpu_torch.parallel import (
        ProcessGroupComm, build_world_rollout, make_thread_mesh,
        shard_state_by_region)
    from rmf_crowdsim_tpu_torch.parallel.comm import init_process_group

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    init_process_group("nccl", 0, 1, f"tcp://localhost:{port}")
    try:
        out = {}
        for name in ("nccl", "threads"):
            cfg, hl, lp, params, st = scenes.crossing_scene(device=dev)
            mesh = (ProcessGroupComm(device=dev) if name == "nccl"
                    else make_thread_mesh(1, dev))
            shards, c = build_world_rollout(cfg, [hl], [lp], mesh)(
                params, shard_state_by_region(cfg, mesh, st), 1.0, 40)
            out[name] = (shards[0], c)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    (sn, cn), (st_, ct) = out["nccl"], out["threads"]
    for k in ("position", "velocity", "alive", "uid"):
        if not torch.equal(getattr(sn, k), getattr(st_, k)):
            raise AssertionError(f"8e: {k} differs from ThreadMesh's")
    for k in WORLD_COUNTERS:
        if not torch.equal(getattr(cn, k), getattr(ct, k)):
            raise AssertionError(f"8e: {k} differs from ThreadMesh's")
    print(f"phase 8e ProcessGroupComm over {backend} (world size 1, "
          f"{time.perf_counter() - t0:.1f} s with init): the crossing "
          f"scene's 40-step world rollout ({int(cn.n_spawned.sum())} "
          f"spawned) bit for bit ThreadMesh's, counters equal", flush=True)


def _world_phase(torch, dev, card, kernels):
    """Phase 8; returns the launch counts of 8c's timed bitwise steps."""
    _world_gates(torch, dev)
    torch.cuda.empty_cache()
    _world_kernels(torch, dev)
    torch.cuda.empty_cache()
    launches = _world_1m(torch, dev, card, kernels)
    _shard_proxy(torch, dev, card)
    torch.cuda.empty_cache()
    _nccl_world(torch, dev)
    return launches


def _bench_phase(kernels, card):
    """9a: the port's bench (``rmf_crowdsim_tpu_torch.bench``) at its
    defaults, in this process, with the launch counts set to 0 just before
    and read just after; returns them."""
    from rmf_crowdsim_tpu_torch import bench

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = bench.run()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    missing = [k for k in MAIN_KERNELS if launches[k] == 0]
    stray = [k for k in launches if k not in MAIN_KERNELS and launches[k]]
    if missing or stray:
        raise AssertionError(f"9a bench: never launched {missing}, "
                             f"launched {stray}")
    extra = result["extra"]
    if extra["compiled_parity"] is not True or (
            extra["neighbor_backend"] != "grid_pallas"):
        raise AssertionError(f"9a bench: gate or backend wrong: {extra}")
    cells = [result["value"], extra["p50_step_ms"],
             extra["steps_per_sec_rmf10k"], extra["steps_per_sec_1000"],
             extra["steps_per_sec_100000"],
             extra["rmf10k_host_planning"]["host_plan_s_10k_agents"]] + [
        extra[k]["ms_per_step"] for k in (
            "multichip_shard_proxy", "multichip_shard_proxy_tolerance",
            "multichip_shard_proxy_tolerance_d16")]
    if not all(isinstance(v, float) and v > 0 for v in cells):
        raise AssertionError(f"9a bench: a cell is not a positive number: "
                             f"{cells}")
    print(f"phase 9 bench: {json.dumps(result)}", flush=True)
    print(f"phase 9a bench: {wall:.1f} s in all on '{card}'; launches "
          f"{launches}", flush=True)
    return launches


def _validate_phase(dev, card):
    """9b: ``validate_highD`` at D = 16 on the card, both modes, and its
    halo table."""
    from rmf_crowdsim_tpu_torch.tools import validate_highD

    validate_highD.halo_table()
    t0 = time.perf_counter()
    r = validate_highD.validate(16, dev)
    print(f"phase 9b validate_highD: D = 16 on '{card}': bitwise D = 1 bit "
          f"for bit over {r['agents']} agents, {r['migrations']} "
          f"migrations; tolerance max abs diff {r['tolerance_max_diff']} "
          f"(tol {validate_highD.TOL}), lifecycle counters equal, "
          f"{r['resorted']} of {r['shard_steps']} shard-steps re-sorted; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# Phase 10: the SimConfig knobs of which one case must keep the defaults.
DEFAULT_KNOBS = ("bucket_capacity", "bucket_tile_size", "presort",
                 "integer_priorities", "use_pack_kernel", "fused_spills")


def _fuzz_phase(torch, dev, card, kernels):
    """Phase 10: the randomized differential sweep on the card.  10a, the
    43 cases of tests/test_fuzz_step.py (``scenes.fuzz_cases``); 10b, the
    16 wide cases (``scenes.wide_cases``): each through the port's
    sessions, every fast backend against ``brute`` by uid at the JAX
    file's tolerances, counters equal, truncation 0.  The launch counts
    are set to 0 before the phase and read after it; every kernel of
    ``kernels`` (the five of the simulator's paths) must have launched, a fused-spill wide case must
    have passed more spills than K1b's lanes through K2's storm branch,
    and a ``grid_pallas`` case must have kept every ``DEFAULT_KNOBS`` at
    ``SimConfig``'s default.  Returns the launch counts."""
    import dataclasses

    from rmf_crowdsim_tpu_torch import SimConfig, scenes
    from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb

    defaults = {f.name: f.default for f in dataclasses.fields(SimConfig)
                if f.name in DEFAULT_KNOBS}
    for fn in kernels.values():
        fn.launches = 0
    default_cases, storms = [], []
    for label, cases in (("10a", scenes.fuzz_cases()),
                         ("10b", scenes.wide_cases())):
        t0 = time.perf_counter()
        errs, shares, steps, occ, spills = {}, {}, 0, 0, 0
        for case in cases:
            out = scenes.run_fuzz_case(case, dev)
            if out["truncated"] or out["steps"] != case.n_steps:
                raise AssertionError(f"phase {label} {case.name}: "
                                     f"{out['truncated']} truncated, "
                                     f"{out['steps']} steps")
            steps += out["steps"]
            for b, e in out["err"].items():
                errs[b] = max(errs.get(b, 0.0), e)
                shares[b] = max(shares.get(b, 0.0), out["share"][b])
            occ = max(occ, out["max_occ"])
            spills = max(spills, out["max_spills"])
            cfg = scenes.fuzz_config(case, case.fast[-1])
            if "grid_pallas" in case.fast and all(
                    getattr(cfg, k) == v for k, v in defaults.items()):
                default_cases.append(case.name)
            if (label == "10b" and cfg.fused_spills
                    and out["max_spills"] > zb.FUSED_SPILL_LANES):
                storms.append(case.name)
        torch.cuda.synchronize()
        err_text = ", ".join(
            f"{b} {e:.3g} ({100 * shares[b]:.1f}% of rtol = atol = "
            f"{scenes.FUZZ_TOL[b]})" for b, e in sorted(errs.items()))
        print(f"phase {label} fuzz sweep on '{card}': {len(cases)} cases, "
              f"{steps} steps, each against brute by uid; max abs err "
              f"{err_text}; counters equal; truncated 0; largest tile "
              f"occupancy {occ}, spills {spills}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = {k: fn.launches for k, fn in kernels.items()}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"phase 10: never launched {missing}")
    if not storms:
        raise AssertionError(f"phase 10b: no fused-spill case passed more "
                             f"than {zb.FUSED_SPILL_LANES} spills through "
                             f"K2's storm branch")
    if not default_cases:
        raise AssertionError(f"phase 10: no grid_pallas case kept the "
                             f"defaults {defaults}")
    print(f"phase 10 launches {launches}; K2 storm (> "
          f"{zb.FUSED_SPILL_LANES} spills) in {storms}; the defaults "
          f"{defaults} in {len(default_cases)} cases ({default_cases[0]} "
          f"first)", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rmf_crowdsim_tpu_torch import scenes
    from rmf_crowdsim_tpu_torch.core.step import build_rollout, spawn_blocked
    from rmf_crowdsim_tpu_torch.ops.spawn_gate import spawn_blocked_plain
    from rmf_crowdsim_tpu_torch.ops import pack, spill
    from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as zb
    from rmf_crowdsim_tpu_torch.ops import zanlungo_dense as zd
    from rmf_crowdsim_tpu_torch.utils import cuda_build
    from rmf_crowdsim_tpu_torch.utils import roofline as rl
    from rmf_crowdsim_tpu_torch.utils.profile_step import (
        card_line, cuda_ms_in_turns, kernel_device_ms)

    def bound_text(b, ms):
        return (f"bound {b.ms:.4f} ms ({b.bound_by}: {b.bytes} B, {b.ops} "
                f"f32 ops), {100 * b.ms / ms:.1f}% of bound")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: nvidia-smi '{card}'; torch '{kind}'; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    cuda_build.library()
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: {build_s:.1f} s -> {cuda_build.library_path()}",
          flush=True)
    for line in cuda_build.build_log().splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- phase 3: kernels vs plain versions at the 1M bench shapes ------
    config, bcfg, params, st, rec, feat_t, bpos, bucket_pos = (
        scenes.bench_bucketed(N_MAIN, device=dev))
    results = {}

    packed_t, packed_T, _ = pack.pack_rows(feat_t, bpos, bcfg.slots)
    plain_t, plain_T = pack.pack_rows_plain(feat_t, bpos, bcfg.slots)
    err3 = max((packed_t - plain_t).abs().max().item(),
               (packed_T - plain_T).abs().max().item())
    if not (torch.equal(packed_t, plain_t) and torch.equal(packed_T, plain_T)):
        raise AssertionError(f"K3 pack differs from its plain version "
                             f"(max abs err {err3})")
    ms, pms = cuda_ms_in_turns(
        lambda: pack.pack_rows(feat_t, bpos, bcfg.slots),
        lambda: pack.pack_rows_plain(feat_t, bpos, bcfg.slots), 10)
    b3 = rl.Bound(rl.k3_bytes(N_MAIN, bcfg.slots))
    results["pack_rows"] = dict(err=err3, ms=ms, plain_ms=pms, bound=b3)
    print(f"phase 3 K3 pack_rows: {N_MAIN} rows -> {bcfg.slots} slots, "
          f"bitwise equal; kernel {ms:.3f} ms, plain {pms:.3f} ms, "
          f"{bound_text(b3, ms)}", flush=True)

    zp5 = zb.zparams5(params.lp[0])
    live = packed_T[zb.ROW_ID] >= 0
    n_live = int(live.sum())
    err1, t1 = 0.0, []
    for int_prio in (True, False):
        over = torch.zeros((1,), dtype=torch.int32, device=dev)
        out_k = zb.zanlungo_forces_bucketed(bcfg, zp5, packed_t, packed_T,
                                            int_prio=int_prio, overflow=over)
        out_p = zb.forces_bucketed_plain(bcfg, zp5, packed_t, packed_T,
                                         int_prio)
        n_forced = int(((out_p - packed_t[:, 8:10]).abs().sum(1)
                        > 0)[live].sum())
        torch.testing.assert_close(out_k[live], out_p[live], rtol=TOL,
                                   atol=TOL)
        e = (out_k[live] - out_p[live]).abs().max().item()
        err1 = max(err1, e)
        ms, pms = cuda_ms_in_turns(
            lambda: zb.zanlungo_forces_bucketed(
                bcfg, zp5, packed_t, packed_T, int_prio=int_prio),
            lambda: zb.forces_bucketed_plain(bcfg, zp5, packed_t,
                                             packed_T, int_prio), 3)
        b1 = rl.Bound(rl.k1_bytes(bcfg, n_live),
                      rl.k1_work(bcfg, zp5, packed_t, packed_T).ops(int_prio))
        t1.append((ms, pms, b1))
        print(f"phase 3 K1 zanlungo_bucketed int_prio={int_prio}: "
              f"{n_live} live slots ({n_forced} with forces) of "
              f"{bcfg.slots}; {int(over.item())} list overflows; max abs "
              f"err {e:.3g} (tol {TOL}); kernel {ms:.3f} ms, plain "
              f"{pms:.3f} ms, {bound_text(b1, ms)}", flush=True)
    results["zanlungo_bucketed"] = dict(err=err1, ms=t1[0][0],
                                        plain_ms=t1[0][1], bound=t1[0][2])

    c_sp, rows, sp_tcx, sp_tcy = spill.spill_rows(
        bcfg, st.position, st.velocity, rec, st.preferred_vel, st.priority,
        st.eyesight, st.alive, rec, bucket_pos, config.spill_capacity)
    n_spill = int(c_sp.count)
    if n_spill == 0:
        raise AssertionError("the 1M hotspot scene has no spills")
    err2, t2 = 0.0, []
    for int_prio in (True, False):
        over = torch.zeros((1,), dtype=torch.int32, device=dev)
        e, n_live_q, n_written = _k2_check(torch, spill, zb, bcfg, zp5,
                                           packed_t, packed_T, rows, sp_tcx,
                                           sp_tcy, rec, int_prio, over)
        err2 = max(err2, e)
        vel_k, vel_p = rec.clone(), rec.clone()

        def k2():
            spill.spill_window(bcfg, zp5, packed_t, packed_T, rows, sp_tcx,
                               sp_tcy, vel_k, int_prio=int_prio)

        ms, pms = cuda_ms_in_turns(
            k2, lambda: spill.spill_window_plain(
                bcfg, zp5, packed_t, packed_T, rows, sp_tcx, sp_tcy, vel_p,
                int_prio), 10)
        dev_ms = kernel_device_ms(k2, 20, "spill_window_kernel")
        b2 = rl.Bound(rl.k2_bytes(bcfg, zp5, packed_t, rows, sp_tcx, sp_tcy,
                                  vel_k),
                      rl.k2_work(bcfg, zp5, packed_t, packed_T, rows, sp_tcx,
                                 sp_tcy).ops(int_prio))
        t2.append((ms, pms, b2, dev_ms))
        print(f"phase 3 K2 spill_window int_prio={int_prio}: {n_spill} "
              f"spills in {rows.shape[0]} slots (spill_capacity "
              f"{config.spill_capacity}), {n_live_q} live "
              f"window queries, {n_written} velocity rows written; "
              f"{int(over.item())} list overflows; window rows, own rows, "
              f"written rows and windows off: max abs err {e:.3g} (tol "
              f"{TOL}); kernel {ms:.4f} ms a call (CUDA events, as the "
              f"other kernels), {dev_ms:.4f} ms on the device (profiler), "
              f"plain {pms:.3f} ms, {bound_text(b2, ms)}; "
              f"{100 * b2.ms / dev_ms:.1f}% of bound on the device time",
              flush=True)
    results["spill_window"] = dict(err=err2, ms=t2[0][0], plain_ms=t2[0][1],
                                   bound=t2[0][2], device_ms=t2[0][3])

    # K1b: its spill plane is the first rows of the spill list, as
    # zanlungo_fused takes it.
    n_f = min(zb.FUSED_SPILL_LANES, config.spill_capacity)
    sflag = spill.spill_flags(bcfg, sp_tcx[:n_f], sp_tcy[:n_f],
                              c_sp.valid[:n_f])
    sp_fT = spill.spill_candidates(rows[:n_f])
    n_flagged = int((sflag > 0).sum())
    if n_flagged == 0:
        raise AssertionError("K1b: no sub-block is flagged")
    flagged = zb.slot_flags(bcfg, sflag)
    err1b, t1b = 0.0, []
    for int_prio in (True, False):
        over = torch.zeros((1,), dtype=torch.int32, device=dev)
        out_k = zb.zanlungo_forces_bucketed_spill(
            bcfg, zp5, packed_t, packed_T, sflag, sp_fT, int_prio=int_prio,
            overflow=over)
        out_p = zb.forces_bucketed_spill_plain(
            bcfg, zp5, packed_t, packed_T, sflag, sp_fT, int_prio)
        out_1 = zb.zanlungo_forces_bucketed(bcfg, zp5, packed_t, packed_T,
                                            int_prio=int_prio)
        torch.testing.assert_close(out_k[live], out_p[live], rtol=TOL,
                                   atol=TOL)
        if not torch.equal(out_k[~flagged], out_1[~flagged]):
            raise AssertionError("K1b differs from K1 on unflagged slots")
        n_changed = int(((out_k - out_1).abs().sum(1) > 0).sum())
        n_over = int(over.item())
        e = (out_k[live] - out_p[live]).abs().max().item()
        err1b = max(err1b, e)
        ms, pms = cuda_ms_in_turns(
            lambda: zb.zanlungo_forces_bucketed_spill(
                bcfg, zp5, packed_t, packed_T, sflag, sp_fT,
                int_prio=int_prio),
            lambda: zb.forces_bucketed_spill_plain(
                bcfg, zp5, packed_t, packed_T, sflag, sp_fT, int_prio), 3)
        b1b = rl.Bound(rl.k1b_bytes(bcfg, n_live, sp_fT),
                       rl.k1b_work(bcfg, zp5, packed_t, packed_T, sflag,
                                   sp_fT).ops(int_prio))
        t1b.append((ms, pms, b1b))
        print(f"phase 3 K1b zanlungo_bucketed_spill int_prio={int_prio}: "
              f"{n_spill} spills, {n_flagged} flagged sub-blocks "
              f"({int(flagged.sum())} slots, {n_changed} changed vs K1, "
              f"the rest bitwise K1); {n_over} list overflows; "
              f"max abs err {e:.3g} (tol {TOL}); kernel {ms:.3f} ms, plain "
              f"{pms:.3f} ms, {bound_text(b1b, ms)}", flush=True)
    results["zanlungo_bucketed_spill"] = dict(err=err1b, ms=t1b[0][0],
                                              plain_ms=t1b[0][1],
                                              bound=t1b[0][2])

    # The whole fused pass against the spill-patch pass, same state.
    passes = {}
    for fused in (True, False):
        vel, _, dropped = zb.zanlungo_fused(
            bcfg, params.lp[0], st.position, st.velocity, rec,
            st.preferred_vel, st.priority, st.eyesight, st.alive, rec,
            use_pack_kernel=True, spill_capacity=config.spill_capacity,
            presorted=True, int_prio=True, fused_spills=fused)
        if int(dropped):
            raise AssertionError(f"fused_spills={fused} drops {dropped}")
        passes[fused] = vel
    a = st.alive
    torch.testing.assert_close(passes[True][a], passes[False][a], rtol=TOL,
                               atol=TOL)
    e = (passes[True][a] - passes[False][a]).abs().max().item()
    if not torch.equal(passes[True][a], passes[False][a]):
        raise AssertionError("the fused pass differs from the spill-patch "
                             "pass")
    print(f"phase 3 fused pass: {N_MAIN} agents, fused_spills=True vs the "
          f"spill patch: equal (max abs err {e:.3g}); dropped 0",
          flush=True)
    del (params, st, feat_t, packed_t, packed_T, plain_t, plain_T,
         out_k, out_p, out_1, passes)
    torch.cuda.empty_cache()

    # The re-walk of queries with more than K1_LIST_CAP hits, on states
    # that have them: the 1M scene one step in, while its hotspot is still
    # packed (K1b's spill segment adds the spilled part of it), and a
    # 4,096-agent scene whose hotspot straddles a tile corner, so its four
    # buckets hold all of it and K1 alone sees ~47 neighbours a query.
    gcfg = scenes.bench_bucket_config(N_GATE)
    corner = (gcfg.offset[0] + gcfg.tile_size * (gcfg.tx // 2) - 1.0,
              gcfg.offset[1] + gcfg.tile_size * (gcfg.ty // 2) - 1.0)
    rewalked = {"K1": 0, "K1b": 0, "K2": 0}
    for label, n, scene in (
            (f"{N_MAIN}-agent hotspot, 1 step", N_MAIN, {}),
            (f"{N_GATE}-agent corner hotspot ({corner[0]:.2f}, "
             f"{corner[1]:.2f}),"
             " 1 step", N_GATE, dict(hotspot_origin=corner))):
        wconfig, wcfg, wparams, wst, wrec, wfeat, wbpos, wbucket = (
            scenes.bench_bucketed(n, device=dev, steps=1, **scene))
        w_t, w_T, _ = pack.pack_rows(wfeat, wbpos, wcfg.slots)
        w_live = w_T[zb.ROW_ID] >= 0
        wzp5 = zb.zparams5(wparams.lp[0])
        c_w, rows_w, w_tcx, w_tcy = spill.spill_rows(
            wcfg, wst.position, wst.velocity, wrec, wst.preferred_vel,
            wst.priority, wst.eyesight, wst.alive, wrec, wbucket,
            wconfig.spill_capacity)
        n_wf = min(zb.FUSED_SPILL_LANES, wconfig.spill_capacity)
        w_flag = spill.spill_flags(wcfg, w_tcx[:n_wf], w_tcy[:n_wf],
                                   c_w.valid[:n_wf])
        w_spT = spill.spill_candidates(rows_w[:n_wf])
        for int_prio in (True, False):
            counts = {}
            for name, kernel, plain in (
                    ("K1", lambda o: zb.zanlungo_forces_bucketed(
                        wcfg, wzp5, w_t, w_T, int_prio=int_prio, overflow=o),
                     lambda: zb.forces_bucketed_plain(wcfg, wzp5, w_t, w_T,
                                                      int_prio)),
                    ("K1b", lambda o: zb.zanlungo_forces_bucketed_spill(
                        wcfg, wzp5, w_t, w_T, w_flag, w_spT,
                        int_prio=int_prio, overflow=o),
                     lambda: zb.forces_bucketed_spill_plain(
                         wcfg, wzp5, w_t, w_T, w_flag, w_spT, int_prio))):
                over = torch.zeros((1,), dtype=torch.int32, device=dev)
                out_k = kernel(over)
                out_p = plain()
                torch.testing.assert_close(out_k[w_live], out_p[w_live],
                                           rtol=TOL, atol=TOL)
                e = (out_k[w_live] - out_p[w_live]).abs().max().item()
                counts[name] = (int(over.item()), e)
            over = torch.zeros((1,), dtype=torch.int32, device=dev)
            e, _, _ = _k2_check(torch, spill, zb, wcfg, wzp5, w_t, w_T,
                                rows_w, w_tcx, w_tcy, wrec, int_prio, over)
            counts["K2"] = (int(over.item()), e)
            for name in rewalked:
                rewalked[name] += counts[name][0]
            print(f"phase 3 re-walk, {label}, int_prio={int_prio}: "
                  f"{int(c_w.count)} spills; list overflows (re-walked "
                  f"queries) K1 {counts['K1'][0]}, K1b {counts['K1b'][0]}, "
                  f"K2 {counts['K2'][0]}; max abs err K1 "
                  f"{counts['K1'][1]:.3g}, K1b {counts['K1b'][1]:.3g}, K2 "
                  f"{counts['K2'][1]:.3g} (tol {TOL})", flush=True)
        del wparams, wst, wrec, wfeat, w_t, w_T, out_k, out_p
    for name, count in rewalked.items():
        if count == 0:
            raise AssertionError(f"{name}: no query overflowed its "
                                 f"neighbour list; the re-walk never ran")
    torch.cuda.empty_cache()

    # K4 at the 1M bench grid_dense shapes.
    dcfg = scenes.bench_dense_config(N_MAIN)
    geo = zd.k4_geometry(dcfg, N_MAIN)
    rollout, params, st = scenes.build_bench(N_MAIN, backend="grid_dense",
                                             device=dev, hotspot=True)
    st, _ = rollout(params, st, DT, 2)
    st, feat, tile_start, rows, occ = _dense_inputs(torch, dcfg, params, st)
    err4, t4 = 0.0, []
    for int_prio in (True, False):
        over = torch.zeros((2,), dtype=torch.int32, device=dev)
        out_k = zd.zanlungo_forces_dense(dcfg, zp5, feat, tile_start,
                                         int_prio=int_prio, overflow=over)
        out_p = zd.forces_dense_plain(dcfg, zp5, feat, tile_start, int_prio)
        n_forced = int(((out_p[rows] - feat[st.alive, 8:10]).abs().sum(1)
                        > 0).sum())
        torch.testing.assert_close(out_k[rows], out_p[rows], rtol=TOL,
                                   atol=TOL)
        e = (out_k[rows] - out_p[rows]).abs().max().item()
        err4 = max(err4, e)
        ms, pms = cuda_ms_in_turns(
            lambda: zd.zanlungo_forces_dense(
                dcfg, zp5, feat, tile_start, int_prio=int_prio),
            lambda: zd.forces_dense_plain(dcfg, zp5, feat, tile_start,
                                          int_prio), 3)
        b4 = rl.Bound(rl.k4_bytes(dcfg, feat),
                      rl.k4_work(dcfg, zp5, feat, tile_start).ops(int_prio))
        t4.append((ms, pms, b4))
        n_rewalk, n_inplace = over.tolist()
        print(f"phase 3 K4 zanlungo_dense int_prio={int_prio}: "
              f"{rows.shape[0]} live rows ({n_forced} with forces) in "
              f"{dcfg.slots} padded rows ({dcfg.tx} columns of "
              f"{dcfg.col_cap}), max tile occupancy {occ}; {geo}; "
              f"{n_rewalk} list overflows, {n_inplace} blocks in place; "
              f"max abs err {e:.3g} (tol {TOL}); kernel {ms:.3f} ms, plain "
              f"{pms:.3f} ms, {bound_text(b4, ms)}", flush=True)
    results["zanlungo_dense"] = dict(err=err4, ms=t4[0][0],
                                     plain_ms=t4[0][1], bound=t4[0][2])

    # K4's two exact detours on the card: the same state with two crowds
    # (_dense_clusters), one past the stage, one past the list.
    hot = _dense_clusters(torch, dcfg, st, tile_start, geo)
    hot, feat, tile_start, rows, occ = _dense_inputs(torch, dcfg, params, hot)
    detours = [0, 0]
    for int_prio in (True, False):
        over = torch.zeros((2,), dtype=torch.int32, device=dev)
        out_k = zd.zanlungo_forces_dense(dcfg, zp5, feat, tile_start,
                                         int_prio=int_prio, overflow=over)
        out_p = zd.forces_dense_plain(dcfg, zp5, feat, tile_start, int_prio)
        torch.testing.assert_close(out_k[rows], out_p[rows], rtol=TOL,
                                   atol=TOL)
        e = (out_k[rows] - out_p[rows]).abs().max().item()
        counts = over.tolist()
        detours = [a + b for a, b in zip(detours, counts)]
        print(f"phase 3 K4 detours int_prio={int_prio}: crowds of "
              f"{geo.stage_rows // 2 + 1} and {K4_REWALK_CLUSTER} rows, max "
              f"tile occupancy {occ}; list overflows (re-walked queries) "
              f"{counts[0]}, blocks in place {counts[1]}; max abs err "
              f"{e:.3g} (tol {TOL})", flush=True)
    if min(detours) == 0:
        raise AssertionError(f"K4: a detour never ran on the card (list "
                             f"overflows, blocks in place: {detours})")
    del rollout, params, st, hot, feat, out_k, out_p
    torch.cuda.empty_cache()

    _fresh_dead(torch, dev)
    torch.cuda.empty_cache()

    # ---- phase 4: gates against brute ----------------------------------
    gates = {"grid_pallas": dict(backend="grid_pallas"),
             "grid_pallas fused_spills": dict(backend="grid_pallas",
                                              fused_spills=True),
             "grid_dense": dict(backend="grid_dense")}
    outs, occs = {}, {}
    for name, kw in {"brute": dict(backend="brute"), **gates}.items():
        rollout, params, st = scenes.build_bench(N_GATE, device=dev,
                                                 hotspot=True, **kw)
        st, c = rollout(params, st, DT, 5)
        truncated = int(c.neighbor_truncated.max())
        if truncated:
            raise AssertionError(f"gate scene truncates {truncated} on "
                                 f"{name}")
        outs[name] = st.position[torch.argsort(st.uid)]
        occs[name] = int(c.max_cell_occupancy.max())
    for name in gates:
        if name.startswith("grid_pallas") and (
                occs[name] <= config.bucket_capacity):
            raise AssertionError(f"gate scene does not overflow a bucket "
                                 f"on {name}")
        torch.testing.assert_close(outs[name], outs["brute"], rtol=TOL,
                                   atol=TOL)
        gate_err = (outs[name] - outs["brute"]).abs().max().item()
        print(f"phase 4 gate {name}: {N_GATE} agents + hotspot, 5 steps, "
              f"vs brute by uid: max abs err {gate_err:.3g} (tol {TOL}); "
              f"max tile occupancy {occs[name]}; truncated 0", flush=True)

    # The streaming gate: the same scene with 16 sources.
    souts = {}
    for name, kw in {"brute": dict(backend="brute"), **gates,
                     "grid": dict(backend="grid")}.items():
        rollout, params, st = scenes.build_streams(
            N_GATE, CAP_GATE, N_GATE_SOURCES, device=dev, hotspot=True, **kw)
        st, c = rollout(params, st, DT, 8)
        truncated = int(c.neighbor_truncated.max())
        if truncated:
            raise AssertionError(f"streaming gate truncates {truncated} on "
                                 f"{name}")
        uid = st.uid[st.alive]
        order = torch.argsort(uid)
        souts[name] = (uid[order], st.position[st.alive][order], c)
    b_uid, b_pos, b_c = souts.pop("brute")
    if int(b_c.n_spawned.sum()) == 0:
        raise AssertionError("the streaming gate spawns nothing")
    for name, (uid, pos, c) in souts.items():
        if not torch.equal(uid, b_uid):
            raise AssertionError(f"streaming gate {name}: other agents "
                                 f"alive than on brute")
        for k in STREAM_COUNTERS:
            if not torch.equal(getattr(c, k), getattr(b_c, k)):
                raise AssertionError(f"streaming gate {name}: {k} differs "
                                     f"from brute")
        torch.testing.assert_close(pos, b_pos, rtol=TOL, atol=TOL)
        gate_err = (pos - b_pos).abs().max().item()
        print(f"phase 4 streaming gate {name}: {N_GATE} agents + hotspot, "
              f"{N_GATE_SOURCES} sources, capacity {CAP_GATE}, 8 steps, vs "
              f"brute: {uid.shape[0]} uids alive, the same; counters equal "
              f"(spawned {int(c.n_spawned.sum())}, reached "
              f"{int(c.n_waypoint_reached.sum())}, despawned "
              f"{int(c.n_destroyed.sum())}, dropped "
              f"{int(c.spawn_dropped.sum())}); max abs err {gate_err:.3g} "
              f"(tol {TOL}); truncated 0", flush=True)

    # ---- phase 5: the 1M bench scene on three paths ----------------------
    kernels = {
        "pack_rows": pack.pack_rows,
        "zanlungo_bucketed": zb.zanlungo_forces_bucketed,
        "spill_window": spill.spill_window,
        "zanlungo_bucketed_spill": zb.zanlungo_forces_bucketed_spill,
        "zanlungo_dense": zd.zanlungo_forces_dense,
        "spawn_blocked": spawn_blocked,
    }
    # (scene options, kernels that must launch, kernels that must not);
    # the bench scene has no sources, so no path of it runs the gate.
    paths = {
        "main grid_pallas": (
            dict(backend="grid_pallas"), MAIN_KERNELS,
            ("zanlungo_bucketed_spill", "zanlungo_dense", "spawn_blocked")),
        "path A grid_dense": (
            dict(backend="grid_dense"), ("zanlungo_dense",),
            ("pack_rows", "zanlungo_bucketed", "spill_window",
             "zanlungo_bucketed_spill", "spawn_blocked")),
        "path B grid_pallas fused_spills": (
            dict(backend="grid_pallas", fused_spills=True),
            ("pack_rows", "zanlungo_bucketed_spill", "spill_window"),
            ("zanlungo_bucketed", "zanlungo_dense", "spawn_blocked")),
    }
    launches, walls, profs, gate_paths = {}, {}, {}, {}
    for name, (kw, required, absent) in paths.items():
        rollout, params, st = scenes.build_bench(N_MAIN, device=dev, **kw)
        counts, walls[name], profs[name], _ = _drive(
            torch, name, rollout, params, st, kernels, required, absent, card)
        for k in required:
            launches.setdefault(k, counts[k])
        gate_paths[name] = counts["spawn_blocked"]
        del rollout, params, st
        torch.cuda.empty_cache()

    # Path C: the 1M bench crowd with 1,024 streaming sources.
    name = "path C grid_pallas streams"
    rollout, params, st = scenes.build_streams(N_MAIN, CAP_MAIN, N_SOURCES,
                                               device=dev)
    launches_c, wall_c, prof_c, st = _drive(
        torch, name, rollout, params, st, kernels,
        MAIN_KERNELS + ("spawn_blocked",),
        ("zanlungo_bucketed_spill", "zanlungo_dense"), card, warm=STREAM_WARM,
        check=_stream_check(torch, name))
    gates = launches_c["spawn_blocked"]
    if gates != 20:
        raise AssertionError(f"{name}: the gate kernel launched {gates} "
                             f"times in 20 timed steps")
    gate_paths[name] = gates
    launches["spawn_blocked"] = gates
    sp = params.sources
    clear = scenes.stream_config(N_MAIN, CAP_MAIN).spawn_clearance
    gate_args = (st.position, st.alive, sp.source, clear)
    blocked = spawn_blocked(*gate_args)
    gate_err = float((blocked.to(torch.int8)
                      - spawn_blocked_plain(*gate_args).to(torch.int8))
                     .abs().max())
    if gate_err:
        raise AssertionError(f"{name}: the gate kernel differs from "
                             f"spawn_blocked_plain")
    gate_ms, plain_ms = cuda_ms_in_turns(
        lambda: spawn_blocked(*gate_args),
        lambda: spawn_blocked_plain(*gate_args), 10)
    gate_dev = kernel_device_ms(lambda: spawn_blocked(*gate_args), 10,
                                "spawn_gate_kernel")
    gate_b = rl.gate_bound(CAP_MAIN, int(st.num_alive), N_SOURCES)
    results["spawn_blocked"] = dict(err=gate_err, ms=gate_ms,
                                    plain_ms=plain_ms, bound=gate_b,
                                    device_ms=gate_dev)
    main = "main grid_pallas"
    print(f"phase 5 {name} clearance gate G1 ({N_SOURCES} sources x "
          f"{CAP_MAIN} slots, {int(blocked.sum())} blocked, bitwise "
          f"spawn_blocked_plain; {gates} launches in the 20 timed steps): "
          f"{gate_ms:.4f} ms a call (zero fill + kernel, CUDA events over "
          f"10 calls, in turns with the plain version's {plain_ms:.3f}), "
          f"the kernel {gate_dev:.4f} ms on the device, "
          f"{bound_text(gate_b, gate_dev)}; "
          f"{100 * gate_ms / prof_c['device_busy_ms']:.1f}% of the path's "
          f"device busy time; path C vs the main path in this call: "
          f"{wall_c:.3f} vs {walls[main]:.3f} ms/step, device busy "
          f"{prof_c['device_busy_ms']:.3f} vs "
          f"{profs[main]['device_busy_ms']:.3f} ms/step, "
          f"{prof_c['launches_per_step']:.1f} vs "
          f"{profs[main]['launches_per_step']:.1f} launches/step; kernel "
          f"launches in the timed steps {launches_c}", flush=True)

    # Five more steps with per-uid event records.
    ev_rollout = build_rollout(
        scenes.stream_config(N_MAIN, CAP_MAIN),
        *scenes.stream_planners(params.hl[1]["routes"]),
        event_capacity=EVENT_CAPACITY)
    next_uid = int(st.next_uid)
    st, ev = ev_rollout(params, st, DT, 5)
    if int(ev.overflow.max()):
        raise AssertionError(f"{name}: event records overflow")
    for uid_f, counter in (("spawned_uid", "n_spawned"),
                           ("destroyed_uid", "n_destroyed"),
                           ("reached_uid", "n_waypoint_reached")):
        got = (getattr(ev, uid_f) >= 0).sum(1, dtype=torch.int32)
        if not torch.equal(got, getattr(ev.counters, counter)):
            raise AssertionError(f"{name}: {uid_f} records differ from "
                                 f"{counter}")
    firsts = next_uid + torch.cumsum(ev.counters.n_spawned, 0) \
        - ev.counters.n_spawned
    new = ev.spawned_uid >= 0
    if not bool((ev.spawned_uid >= firsts[:, None])[new].all()):
        raise AssertionError(f"{name}: a spawned uid is not new")
    print(f"phase 5 {name} event records ({EVENT_CAPACITY} a kind), 5 "
          f"steps: spawned {ev.counters.n_spawned.tolist()}, despawned "
          f"{ev.counters.n_destroyed.tolist()}, reached "
          f"{ev.counters.n_waypoint_reached.tolist()}; valid uids = "
          f"counters, overflow 0, every spawned uid new", flush=True)
    del rollout, ev_rollout, params, st, ev
    torch.cuda.empty_cache()

    # The grid backend on the 1M bench scene.
    rollout, params, st = scenes.build_bench(N_MAIN, backend="grid",
                                             device=dev,
                                             force_chunk=GRID_CHUNK)
    st, _ = rollout(params, st, DT, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, c = rollout(params, st, DT, 3)
    torch.cuda.synchronize()
    wall_g = (time.perf_counter() - t0) / 3
    if int(c.neighbor_truncated.max()):
        raise AssertionError(f"grid truncates {int(c.neighbor_truncated.max())}")
    if not bool(torch.isfinite(st.position).all()) or int(
            c.n_alive.min()) != N_MAIN:
        raise AssertionError("grid: state not finite or agents lost")
    print(f"phase 5 grid: {N_MAIN} agents, 3 steps, {1e3 * wall_g:.3f} "
          f"ms/step on '{card}'; max cell occupancy "
          f"{int(c.max_cell_occupancy.max())} (max_per_cell "
          f"{scenes.bench_config(N_MAIN).max_per_cell}); truncated 0; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del rollout, params, st
    torch.cuda.empty_cache()

    probe_rows = _probes(torch, dev, card, rl)

    # ---- phase 7: the Simulation session ----------------------------------
    _session_gate(torch, dev, card)
    torch.cuda.empty_cache()
    launches_d = _path_d(torch, dev, card, kernels)
    torch.cuda.empty_cache()

    # ---- phase 8: the multi-device engines --------------------------------
    launches_w = _world_phase(torch, dev, card, kernels)
    torch.cuda.empty_cache()

    # ---- phase 9: the bench and the high-D validation -------------------
    launches_b = _bench_phase(kernels, card)
    torch.cuda.empty_cache()
    _validate_phase(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 10: the randomized differential sweep ---------------------
    launches_f = _fuzz_phase(torch, dev, card, kernels)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"build included", flush=True)

    source = {
        "pack_rows": ("rmf_crowdsim_tpu_torch/csrc/pack_rows.cu",
                      "rmf_crowdsim_tpu/ops/pack_pallas.py:206"),
        "zanlungo_bucketed": (
            "rmf_crowdsim_tpu_torch/csrc/zanlungo_bucketed.cuh",
            "rmf_crowdsim_tpu/ops/zanlungo_pallas.py:1348"),
        "spill_window": ("rmf_crowdsim_tpu_torch/csrc/spill_window.cu",
                         "rmf_crowdsim_tpu/ops/zanlungo_pallas.py:1867"),
        "zanlungo_bucketed_spill": (
            "rmf_crowdsim_tpu_torch/csrc/zanlungo_bucketed.cuh",
            "rmf_crowdsim_tpu/ops/zanlungo_pallas.py:1403"),
        "zanlungo_dense": ("rmf_crowdsim_tpu_torch/csrc/zanlungo_dense.cu",
                           "rmf_crowdsim_tpu/ops/zanlungo_dense.py:878"),
        "spawn_blocked": ("rmf_crowdsim_tpu_torch/csrc/spawn_gate.cu", None),
    }
    counted = MAIN_KERNELS + ("spawn_blocked",)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source[name][0],
         "replaces": source[name][1], "launches": launches[name],
         "max_abs_err": results[name]["err"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound"].ms,
         "bound_by": results[name]["bound"].bound_by,
         "library_ms": None,
         **({"device_ms": results[name]["device_ms"]}
            if "device_ms" in results[name] else {}),
         "launches_fuzz": launches_f[name],
         **({"launches_path_c": launches_c[name],
             "launches_path_d": launches_d[name],
             "launches_world": launches_w[name],
             "launches_bench": launches_b[name]}
            if name in counted else {}),
         **({"launches_phase5": gate_paths}
            if name == "spawn_blocked" else {})}
        for name in source
    ] + probe_rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
