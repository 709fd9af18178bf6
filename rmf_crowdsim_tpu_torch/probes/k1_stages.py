"""P1/P2: K1 cut after each of its own stages, timed stage by stage.

    python -m rmf_crowdsim_tpu_torch.probes.k1_stages [--n 1000000]

Counterpart of the TPU probes ``perf/kvar.py`` and ``perf/kvar2.py``,
which build the TPU kernel cumulatively so that consecutive deltas give
each stage's cost.  This probe cuts the port's own K1
(``csrc/zanlungo_bucketed.cuh``, instantiated by ``csrc/k1_stages.cu``)
after each of its stages, on the bench scene's bucketed plane
(``scenes.bench_bucketed``): for each stage and both ``int_prio`` modes
it prints the CUDA-event time over back-to-back calls, the delta to the
stage before, the stage's bound (``utils/roofline.k1_stage_bytes`` and
``k1_stage_ops``) and
the time of its plain version; one more row runs the whole kernel with
threads sized as K4 sizes them (1.125 times the mean live queries a
block, rounded up to a warp).  Every cut is first held against its plain
version (:func:`check`).  Needs a CUDA device; raises without one.

What each cut writes into ``out [slots, 2]`` for a live slot (every
empty slot gets its rec row at every stage):

- ``floor``: the grid alone; every slot writes its rec row;
- ``queries``: the live queries listed; each writes its rec row;
- ``stage``: the compacted stage; (live candidates of the query's 3x3
  tiles, 0);
- ``mask``: the mask pass into the lists; (hits, 1 if hits > 32 else 0);
- ``ttc``: the TTC pass; (minimum time to collision, hits);
- ``full``: K1, the velocities.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import zanlungo_bucketed as zb
from ..ops import zanlungo_dense as zd
from ..utils import roofline as rl
from . import max_abs_err, require_card, timed

STAGES = ("floor", "queries", "stage", "mask", "ttc", "full")
REC = slice(zb.ROW_RX, zb.ROW_RY + 1)
CHUNK_SLOTS = 1 << 17  # query slots of the plain version's pair tensors
REPS = 20              # timed calls of the kernel a row


def k4_rule_threads(cfg: zb.BucketConfig, n_live: int) -> int:
    """Threads a K1 block as K4 sizes them (``ops/zanlungo_dense.
    query_threads``) for the mean live queries of a K1 block."""
    tiles = zb.k1_geometry(cfg).tiles
    return zd.query_threads(tiles * n_live / cfg.n_tiles)


def k1_stage_plain(cfg: zb.BucketConfig, zp5, packed_t, packed_T, stage: str,
                   int_prio: bool):
    """The plain version of cut ``stage``: [slots, 2] f32."""
    if stage == "full":
        return zb.forces_bucketed_plain(cfg, zp5, packed_t, packed_T,
                                        int_prio)
    out = packed_t[:, REC].clone()
    if stage in ("floor", "queries"):
        return out
    b = cfg.bucket
    dev = packed_t.device
    chunk_tiles = max(1, CHUNK_SLOTS // b)
    for t0 in range(0, cfg.n_tiles, chunk_tiles):
        t1 = min(cfg.n_tiles, t0 + chunk_tiles)
        cf = zb._window_candidates(cfg, packed_T,
                                   torch.arange(t0, t1, device=dev))
        rows = packed_t[t0 * b:t1 * b].reshape(t1 - t0, b, zb.NUM_F)
        live = rows[..., zb.ROW_ID] >= 0                       # [T, b]
        zero = torch.zeros_like(rows[..., 0])
        if stage == "stage":
            count = (cf[zb.ROW_ID] >= 0).sum(-1, dtype=torch.int32)
            got = torch.stack([count[:, None].expand(-1, b).to(zero), zero],
                              -1)
        else:
            q = zb.query_features(rows)
            c = zb.candidate_features(cf)
            mask = zb.pair_mask(q, c)                          # [T, b, 9b]
            hits = mask.sum(-1, dtype=torch.int32).to(zero)
            if stage == "mask":
                got = torch.stack(
                    [hits, (hits > zb.K1_LIST_CAP).to(zero)], -1)
            else:
                ttc = zb._pair_ttc(q["vx"], q["vy"], q["px"], q["py"],
                                   c["vx"], c["vy"], c["px"], c["py"],
                                   zp5[3])
                t_i = torch.where(mask, ttc, torch.full_like(
                    ttc, float("inf"))).amin(-1)
                got = torch.stack([t_i, hits], -1)
        seg = out[t0 * b:t1 * b].view(t1 - t0, b, 2)
        seg[live] = got[live]
    return out


def k1_stage(cfg: zb.BucketConfig, zp5: torch.Tensor, packed_t: torch.Tensor,
             packed_T: torch.Tensor, stage: str, int_prio: bool = False,
             threads: int | None = None,
             overflow: torch.Tensor | None = None) -> torch.Tensor:
    """Cut ``stage`` of K1 over the packed plane: [slots, 2] f32 (the
    module docstring says what each cut writes).  ``threads``: a block's
    threads, K1's own rule where None.  ``overflow``: as for
    ``zanlungo_forces_bucketed``, counted from the mask pass on.  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/k1_stages.cu``."""
    if stage not in STAGES:
        raise ValueError(f"k1_stage: stage must be one of {STAGES}, got "
                         f"{stage!r}")
    if packed_t.device.type == "cpu":
        return k1_stage_plain(cfg, zp5, packed_t, packed_T, stage, int_prio)
    from ..utils import cuda_build

    cuda_build.check_tensors(
        "k1_stage",
        zp5=(zp5, torch.float32, (5,)),
        packed_t=(packed_t, torch.float32, (cfg.slots, zb.NUM_F)),
        packed_T=(packed_T, torch.float32, (zb.NUM_CAND, cfg.slots)),
        **zb._overflow_spec(overflow),
    )
    geo = zb.k1_geometry(cfg, threads=threads)
    out = torch.empty((cfg.slots, 2), dtype=torch.float32,
                      device=packed_t.device)
    cuda_build.launch(
        "crowdsim_k1_stage", zp5, packed_t, packed_T, out, overflow, cfg.tx,
        cfg.ty, cfg.bucket, geo.tiles, geo.threads, int(bool(int_prio)),
        STAGES.index(stage))
    k1_stage.launches += 1
    return out


k1_stage.launches = 0


def check(cfg, zp5, packed_t, packed_T, k4_threads: int) -> dict:
    """Each cut against its plain version on these planes, both
    ``int_prio`` modes: bitwise on every slot; ``full`` also bitwise the
    main path's K1 on every slot, and at ``k4_threads`` threads too.
    Where the plain TTC differs from the kernel's in its last bits (the
    plain version runs its arithmetic op by op), ``ttc`` is held to 2e-4
    relative instead and the slots are counted.  Returns {stage: (max abs
    error over finite values, slots that differ)}; raises on a
    mismatch."""
    live = packed_T[zb.ROW_ID] >= 0
    errs = {}
    for int_prio in (True, False):
        main = zb.zanlungo_forces_bucketed(cfg, zp5, packed_t, packed_T,
                                           int_prio=int_prio)
        for stage in STAGES:
            got = k1_stage(cfg, zp5, packed_t, packed_T, stage, int_prio)
            want = k1_stage_plain(cfg, zp5, packed_t, packed_T, stage,
                                  int_prio)
            differ = int((got != want).any(1).sum())
            err = max_abs_err(got, want)
            if stage == "full":
                if not torch.equal(got, main):
                    raise AssertionError(f"k1_stage full (int_prio="
                                         f"{int_prio}) differs from K1")
                k4 = k1_stage(cfg, zp5, packed_t, packed_T, stage, int_prio,
                              threads=k4_threads)
                if not torch.equal(k4, main):
                    raise AssertionError(f"k1_stage full at {k4_threads} "
                                         f"threads differs from K1")
                torch.testing.assert_close(got[live], want[live], rtol=2e-4,
                                           atol=2e-4)
            elif stage == "ttc" and differ:
                torch.testing.assert_close(got, want, rtol=2e-4, atol=0.0)
            elif differ:
                raise AssertionError(f"k1_stage {stage} (int_prio="
                                     f"{int_prio}) differs from its plain "
                                     f"version on {differ} slots")
            prev = errs.get(stage, (0.0, 0))
            errs[stage] = (max(prev[0], err), max(prev[1], differ))
    return errs


def measure(cfg, zp5, packed_t, packed_T) -> list:
    """Times every cut, both ``int_prio`` modes, and ``full`` at K4's
    thread rule.  Returns rows (stage, int_prio, threads, ms, plain ms,
    Bound, launches, max abs err); ``threads`` is None for K1's own rule;
    ``launches`` counts the row's calls, its warm-up included; the error
    is that of the last timed output against the last plain one."""
    n_live = int((packed_T[zb.ROW_ID] >= 0).sum())
    work = rl.k1_work(cfg, zp5, packed_t, packed_T)
    k4_threads = k4_rule_threads(cfg, n_live)
    rows = []
    for int_prio in (True, False):
        runs = [(s, None) for s in STAGES] + [("full", k4_threads)]
        for stage, threads in runs:
            ms, got, n = timed(lambda: k1_stage(
                cfg, zp5, packed_t, packed_T, stage, int_prio,
                threads=threads), REPS, k1_stage)
            pms, want, _ = timed(lambda: k1_stage_plain(
                cfg, zp5, packed_t, packed_T, stage, int_prio), 1)
            bound = rl.Bound(rl.k1_stage_bytes(cfg, n_live, stage),
                             rl.k1_stage_ops(work, stage, int_prio))
            rows.append((stage, int_prio, threads, ms, pms, bound, n,
                         max_abs_err(got, want)))
    return rows


def stage_table(rows, card: str) -> str:
    """The rows of :func:`measure` as text, with each stage's delta to the
    one before."""
    lines = [f"K1 stage probe on '{card}'"]
    prev = {}
    for stage, int_prio, threads, ms, pms, bound, *_ in rows:
        label = stage if threads is None else f"full@{threads}thr"
        delta = "" if threads is not None or int_prio not in prev else (
            f" ({ms - prev[int_prio]:+.4f})")
        if threads is None:
            prev[int_prio] = ms
        lines.append(
            f"  {label:14s} int_prio={int(int_prio)}: {ms:.4f} ms{delta}; "
            f"bound {bound.ms:.4f} ms ({bound.bound_by}: {bound.bytes} B, "
            f"{bound.ops} ops), {100 * bound.ms / ms:.1f}% of bound; plain "
            f"{pms:.3f} ms")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    dev = require_card()
    from .. import scenes
    from ..ops import pack
    from ..utils.profile_step import card_line

    _, cfg, params, *_, feat_t, bpos, _ = scenes.bench_bucketed(args.n,
                                                                device=dev)
    packed_t, packed_T, _ = pack.pack_rows(feat_t, bpos, cfg.slots)
    zp5 = zb.zparams5(params.lp[0])
    n_live = int((packed_T[zb.ROW_ID] >= 0).sum())
    errs = check(cfg, zp5, packed_t, packed_T, k4_rule_threads(cfg, n_live))
    print(f"checked against the plain versions: {errs}")
    print(stage_table(measure(cfg, zp5, packed_t, packed_T), card_line()))


if __name__ == "__main__":
    main()
