"""K3's plain version, slot by slot, against the JAX pack kernel.

``pack_rows_plain`` computes what ``csrc/pack_rows.cu`` computes, pass
for pass: it scatters the inverse map ``inv[bpos[r]] = r`` over scratch
that nobody clears, then fills each slot from row ``inv[s]`` where that
row's ``bpos`` is ``s``, else with the sentinel row.  On a fresh sort, a
carried binning with agents that died since the sort, and a tile whose
bucket overflows (its overflow rows, ``bpos == slots``, sit between
in-bucket rows), both planes are bitwise the JAX pack kernel's (Pallas,
interpret mode) on the same rows; and whatever the scratch held, the
result is the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmf_crowdsim_tpu.ops import zanlungo_pallas as jzp
from rmf_crowdsim_tpu.ops.pack_pallas import pack_rows_pallas
from rmf_crowdsim_tpu_torch.ops import pack as tpack
from rmf_crowdsim_tpu_torch.ops import zanlungo_bucketed as tzb

from test_torch_layout import CFG_ARGS, _scene, _sorted


def _pack_inputs(case):
    """(feat_t [16, N], bpos [N], slots) from the port's binning on one of
    the three cases, tile-sorted as the main path packs them."""
    jcfg = jzp.BucketConfig.create(**CFG_ARGS)
    tcfg = tzb.BucketConfig.create(**CFG_ARGS)
    s = _sorted(_scene(seed=8, hot=120 if case == "overflow" else 60), jcfg)
    binning = None
    if case == "carried":
        key = tzb.tile_key(tcfg, torch.as_tensor(s["pos"]),
                           torch.as_tensor(s["alive"]))
        binning = tzb.rank_from_sorted_key(tcfg, key)
        s["alive"] = s["alive"].copy()
        s["alive"][np.flatnonzero(s["alive"])[::5]] = False
    args = [torch.as_tensor(s[k]) for k in ("pos", "vel", "pref", "spref",
                                             "prio", "eye", "rec", "alive")]
    feat_t, bpos, _, _, n_over = tzb.feature_rows(
        tcfg, *args, use_pack_kernel=True, presorted=True, binning=binning)
    return feat_t, bpos, tcfg.slots, int(n_over), s["alive"]


@pytest.mark.parametrize("case", ["fresh", "carried", "overflow"])
def test_pack_plain_matches_jax_pack(case):
    feat_t, bpos, slots, n_over, alive = _pack_inputs(case)
    b = bpos.numpy()
    lands = b < slots
    assert n_over > 0 and not lands.all()
    # Overflow rows sit between rows that land.
    assert (~lands[np.argmax(~lands):np.flatnonzero(lands)[-1]]).any()
    if case == "carried":
        dead_slots = b[lands & ~alive]
        assert dead_slots.size > 0     # fresh-dead rows keep their slot
    packed_t, packed_T = tpack.pack_rows_plain(feat_t, bpos, slots)
    want_t, want_T, _ = pack_rows_pallas(jnp.asarray(feat_t.numpy()),
                                         jnp.asarray(b), slots,
                                         interpret=True)
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(packed_T.numpy(), np.asarray(want_T))
    if case == "carried":
        np.testing.assert_array_equal(packed_t.numpy()[dead_slots,
                                                       tzb.ROW_ID], -1.0)
    # The wrapper's CPU path is the plain version.
    got_t, got_T, overflow = tpack.pack_rows(feat_t, bpos, slots)
    assert torch.equal(got_t, packed_t) and torch.equal(got_T, packed_T)
    assert int(overflow) == 0


@pytest.mark.parametrize("scratch", ["rows", "zeros", "random"])
def test_pack_ignores_what_the_scratch_held(scratch):
    """Stale inverse-map entries are rejected by ``bpos[inv[s]] == s``:
    scratch full of row ids (a permutation, so most point at rows whose
    slot is another), zeros, or random ints in and out of range."""
    feat_t, bpos, slots, _, _ = _pack_inputs("carried")
    n = feat_t.shape[1]
    gen = torch.Generator().manual_seed(4)
    inv = {
        "rows": torch.randperm(n, generator=gen).repeat(
            slots // n + 1)[:slots],
        "zeros": torch.zeros(slots, dtype=torch.int64),
        "random": torch.randint(-n, 3 * n, (slots,), generator=gen),
    }[scratch].to(torch.int32)
    before = inv.clone()
    clean = tpack.pack_rows_plain(
        feat_t, bpos, slots, inv=torch.full((slots,), -1, dtype=torch.int32))
    stale = tpack.pack_rows_plain(feat_t, bpos, slots, inv=inv)
    assert torch.equal(stale[0], clean[0]) and torch.equal(stale[1], clean[1])
    assert torch.equal(inv, before)
