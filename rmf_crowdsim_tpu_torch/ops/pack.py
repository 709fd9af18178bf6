"""Pack kernel (K3): tile-sorted feature rows into the bucketed layout.

Counterpart of ``rmf_crowdsim_tpu/ops/pack_pallas.py`` (``pack_rows_pallas``,
the TPU's one-hot MXU pack).  On the GPU the pack is driven by slot:
``csrc/pack_rows.cu`` first scatters the inverse map ``inv[bpos[r]] = r``
into scratch that nobody clears, then writes every slot of both planes
once, with its row's features where ``inv[s]`` names a row whose
``bpos`` is ``s`` and the sentinel row elsewhere.  Slots are unique, so
that test finds the one row that targets a slot, or none, whatever the
scratch held.  The result equals the JAX pack kernel's output value for
value, rows 13 (slot) and 15 (1.0) included.

``overflow`` is 0 by construction: the TPU kernel streams at most
``MAX_CHUNKS * CHUNK`` rows per 512-slot group (pack_pallas.py:56-72)
and counts rows past that window; the GPU pack has no window, and
bucket slots are unique, so every in-bucket row lands.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .zanlungo_bucketed import NUM_CAND, NUM_F, sentinel_rows


def pack_rows_plain(feat_t, bpos, slots, inv=None):
    """Plain version of K3, pass for pass.  The inverse map is scattered
    over ``inv`` ([slots] int32 scratch, left as it was; uninitialised
    when None), then slot ``s`` takes row ``x = inv[s]`` if ``x`` is a
    row and ``bpos[x] == s``, else the sentinel row.  Returns (packed_t,
    packed_T)."""
    n = feat_t.shape[1]
    dev = feat_t.device
    if inv is None:
        inv = torch.empty((slots,), dtype=torch.int32, device=dev)
    # Rows with bpos outside [0, slots) (dead, bucket overflow) write the
    # discard entry `slots`.
    lands = (bpos >= 0) & (bpos < slots)
    buf = torch.cat([inv, inv.new_zeros((1,))])
    buf[torch.where(lands, bpos, slots).long()] = torch.arange(
        n, dtype=torch.int32, device=dev)
    # Row n is the sentinel row; its bpos, -1, is no slot.
    x = buf[:slots].long()
    x = torch.where((x >= 0) & (x < n), x, n)
    bpos_ext = torch.cat([bpos, bpos.new_full((1,), -1)])
    x = torch.where(bpos_ext[x] == torch.arange(slots, device=dev), x, n)
    packed_t = torch.cat([feat_t.t(), sentinel_rows(1, dev)])[x]
    return packed_t, packed_t[:, :NUM_CAND].t().contiguous()


def pack_rows(feat_t: torch.Tensor, bpos_sorted: torch.Tensor, slots: int):
    """Pack sorted feature rows.

    feat_t: [NUM_F, N] f32, the transposed feature rows; bpos_sorted: [N]
    int32 bucket slot per row (``slots`` for rows that are not packed;
    each slot targeted by at most one row).  Returns (packed_t [slots,
    NUM_F], packed_T [NUM_CAND, slots], overflow [] int32 — always 0, see
    the module docstring).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/pack_rows.cu``."""
    n = feat_t.shape[1]
    overflow = torch.zeros((), dtype=torch.int32, device=feat_t.device)
    if feat_t.device.type == "cpu":
        packed_t, packed_T = pack_rows_plain(feat_t, bpos_sorted, slots)
        return packed_t, packed_T, overflow
    assert slots < (1 << 24), "slot ids must be exact in f32"
    cuda_build.check_tensors(
        "pack_rows",
        feat_t=(feat_t, torch.float32, (NUM_F, n)),
        bpos_sorted=(bpos_sorted, torch.int32, (n,)),
    )
    dev = feat_t.device
    inv = torch.empty((slots,), dtype=torch.int32, device=dev)
    packed_t = torch.empty((slots, NUM_F), dtype=torch.float32, device=dev)
    packed_T = torch.empty((NUM_CAND, slots), dtype=torch.float32,
                           device=dev)
    cuda_build.launch("crowdsim_pack_rows", feat_t, bpos_sorted, inv, n,
                      slots, packed_t, packed_T)
    pack_rows.launches += 1
    return packed_t, packed_T, overflow


pack_rows.launches = 0
