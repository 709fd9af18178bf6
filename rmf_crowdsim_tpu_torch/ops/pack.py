"""Pack kernel (K3): tile-sorted feature rows into the bucketed layout.

Counterpart of ``rmf_crowdsim_tpu/ops/pack_pallas.py`` (``pack_rows_pallas``,
the TPU's one-hot MXU pack).  On the GPU the pack is a plain scatter:
``csrc/pack_rows.cu`` fills both planes with the sentinel row, then one
thread per sorted row with ``bpos < slots`` copies the row's 16 features
into ``packed_t[bpos, :]`` and its 8 candidate features into
``packed_T[:, bpos]``.  The result equals the JAX pack kernel's output
value for value, rows 13 (slot) and 15 (1.0) included.

``overflow`` is 0 by construction: the TPU kernel streams at most
``MAX_CHUNKS * CHUNK`` rows per 512-slot group (pack_pallas.py:56-72)
and counts rows past that window; the GPU scatter has no window, and
bucket slots are unique, so every in-bucket row lands.
"""

from __future__ import annotations

import torch

from .zanlungo_bucketed import NUM_CAND, NUM_F, sentinel_rows


def pack_rows_plain(feat_t, bpos, slots):
    """Plain version of K3: sentinel fill, then one masked row scatter.
    Returns (packed_t, packed_T)."""
    # Rows with bpos >= slots (dead, bucket overflow) go to a discard row.
    buf = sentinel_rows(slots + 1, feat_t.device)
    tgt = torch.where(bpos < slots, bpos, torch.full_like(bpos, slots))
    buf[tgt.long()] = feat_t.t()
    packed_t = buf[:slots]
    return packed_t, packed_t[:, :NUM_CAND].t().contiguous()


def pack_rows(feat_t: torch.Tensor, bpos_sorted: torch.Tensor, slots: int):
    """Pack sorted feature rows.

    feat_t: [NUM_F, N] f32, the transposed feature rows; bpos_sorted: [N]
    int32 bucket slot per row (``slots`` for rows that are not packed).
    Returns (packed_t [slots, NUM_F], packed_T [NUM_CAND, slots],
    overflow [] int32 — always 0, see the module docstring).  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/pack_rows.cu``."""
    n = feat_t.shape[1]
    overflow = torch.zeros((), dtype=torch.int32, device=feat_t.device)
    if feat_t.device.type == "cpu":
        packed_t, packed_T = pack_rows_plain(feat_t, bpos_sorted, slots)
        return packed_t, packed_T, overflow
    from ..utils import cuda_build

    assert slots < (1 << 24), "slot ids must be exact in f32"
    cuda_build.check_tensors(
        "pack_rows",
        feat_t=(feat_t, torch.float32, (NUM_F, n)),
        bpos_sorted=(bpos_sorted, torch.int32, (n,)),
    )
    packed_t = torch.empty((slots, NUM_F), dtype=torch.float32,
                           device=feat_t.device)
    packed_T = torch.empty((NUM_CAND, slots), dtype=torch.float32,
                           device=feat_t.device)
    cuda_build.launch("crowdsim_pack_rows", feat_t, bpos_sorted, n, slots,
                      packed_t, packed_T)
    pack_rows.launches += 1
    return packed_t, packed_T, overflow


pack_rows.launches = 0
