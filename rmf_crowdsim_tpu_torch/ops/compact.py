"""Fixed-k mask compaction without scatters.

Counterpart of ``rmf_crowdsim_tpu/ops/compact.py``: the r-th flagged row's
position is a binary search on the inclusive prefix count
(``torch.searchsorted``), so no host read of the count is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Compaction(NamedTuple):
    idx: torch.Tensor     # [k] int32 — position of the r-th True (or >= n)
    valid: torch.Tensor   # [k] bool — rank r exists
    count: torch.Tensor   # [] int32 — total number of True entries
    n_over: torch.Tensor  # [] int32 — True entries beyond the k buffer


def compact_indices(mask: torch.Tensor, k: int) -> Compaction:
    """Positions of the first ``k`` True entries of ``mask``, in order.
    ``idx[r]`` is ``n`` where fewer than ``r + 1`` entries are set."""
    n = mask.shape[0]
    csum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    idx = torch.searchsorted(csum, targets, side="left").to(torch.int32)
    count = csum[-1]
    return Compaction(
        idx=idx,
        valid=idx < n,
        count=count,
        n_over=torch.clamp(count - k, min=0),
    )
