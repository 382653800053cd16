"""The distinct rows of a batch, selected on the device with no host sync.

``torch.unique`` returns a tensor whose size depends on the data, so the
host waits for the device twice (the count, then the copy). XSimGCL's
in-batch InfoNCE runs over each step's distinct users and distinct positive
items, once a step: :func:`distinct_rows` gives them as the first ``count``
entries of a buffer of fixed size, with ``count`` left on the device for the
kernel that reads them (``ops/cuda_infonce.py``).

A presence mask over the rows, its running sum and one scatter: present row
``r`` goes to position ``csum[r] - 1`` and absent row ``r`` to
``count + r - csum[r]``. The result is a permutation of every row, the
present ones first in ascending order (``torch.unique``'s order), so the
ids in the buffer are distinct even past ``count`` and a gather by them has
a backward without repeated rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def distinct_rows(idx: torch.Tensor, rows: int, mask: Optional[torch.Tensor] = None,
                  cap: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids, count)``: ``ids`` (int64, ``cap`` entries, default ``rows``)
    starts with the distinct values of ``idx`` (in ``[0, rows)``; entries
    where ``mask`` is False are left out) in ascending order, ``count`` of
    them, and goes on with the absent rows in ascending order. ``count`` is
    a (1,) int32 tensor on ``idx``'s device. ``cap`` below the number of
    distinct values drops the largest of them from ``ids``."""
    dev = idx.device
    cap = rows if cap is None else min(int(cap), rows)
    where = idx.reshape(-1).long()
    if mask is not None:
        where = torch.where(mask.reshape(-1), where, torch.full_like(where, rows))
    present = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    present.index_fill_(0, where, 1)
    present = present[:rows]
    csum = torch.cumsum(present, 0, dtype=torch.int32)
    count = csum[-1:]
    arange = torch.arange(rows, dtype=torch.int64, device=dev)
    pos = torch.where(present.bool(), csum.long() - 1, count.long() + arange - csum.long())
    perm = torch.empty(rows, dtype=torch.int64, device=dev)
    perm.scatter_(0, pos, arange)
    return perm[:cap], count
