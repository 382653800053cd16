"""Per-user grouping of train interactions (JAX package ``training/evaluate.py``).

Only ``_np_group_by_user`` and its cache are ported; ``ServingIndex.build``
needs them. ``evaluate_full_ranking`` is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: bounded FIFO cache of group-by results keyed on a cheap content
#: fingerprint: a run groups the SAME edge arrays many times, and the host
#: group-by over a 25M-rating train set takes seconds. The cache holds a
#: strong reference to each keyed array so its id() stays valid.
_GROUP_CACHE: dict = {}
_GROUP_CACHE_MAX = 6


def _edges_key(edges: np.ndarray, num_users: int):
    """Array id + shape + a strided sample hash (≤2048 columns): guards
    against id reuse and in-place edits without hashing the whole array."""
    step = max(1, edges.shape[1] // 1024)
    sample = np.ascontiguousarray(edges[:, ::step])
    return (id(edges), edges.shape, str(edges.dtype), num_users,
            hash(sample.tobytes()))


def _np_group_by_user(edges: np.ndarray, num_users: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, items) of DISTINCT user→item lists from an undirected
    edge set; duplicate (user, item) pairs collapse. Cached per edge array."""
    key = _edges_key(edges, num_users)
    hit = _GROUP_CACHE.get(key)
    if hit is not None:
        return hit[1]
    head, tail = edges[0], edges[1]
    fwd = (head < num_users) & (tail >= num_users)
    u = head[fwd].astype(np.int64)
    it = (tail[fwd] - num_users).astype(np.int64)
    num_items = int(it.max()) + 1 if it.size else 1
    keys = np.unique(u * num_items + it)
    u, it = keys // num_items, keys % num_items
    counts = np.bincount(u, minlength=num_users)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    if len(_GROUP_CACHE) >= _GROUP_CACHE_MAX:
        _GROUP_CACHE.pop(next(iter(_GROUP_CACHE)))
    _GROUP_CACHE[key] = (edges, (indptr, it))
    return indptr, it
