"""The benchmark's own copy of the port's synthetic MovieLens generator and of
its two 90/5/5 splits, frozen here so that a later change to the program
cannot change the data the benchmark measures.

``make_graph`` returns what ``data/movielens.py::make_synthetic_movielens``
returns (users, items, the doubled and sorted edge list), bit for bit, but
deduplicates every key set by one sort instead of NumPy's hashing
``np.unique``. ``split_edges`` and ``split_interactions`` return what the
port's ``split_edges(..., split_level="edge" | "interaction")`` returns on a
first run (no persisted indices), without writing any file.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique`` of a 1-D array by one sort."""
    a = np.sort(a)
    keep = np.ones(a.shape[0], bool)
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def _dense_index(uniq: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Position of each value in the sorted unique array ``uniq``."""
    return np.searchsorted(uniq, values).astype(np.int64)


def to_undirected(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Both directions of every edge, sorted by (src, dst) and deduplicated."""
    src = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
    dst = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
    uniq = sorted_unique(src * np.int64(num_nodes) + dst)
    return np.stack([uniq // num_nodes, uniq % num_nodes]).astype(np.int32)


def make_graph(num_users: int, num_items: int, num_interactions: int, seed: int = 0,
               power: float = 1.1, num_communities: int = 0, intra_prob: float = 0.85
               ) -> Tuple[int, int, np.ndarray]:
    """(users, items, edge_index (2, E) int32): Zipf-like user activity and
    item popularity, ``intra_prob`` of the draws moved into the user's
    community when ``num_communities > 1``; items are numbered after users."""
    rng = np.random.default_rng(seed)
    u_p = 1.0 / np.arange(1, num_users + 1) ** power
    i_p = 1.0 / np.arange(1, num_items + 1) ** power
    u_p /= u_p.sum()
    i_p /= i_p.sum()
    users = rng.choice(num_users, size=num_interactions, p=u_p)
    items = rng.choice(num_items, size=num_interactions, p=i_p)
    if num_communities > 1:
        u_comm = users % num_communities
        i_comm = items % num_communities
        intra = rng.random(num_interactions) < intra_prob
        mism = intra & (i_comm != u_comm)
        delta = (u_comm[mism] - i_comm[mism]) % num_communities
        items = items.copy()
        items[mism] = (items[mism] + delta) % num_items
    pairs = sorted_unique(users.astype(np.int64) * num_items + items)
    users = pairs // num_items
    items = pairs % num_items
    uu = sorted_unique(users)
    ii = sorted_unique(items)
    n_u, n_i = len(uu), len(ii)
    edge_index = np.stack([_dense_index(uu, users), _dense_index(ii, items) + n_u])
    return n_u, n_i, to_undirected(edge_index, n_u + n_i)


def split_edges(edge_index: np.ndarray, train_size: float = 0.9,
                val_test_ratio: float = 0.5, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's split of the directed edges: (train, val, test), each
    int32 (2, E_split) in edge order."""
    num_edges = edge_index.shape[1]
    perm = np.random.default_rng(seed).permutation(num_edges)
    n_train = int(round(train_size * num_edges))
    rest = perm[n_train:]
    n_val = int(round(val_test_ratio * len(rest)))
    parts = (np.sort(perm[:n_train]), np.sort(rest[:n_val]), np.sort(rest[n_val:]))
    return tuple(edge_index[:, p].astype(np.int32) for p in parts)


def _double(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.stack([np.concatenate([u, v]), np.concatenate([v, u])]).astype(np.int32)


def split_interactions(edge_index: np.ndarray, num_users: int, train_size: float = 0.9,
                       val_test_ratio: float = 0.5, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split the unique (user, item) pairs 90/5/5, then double each split:
    no held-out pair's reverse edge stays in the train graph."""
    head, tail = edge_index[0], edge_index[1]
    fwd = (head < num_users) & (tail >= num_users)
    u, v = head[fwd].astype(np.int64), tail[fwd].astype(np.int64)
    num_pairs = u.shape[0]
    perm = np.random.default_rng(seed).permutation(num_pairs)
    n_train = int(round(train_size * num_pairs))
    rest = perm[n_train:]
    n_val = int(round(val_test_ratio * len(rest)))
    val_idx, test_idx = np.sort(rest[:n_val]), np.sort(rest[n_val:])
    train = np.ones(num_pairs, bool)
    train[val_idx] = False
    train[test_idx] = False
    train_idx = np.flatnonzero(train)
    return tuple(_double(u[i], v[i]) for i in (train_idx, val_idx, test_idx))
