"""METIS-free graph partitioning for Cluster-GCN-style subgraph training.

The reference scales to ML-25M by METIS-partitioning the train graph into 100
clusters and training on one induced subgraph per step (reference
data/dataset_handler.py:256-288 via PyG ``ClusterData``; README.md:53-54 cites the
Cluster-GCN paper). Each cluster's edge_index is remapped back to GLOBAL node ids
(dataset_handler.py:277-282), so clusters partition *edges* while the embedding
tables stay global — exactly the contract our trainer keeps.

METIS-free replacements, pure NumPy (the JAX package's NumPy path, array for
array; its optional C++ binding with label-propagation refinement is not
ported yet):

  * :func:`partition_bipartite_greedy` (default) — degree-balanced user assignment
    + majority-vote item assignment. One streaming pass, high intra-cluster edge
    retention on power-law bipartite graphs; the spiritual METIS stand-in.
  * :func:`partition_edges_random` — uniform random edge partition: keeps every
    edge across the epoch (no cluster-GCN edge loss) at the cost of subgraph
    locality. Often trains better; offered as a config choice.

Both return, per cluster, a global-id edge array — feed to
``training.pipeline.build_cluster_batches`` or
``training.compact.build_compact_clusters`` for padding + device upload.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def forward_half(edge_index: np.ndarray, num_users: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the user→item half of a doubled undirected edge_index.

    Returns ``(u, it)`` int64 arrays with item ids shifted back to item space
    (the reference's node-id convention offsets items by num_users,
    dataset_handler.py:115-118). Factored out so partitioners and trainers
    share ONE O(E) pass instead of recomputing it per consumer.
    """
    head, tail = edge_index[0], edge_index[1]
    fwd = (head < num_users) & (tail >= num_users)
    u = head[fwd].astype(np.int64)
    it = (tail[fwd] - num_users).astype(np.int64)
    return u, it


def partition_bipartite_greedy(
    edge_index: np.ndarray,
    num_users: int,
    num_nodes: int,
    num_parts: int,
    seed: int = 0,
    balance_tol: float = 0.0,
) -> List[np.ndarray]:
    """Partition nodes, keep intra-cluster edges (Cluster-GCN semantics).

    1. users are sorted by degree (desc) and dealt snake-wise over parts so user
       degree mass balances;
    2. each item joins the part holding the plurality of its edges;
    3. edges survive iff part(user) == part(item) — mirrored edges (item→user)
       survive symmetrically, so subgraphs stay undirected.

    ``balance_tol`` > 0 adds a kept-edge balance pass capping every part's
    intra-cluster edge count at tol× the mean (the per-step padded triplet
    width is set by the LARGEST part, so balance buys epoch time directly).
    """
    u, it = forward_half(edge_index, num_users)
    part_of_user, part_of_item = partition_assignments(
        edge_index, num_users, num_nodes, num_parts, seed=seed,
        balance_tol=balance_tol, uv=(u, it))
    ep = part_of_user[u]
    keep = ep == part_of_item[it]
    u_k, it_k, p_k = u[keep], it[keep], ep[keep]
    out: List[np.ndarray] = []
    for p in range(num_parts):
        m = p_k == p
        uu, ii = u_k[m], it_k[m] + num_users
        # undirected: both directions, matching the reference's doubled graph
        e = np.stack([np.concatenate([uu, ii]), np.concatenate([ii, uu])]).astype(np.int32)
        out.append(e)
    return out


def partition_assignments(
    edge_index: np.ndarray,
    num_users: int,
    num_nodes: int,
    num_parts: int,
    seed: int = 0,
    balance_tol: float = 0.0,
    uv: Tuple[np.ndarray, np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Node→part assignments (part_of_user, part_of_item) — the raw output of
    the greedy partitioner, exposed for consumers that need the node partition
    itself (e.g. hybrid block-diagonal propagation) rather than kept-edge
    subgraphs. ``uv`` optionally supplies a precomputed :func:`forward_half`
    result to avoid a second O(E) pass."""
    # operate on the user→item half; mirror at the end
    u, it = uv if uv is not None else forward_half(edge_index, num_users)
    num_items = num_nodes - num_users

    u_deg = np.bincount(u, minlength=num_users)
    order = np.argsort(-u_deg, kind="stable")
    part_of_user = np.empty(num_users, dtype=np.int32)
    # snake deal: 0..P-1, P-1..0, 0..P-1, ... balances degree mass
    lane = np.arange(num_users) % (2 * num_parts)
    snake = np.where(lane < num_parts, lane, 2 * num_parts - 1 - lane)
    part_of_user[order] = snake.astype(np.int32)

    # item -> plurality part of its user neighbors
    ep = part_of_user[u]
    counts = np.zeros((num_items, num_parts), dtype=np.int32)
    np.add.at(counts, (it, ep), 1)
    part_of_item = counts.argmax(axis=1).astype(np.int32)
    # items with no edges: spread uniformly
    rng = np.random.default_rng(seed)
    empty = counts.sum(axis=1) == 0
    part_of_item[empty] = rng.integers(0, num_parts, empty.sum())

    if balance_tol > 0:
        part_of_user = _balance_kept_edges_numpy(
            u, it, part_of_user, part_of_item, num_parts, balance_tol)
    return part_of_user, part_of_item


def _balance_kept_edges_numpy(u, it, part_of_user, part_of_item, num_parts,
                              tol):
    """Cap each part's kept-edge count at tol× the mean by moving least-loyal
    users to their best-affinity part with room."""
    num_users = part_of_user.shape[0]
    counts = np.zeros((num_users, num_parts), np.int32)
    np.add.at(counts, (u, part_of_item[it]), 1)
    part_of_user = part_of_user.copy()
    kept = np.zeros(num_parts, np.int64)
    own = counts[np.arange(num_users), part_of_user]
    np.add.at(kept, part_of_user, own)
    target = int(tol * kept.sum() / num_parts) + 1

    # caps on kept-user/kept-item counts per part (they set u_pad/i_pad — the
    # compact trainer's padded node widths).
    # kedge_item must span ALL items (edgeless high ids included) — it is used
    # as a boolean mask over part_of_item below
    num_items = part_of_item.shape[0]
    kept_edge = part_of_user[u] == part_of_item[it]
    kedge_item = np.bincount(it[kept_edge], minlength=num_items)
    kuser = np.bincount(part_of_user[own > 0], minlength=num_parts).astype(np.int64)
    kitem = np.bincount(part_of_item[kedge_item > 0], minlength=num_parts).astype(np.int64)
    kumax, kimax = int(kuser.max()), int(kitem.max())
    order_u = np.argsort(u, kind="stable")
    uptr = np.searchsorted(u[order_u], np.arange(num_users + 1))
    uadj = it[order_u]

    for p in np.argsort(-kept):
        if kept[p] <= target:
            break
        vs = np.where(part_of_user == p)[0]
        vs = vs[np.argsort(counts[vs, p], kind="stable")]
        for v in vs:
            if kept[p] <= target:
                break
            row = counts[v].copy()
            row[p] = -1
            room = (kept + row <= target) & ((row == 0) | (kuser + 1 <= kumax))
            room[p] = False
            if not room.any():
                continue
            q = int(np.where(room, row, -1).argmax())
            if row[q] < 0:
                continue
            items_v = uadj[uptr[v]:uptr[v + 1]]
            if row[q] > 0:
                in_q = items_v[part_of_item[items_v] == q]
                fresh = int((kedge_item[in_q] == 0).sum())
                if kitem[q] + fresh > kimax:
                    continue
            in_p = items_v[part_of_item[items_v] == p]
            in_q = items_v[part_of_item[items_v] == q]
            kedge_item[in_p] -= 1
            kitem[p] -= int((kedge_item[in_p] == 0).sum())
            kitem[q] += int((kedge_item[in_q] == 0).sum())
            kedge_item[in_q] += 1
            kept[p] -= counts[v, p]
            kept[q] += counts[v, q]
            if counts[v, p] > 0:
                kuser[p] -= 1
            if counts[v, q] > 0:
                kuser[q] += 1
            part_of_user[v] = q
    return part_of_user


def partition_edges_random(
    edge_index: np.ndarray,
    num_users: int,
    num_parts: int,
    seed: int = 0,
) -> List[np.ndarray]:
    """Uniform random partition of the user→item edges; each part mirrored to an
    undirected subgraph. Retains 100% of edges across the epoch."""
    head, tail = edge_index[0], edge_index[1]
    fwd = (head < num_users) & (tail >= num_users)
    u = head[fwd]
    it = tail[fwd]
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, num_parts, u.shape[0])
    out: List[np.ndarray] = []
    for p in range(num_parts):
        m = assign == p
        uu, ii = u[m], it[m]
        e = np.stack([np.concatenate([uu, ii]), np.concatenate([ii, uu])]).astype(np.int32)
        out.append(e)
    return out


def edge_retention(parts: List[np.ndarray], total_edges: int) -> float:
    """Fraction of the original (undirected-doubled) edges kept across clusters."""
    kept = sum(p.shape[1] for p in parts)
    return kept / max(total_edges, 1)
