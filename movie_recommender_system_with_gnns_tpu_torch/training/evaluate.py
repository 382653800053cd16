"""Full-ranking evaluation: standard Recall@k / NDCG@k over the whole catalog
(JAX package ``training/evaluate.py``).

The reference reports only its Monte-Carlo sampled recall with an
all-positives denominator (utils/train_test.py:165-212; kept for parity in
``ops/metrics.py``). This module ranks ALL items per user, excludes the
train-seen interactions and scores the held-out edges, with the same two-phase
chunk-maxima selection the serving path uses (``ops/topk.py::twophase_select``),
in dispatches of ``groups × batch_users`` users whose score matrices never
leave the device: only (users, k) hit bits come back to the host.

Scoring uses layer-0 tables (the reference's serving contract) by default;
propagated final embeddings with ``use_propagated=True`` (the LightGCN-paper
protocol).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.lightgcn import LightGCNParams
from ..ops.bpr import normalize_embedding
from ..ops.topk import NEG_INF, DTypeLike, _scores, twophase_select
from ..utils.device import as_dtype

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


def _batch_pairs(ptr: torch.Tensor, items: torch.Tensor, batch: torch.Tensor,
                 total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened (row, item) pairs of the batch's CSR lists, built on the
    device. ``total`` is the pair count, known on the host, so that nothing
    here waits for the device."""
    starts = ptr[batch]
    lens = ptr[batch + 1] - starts
    rows = torch.repeat_interleave(
        torch.arange(batch.shape[0], device=batch.device), lens, output_size=total)
    first = torch.cumsum(lens, 0) - lens              # each row's first pair
    pos = torch.arange(total, device=batch.device) - first[rows] + starts[rows]
    return rows, items[pos]


def evaluate_full_ranking(
    params: LightGCNParams,
    train_edges: np.ndarray,
    eval_edges: np.ndarray,
    num_users: int,
    k: int = 10,
    batch_users: int = 1024,
    use_propagated: bool = False,
    cfg: Optional[Config] = None,
    max_users: Optional[int] = None,
    normalize: bool = True,
    sample_seed: int = 0,
    mesh=None,
    groups: int = 8,
    score_dtype: DTypeLike = None,
) -> Tuple[float, float]:
    """Standard Recall@k and NDCG@k over users with ≥1 held-out edge.

    Runs on the device of ``params``. ``normalize=True`` ranks by cosine (the
    reference's serving contract); False ranks by raw inner products, the
    score a ``loss="standard"`` model optimizes and the LightGCN-paper
    protocol for propagated tables. ``max_users`` takes a seeded uniform
    SAMPLE of eval users (not the first N, which would bias toward the most
    active ids). ``use_propagated`` scores with
    ``serving.recommend.compute_serving_tables(mode="propagated")`` and needs
    ``cfg``.

    One dispatch ranks ``groups × batch_users`` users: the scores stay on the
    device, train-seen exclusion is a scatter of ``NEG_INF`` at index pairs
    built there from the CSR lists, selection is the serving path's exact
    :func:`ops.topk.twophase_select`, and the hit test against the held-out
    items happens on the device too. ``score_dtype="bfloat16"`` halves the
    score matrix (exact top-k of the rounded scores; near-ties may order
    differently than f32). Recall and NDCG are summed on the host in float64.
    ``mesh`` (catalog sharded over devices) is not ported.

    The wall-clock breakdown is left in ``evaluate_full_ranking.last_timings``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded evaluation is not ported to the PyTorch package "
            "(ROADMAP queue A 8: multi-device paths)")
    t_start = time.perf_counter()
    num_items = params.item_emb.shape[0]
    if use_propagated:
        if cfg is None:
            raise ValueError("use_propagated=True requires cfg")
        from ..serving.recommend import compute_serving_tables

        tables = compute_serving_tables(params, train_edges, cfg, mode="propagated")
        user_table, item_table = tables.user_emb, tables.item_emb
    else:
        user_table, item_table = params.user_emb, params.item_emb
    dev = item_table.device

    t0 = time.perf_counter()
    groupby_cached = (_edges_key(train_edges, num_users) in _GROUP_CACHE
                      and _edges_key(eval_edges, num_users) in _GROUP_CACHE)
    tr_ptr, tr_items = _np_group_by_user(train_edges, num_users)
    ev_ptr, ev_items = _np_group_by_user(eval_edges, num_users)
    t_pairs = time.perf_counter() - t0

    eval_users = np.flatnonzero(np.diff(ev_ptr) > 0)
    if max_users is not None and eval_users.size > max_users:
        rng = np.random.default_rng(sample_seed)
        eval_users = np.sort(rng.choice(eval_users, size=max_users, replace=False))

    sd = as_dtype(score_dtype)
    cat = normalize_embedding(item_table) if normalize else item_table
    kk = min(k, num_items)
    # don't over-pad tiny eval sets to groups × batch_users
    gb = int(min(groups * batch_users,
                 -(-max(eval_users.size, 1) // batch_users) * batch_users))

    t0 = time.perf_counter()
    lens_tr, lens_ev = np.diff(tr_ptr), np.diff(ev_ptr)
    trp, tri, evp, evi = (torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)
                          for a in (tr_ptr, tr_items, ev_ptr, ev_items))
    users_d = torch.from_numpy(eval_users.astype(np.int64)).to(dev)
    t_pairs += time.perf_counter() - t0

    t0 = time.perf_counter()
    hit_chunks = []
    for lo in range(0, eval_users.size, gb):
        batch_np = eval_users[lo:lo + gb]
        batch = users_d[lo:lo + gb]
        rows = user_table[batch]
        q = normalize_embedding(rows) if normalize else rows
        s = _scores(q, cat, sd)                               # (B, I)
        trr, trc = _batch_pairs(trp, tri, batch, int(lens_tr[batch_np].sum()))
        s[trr, trc] = NEG_INF                                 # train-seen exclusion
        _, ti = twophase_select(s, kk)                        # (B, kk)
        evr, evc = _batch_pairs(evp, evi, batch, int(lens_ev[batch_np].sum()))
        evm = torch.zeros(s.shape, dtype=torch.bool, device=dev)
        evm[evr, evc] = True
        hit_chunks.append(torch.gather(evm, 1, ti))
    total_cnt = int(eval_users.size)
    recall_mean = ndcg_mean = 0.0
    if total_cnt:
        hits = torch.cat(hit_chunks).cpu().numpy().astype(np.float64)
        if kk < k:
            hits = np.pad(hits, ((0, 0), (0, k - kk)))
        discounts = 1.0 / np.log2(np.arange(2, k + 2))
        cumdisc = np.concatenate([[0.0], np.cumsum(discounts)])
        num_rel = lens_ev[eval_users]
        recall = hits.sum(axis=1) / np.maximum(num_rel, 1)
        dcg = (hits * discounts[None, :]).sum(axis=1)
        idcg = cumdisc[np.minimum(num_rel, k)]
        recall_mean = float(recall.sum() / total_cnt)
        ndcg_mean = float((dcg / np.maximum(idcg, 1e-12)).sum() / total_cnt)
    t_score = time.perf_counter() - t0
    evaluate_full_ranking.last_timings = {
        "eval_users": total_cnt,
        "mask_build_s": round(t_pairs, 4),
        "score_topk_s": round(t_score, 4),
        "total_s": round(time.perf_counter() - t_start, 4),
        "sharded": False,
        "dispatch_users": gb,
        "score_dtype": str(score_dtype or "float32").replace("torch.", ""),
        "groupby_cached": groupby_cached,
    }
    return recall_mean, ndcg_mean
