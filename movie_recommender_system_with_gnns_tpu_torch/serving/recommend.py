"""Serving: top-10 user→movie and movie→user recommendations, one query or a
batch (JAX package ``serving/recommend.py``).

  * scores are cosine similarities of the layer-0 embedding tables — the
    reference's serving contract (light_gcn.py:55-61);
  * train-seen exclusion is a ``NEG_INF`` mask applied before selection
    (reference recommend.py:48-50);
  * return schemas match the reference: ``{'recommendations': [{'title',
    'movieId', 'score'}]}`` / ``{'top_users': [{'user_id', 'score'}]}`` and
    ``{'error': 'Invalid user ID'}`` / ``{'error': 'Invalid movie ID'}``.

Batched serving (:class:`ServingIndex`, :func:`batch_recommend_users`) runs
the fused lane (``ops/cuda_mips.py``) when the tables are on the GPU.
:func:`compute_serving_tables` offers the LightGCN-paper protocol besides:
tables propagated over the train graph before scoring.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.movielens import MovieLensData
from ..models.lightgcn import LightGCNParams
from ..ops.topk import DTypeLike, mips_topk
from ..utils.observability import count, trace_span

#: tile width of the packed serving mask (ops/topk.py::pack_mask_tiles); the
#: fused lane pads the catalog to a multiple of it
_MASK_TILE = 2048
#: users per packed-mask build step: bounds the int32 accumulator of one step
_BUILD_ROWS = 32768


def compute_serving_tables(
    params: LightGCNParams,
    train_edges: Optional[np.ndarray] = None,
    cfg=None,
    mode: str = "layer0",
    chunk_budget_bytes: int = 2 << 30,
    mesh=None,
) -> LightGCNParams:
    """Embedding tables used for retrieval scoring, on the device of ``params``.

    ``mode='layer0'`` (default) is the reference contract: the raw trained
    tables. ``mode='propagated'`` runs the K-layer propagation over the train
    graph first (the LightGCN-paper serving protocol), with
    ``cfg.model.num_layers`` and ``cfg.model.readout``; an XSimGCL config
    (``cfg.model.model``) takes its own unperturbed readout, the mean of
    hops 1..L (``models/xsimgcl.py``).

    Tables on a CUDA device propagate through the degree-bucketed ELL layout
    and the hand-written SpMM kernel (``ops/cuda_spmm.py``), which gathers rows
    and builds no (E, d) message tensor. Tables on the CPU propagate through
    ``spmm_segment``, in edge chunks once the message tensor would exceed
    ``chunk_budget_bytes``.

    With ``mesh`` (``parallel/mesh.py::Mesh``; every rank calls with the
    same tables) the tables propagate row-sharded over its ``model`` axis,
    through the sharded trainer's propagation
    (``parallel/sharding.py::make_sharded_propagate``, edges chunked by
    ``cfg.train.spmm_chunks``), and every rank gets the whole unpadded
    tables back.
    """
    if mode == "layer0":
        return params
    if mode != "propagated":
        raise ValueError(f"unknown serving mode {mode!r}")
    if train_edges is None or cfg is None:
        raise ValueError("propagated serving needs train_edges + cfg")
    if mesh is not None:
        return _sharded_tables(params, train_edges, cfg, mesh)
    from ..models.xsimgcl import final_tables

    dev = params.user_emb.device
    n = params.user_emb.shape[0] + params.item_emb.shape[0]
    d = params.user_emb.shape[1]
    e = train_edges.shape[1]
    if dev.type == "cuda":
        from ..data.graph import EllGraph
        from ..ops.cuda_spmm import select_spmm
        from ..ops.spmm import DeviceELL

        graph = DeviceELL.from_host(EllGraph.build(train_edges, n), dev)
        spmm = select_spmm(n, d)
    else:
        from ..data.graph import COOGraph
        from ..ops.spmm import DeviceCOO, make_spmm_chunked, spmm_segment

        chunks = max(1, int(np.ceil(e * d * 4 / chunk_budget_bytes)))
        if chunks > 1:
            per = -(-e // chunks)
            per = ((per + 127) // 128) * 128
            graph = DeviceCOO.from_host(
                COOGraph.build(train_edges, n, pad_to=per * chunks), dev)
            spmm = make_spmm_chunked(chunks)
        else:
            graph = DeviceCOO.from_host(COOGraph.build(train_edges, n), dev)
            spmm = spmm_segment
    fu, fi = final_tables(params, graph, spmm, cfg)
    return LightGCNParams(fu, fi)


def _sharded_tables(params: LightGCNParams, train_edges: np.ndarray, cfg, mesh
                    ) -> LightGCNParams:
    from ..config import check_model
    from ..parallel.mesh import Mesh
    from ..parallel.sharding import (ShardPlan, gather_params, make_sharded_propagate,
                                     pad_params, shard_coos, shard_graph, shard_params,
                                     unpad_params)

    check_model(cfg, "sharded")
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    plan = ShardPlan.create(params.user_emb.shape[0], params.item_emb.shape[0], mesh.mp)
    m = mesh.coords[1]
    coos = shard_coos(shard_graph(train_edges, plan), plan, m, params.user_emb.device,
                      cfg.train.spmm_chunks)
    local = make_sharded_propagate(cfg, mesh, plan)(
        shard_params(pad_params(params, plan), plan, m), coos)
    return unpad_params(gather_params(local, mesh), plan)


def _exclusion_mask(num_cols: int, excluded: Optional[Sequence[int]],
                    device: torch.device) -> Optional[torch.Tensor]:
    if excluded is None:
        return None
    m = np.zeros((1, num_cols), dtype=bool)
    # accept any iterable of indices (the CLI may build a python set)
    idx = np.fromiter(excluded, dtype=np.int64) if isinstance(
        excluded, (set, frozenset)) else np.asarray(excluded, dtype=np.int64)
    idx = idx[(idx >= 0) & (idx < num_cols)]
    m[0, idx] = True
    return torch.from_numpy(m).to(device)


def recommend_from_user(
    params: LightGCNParams,
    user_id: int,
    data: MovieLensData,
    excluded_train_items: Optional[Sequence[int]] = None,
    top_k: int = 10,
    normalize: bool = True,
) -> Dict[str, Union[str, List[Dict[str, Any]]]]:
    """Top-k movies for a raw userId (reference recommend_from_user, :12-63).

    Runs on the tables' device. ``normalize=False`` ranks by raw inner
    products instead of cosine."""
    uidx = int(data.user_index(user_id))
    if uidx < 0:
        return {"error": "Invalid user ID"}
    query = params.user_emb[uidx][None, :]
    mask = _exclusion_mask(params.item_emb.shape[0], excluded_train_items,
                           params.item_emb.device)
    scores, idx = mips_topk(query, params.item_emb, k=top_k, exclude_mask=mask,
                            normalize=normalize)
    recs = []
    for s, i in zip(scores[0].tolist(), idx[0].tolist()):
        raw = int(data.raw_movie_id(i))
        recs.append({"title": data.title_of(raw), "movieId": raw, "score": float(s)})
    return {"recommendations": recs}


def recommend_from_movie(
    params: LightGCNParams,
    movie_id: int,
    data: MovieLensData,
    excluded_train_users: Optional[Sequence[int]] = None,
    top_k: int = 10,
    normalize: bool = True,
) -> Dict[str, Union[str, List[Dict[str, Any]]]]:
    """Top-k users for a raw movieId (reference recommend_from_movie, :65-113)."""
    node = int(data.movie_index(movie_id))
    if node < 0:
        return {"error": "Invalid movie ID"}
    iidx = node - data.num_users
    query = params.item_emb[iidx][None, :]
    mask = _exclusion_mask(params.user_emb.shape[0], excluded_train_users,
                           params.user_emb.device)
    scores, idx = mips_topk(query, params.user_emb, k=top_k, exclude_mask=mask,
                            normalize=normalize)
    return {"top_users": [
        {"user_id": int(data.raw_user_id(i)), "score": float(s)}
        for s, i in zip(scores[0].tolist(), idx[0].tolist())
    ]}


class ServingIndex:
    """Device-resident batch-serving state: the embedding tables and the
    train-seen exclusion mask of the whole user base, tile-bit-packed to
    (U, ⌈N/2048⌉·256) uint8 (1.2 GB at ML-25M width, 8× under int8).

    The exclusion set belongs to a model refresh, not to a request batch: the
    packed mask is built once, and each batch pays a row gather before the
    masked fused kernel unpacks its bits in the epilogue.
    """

    def __init__(self, params: LightGCNParams, mask: torch.Tensor,
                 num_items: int, user_lo: int = 0):
        self.params = params
        self.mask = mask                 # (U, n_tiles·n_tile/8) uint8
        self.num_items = num_items
        self.user_lo = user_lo           # replica shard offset

    @staticmethod
    def build(params: LightGCNParams, train_edge_index: np.ndarray,
              num_users: int, user_range=None) -> "ServingIndex":
        """Build the packed mask on the tables' device, ``_BUILD_ROWS`` users
        at a time. ``user_range=(lo, hi)`` restricts it to a replica's user
        shard; ``batch_recommend`` then accepts only users in range."""
        from ..ops.topk import pack_mask_tiles
        from ..training.evaluate import _np_group_by_user

        # distinct (user, item) pairs -> distinct (row, byte, bit) triples,
        # so pack_mask_tiles' sum is exactly a bitwise OR
        indptr, items = _np_group_by_user(train_edge_index, num_users)
        lo, hi = user_range if user_range is not None else (0, num_users)
        dev = params.item_emb.device
        num_items = params.item_emb.shape[0]
        blocks = []
        for st in range(lo, hi, _BUILD_ROWS):
            en = min(st + _BUILD_ROWS, hi)
            lens = torch.from_numpy(np.diff(indptr[st:en + 1])).to(dev)
            rows = torch.repeat_interleave(
                torch.arange(en - st, device=dev), lens)
            cols = torch.from_numpy(items[indptr[st]:indptr[en]]).to(dev)
            blocks.append(pack_mask_tiles(rows, cols, num_rows=en - st,
                                          num_items=num_items,
                                          n_tile=_MASK_TILE))
        mask = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
        return ServingIndex(params, mask, num_items, user_lo=lo)

    def batch_recommend(self, user_indices, top_k: int = 10,
                        normalize: bool = True):
        """(scores f32, item indices int64), both (B, top_k), train-seen
        excluded."""
        from ..ops.cuda_mips import mips_topk_fused

        dev = self.mask.device
        with trace_span("serving.batch_recommend"):
            with trace_span("serving.ids"):
                idx = torch.as_tensor(np.asarray(user_indices), dtype=torch.int64)
                local = idx - self.user_lo
                if local.numel() and (local.min() < 0 or local.max() >= self.mask.shape[0]):
                    raise ValueError(
                        f"user index outside this replica's shard "
                        f"[{self.user_lo}, {self.user_lo + self.mask.shape[0]})")
                idx, local = _to_device(idx, dev), _to_device(local, dev)
            q = self.params.user_emb[idx]
            rows = self.mask[local]               # (B, W) uint8 row gather
            return mips_topk_fused(q, self.params.item_emb, k=top_k,
                                   normalize=normalize, n_tile=_MASK_TILE,
                                   exclude_mask_packed=rows)


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``; onto the card a copy from pageable memory, which
    blocks until the card has run what was queued (a ``host_sync``)."""
    t = t.to(dev)
    if dev.type == "cuda":
        count("host_sync")
    return t


def train_seen_items(train_edge_index: np.ndarray, num_users: int, user_index: int
                     ) -> np.ndarray:
    """Item indices the user interacted with in train (exclusion list,
    reference recommend.py:141-142)."""
    head, tail = train_edge_index[0], train_edge_index[1]
    m = (head == user_index) & (tail >= num_users)
    return (tail[m] - num_users).astype(np.int64)


def batch_recommend_users(
    params: LightGCNParams,
    user_indices: np.ndarray,
    exclude_mask: Optional[np.ndarray] = None,   # (B, num_items) bool
    top_k: int = 10,
    normalize: bool = True,
    exclude_pairs=None,     # CSR (indptr (B+1,), items (P,)) — device-built mask
    score_dtype: DTypeLike = None,
    method: Optional[str] = None,
    max_flat_bytes: int = 512 * 1024 * 1024,
):
    """Batched retrieval for many users at once. Returns (scores, item
    indices), both (B, k).

    With the tables on the GPU, batches take the fused lane
    (``method="fused"``, bf16 scores); on the CPU they take ``"auto"`` (exact
    f32). ``exclude_pairs`` is a CSR (indptr, items) over the batch rows: the
    (chunk, num_items) int8 exclusion mask is built on the tables' device
    (:func:`ops.topk.seen_mask_from_pairs`). Batches whose score matrix
    (plus mask) would exceed ``max_flat_bytes`` are split along the query
    axis into chunks of a multiple of 512 rows.
    """
    from ..ops.topk import seen_mask_from_pairs
    from ..utils.device import as_dtype

    dev = params.item_emb.device
    num_items = params.item_emb.shape[0]
    user_indices = np.asarray(user_indices)
    nq = int(user_indices.shape[0])
    if method is None:
        method = "fused" if dev.type == "cuda" else "auto"
    eff_dtype = as_dtype(score_dtype) or (torch.bfloat16 if method == "fused"
                                          else torch.float32)
    itemsize = torch.finfo(eff_dtype).bits // 8
    masked = exclude_mask is not None or exclude_pairs is not None
    per_row = num_items * (itemsize + (1 if masked else 0))
    chunk = nq
    if nq * per_row > max_flat_bytes:
        chunk = max(512, (max_flat_bytes // per_row) // 512 * 512)

    if exclude_pairs is not None and exclude_mask is not None:
        raise ValueError("pass exclude_mask OR exclude_pairs, not both")
    indptr = items = None
    if exclude_pairs is not None:
        indptr, items = (np.asarray(exclude_pairs[0]),
                         np.asarray(exclude_pairs[1]))
        if indptr.shape[0] != nq + 1:
            raise ValueError(f"exclude_pairs indptr must have B+1={nq + 1} "
                             f"entries, got {indptr.shape[0]}")

    out_s, out_i = [], []
    for lo in range(0, nq, chunk):
        hi = min(lo + chunk, nq)
        query = params.user_emb[torch.from_numpy(user_indices[lo:hi]).long().to(dev)]
        mask = None
        if exclude_mask is not None:
            mask = torch.from_numpy(np.asarray(exclude_mask[lo:hi])).to(dev)
        elif indptr is not None:
            lens = torch.from_numpy(np.diff(indptr[lo:hi + 1])).to(dev)
            rows = torch.repeat_interleave(torch.arange(hi - lo, device=dev), lens)
            cols = torch.from_numpy(items[indptr[lo]:indptr[hi]]).to(dev)
            mask = seen_mask_from_pairs(rows, cols, num_rows=hi - lo,
                                        num_cols=num_items)
        s, i = mips_topk(query, params.item_emb, k=top_k, exclude_mask=mask,
                         method=method, normalize=normalize,
                         score_dtype=score_dtype)
        out_s.append(s)
        out_i.append(i)
    if len(out_s) == 1:
        return out_s[0], out_i[0]
    return torch.cat(out_s), torch.cat(out_i)
