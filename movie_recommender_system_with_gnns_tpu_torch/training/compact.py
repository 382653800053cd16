"""Compact-cluster trainer: per-cluster node compaction for Cluster-GCN steps
(JAX package ``training/compact.py``).

The reference trains each Cluster-GCN step over the FULL node-id space: every
cluster's edge_index is remapped back to global ids and propagation allocates
(U+I, d) tensors per layer (reference data/dataset_handler.py:277-282,
models/light_gcn.py:29-36), although a cluster touches about 1% of the nodes.

This module keeps the reference's exact math while propagating in the
cluster's COMPACT node space:

  * gather the cluster's user/item rows from the global tables (one gather per
    table; autograd turns it into one scatter-add per table on backward);
  * run the K-layer propagation over local ids (small tensors): dense-Â
    matmuls when the clusters carry ``adj``, gather + row sum otherwise;
  * negatives stay reference-semantics: sampled uniformly over the FULL item
    catalog (helpers.py:79-80), or exact-feasible (no train pair of the
    triplet's user) when the clusters carry a member table
    (:func:`attach_member_table`). An out-of-cluster negative receives no
    messages under cluster propagation, so its final embedding is analytically
    ``table_row · readout_scale``; in-cluster negatives use the propagated
    row, resolved by a ``searchsorted`` membership probe.

With ``TrainConfig.fused_bpr`` the triplet loss and its gradients come from
the hand-written kernel behind ``ops/cuda_bpr.py::fused_bpr_loss``.

A step is run-to-run deterministic on the card: every scatter of repeated
rows sums in an order fixed by the data. ``build_compact_clusters`` lists, once
per cluster on the host, the stable orders of the segment path's ``src`` and
``dst`` and the fused kernel's user and positive incidence
(:class:`ClusterLists`); each step sorts its negatives once
(``ops/cuda_scatter.py::sort_rows``), and that order serves both the
negatives' gradient scatter (``gather_rows``) and the kernel's negative
lists. The gathers of ``user_ids``/``item_ids`` repeat only padding ids, whose
gradient rows are exact zeros, so their atomic scatter adds nothing. The epoch
is a Python loop over the clusters (the JAX package fuses it into one
``lax.scan``); per-step host work and synchronisation are kept out of it.

Four optimizers: ``adam`` (clip + dense Adam on both tables, through
``train.make_optimizer``), and the three that take gradients with respect to
the step's gathered rows (:func:`row_loss`) and touch fewer rows:
``lazy_adam`` (SparseAdam-style rows everywhere), ``hybrid_adam`` (dense
Adam on the item table, lazy user rows) and ``lazy_item_adam`` (hybrid with
the item update on the touched rows only). Their repeated rows are summed in
sorted order too, so their steps are as reproducible as Adam's.
The frozen boundary correction is not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.graph import gcn_norm
from ..models.lightgcn import LightGCNParams
from ..ops.bpr import select_bpr_loss
from ..ops.cuda_scatter import (gather_rows, scatter_rows, sort_rows, sort_rows_np,
                                sorted_index_add)
from ..ops.sampling import (build_member_table, check_negatives_mode, member_keys,
                             sample_negative, sample_negative_feasible)
from ..ops.spmm import block_matmul
from ..ops.topk import DTypeLike
from ..utils.device import DeviceLike, as_dtype, resolve_device
from .train import (AdamState, TrainState, adam_step_, bias_corrections, loss_and_grads,
                    make_lr_schedule, make_optimizer)


class ClusterLists(NamedTuple):
    """One cluster's row lists (int32), as ``ops/cuda_scatter.py::sort_rows``
    gives them: a stable order of an index array and its row starts.

    ``src``/``dst`` over the ``n_local`` compact nodes (the segment path's
    gather and sum); ``user_local``/``pos_local`` of the valid triplets over
    ``u_pad``/``i_pad`` rows (the fused kernel's user and positive incidence,
    a masked triplet keyed to the sentinel row); ``neg_keys`` (2·i_pad) the
    ids that bound each local item row's run among the step's sorted
    negatives: ``item_ids``, then ``item_ids + 1`` on a valid row and
    ``item_ids`` on a padding row (an empty run)."""

    src_order: torch.Tensor
    src_start: torch.Tensor
    dst_order: torch.Tensor
    dst_start: torch.Tensor
    user_order: torch.Tensor
    user_start: torch.Tensor
    pos_order: torch.Tensor
    pos_start: torch.Tensor
    neg_keys: torch.Tensor


def _np_cluster_lists(item_ids, src, dst, user_local, pos_local, mask,
                      u_pad: int, i_pad: int) -> Tuple[np.ndarray, ...]:
    """:class:`ClusterLists`' fields for one cluster's host arrays; a valid
    item row is the first of its id (padding repeats the last valid id)."""
    n_local = u_pad + i_pad
    valid = np.ones(len(item_ids), bool)
    valid[1:] = item_ids[1:] != item_ids[:-1]
    return (*sort_rows_np(src, n_local), *sort_rows_np(dst, n_local),
            *sort_rows_np(np.where(mask, user_local, u_pad), u_pad),
            *sort_rows_np(np.where(mask, pos_local, i_pad), i_pad),
            np.concatenate([item_ids, item_ids + valid]).astype(np.int32))


@dataclass(frozen=True)
class CompactClusters:
    """Stacked compact cluster batches (leading axis = cluster), as tensors
    on one device.

    ``user_ids``/``item_ids`` are each cluster's sorted global user/item
    indices, padded with the LAST valid id repeated (duplicate gathers are
    harmless; padded rows receive zero edge weight and masked triplets, so
    their gradient contribution is exactly zero).
    """

    user_ids: torch.Tensor      # (K, Upad) int32
    item_ids: torch.Tensor      # (K, Ipad) int32
    src: torch.Tensor           # (K, Epad) int32
    dst: torch.Tensor           # (K, Epad) int32, sorted; padding -> n_local-1
    w: torch.Tensor             # (K, Epad) float32, zero on padding
    user_local: torch.Tensor    # (K, B) int32
    pos_local: torch.Tensor     # (K, B) int32
    mask: torch.Tensor          # (K, B) bool
    edge_counts: torch.Tensor   # (K,) float32 true (undirected-doubled) edge counts
    user_valid: torch.Tensor    # (K, Upad) bool
    item_valid: torch.Tensor    # (K, Ipad) bool
    u_pad: int
    i_pad: int
    # inverse user map: user_cluster[u] = owning cluster (or -1), user_slot[u]
    # = row inside that cluster's user_ids; valid only when users_disjoint
    # (each user's edges in exactly one cluster: greedy node partition)
    user_cluster: torch.Tensor  # (U,) int32
    user_slot: torch.Tensor     # (U,) int32
    # each cluster's valid user count, on the host: the valid slots are the
    # first user_counts[c] of user_ids[c] (hybrid Adam writes those rows)
    user_counts: Tuple[int, ...]
    users_disjoint: bool = True
    # optional densified Â per cluster (K, n_local, n_local): turns the
    # propagation into matmuls (see densify_adjacency)
    adj: Optional[torch.Tensor] = None
    # per-cluster row lists (ClusterLists' fields, each stacked over clusters)
    row_lists: Optional[ClusterLists] = None
    # the train pairs' int64 search keys (ops/sampling.py::member_keys):
    # when present, every epoch fn draws exact-feasible negatives
    member_table: Optional[torch.Tensor] = None

    @property
    def num_clusters(self) -> int:
        return int(self.src.shape[0])

    def cluster(self, c: int) -> Tuple[torch.Tensor, ...]:
        """The 8-tuple :func:`compact_cluster_loss` takes for cluster ``c``."""
        return (self.user_ids[c], self.item_ids[c], self.src[c], self.dst[c],
                self.w[c], self.user_local[c], self.pos_local[c], self.mask[c])

    def lists(self, c: int) -> Optional[ClusterLists]:
        """Cluster ``c``'s :class:`ClusterLists`, the ``lists`` argument of
        :func:`compact_cluster_loss` (None when the clusters carry none)."""
        if self.row_lists is None:
            return None
        return ClusterLists(*(t[c] for t in self.row_lists))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_compact_clusters(
    parts: List[np.ndarray],
    num_users: int,
    align: int = 128,
    device: DeviceLike = None,
) -> CompactClusters:
    """Host-side compaction of partitioned (global-id, undirected) edge lists,
    then one upload to ``device``.

    Also builds the inverse user map (``user_cluster``/``user_slot``);
    ``users_disjoint`` records whether each user really appears in at most one
    cluster (true for the greedy node partition, false for random edge
    partitions); and each cluster's :class:`ClusterLists`, by NumPy stable
    argsorts."""
    dev = resolve_device(device)
    parts = [p for p in parts if p.shape[1] > 0]
    infos = []
    for e in parts:
        head, tail = e[0], e[1]
        fwd = (head < num_users) & (tail >= num_users)
        u = head[fwd].astype(np.int64)
        it = (tail[fwd] - num_users).astype(np.int64)
        uu = np.unique(u)               # sorted
        ii = np.unique(it)              # sorted
        ul = np.searchsorted(uu, u)
        il = np.searchsorted(ii, it)
        infos.append((uu, ii, ul, il, e.shape[1]))

    u_pad = _round_up(max(len(i[0]) for i in infos), align)
    i_pad = _round_up(max(len(i[1]) for i in infos), align)
    e_fwd_pad = _round_up(max(len(i[2]) for i in infos), align)
    e_pad = 2 * e_fwd_pad

    k = len(infos)
    user_ids = np.zeros((k, u_pad), np.int32)
    item_ids = np.zeros((k, i_pad), np.int32)
    src = np.zeros((k, e_pad), np.int32)
    dst = np.zeros((k, e_pad), np.int32)
    w = np.zeros((k, e_pad), np.float32)
    user_local = np.zeros((k, e_fwd_pad), np.int32)
    pos_local = np.zeros((k, e_fwd_pad), np.int32)
    mask = np.zeros((k, e_fwd_pad), bool)
    edge_counts = np.zeros(k, np.float32)
    user_valid = np.zeros((k, u_pad), bool)
    item_valid = np.zeros((k, i_pad), bool)
    lists = []

    n_local = u_pad + i_pad
    user_cluster = np.full(num_users, -1, np.int32)
    user_slot = np.zeros(num_users, np.int32)
    users_disjoint = True
    for c, (uu, ii, ul, il, ecount) in enumerate(infos):
        if (user_cluster[uu] >= 0).any():
            users_disjoint = False
        user_cluster[uu] = c
        user_slot[uu] = np.arange(len(uu), dtype=np.int32)
        # pad id lists by repeating the last valid id (gather-safe)
        user_ids[c] = np.pad(uu, (0, u_pad - len(uu)), mode="edge") if len(uu) else 0
        item_ids[c] = np.pad(ii, (0, i_pad - len(ii)), mode="edge") if len(ii) else 0
        nf = len(ul)
        # undirected compact edges: user→item and item→user halves
        s = np.concatenate([ul, u_pad + il])
        d = np.concatenate([u_pad + il, ul])
        e_loc = np.stack([s, d])
        wts = gcn_norm(e_loc, n_local)
        order = np.argsort(d, kind="stable")
        s, d, wts = s[order], d[order], wts[order]
        src[c, : 2 * nf] = s
        dst[c, 2 * nf:] = n_local - 1
        dst[c, : 2 * nf] = d
        w[c, : 2 * nf] = wts
        user_local[c, :nf] = ul
        pos_local[c, :nf] = il
        mask[c, :nf] = True
        edge_counts[c] = float(ecount)
        user_valid[c, : len(uu)] = True
        item_valid[c, : len(ii)] = True
        lists.append(_np_cluster_lists(item_ids[c], src[c], dst[c], user_local[c],
                                       pos_local[c], mask[c], u_pad, i_pad))

    t = lambda a: torch.from_numpy(a).to(dev)
    return CompactClusters(
        user_ids=t(user_ids), item_ids=t(item_ids), src=t(src), dst=t(dst),
        w=t(w), user_local=t(user_local), pos_local=t(pos_local), mask=t(mask),
        edge_counts=t(edge_counts), user_valid=t(user_valid),
        item_valid=t(item_valid), u_pad=u_pad, i_pad=i_pad,
        user_cluster=t(user_cluster), user_slot=t(user_slot),
        user_counts=tuple(len(info[0]) for info in infos),
        users_disjoint=users_disjoint,
        row_lists=ClusterLists(*(t(np.stack(f)) for f in zip(*lists))),
    )


def cluster_lists(cluster: Tuple, u_pad: int, i_pad: int) -> ClusterLists:
    """:class:`ClusterLists` of a :meth:`CompactClusters.cluster` tuple, listed
    on the host as ``build_compact_clusters`` lists them and moved to the
    tuple's device; for callers that hold a cluster's arrays but not its
    lists."""
    (_, item_ids, src, dst, _, user_local, pos_local, mask) = cluster
    host = (t.cpu().numpy() for t in (item_ids, src, dst, user_local, pos_local, mask))
    return ClusterLists(*(torch.from_numpy(a).to(src.device)
                          for a in _np_cluster_lists(*host, u_pad, i_pad)))


def densify_adjacency(cc: CompactClusters, dtype: DTypeLike = torch.bfloat16,
                      max_local_nodes: int = 4096) -> CompactClusters:
    """Materialize each cluster's normalized adjacency as a dense
    (n_local, n_local) block so propagation runs as matmuls.

    Only sensible while K·n_local² fits device memory; refuses beyond
    ``max_local_nodes`` (the segment path then runs). The blocks are built on
    the clusters' device from the COO edges already there
    (``ops/spmm.py::densify_blocks``); padding edges carry w=0, so they are
    harmless.
    """
    n_local = cc.u_pad + cc.i_pad
    if n_local > max_local_nodes:
        raise ValueError(
            f"n_local={n_local} > {max_local_nodes}: dense adjacency would "
            f"need {cc.num_clusters * n_local * n_local * 2 / 1e9:.1f} GB — "
            "use more clusters or the segment-sum path")
    from ..ops.spmm import densify_blocks

    k = cc.num_clusters
    # host views of the indices so densify_blocks' range check engages
    blk = np.broadcast_to(np.arange(k, dtype=np.int32)[:, None], tuple(cc.src.shape))
    adj = densify_blocks(blk, cc.dst.cpu().numpy(), cc.src.cpu().numpy(), cc.w,
                         num_blocks=k, width=n_local, dtype=dtype,
                         device=cc.src.device)
    return dataclasses.replace(cc, adj=adj)


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP queue A 6, "
        "compact cluster trainer)")


def attach_member_table(cc: CompactClusters, train_edge_index: np.ndarray,
                        num_users: int) -> CompactClusters:
    """A copy of ``cc`` carrying the train pairs' member table (as its int64
    search keys, on ``cc``'s device), so every compact epoch fn draws EXACT
    feasible negatives. The pairs come from the FULL train edge set, not just
    the edges kept inside clusters: a negative must avoid everything the user
    interacted with."""
    from ..data.partition import forward_half

    u, it = forward_half(train_edge_index, num_users)
    table = build_member_table(u.astype(np.int32), it.astype(np.int32))
    return dataclasses.replace(cc, member_table=member_keys(table, cc.src.device))


def build_boundary_correction(params, hybrid, cc: CompactClusters, cfg: Config,
                              num_users: int, corr_dtype: str = "float32"):
    """The frozen inter-cluster correction needs the full-graph propagation."""
    _not_ported("build_boundary_correction (the frozen boundary correction)")


def _step_negatives(cfg: Config, generator: torch.Generator, cc: CompactClusters,
                    c: int, num_items: int) -> torch.Tensor:
    """Cluster ``c``'s negative draw: uniform (reference helpers.py:79-80),
    or exact-feasible against the global user of each triplet slot when
    ``cc`` carries a member table."""
    if cc.member_table is None:
        return sample_negative(generator, cc.user_local.shape[1], num_items,
                               num=cfg.train.num_negatives, device=cc.src.device)
    users = cc.user_ids[c].index_select(0, cc.user_local[c])
    return sample_negative_feasible(generator, users, num_items, cc.member_table,
                                    num=cfg.train.num_negatives)


def _one_hop(cur, src, dst, w, adj, n_local, lists: Optional[ClusterLists] = None):
    """One propagation hop in the cluster's compact node space. The segment
    path gathers and sums its messages through ``lists``' stable orders of
    ``src`` and ``dst`` (sorted here when None), so both directions sum in an
    order fixed by the data."""
    if adj is not None:
        if adj.dtype == cur.dtype:
            return adj @ cur
        # f32 accumulation and result; the backward rounds the cotangent
        return block_matmul(adj, cur).to(cur.dtype)
    if lists is None:
        src_lists, dst_lists = sort_rows(src, n_local), sort_rows(dst, n_local)
    else:
        src_lists = (lists.src_order, lists.src_start)
        dst_lists = (lists.dst_order, lists.dst_start)
    msg = gather_rows(cur, src, *src_lists) * w[:, None].to(cur.dtype)
    return scatter_rows(msg, dst, *dst_lists, n_local)


def _propagate_local(emb, src, dst, w, adj, num_layers, n_local, corr=None,
                     lists: Optional[ClusterLists] = None):
    """Compact-space propagation: dense-Â matmuls when ``adj`` is present,
    gather + row sum otherwise. Returns the layer-summed accumulator.
    ``corr`` (the frozen boundary correction) must be None."""
    if corr is not None:
        _not_ported("the frozen boundary correction (corr)")
    acc = emb
    cur = emb
    for _ in range(num_layers):
        cur = _one_hop(cur, src, dst, w, adj, n_local, lists)
        acc = acc + cur
    return acc


def _neg_local_index(item_ids: torch.Tensor, neg: torch.Tensor, i_pad: int):
    """Map sampled global negative item ids to cluster-local slots.

    ``item_ids`` is sorted with the last valid id repeated as padding.
    Returns ``(loc, in_cluster)``: ``loc = min(lower_bound(item_ids, neg),
    i_pad − 1)`` and ``in_cluster`` iff the lower bound is below ``i_pad`` and
    ``item_ids[loc] == neg``; on the repeated padding id the first slot wins.
    (The JAX package reaches the same values through an inverse table, a
    workaround for the TPU's slow binary search.)
    """
    lb = torch.searchsorted(item_ids, neg.to(item_ids.dtype).contiguous(),
                            out_int32=True)
    loc = lb.clamp_max(i_pad - 1)
    return loc, (lb < i_pad) & (item_ids[loc] == neg)


def step_incidence(lists: ClusterLists, neg_lists: Tuple[torch.Tensor, torch.Tensor],
                   kneg: int = 1):
    """The fused kernel's ``BprIncidence`` for one step: the cluster's user and
    positive lists (an entry per group of ``kneg`` triplets) and each local
    item row's run among the step's sorted negatives, ``neg_lists = (order,
    starts)`` of the flattened negatives over the catalog."""
    from ..ops.cuda_bpr import BprIncidence

    order, starts = neg_lists
    return BprIncidence(lists.user_order, lists.user_start, lists.pos_order,
                        lists.pos_start, order, starts.index_select(0, lists.neg_keys),
                        kneg)


def _triplet_loss(fu, u_rows, fi, i_rows, ni, neg, item_ids, user_local,
                  pos_local, mask, cfg: Config, i_pad: int, scale: float,
                  lists: ClusterLists,
                  neg_lists: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Compact-space BPR dispatch: the fused kernel when
    ``cfg.train.fused_bpr``, the row-gather route otherwise.

    ``neg`` is (B,) or (B, K) for K negatives per positive; ``ni`` its
    gathered initial rows. The fused kernel is single-negative: K>1 flattens
    to B·K triplets with users/positives repeated, which is exactly
    equivalent, because both masked means in the loss decompose over the
    expansion (``ops/bpr.py::bpr_loss`` means over B·d reg entries and over B
    pairwise rows; with u/p repeated K times those equal the B·K-expanded
    means). The kernel's lists: the cluster's user and positive incidence
    from ``lists`` (an entry stands for its K triplets) and each local item
    row's run among the step's sorted negatives, ``neg_lists`` = ``(order,
    starts)`` of the flattened ``neg`` over the catalog.
    """
    d = u_rows.shape[1]
    if cfg.train.fused_bpr and cfg.train.loss in ("reference", "standard"):
        from ..ops.cuda_bpr import fused_bpr_loss, fused_bpr_supported

        if not fused_bpr_supported(fu.shape[0], i_pad, d):
            raise ValueError(f"fused_bpr: d={d} is wider than the kernel takes")
        if neg.dim() == 2:
            kneg = neg.shape[1]
            ul_x = user_local.repeat_interleave(kneg)
            pl_x = pos_local.repeat_interleave(kneg)
            m_x = mask.repeat_interleave(kneg)
            neg_x = neg.reshape(-1)
            ni_x = ni.reshape(-1, d)
        else:
            ul_x, pl_x, m_x, neg_x, ni_x = user_local, pos_local, mask, neg, ni
        loc, in_cluster = _neg_local_index(item_ids, neg_x, i_pad)
        incidence = step_incidence(lists, neg_lists,
                                   neg.shape[1] if neg.dim() == 2 else 1)
        return fused_bpr_loss(fu, u_rows, fi, i_rows, ni_x, ul_x, pl_x, loc,
                              in_cluster, m_x, scale=scale,
                              bpr_coeff=cfg.train.bpr_coeff,
                              loss=cfg.train.loss, incidence=incidence)

    u_cat = torch.cat([fu, u_rows], dim=1)[user_local]          # (B, 2d)
    uf, ui = u_cat[:, :d], u_cat[:, d:]
    p_cat = torch.cat([fi, i_rows], dim=1)[pos_local]
    pf, pi = p_cat[:, :d], p_cat[:, d:]
    # negatives over the FULL catalog (reference helpers.py:79-80): in-cluster
    # negatives take the propagated row; out-of-cluster ones are isolated
    # under cluster propagation, so final = table_row · scale analytically
    loc, in_cluster = _neg_local_index(item_ids, neg, i_pad)
    nf = torch.where(in_cluster[..., None], fi[loc], ni * scale)
    loss_fn = select_bpr_loss(cfg.train.loss)
    return loss_fn(uf, ui, pf, pi, nf, ni, cfg.train.bpr_coeff, mask=mask)


def row_loss(u_rows, i_rows, n_rows, cluster: Tuple, neg: torch.Tensor,
             cfg: Config, u_pad: int, i_pad: int, adj: Optional[torch.Tensor],
             lists: ClusterLists,
             neg_lists: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The compact BPR loss from the rows a step gathered (JAX ``row_loss``):
    ``u_rows`` (u_pad, d) and ``i_rows`` (i_pad, d) the cluster's table rows,
    ``n_rows`` (B·K, d) the flattened negatives' rows, ``neg_lists`` =
    ``sort_rows`` of the flattened ``neg`` over the catalog. Autograd reaches
    the rows through the propagation and the BPR dispatch (B1's
    ``autograd.Function`` on the fused route)."""
    (user_ids, item_ids, src, dst, w, user_local, pos_local, mask) = cluster
    n_local = u_pad + i_pad
    k1 = cfg.model.num_layers + 1
    scale = 1.0 / (k1 * k1) if cfg.model.readout == "reference" else 1.0 / k1
    cdtype = as_dtype(cfg.model.compute_dtype)

    emb = torch.cat([u_rows, i_rows], dim=0).to(cdtype)
    acc = _propagate_local(emb, src, dst, w, adj, cfg.model.num_layers, n_local,
                           lists=lists)
    final = acc.to(torch.float32) * scale
    fu, fi = final[:u_pad], final[u_pad:]
    ni = n_rows.reshape(*neg.shape, n_rows.shape[1])
    return _triplet_loss(fu, u_rows, fi, i_rows, ni, neg, item_ids,
                         user_local, pos_local, mask, cfg, i_pad, scale, lists,
                         neg_lists)


def compact_cluster_loss(
    params: LightGCNParams,
    cluster: Tuple,
    neg: torch.Tensor,
    cfg: Config,
    u_pad: int,
    i_pad: int,
    adj: Optional[torch.Tensor] = None,
    lists: Optional[ClusterLists] = None,
) -> torch.Tensor:
    """Reference-equivalent BPR loss for one compact cluster.

    Matches ``training.train.compute_loss`` over the same cluster with global
    propagation. ``neg`` may be (B,) or (B, K): K uniform negatives per
    positive. ``cluster`` is :meth:`CompactClusters.cluster`'s 8-tuple and
    ``lists`` its :meth:`CompactClusters.lists` (listed here when None). The
    negatives are sorted once: their gradient rows and the fused kernel's
    negative lists share the order.
    """
    user_ids, item_ids = cluster[:2]
    if lists is None:
        lists = cluster_lists(cluster, u_pad, i_pad)
    u_rows = params.user_emb.index_select(0, user_ids)      # (Upad, d) gather
    i_rows = params.item_emb.index_select(0, item_ids)      # (Ipad, d)
    # the step's one sort of its negatives (global ids over the catalog)
    neg_flat = neg.reshape(-1)
    neg_lists = sort_rows(neg_flat, params.item_emb.shape[0])
    n_rows = gather_rows(params.item_emb, neg_flat, *neg_lists)
    return row_loss(u_rows, i_rows, n_rows, cluster, neg, cfg, u_pad, i_pad, adj,
                    lists, neg_lists)


# ---------------------------------------------------------------------------
# Lazy (sparse) Adam: moments of the touched rows only, the torch SparseAdam
# analog (JAX package ``training/compact.py``, lazy and hybrid epochs)
# ---------------------------------------------------------------------------

#: the optimizers whose state is a :class:`LazyAdamState`
LAZY_OPTIMIZERS = ("lazy_adam", "hybrid_adam", "lazy_item_adam")


class LazyAdamState(NamedTuple):
    """Full-table moments and the step count, a Python int (JAX's field
    order); only the update rule differs between the three optimizers."""

    mu: LightGCNParams
    nu: LightGCNParams
    count: int


def init_lazy_adam(params: LightGCNParams) -> LazyAdamState:
    z = lambda: LightGCNParams(torch.zeros_like(params.user_emb),
                               torch.zeros_like(params.item_emb))
    return LazyAdamState(mu=z(), nu=z(), count=0)


def create_lazy_train_state(cfg: Config, params: LightGCNParams) -> TrainState:
    return TrainState(params=params, opt_state=init_lazy_adam(params), step=0)


def lazy_state_from_optax(opt_state: AdamState) -> LazyAdamState:
    """The Adam state's ``(mu, nu, count)`` as a :class:`LazyAdamState`. The
    port's :class:`~.train.AdamState` follows ``optax.chain(clip, adam)``
    step for step and both sides keep per-row moments under the same law, so
    the bridge is a relabelling: the tensors are shared, not copied."""
    if not isinstance(opt_state, AdamState):
        raise ValueError(f"expected an AdamState, got {type(opt_state).__name__}")
    return LazyAdamState(mu=opt_state.mu, nu=opt_state.nu, count=opt_state.count)


def lazy_state_to_optax(lz: LazyAdamState) -> AdamState:
    """The reverse relabelling, for ``optimizer="adam"``. The JAX function
    also takes a template of the optax chain, whose schedule count it sets to
    the same step; the port's Adam state holds the one count."""
    return AdamState(count=lz.count, mu=lz.mu, nu=lz.nu)


class RowGrads(NamedTuple):
    """One step's loss and its gradients with respect to the rows it gathered
    (JAX: ``value_and_grad(row_loss, argnums=(0, 1, 2))``), with the step's
    lists: the cluster's and the one sort of its negatives."""

    loss: torch.Tensor
    gu: torch.Tensor            # (u_pad, d)
    gi: torch.Tensor            # (i_pad, d)
    gn: torch.Tensor            # (B·K, d), the negatives in draw order
    neg: torch.Tensor           # (B·K,) the flattened negatives
    neg_lists: Tuple[torch.Tensor, torch.Tensor]   # sort_rows(neg, num_items)
    lists: ClusterLists


def compact_row_grads(params: LightGCNParams, cc: CompactClusters, c: int,
                      neg: torch.Tensor, cfg: Config) -> RowGrads:
    """Cluster ``c``'s loss and row gradients for the negatives ``neg``."""
    cluster = cc.cluster(c)
    lists = cc.lists(c)
    if lists is None:
        lists = cluster_lists(cluster, cc.u_pad, cc.i_pad)
    neg_flat = neg.reshape(-1)
    neg_lists = sort_rows(neg_flat, params.item_emb.shape[0])
    rows = [table.index_select(0, idx).requires_grad_(True) for table, idx in (
        (params.user_emb, cluster[0]), (params.item_emb, cluster[1]),
        (params.item_emb, neg_flat))]
    with torch.enable_grad():
        loss = row_loss(*rows, cluster, neg, cfg, cc.u_pad, cc.i_pad,
                        None if cc.adj is None else cc.adj[c], lists, neg_lists)
        gu, gi, gn = torch.autograd.grad(loss, rows)
    return RowGrads(loss.detach(), gu, gi, gn.contiguous(), neg_flat, neg_lists,
                    lists)


class Runs(NamedTuple):
    """The runs of equal ids among an index array's stable sort, for
    :func:`~..ops.cuda_scatter.sorted_index_add` with ``rows = n``: sorted
    position ``p`` gets the sum, in entry order, of its run when it is the
    run's first (``first``), and zero otherwise."""

    order: torch.Tensor         # (n,) int32, the stable sort
    starts: torch.Tensor        # (n + 1,) int32
    keys: torch.Tensor          # (n,) the sorted ids
    first: torch.Tensor         # (n,) bool


def _runs(idx: torch.Tensor, lists: Tuple[torch.Tensor, torch.Tensor]) -> Runs:
    """:class:`Runs` of ``idx`` from its ``lists = sort_rows(idx, rows)``:
    a run's first position keeps its row's start, every other position the
    run's end (an empty list); no host sync."""
    order, starts = lists
    keys = idx.index_select(0, order)
    n = keys.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=idx.device)
    first = starts.index_select(0, keys) == pos
    ends = starts.index_select(0, keys + 1)
    return Runs(order, torch.cat([torch.where(first, pos, ends), pos.new_full((1,), n)]),
                keys, first)


def _clip_scale(sq_sum: torch.Tensor, clip: float) -> torch.Tensor:
    """The lazy paths' global-norm clip (JAX): ``min(1, clip / max(‖g‖, 1e-6))``."""
    return (clip / sq_sum.sqrt().clamp_min(1e-6)).clamp_max(1.0)


def _lr_t(lr: float, bc1: float, bc2: float) -> float:
    """SparseAdam's step size ``lr·√(1 − b2ᵗ)/(1 − b1ᵗ)``, in float32."""
    f = np.float32
    return float(f(lr) * np.sqrt(f(bc2)) / f(bc1))


def _lazy_row_update(table, mu, nu, rows, g_rows, valid, lr_t, b1, b2, eps, scale,
                     runs: Optional[Runs] = None):
    """Adam on the gathered rows only, in the ``lr_t`` form (eps outside the
    uncorrected √v), written back in place as masked row adds of the deltas
    of table, ``mu`` and ``nu``.

    Untouched rows keep stale moments (no decay while idle, as torch
    SparseAdam), and rows that repeat within one call each apply a delta
    computed from the same pre-state. Without ``runs`` every repeated row but
    one must be masked out by ``valid`` (the padding slots): the adds then
    meet no other nonzero add. ``runs`` (the :class:`Runs` of ``rows``) sums
    each row's deltas over its run, in entry order, before one add per row;
    ``valid`` None masks nothing."""
    g = g_rows * scale
    m_old = mu.index_select(0, rows)
    v_old = nu.index_select(0, rows)
    m = b1 * m_old + (1.0 - b1) * g
    v = b2 * v_old + (1.0 - b2) * (g * g)
    upd = -lr_t * m / (v.sqrt() + eps)
    for t, delta in ((table, upd), (mu, m - m_old), (nu, v - v_old)):
        if valid is not None:
            delta = delta * valid[:, None].to(delta.dtype)
        if runs is None:
            t.index_add_(0, rows, delta)
        else:
            n = rows.shape[0]
            t.index_add_(0, runs.keys, sorted_index_add(delta.contiguous(), runs.order,
                                                        runs.starts, n))
    return table, mu, nu


UpdateFn = Callable[[LightGCNParams, LazyAdamState, CompactClusters, int, RowGrads],
                    Tuple[LightGCNParams, LazyAdamState]]


def _lazy_update(cfg: Config) -> UpdateFn:
    """``lazy_adam``: lazy rows on both tables; the clip norm over the
    unsummed row gradients; the cluster's items first, then the negatives,
    which read the moments as the item update left them."""
    lr_of = make_lr_schedule(cfg)
    b1, b2, eps = cfg.train.adam_b1, cfg.train.adam_b2, cfg.train.adam_eps
    clip = cfg.train.grad_clip_norm

    @torch.no_grad()
    def update(params, ost, cc, c, rg):
        cscale = _clip_scale(rg.gu.square().sum() + rg.gi.square().sum()
                             + rg.gn.square().sum(), clip)
        count = ost.count + 1
        lr_t = _lr_t(lr_of(ost.count), *bias_corrections(count, b1, b2))
        args = (lr_t, b1, b2, eps, cscale)
        _lazy_row_update(params.user_emb, ost.mu.user_emb, ost.nu.user_emb,
                         cc.user_ids[c], rg.gu, cc.user_valid[c], *args)
        tables = (params.item_emb, ost.mu.item_emb, ost.nu.item_emb)
        _lazy_row_update(*tables, cc.item_ids[c], rg.gi, cc.item_valid[c], *args)
        _lazy_row_update(*tables, rg.neg, rg.gn, None, *args,
                         runs=_runs(rg.neg, rg.neg_lists))
        return params, LazyAdamState(ost.mu, ost.nu, count)

    return update


def _touched_item_grads(rg: RowGrads, gi: torch.Tensor, item_ids: torch.Tensor,
                        item_valid: torch.Tensor, i_pad: int):
    """``lazy_item_adam``'s item rows: ``(rows, g, valid)`` over the cluster's
    items then the negatives' sorted positions. An item row's gradient is its
    negatives' run (in draw order) plus its own row, the order of JAX's
    stable sort of ``[neg ‖ item_ids]``; a negative outside the cluster keeps
    its run's sum at the run's first position; every other entry is masked.
    No dense (num_items, d) gradient is formed."""
    runs = _runs(rg.neg, rg.neg_lists)
    n = runs.keys.shape[0]
    sums = sorted_index_add(rg.gn, runs.order, runs.starts, n)
    bounds = rg.neg_lists[1].index_select(0, rg.lists.neg_keys)
    lo, hi = bounds[:i_pad], bounds[i_pad:]
    g_items = gi + torch.where((hi > lo)[:, None],
                               sums.index_select(0, lo.clamp_max(n - 1)), 0.0)
    keys = runs.keys.to(item_ids.dtype)
    keep = runs.first & ~_neg_local_index(item_ids, keys, i_pad)[1]
    return (torch.cat([item_ids, keys]),
            torch.cat([g_items, sums * keep[:, None].to(sums.dtype)]),
            torch.cat([item_valid, keep]))


def _hybrid_update(cfg: Config, lazy_items: bool) -> UpdateFn:
    """``hybrid_adam``: exact dense Adam (optax form) on the item table, from
    the dense item gradient: the negatives' rows summed over the step's lists
    (``sorted_index_add``), then the cluster's item rows added; lazy user
    rows (``lr_t`` form) written to the cluster's valid slots. The clip norm
    is ``√(Σgu² + Σgi_dense²)`` over the valid user rows.

    ``lazy_items`` (``lazy_item_adam``): the same optax-form Adam on the
    touched item rows only (:func:`_touched_item_grads`), as masked row adds
    of the deltas; the clip norm over the touched rows' summed gradients."""
    lr_of = make_lr_schedule(cfg)
    b1, b2, eps = cfg.train.adam_b1, cfg.train.adam_b2, cfg.train.adam_eps
    clip = cfg.train.grad_clip_norm

    @torch.no_grad()
    def update(params, ost, cc, c, rg):
        if not cc.users_disjoint:
            raise ValueError(
                "hybrid_adam needs disjoint per-cluster user sets (greedy "
                "node partition); rebuild the clusters with "
                "partitioner='greedy' or use optimizer='adam'/'lazy_adam'")
        item_ids, item_valid = cc.item_ids[c], cc.item_valid[c]
        gi = rg.gi * item_valid[:, None].to(rg.gi.dtype)
        # the valid user slots come first: each user's one row in this step
        nv = cc.user_counts[c]
        user_ids, gu = cc.user_ids[c][:nv], rg.gu[:nv]
        if lazy_items:
            rows, g_rows, valid = _touched_item_grads(rg, gi, item_ids, item_valid,
                                                      cc.i_pad)
            cscale = _clip_scale(gu.square().sum() + g_rows.square().sum(), clip)
        else:
            order, starts = rg.neg_lists
            g_dense = sorted_index_add(rg.gn, order, starts, params.item_emb.shape[0])
            # a valid item id occurs once; the padding slots add exact zeros
            g_dense.index_add_(0, item_ids, gi)
            cscale = _clip_scale(gu.square().sum() + g_dense.square().sum(), clip)
        lr = lr_of(ost.count)
        count = ost.count + 1
        bc1, bc2 = bias_corrections(count, b1, b2)
        mu_i, nu_i = ost.mu.item_emb, ost.nu.item_emb
        if lazy_items:
            g = g_rows * cscale
            m_old, v_old = mu_i.index_select(0, rows), nu_i.index_select(0, rows)
            m_new = b1 * m_old + (1.0 - b1) * g
            v_new = b2 * v_old + (1.0 - b2) * (g * g)
            upd = m_new / ((v_new / bc2).sqrt() + eps) * (-lr / bc1)
            fm = valid[:, None].to(g.dtype)
            for t, delta in ((params.item_emb, upd), (mu_i, m_new - m_old),
                             (nu_i, v_new - v_old)):
                t.index_add_(0, rows, delta * fm)
        else:
            adam_step_(params.item_emb, g_dense * cscale, mu_i, nu_i, lr, bc1, bc2,
                       b1, b2, eps)

        # users: lazy rows, each user in one cluster, so the rows read here are
        # the epoch-start ones JAX reads; written in place of the old rows
        lr_t = _lr_t(lr, bc1, bc2)
        tables = (params.user_emb, ost.mu.user_emb, ost.nu.user_emb)
        u_rows, mu_rows, nu_rows = (t.index_select(0, user_ids) for t in tables)
        gs = gu * cscale
        m_new = b1 * mu_rows + (1.0 - b1) * gs
        v_new = b2 * nu_rows + (1.0 - b2) * (gs * gs)
        u_new = u_rows - lr_t * m_new / (v_new.sqrt() + eps)
        slots = user_ids.long()
        for t, new in zip(tables, (u_new, m_new, v_new)):
            t.index_copy_(0, slots, new)
        return params, LazyAdamState(ost.mu, ost.nu, count)

    return update


def make_row_update(cfg: Config) -> UpdateFn:
    """``update(params, opt_state, cc, c, row_grads) -> (params, opt_state)``:
    one step of ``cfg.train.optimizer`` (one of :data:`LAZY_OPTIMIZERS`) from
    :func:`compact_row_grads`, in place on the tables and moments. No host
    sync: the bias corrections come from the Python count."""
    opt = cfg.train.optimizer
    if opt == "lazy_adam":
        return _lazy_update(cfg)
    if opt in ("hybrid_adam", "lazy_item_adam"):
        return _hybrid_update(cfg, lazy_items=opt == "lazy_item_adam")
    raise ValueError(f"optimizer {opt!r} has no row update")


Step = Callable[[TrainState, CompactClusters, int, torch.Tensor],
                Tuple[TrainState, torch.Tensor]]


def _epoch_fn(cfg: Config, step: Step):
    """``epoch_fn(state, cc, generator, perm=None, neg=None) -> (state,
    mean_loss)``: ``step(state, cc, c, neg)`` over the clusters in a shuffled
    order, the mean loss weighted by the clusters' true edge counts.

    ``perm`` (K,) injects the cluster order and ``neg`` (K, B) or (K, B, Kneg)
    the negatives of each STEP (``neg[j]`` belongs to step j, which trains
    cluster ``perm[j]``), so a test can replay what another run drew; left
    None they come from ``generator``."""
    check_negatives_mode(cfg.train.negatives)

    def epoch_fn(state: TrainState, cc: CompactClusters,
                 generator: Optional[torch.Generator],
                 perm=None, neg: Optional[torch.Tensor] = None
                 ) -> Tuple[TrainState, float]:
        num_items = state.params.item_emb.shape[0]
        k = cc.num_clusters
        device = cc.src.device
        if perm is None:
            perm = torch.randperm(k, generator=generator, device=generator.device)
        order = [int(c) for c in (perm.tolist() if isinstance(perm, torch.Tensor)
                                  else perm)]
        wloss = torch.zeros((), dtype=torch.float32, device=device)
        for j, c in enumerate(order):
            neg_j = (neg[j] if neg is not None else
                     _step_negatives(cfg, generator, cc, c, num_items))
            state, loss = step(state, cc, c, neg_j)
            wloss = wloss + loss * cc.edge_counts[c]
        # the epoch's one host sync
        mean_loss = float(wloss / cc.edge_counts.sum().clamp_min(1.0))
        return state, mean_loss

    return epoch_fn


def _row_epoch_fn(cfg: Config, update: UpdateFn):
    """An epoch of row-gradient steps: :func:`compact_row_grads`, then
    ``update``. The state's optimizer state is a :class:`LazyAdamState`."""

    def step(state, cc, c, neg):
        rg = compact_row_grads(state.params, cc, c, neg, cfg)
        params, ost = update(state.params, state.opt_state, cc, c, rg)
        return TrainState(params, ost, state.step + 1), rg.loss

    return _epoch_fn(cfg, step)


def make_compact_lazy_epoch_fn(cfg: Config):
    """Epoch with lazy Adam: per step, only the cluster's gathered rows
    (users, items, and the sampled negatives) move."""
    return _row_epoch_fn(cfg, _lazy_update(cfg))


def make_compact_hybrid_epoch_fn(cfg: Config, lazy_items: bool = False):
    """Hybrid-Adam epoch: exact dense Adam on the item table, lazy rows on the
    user table (``lazy_items``: touched item rows only). Needs disjoint
    per-cluster user sets (``cc.users_disjoint``): a step raises
    ``ValueError`` otherwise."""
    return _row_epoch_fn(cfg, _hybrid_update(cfg, lazy_items))


def make_compact_epoch_fn(cfg: Config):
    """Build ``epoch_fn(state, cc, generator, perm=None, neg=None) ->
    (state, mean_loss)`` (:func:`_epoch_fn`): one shuffled pass over all
    compact clusters, one optimizer step per cluster.

    ``cfg.train.optimizer``: ``"adam"`` (clip + dense Adam from the table
    gradients), or ``lazy_adam`` / ``hybrid_adam`` / ``lazy_item_adam`` (from
    the row gradients; the state's optimizer state a :class:`LazyAdamState`).
    ``num_negatives > 1``, ``fused_bpr`` and any ``loss``/``readout``
    combination are supported under each.
    """
    if cfg.train.optimizer == "lazy_adam":
        return make_compact_lazy_epoch_fn(cfg)
    if cfg.train.optimizer == "hybrid_adam":
        return make_compact_hybrid_epoch_fn(cfg)
    if cfg.train.optimizer == "lazy_item_adam":
        return make_compact_hybrid_epoch_fn(cfg, lazy_items=True)
    if cfg.train.optimizer != "adam":
        raise ValueError(f"unknown optimizer {cfg.train.optimizer!r}")
    opt = make_optimizer(cfg)

    def step(state, cc, c, neg):
        loss, grads = loss_and_grads(
            compact_cluster_loss, state.params, cc.cluster(c), neg, cfg,
            cc.u_pad, cc.i_pad, None if cc.adj is None else cc.adj[c], cc.lists(c))
        params, opt_state = opt.update(state.params, grads, state.opt_state)
        return TrainState(params, opt_state, state.step + 1), loss

    return _epoch_fn(cfg, step)
