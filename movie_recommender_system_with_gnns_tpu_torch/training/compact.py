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
    matmuls when the clusters carry ``adj``, gather + ``index_add`` otherwise;
  * negatives stay reference-semantics: sampled uniformly over the FULL item
    catalog (helpers.py:79-80). An out-of-cluster negative receives no
    messages under cluster propagation, so its final embedding is analytically
    ``table_row · readout_scale``; in-cluster negatives use the propagated
    row, resolved by a ``searchsorted`` membership probe.

With ``TrainConfig.fused_bpr`` the triplet loss and its gradients come from
the hand-written kernel behind ``ops/cuda_bpr.py::fused_bpr_loss``. The epoch
is a Python loop over the clusters (the JAX package fuses it into one
``lax.scan``); per-step host work and synchronisation are kept out of it.
``optimizer="adam"`` only: the lazy/hybrid Adam variants, exact-feasible
negatives and the frozen boundary correction are not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.graph import gcn_norm
from ..models.lightgcn import LightGCNParams
from ..ops.bpr import select_bpr_loss
from ..ops.sampling import check_negatives_mode, sample_negative
from ..ops.topk import DTypeLike
from ..utils.device import DeviceLike, as_dtype, resolve_device
from .train import TrainState, loss_and_grads, make_optimizer


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
    users_disjoint: bool = True
    # optional densified Â per cluster (K, n_local, n_local): turns the
    # propagation into matmuls (see densify_adjacency)
    adj: Optional[torch.Tensor] = None

    @property
    def num_clusters(self) -> int:
        return int(self.src.shape[0])

    def cluster(self, c: int) -> Tuple[torch.Tensor, ...]:
        """The 8-tuple :func:`compact_cluster_loss` takes for cluster ``c``."""
        return (self.user_ids[c], self.item_ids[c], self.src[c], self.dst[c],
                self.w[c], self.user_local[c], self.pos_local[c], self.mask[c])


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
    partitions)."""
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

    t = lambda a: torch.from_numpy(a).to(dev)
    return CompactClusters(
        user_ids=t(user_ids), item_ids=t(item_ids), src=t(src), dst=t(dst),
        w=t(w), user_local=t(user_local), pos_local=t(pos_local), mask=t(mask),
        edge_counts=t(edge_counts), user_valid=t(user_valid),
        item_valid=t(item_valid), u_pad=u_pad, i_pad=i_pad,
        user_cluster=t(user_cluster), user_slot=t(user_slot),
        users_disjoint=users_disjoint,
    )


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
        f"{what} is not ported to the PyTorch package yet (ROADMAP queue A, "
        "compact cluster trainer)")


def attach_member_table(cc: CompactClusters, train_edge_index: np.ndarray,
                        num_users: int) -> CompactClusters:
    """Exact-feasible negatives need the sorted train-pair table."""
    _not_ported("attach_member_table (negatives='feasible')")


def build_boundary_correction(params, hybrid, cc: CompactClusters, cfg: Config,
                              num_users: int, corr_dtype: str = "float32"):
    """The frozen inter-cluster correction needs the full-graph propagation."""
    _not_ported("build_boundary_correction (the frozen boundary correction)")


def _step_negatives(cfg: Config, generator: torch.Generator, batch: int,
                    num_items: int, device: torch.device) -> torch.Tensor:
    """Per-cluster negative draw: uniform (reference helpers.py:79-80)."""
    return sample_negative(generator, batch, num_items,
                           num=cfg.train.num_negatives, device=device)


class _LowPrecisionAdjMatmul(torch.autograd.Function):
    """``adj @ x`` with ``adj`` stored in a lower precision than ``x``: both
    operands in ``adj``'s dtype, f32 accumulation AND f32 output
    (``torch.matmul`` of two bf16 tensors would round its output to bf16).
    ``adj`` is a constant. Backward is the same product with ``adjᵀ`` and the
    cotangent rounded to ``adj``'s dtype. CUDA tensors take
    ``torch.mm(..., out_dtype=float32)``; CPU tensors an f32 product of the
    upcast operands (the CPU build has no mixed-output ``mm``)."""

    @staticmethod
    def _mm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = x.to(a.dtype)
        if a.device.type == "cuda":
            return torch.mm(a, x, out_dtype=torch.float32)
        return torch.mm(a.float(), x.float())

    @staticmethod
    def forward(ctx, adj, x):
        ctx.save_for_backward(adj)
        ctx.x_dtype = x.dtype
        return _LowPrecisionAdjMatmul._mm(adj, x).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (adj,) = ctx.saved_tensors
        return None, _LowPrecisionAdjMatmul._mm(adj.T, g).to(ctx.x_dtype)


def _one_hop(cur, src, dst, w, adj, n_local):
    """One propagation hop in the cluster's compact node space."""
    if adj is not None:
        if adj.dtype == cur.dtype:
            return adj @ cur
        return _LowPrecisionAdjMatmul.apply(adj, cur)
    msg = cur.index_select(0, src) * w[:, None].to(cur.dtype)
    out = torch.zeros((n_local, cur.shape[1]), dtype=cur.dtype, device=cur.device)
    return out.index_add(0, dst, msg)


def _propagate_local(emb, src, dst, w, adj, num_layers, n_local, corr=None):
    """Compact-space propagation: dense-Â matmuls when ``adj`` is present,
    gather + ``index_add`` otherwise. Returns the layer-summed accumulator.
    ``corr`` (the frozen boundary correction) must be None."""
    if corr is not None:
        _not_ported("the frozen boundary correction (corr)")
    acc = emb
    cur = emb
    for _ in range(num_layers):
        cur = _one_hop(cur, src, dst, w, adj, n_local)
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


def _triplet_loss(fu, u_rows, fi, i_rows, ni, neg, item_ids, user_local,
                  pos_local, mask, cfg: Config, i_pad: int,
                  scale: float) -> torch.Tensor:
    """Compact-space BPR dispatch: the fused kernel when
    ``cfg.train.fused_bpr``, the row-gather route otherwise.

    ``neg`` is (B,) or (B, K) for K negatives per positive; ``ni`` its
    gathered initial rows. The fused kernel is single-negative: K>1 flattens
    to B·K triplets with users/positives repeated, which is exactly
    equivalent, because both masked means in the loss decompose over the
    expansion (``ops/bpr.py::bpr_loss`` means over B·d reg entries and over B
    pairwise rows; with u/p repeated K times those equal the B·K-expanded
    means).
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
        return fused_bpr_loss(fu, u_rows, fi, i_rows, ni_x, ul_x, pl_x, loc,
                              in_cluster, m_x, scale=scale,
                              bpr_coeff=cfg.train.bpr_coeff,
                              loss=cfg.train.loss)

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


def compact_cluster_loss(
    params: LightGCNParams,
    cluster: Tuple,
    neg: torch.Tensor,
    cfg: Config,
    u_pad: int,
    i_pad: int,
    adj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference-equivalent BPR loss for one compact cluster.

    Matches ``training.train.compute_loss`` over the same cluster with global
    propagation. ``neg`` may be (B,) or (B, K): K uniform negatives per
    positive. ``cluster`` is :meth:`CompactClusters.cluster`'s 8-tuple.
    """
    (user_ids, item_ids, src, dst, w, user_local, pos_local, mask) = cluster
    n_local = u_pad + i_pad
    k1 = cfg.model.num_layers + 1
    scale = 1.0 / (k1 * k1) if cfg.model.readout == "reference" else 1.0 / k1
    cdtype = as_dtype(cfg.model.compute_dtype)

    u_rows = params.user_emb.index_select(0, user_ids)      # (Upad, d) gather
    i_rows = params.item_emb.index_select(0, item_ids)      # (Ipad, d)
    emb = torch.cat([u_rows, i_rows], dim=0).to(cdtype)
    acc = _propagate_local(emb, src, dst, w, adj, cfg.model.num_layers, n_local)
    final = acc.to(torch.float32) * scale
    fu, fi = final[:u_pad], final[u_pad:]

    ni = params.item_emb.index_select(0, neg.reshape(-1)).reshape(
        *neg.shape, params.item_emb.shape[1])
    return _triplet_loss(fu, u_rows, fi, i_rows, ni, neg, item_ids,
                         user_local, pos_local, mask, cfg, i_pad, scale)


def make_compact_epoch_fn(cfg: Config):
    """Build ``epoch_fn(state, cc, generator, perm=None, neg=None) ->
    (state, mean_loss)``: one shuffled pass over all compact clusters, one
    clip + Adam step per cluster, the mean loss weighted by the clusters' true
    edge counts.

    ``perm`` (K,) injects the cluster order and ``neg`` (K, B) or (K, B, Kneg)
    the negatives of each STEP (``neg[j]`` belongs to step j, which trains
    cluster ``perm[j]``), so a test can replay what another run drew; left
    None they come from ``generator``. ``num_negatives > 1``, ``fused_bpr``
    and any ``loss``/``readout`` combination are supported;
    ``optimizer="adam"`` only.
    """
    if cfg.train.optimizer in ("lazy_adam", "hybrid_adam", "lazy_item_adam"):
        _not_ported(f"optimizer={cfg.train.optimizer!r}")
    if cfg.train.optimizer != "adam":
        raise ValueError(f"unknown optimizer {cfg.train.optimizer!r}")
    check_negatives_mode(cfg.train.negatives)
    opt = make_optimizer(cfg)

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
        b = cc.user_local.shape[1]
        wloss = torch.zeros((), dtype=torch.float32, device=device)
        for j, c in enumerate(order):
            neg_j = (neg[j] if neg is not None else
                     _step_negatives(cfg, generator, b, num_items, device))
            loss, grads = loss_and_grads(
                compact_cluster_loss, state.params, cc.cluster(c), neg_j, cfg,
                cc.u_pad, cc.i_pad, None if cc.adj is None else cc.adj[c])
            params, opt_state = opt.update(state.params, grads, state.opt_state)
            state = TrainState(params, opt_state, state.step + 1)
            wloss = wloss + loss * cc.edge_counts[c]
        # the epoch's one host sync
        mean_loss = float(wloss / cc.edge_counts.sum().clamp_min(1.0))
        return state, mean_loss

    return epoch_fn
