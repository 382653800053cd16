"""Sharded training and retrieval: embedding tables row-sharded over the
``model`` axis of a (data, model) mesh of ``torch.distributed`` ranks (JAX
package ``parallel/sharding.py``, its segment path).

  * Host layout, arrays equal to the JAX package's: :class:`ShardPlan` pads
    each table to a multiple of ``pm`` rows; :func:`shard_graph` remaps node
    ids into the padded space and splits the edges by the rank that owns
    their destination row, dst-sorted, padded to one length with zero-weight
    edges into the last local row (GCN weights from the true graph, before
    padding); :func:`pad_params` / :func:`unpad_params`; :func:`pad_batch`.
  * Propagation, per layer: :func:`~.mesh.all_gather_rows` of the user and
    item shards over ``model``, then the shard's dst-sorted segment sum
    through ``ops/spmm.py::spmm_rows`` over a rectangular ``DeviceCOO``
    (``l_rows`` outputs from ``n_pad`` sources, both kinds of row run built
    once per shard, :func:`shard_coos`), so a step is bit-reproducible on
    the card; ``spmm_chunks > 1`` sums the edges chunk by chunk as JAX does.
  * :func:`make_sharded_train_step`: BPR data-parallel over ``data``, table
    gradients back through the all-gathers' reduce-scatters, one all-reduce
    of them over ``data``, the global-norm clip over all shards, Adam on the
    local shards.
  * :func:`make_sharded_propagate` (eval and serving tables) and
    :func:`make_sharded_mips` (top-k over catalog shards, candidates merged).

The hybrid path (``ShardedHybrid``, ``shard_hybrid_graph``,
``make_sharded_epoch_fn``) is not ported (ROADMAP A7b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.graph import gcn_norm
from ..models.lightgcn import LightGCNParams
from ..ops.bpr import select_bpr_loss
from ..ops.cuda_scatter import gather_rows, sort_rows
from ..ops.sampling import TripletBatch
from ..ops.spmm import DeviceCOO, spmm_rows
from ..ops.topk import merge_topk, mips_topk
from ..utils.device import DeviceLike, as_dtype
from .mesh import Mesh, all_gather_rows, all_reduce_, gather_rows_of

A7B = ("the sharded hybrid propagation (ShardedHybrid, shard_hybrid_graph, "
       "make_sharded_epoch_fn) is not ported to the PyTorch package (ROADMAP A7b)")


class ShardedGraph(NamedTuple):
    """Edge shards stacked over the model axis (leading dim = Pm), host
    arrays. ``src`` holds GLOBAL padded node ids; ``dst_local`` indices into
    each shard's local rows (users then items)."""

    src: np.ndarray        # (Pm, E_shard) int32, global padded node id
    dst_local: np.ndarray  # (Pm, E_shard) int32, sorted per shard
    w: np.ndarray          # (Pm, E_shard) float32


@dataclass(frozen=True)
class ShardPlan:
    """Static layout of the padded, sharded problem."""

    num_users: int      # true
    num_items: int      # true
    pm: int             # model-parallel degree
    u_pad: int          # padded user rows (divisible by pm)
    i_pad: int          # padded item rows (divisible by pm)

    @property
    def u_loc(self) -> int:
        return self.u_pad // self.pm

    @property
    def i_loc(self) -> int:
        return self.i_pad // self.pm

    @property
    def n_pad(self) -> int:
        return self.u_pad + self.i_pad

    @staticmethod
    def create(num_users: int, num_items: int, pm: int) -> "ShardPlan":
        rnd = lambda x: ((x + pm - 1) // pm) * pm
        return ShardPlan(num_users, num_items, pm, rnd(num_users), rnd(num_items))


def pad_params(params: LightGCNParams, plan: ShardPlan) -> LightGCNParams:
    """Zero-pad table rows so each divides evenly over the model axis."""
    pad = lambda t, rows: torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[0]))
    return LightGCNParams(pad(params.user_emb, plan.u_pad), pad(params.item_emb, plan.i_pad))


def unpad_params(params: LightGCNParams, plan: ShardPlan) -> LightGCNParams:
    return LightGCNParams(params.user_emb[: plan.num_users],
                          params.item_emb[: plan.num_items])


def shard_params(params: LightGCNParams, plan: ShardPlan, m: int) -> LightGCNParams:
    """Model rank ``m``'s rows of PADDED tables, as contiguous copies."""
    return LightGCNParams(
        params.user_emb[m * plan.u_loc:(m + 1) * plan.u_loc].contiguous(),
        params.item_emb[m * plan.i_loc:(m + 1) * plan.i_loc].contiguous())


def gather_params(local: LightGCNParams, mesh: Mesh) -> LightGCNParams:
    """The PADDED tables from every model rank's shard (all-gather over
    ``model``)."""
    return LightGCNParams(gather_rows_of(local.user_emb, mesh.model_group),
                          gather_rows_of(local.item_emb, mesh.model_group))


def _to_padded_ids(nodes: np.ndarray, plan: ShardPlan) -> np.ndarray:
    """True node-id space → padded space (items shift up to ``u_pad``)."""
    shift = plan.u_pad - plan.num_users
    return np.where(nodes >= plan.num_users, nodes + shift, nodes)


def _owner_and_local(nodes: np.ndarray, plan: ShardPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Padded-space node id → (owner device, local row index users‖items)."""
    is_item = nodes >= plan.u_pad
    u_owner = nodes // plan.u_loc
    u_local = nodes % plan.u_loc
    it = nodes - plan.u_pad
    i_owner = it // plan.i_loc
    i_local = plan.u_loc + it % plan.i_loc
    return (
        np.where(is_item, i_owner, u_owner),
        np.where(is_item, i_local, u_local),
    )


def _shard_coo_by_dst(src_p: np.ndarray, dst_p: np.ndarray, w: np.ndarray,
                      plan: ShardPlan) -> ShardedGraph:
    """Partition padded-space COO edges by destination owner; equal-length,
    dst-sorted padded shards (pads point at the last local row with w=0)."""
    own, loc = _owner_and_local(dst_p, plan)
    counts = np.bincount(own, minlength=plan.pm)
    e_shard = int(counts.max(initial=1))
    e_shard = ((e_shard + 127) // 128) * 128
    l_rows = plan.u_loc + plan.i_loc
    src_s = np.zeros((plan.pm, e_shard), np.int32)
    dst_s = np.full((plan.pm, e_shard), l_rows - 1, np.int32)
    w_s = np.zeros((plan.pm, e_shard), np.float32)
    # one global (owner, local-dst) sort, then contiguous slices per shard;
    # padding tails stay dst-sorted for free (real dst <= l_rows-1 = pad dst)
    order = np.lexsort((loc, own))
    src_o, loc_o, w_o = src_p[order], loc[order], w[order]
    ofs = np.concatenate([[0], np.cumsum(counts)])
    for p in range(plan.pm):
        k = int(counts[p])
        src_s[p, :k] = src_o[ofs[p]:ofs[p + 1]]
        dst_s[p, :k] = loc_o[ofs[p]:ofs[p + 1]]
        w_s[p, :k] = w_o[ofs[p]:ofs[p + 1]]
    return ShardedGraph(src_s, dst_s, w_s)


def shard_graph(edge_index: np.ndarray, plan: ShardPlan) -> ShardedGraph:
    """Partition edges by destination owner; emit equal-length padded shards.

    Node ids are remapped into the padded space: users keep their id, items
    shift from ``num_users`` up to ``u_pad``. GCN weights are computed BEFORE
    padding/sharding on the true graph, so sharded propagation sums the same
    terms as the single-device path.
    """
    w = gcn_norm(edge_index, plan.num_users + plan.num_items)
    src_p = _to_padded_ids(edge_index[0].astype(np.int64), plan)
    dst_p = _to_padded_ids(edge_index[1].astype(np.int64), plan)
    return _shard_coo_by_dst(src_p, dst_p, w, plan)


def shard_coos(graph: ShardedGraph, plan: ShardPlan, m: int, device: DeviceLike = None,
               spmm_chunks: int = 1) -> List[DeviceCOO]:
    """Model rank ``m``'s edge shard on ``device``: rectangular
    ``DeviceCOO``s (``l_rows`` outputs from the ``n_pad``-row all-gathered
    table) with both kinds of row run, one per edge chunk. ``spmm_chunks``
    splits the shard into that many equal chunks when it divides the shard's
    length (JAX's condition), else the shard stays whole."""
    l_rows = plan.u_loc + plan.i_loc
    src, dst, w = graph.src[m], graph.dst_local[m], graph.w[m]
    chunks = max(int(spmm_chunks), 1)
    if src.shape[0] % chunks:
        chunks = 1
    c = src.shape[0] // chunks
    return [DeviceCOO.from_arrays(src[lo:lo + c], dst[lo:lo + c], w[lo:lo + c], l_rows,
                                  device, row_runs=True, num_src=plan.n_pad)
            for lo in range(0, src.shape[0], c)]


def pad_batch(batch: TripletBatch, pd: int) -> TripletBatch:
    """Pad the triplet batch so it divides evenly over the data axis."""
    b = batch.user.shape[0]
    pad = (-b) % pd
    if pad == 0:
        return batch
    z = lambda a: torch.cat([a, a.new_zeros((pad,))])
    return TripletBatch(z(batch.user), z(batch.pos_item), z(batch.mask))


def _local_propagate(cfg: Config, plan: ShardPlan, mesh: Mesh, u_shard: torch.Tensor,
                     i_shard: torch.Tensor, coos: List[DeviceCOO]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K layers of (all-gather over ``model`` → the shard's segment sum);
    returns this rank's FINAL rows, users and items (JAX
    ``local_propagate``)."""
    cdtype = as_dtype(cfg.model.compute_dtype)
    u_cur, i_cur = u_shard, i_shard
    acc_u, acc_i = u_shard, i_shard
    for _ in range(cfg.model.num_layers):
        full = torch.cat([all_gather_rows(u_cur, mesh.model_group),
                          all_gather_rows(i_cur, mesh.model_group)]).to(cdtype)
        out = spmm_rows(coos[0], full)
        for coo in coos[1:]:
            out = out + spmm_rows(coo, full)
        u_cur, i_cur = out[:plan.u_loc], out[plan.u_loc:]
        acc_u = acc_u + u_cur
        acc_i = acc_i + i_cur
    k1 = cfg.model.num_layers + 1
    scale = 1.0 / (k1 * k1) if cfg.model.readout == "reference" else 1.0 / k1
    return acc_u * scale, acc_i * scale


def make_sharded_propagate(cfg: Config, mesh: Mesh, plan: ShardPlan):
    """``fn(local_params, coos) -> LightGCNParams``: this rank's FINAL
    propagated rows (padded, row-sharded over ``model``) from its table
    shards (:func:`shard_params`) and edge shard (:func:`shard_coos`), for
    eval and serving tables (the hybrid form is A7b)."""
    @torch.no_grad()
    def fn(local: LightGCNParams, coos: List[DeviceCOO]) -> LightGCNParams:
        return LightGCNParams(*_local_propagate(cfg, plan, mesh, local.user_emb,
                                                local.item_emb, coos))

    return fn


def _local_loss(cfg: Config, plan: ShardPlan, mesh: Mesh, params: LightGCNParams,
                coos: List[DeviceCOO], batch: TripletBatch, neg: torch.Tensor) -> torch.Tensor:
    """This data shard's part of the step's loss: the single-device BPR loss
    (``ops/bpr.py``, masked means over the shard's triplets) times the
    shard's share of the valid triplets, ``local count / psum(count,
    data)``. So each part is the shard's masked SUMS over the GLOBAL count,
    as JAX's ``local_loss`` computes them before its ``psum`` over ``data``,
    and the parts of all data ranks add up to the whole batch's loss. At
    ``dp = 1`` the share is exactly 1: the part is the full-node step's
    loss, bit for bit."""
    fu_loc, fi_loc = _local_propagate(cfg, plan, mesh, params.user_emb,
                                      params.item_emb, coos)
    # full final and initial tables for the triplet gathers
    mg = mesh.model_group
    fu, fi = all_gather_rows(fu_loc, mg), all_gather_rows(fi_loc, mg)
    u0, i0 = all_gather_rows(params.user_emb, mg), all_gather_rows(params.item_emb, mg)
    # the gathers' gradients sum in an order fixed by the data (gather_rows),
    # as train.compute_embeddings gathers
    items = torch.cat([batch.pos_item.reshape(-1), neg.reshape(-1)])
    u_lists, i_lists = sort_rows(batch.user, plan.u_pad), sort_rows(items, plan.i_pad)
    uf, ui = (gather_rows(t, batch.user, *u_lists) for t in (fu, u0))
    itf, ite = (gather_rows(t, items, *i_lists) for t in (fi, i0))
    b, d = batch.user.shape[0], params.user_emb.shape[1]
    neg_shape = tuple(neg.shape) + (d,)
    loss = select_bpr_loss(cfg.train.loss)(
        uf, ui, itf[:b], ite[:b], itf[b:].view(neg_shape), ite[b:].view(neg_shape),
        cfg.train.bpr_coeff, mask=batch.mask)
    local = batch.mask.to(torch.float32).sum()
    return loss * (local / all_reduce_(local.clone(), mesh.data_group).clamp_min(1.0))


def make_sharded_train_step(cfg: Config, mesh: Mesh, plan: ShardPlan, opt,
                            hybrid: bool = False):
    """``step(state, coos, batch, neg) -> (state, loss)``.

    ``state`` is a NamedTuple with ``params`` (this rank's shards of the
    PADDED tables, :func:`shard_params`), ``opt_state`` and ``step``, such as
    ``training/train.py::TrainState``; ``coos`` its edge shard
    (:func:`shard_coos`); ``batch`` and ``neg`` the WHOLE step's triplets
    (size a multiple of ``dp``, :func:`pad_batch`) and negatives, the same on
    every rank: each rank takes its data shard. ``loss`` is the whole
    batch's. ``opt.update(params, grads, opt_state) -> (params, opt_state)``
    is the update applied to the clipped gradients, in place (the trainer
    passes ``training/train.py::make_adam`` at the constant ``cfg.train.lr``,
    as JAX's ``optax.adam``).

    The gradient's bookkeeping (JAX ``:713-737``): every model rank of a
    data row computes the same loss part, so the all-gathers' backward sums
    ``pm`` equal cotangents into each shard, divided out here; each data
    rank's part covers its own triplets, so the table gradients are summed
    over ``data`` once; the clip's norm sums the squares over ``model``,
    whose shards are disjoint. The padded rows' gradients are zero, so they
    stay zero. ``hybrid=True`` is not ported (A7b).
    """
    if hybrid:
        raise NotImplementedError(A7B)
    pm = plan.pm
    dp = mesh.dp
    d_rank = mesh.coords[0]
    max_norm = cfg.train.grad_clip_norm

    def step(state, coos: List[DeviceCOO], batch: TripletBatch, neg: torch.Tensor):
        b = batch.user.shape[0]
        if b % dp:
            raise ValueError(f"batch of {b} does not split over the data axis {dp}: "
                             "pad it with pad_batch")
        lo, hi = d_rank * (b // dp), (d_rank + 1) * (b // dp)
        local = TripletBatch(batch.user[lo:hi], batch.pos_item[lo:hi], batch.mask[lo:hi])
        leaves = LightGCNParams(*(t.detach().requires_grad_(True) for t in state.params))
        with torch.enable_grad():
            part = _local_loss(cfg, plan, mesh, leaves, coos, local, neg[lo:hi])
            grads = torch.autograd.grad(part, leaves)
        with torch.no_grad():
            flat = torch.cat([g.reshape(-1) for g in grads]) / pm
            all_reduce_(flat, mesh.data_group)
            gu, gi = flat.split([grads[0].numel(), grads[1].numel()])
            grads = (gu.view_as(grads[0]), gi.view_as(grads[1]))
            gsq = all_reduce_(flat.square().sum(), mesh.model_group)
            scale = (max_norm / gsq.sqrt().clamp_min(1e-6)).clamp_max(1.0)
            params, opt_state = opt.update(state.params, [g * scale for g in grads],
                                           state.opt_state)
            loss = all_reduce_(part.detach().clone(), mesh.data_group)
        return state._replace(params=params, opt_state=opt_state,
                              step=state.step + 1), loss

    return step


def make_sharded_mips(mesh: Mesh, k: int = 10, block: int = 8192):
    """``fn(query, catalog) -> (scores, indices)``: the catalog's rows split
    over ``model`` (its row count a multiple of ``mp``), each rank's top-k
    over its rows (``ops/topk.py::mips_topk``) with global indices, the
    ``(Q, k)`` candidates all-gathered over ``model`` and merged by
    ``merge_topk`` (ties to the lowest index). Queries and catalog are the
    same on every rank."""
    mp, m = mesh.mp, mesh.coords[1]

    @torch.no_grad()
    def fn(query: torch.Tensor, catalog: torch.Tensor):
        rows = catalog.shape[0] // mp
        if rows * mp != catalog.shape[0]:
            raise ValueError(f"catalog of {catalog.shape[0]} rows does not split over "
                             f"the model axis {mp}")
        s, i = mips_topk(query, catalog[m * rows:(m + 1) * rows], k=k,
                         block=min(block, max(rows, 128)))
        i = i + m * rows                                   # globalize
        all_s = gather_rows_of(s.float().contiguous(), mesh.model_group)
        all_i = gather_rows_of(i.contiguous(), mesh.model_group)
        q = query.shape[0]
        return merge_topk(all_s.view(mp, q, k), all_i.view(mp, q, k), k)

    return fn
