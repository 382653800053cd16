"""Full-graph trainer: every step propagates over ALL train edges (JAX package
``training/fullgraph.py``).

The reference's Cluster-GCN regime (data/dataset_handler.py:256-288) keeps
only the edges inside clusters (about 40 % of ML-25M's at 100 parts). This
trainer keeps them all:

  * propagation runs on the whole train adjacency through the hybrid
    block-diagonal split (``ops/spmm.py::spmm_hybrid``): the intra-part edges
    as dense (K, P, P) blocks, the remainder on the ELL SpMM kernel;
  * the backward reuses the same propagation through the symmetric-Â VJP
    (``ops/spmm.py::spmm_symmetric``) when the train graph is symmetric (the
    interaction-level split); an asymmetric one (the edge-level split) is
    differentiated by autograd, the kernel's backward running over the
    remainder's transpose;
  * the BPR triplets are minibatched: each epoch shuffles all train positives
    and takes ``num_steps`` fixed-size batches, one optimizer step each
    (``TrainConfig.fullgraph_steps``), with the same ``compute_loss``, clip
    at 1.0 and Adam as the other trainers;
  * with ``model="xsimgcl"`` (``models/xsimgcl.py``) a step propagates
    with each hop's noise and adds the in-batch InfoNCE of the readout
    against the contrastive view (``train.compute_loss_xsimgcl``); the noise
    is drawn from the epoch's generator, or injected (``noise=``);
  * with ``loss_microbatches > 1`` a step propagates once and evaluates the
    triplet loss in that many chunks of its batch
    (``train.compute_loss_grads_microbatched``): the same loss and gradients
    up to float reassociation, with one chunk's (B/chunks, K, d) triplet
    temps alive at a time instead of the whole batch's.

The epoch is a Python loop of steps drawing the permutation and each step's
negatives (uniform, popularity^power, or exact-feasible against the train
pairs) from the epoch's generator. The triplet loss is
``ops/bpr.py::triplet_loss_of``'s: on the card the ``standard`` loss runs
its fused kernels (``ops/cuda_triplet.py``), whose row gradients
``ops/cuda_scatter.py::sorted_index_add`` sums in an order fixed by the
data, as the gather route's; so a step is bit-reproducible on the card.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config, check_model
from ..data.graph import adjacency_is_symmetric
from ..data.partition import forward_half, partition_assignments
from ..ops.sampling import (TripletBatch, build_alias_table, build_member_table,
                            check_negatives_mode, item_popularity, member_keys,
                            sample_negative, sample_negative_alias,
                            sample_negative_feasible)
from ..ops.spmm import (HybridGraph, build_hybrid_graph, spmm_hybrid, spmm_hybrid_sym,
                        spmm_symmetric)
from ..utils.device import DeviceLike, as_dtype, resolve_device
from ..utils.observability import count, trace_span
from .train import (TrainState, compute_loss, compute_loss_grads_microbatched,
                    compute_loss_xsimgcl, loss_and_grads, make_optimizer)


class FullGraphTrainData:
    """The full-graph training set on a device: the hybrid adjacency and all
    train positives.

    ``user``/``pos_item`` (int32) are the user→item half of the train edges,
    padded to ``num_steps * batch`` (the padding is masked out of the loss).
    ``symmetric_ok`` is False when the train adjacency failed the symmetry
    check (edge-level split): the epoch then differentiates the propagation
    by autograd. ``alias_table`` is ``(prob, alias)`` when
    ``negatives="popularity"``; ``member_table`` the train pairs' int64
    search keys (``ops/sampling.py::member_keys``) when
    ``negatives="feasible"``."""

    def __init__(self, hybrid: HybridGraph, user: torch.Tensor, pos_item: torch.Tensor,
                 e_real: int, num_steps: int, batch: int, symmetric_ok: bool = True,
                 member_table=None, alias_table=None):
        self.hybrid = hybrid
        self.user = user
        self.pos_item = pos_item
        self.e_real = e_real
        self.num_steps = num_steps
        self.batch = batch
        self.symmetric_ok = symmetric_ok
        self.member_table = member_table
        self.alias_table = alias_table


def build_fullgraph_data(cfg: Config, train_edge_index: np.ndarray, num_users: int,
                         num_nodes: int, device: DeviceLike = None) -> FullGraphTrainData:
    """Host-side build: node partition → hybrid adjacency → padded positives,
    then uploaded to ``device``. The batch is ``ceil(E / fullgraph_steps)``
    (or ``batch_size``) rounded up to a multiple of 1,024, and the step count
    is derived again from it, so no step is all padding."""
    check_negatives_mode(cfg.train.negatives)
    dev = resolve_device(device)
    tc = cfg.train
    if tc.partitioner != "greedy":
        warnings.warn(
            f"fullgraph trainer ignores partitioner={tc.partitioner!r}: "
            "hybrid block-diagonal propagation always uses the greedy NODE "
            "partition (every edge is retained regardless)", stacklevel=2)
    num_parts = tc.hybrid_parts or tc.num_clusters
    uv = forward_half(train_edge_index, num_users)
    part_of_user, part_of_item = partition_assignments(
        train_edge_index, num_users, num_nodes, num_parts, seed=cfg.data.split_seed,
        balance_tol=tc.partition_balance_tol, uv=uv)
    node_part = np.concatenate([part_of_user, part_of_item])

    # the symmetric-Â VJP assumes Â = Âᵀ; the edge-level split keeps single
    # directions of ~2·p·(1−p) of the pairs, so check and fall back to autodiff
    symmetric_ok = True
    if tc.symmetric_vjp:
        symmetric_ok = adjacency_is_symmetric(train_edge_index, num_nodes)
        if not symmetric_ok:
            warnings.warn(
                "fullgraph trainer: train adjacency is asymmetric (edge-level "
                "split keeps single directions — config.py split_level docs); "
                "symmetric_vjp is DISABLED for this run, backward uses the "
                "autodiff hybrid kernel (exact, ~2x backward propagation "
                "cost). Use split_level='interaction' for a symmetric train "
                "graph.", stacklevel=2)
    hybrid = build_hybrid_graph(
        train_edge_index, num_nodes, node_part, num_parts,
        block_dtype=tc.hybrid_block_dtype, max_block_nodes=tc.dense_adjacency_max_nodes,
        off_format=tc.hybrid_off_format,
        transpose=not (tc.symmetric_vjp and symmetric_ok), device=dev)

    users = uv[0].astype(np.int32)
    pos = uv[1].astype(np.int32)
    e_real = int(users.shape[0])
    batch = int(tc.batch_size) if tc.batch_size else -(-e_real // max(1, tc.fullgraph_steps))
    batch_aligned = ((batch + 1023) // 1024) * 1024
    if tc.batch_size and batch_aligned != batch:
        warnings.warn(
            f"fullgraph trainer: batch_size={batch} lane-aligned up to "
            f"{batch_aligned} (the static scan width must be a multiple of "
            "1024; batch_size overrides fullgraph_steps)", stacklevel=2)
    batch = batch_aligned
    num_steps = max(1, -(-e_real // batch))
    e_pad = num_steps * batch
    alias_table = member_table = None
    if tc.negatives == "popularity":
        counts = item_popularity(train_edge_index, num_users, num_nodes - num_users)
        prob, alias = build_alias_table(counts, power=tc.negatives_power)
        alias_table = (torch.from_numpy(prob).to(dev), torch.from_numpy(alias).to(dev))
    elif tc.negatives == "feasible":
        member_table = member_keys(build_member_table(users, pos), dev)
    users = np.concatenate([users, np.zeros(e_pad - e_real, np.int32)])
    pos = np.concatenate([pos, np.zeros(e_pad - e_real, np.int32)])
    return FullGraphTrainData(
        hybrid=hybrid, user=torch.from_numpy(users).to(dev),
        pos_item=torch.from_numpy(pos).to(dev), e_real=e_real, num_steps=num_steps,
        batch=batch, symmetric_ok=symmetric_ok, member_table=member_table,
        alias_table=alias_table)


def fullgraph_spmm(cfg: Config, fg: FullGraphTrainData):
    """The epoch's propagation: ``spmm_hybrid`` (its table rounded to
    ``compute_dtype`` per hop when that is bfloat16, the products and sums
    staying f32), wrapped in the symmetric VJP when the config asks for it
    and the graph passed the symmetry check."""
    cdtype = as_dtype(cfg.model.compute_dtype)
    if cdtype == torch.float32:
        base = spmm_hybrid
    else:
        def base(g, e):
            return spmm_hybrid(g, e.to(cdtype))
    if cfg.train.symmetric_vjp and fg.symmetric_ok:
        return spmm_hybrid_sym if cdtype == torch.float32 else spmm_symmetric(base)
    return base


def make_fullgraph_epoch_fn(cfg: Config, fg: FullGraphTrainData):
    """``epoch_fn(state, fg, generator, perm=None, neg=None, noise=None) ->
    (state, mean_loss)``: shuffle the real positives (the padding stays masked at the
    tail), then ``fg.num_steps`` steps of ``compute_loss`` on the hybrid
    graph (in ``cfg.train.loss_microbatches`` chunks of the batch when that
    is above 1), clip and Adam. The mean loss is weighted by each step's
    real triplets.

    ``perm`` (e_real,) injects the shuffle and ``neg`` (num_steps, batch) or
    (num_steps, batch, K) each step's negatives, so a test can replay what
    another run drew; left None they come from ``generator``. XSimGCL's
    step draws its hops' noise after its negatives, or takes ``noise[s]``
    of ``noise`` (num_steps, L, n, d) raw U(0,1); a LightGCN epoch ignores
    it."""
    check_negatives_mode(cfg.train.negatives)
    xsim = check_model(cfg, "fullgraph") == "xsimgcl"
    micro = cfg.train.loss_microbatches
    if xsim and micro > 1:
        raise ValueError("XSimGCL's loss is not microbatched: set loss_microbatches to 0 or 1")
    opt = make_optimizer(cfg)
    spmm = fullgraph_spmm(cfg, fg)
    k = cfg.train.num_negatives
    hops = cfg.model.num_layers

    def epoch_fn(state: TrainState, fg_: FullGraphTrainData,
                 generator: Optional[torch.Generator], perm=None,
                 neg: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple[TrainState, float]:
        with trace_span("fullgraph.epoch"):
            dev = fg_.user.device
            steps, b = fg_.num_steps, fg_.batch
            num_items = state.params.item_emb.shape[0]
            if perm is None:
                perm = torch.randperm(fg_.e_real, generator=generator, device=generator.device)
            idx = torch.cat([torch.as_tensor(perm).to(dev, torch.int64),
                             torch.arange(fg_.e_real, steps * b, device=dev)])
            u = fg_.user[idx].view(steps, b)
            p = fg_.pos_item[idx].view(steps, b)
            m = (idx < fg_.e_real).view(steps, b)
            wloss = torch.zeros((), dtype=torch.float32, device=dev)
            for s in range(steps):
                with trace_span("fullgraph.step"):
                    if neg is not None:
                        neg_s = torch.as_tensor(neg[s]).to(dev)
                    elif fg_.member_table is not None:
                        neg_s = sample_negative_feasible(generator, u[s], num_items,
                                                         fg_.member_table, num=k)
                    elif fg_.alias_table is not None:
                        neg_s = sample_negative_alias(generator, b, num_items, *fg_.alias_table,
                                                      num=k)
                    else:
                        neg_s = sample_negative(generator, b, num_items, k, device=dev)
                    tb = TripletBatch(user=u[s], pos_item=p[s], mask=m[s])
                    if xsim:
                        if noise is not None:
                            noise_s = torch.as_tensor(noise[s]).to(dev)
                        else:
                            n_rows = fg_.hybrid.num_nodes
                            noise_s = torch.rand((hops, n_rows, state.params.user_emb.shape[1]),
                                                 generator=generator,
                                                 device=generator.device).to(dev)
                        loss, grads = loss_and_grads(compute_loss_xsimgcl, state.params,
                                                     fg_.hybrid, tb, neg_s, cfg, spmm, noise_s)
                    elif micro > 1:
                        loss, grads = compute_loss_grads_microbatched(
                            state.params, fg_.hybrid, tb, neg_s, cfg, spmm, micro)
                    else:
                        loss, grads = loss_and_grads(compute_loss, state.params, fg_.hybrid, tb,
                                                     neg_s, cfg, spmm)
                    with trace_span("fullgraph.optimizer"):
                        params, opt_state = opt.update(state.params, grads, state.opt_state)
                    state = TrainState(params, opt_state, state.step + 1)
                    wloss = wloss + loss * m[s].sum()
            # the epoch's one host sync
            with trace_span("fullgraph.wait", wait=True):
                mean = float(wloss / fg_.e_real)
                if dev.type == "cuda":
                    count("host_sync")
        return state, mean

    return epoch_fn
