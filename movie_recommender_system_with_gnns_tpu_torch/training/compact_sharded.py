"""Data-parallel compact-cluster training over a mesh of ranks (JAX package
``training/compact_sharded.py``).

Scales the compact-cluster trainer (``training/compact.py``) across cards:
each rank of the ``data`` axis trains a DIFFERENT cluster of one shared
permutation per superstep; the gradients, weighted by the clusters' edge
counts, are summed over ``data`` and one optimizer update follows. This is
Cluster-GCN with a cluster batch of ``dp`` clusters (PyG ``ClusterLoader``'s
``batch_size``; the reference pins it to 1, dataset_handler.py:285). Tables
are replicated on every rank. With ``fused_bpr`` each rank's triplet loss is
the fused BPR kernel (``ops/cuda_bpr.py``) through the same route the
single-device compact step takes.

One superstep equals a single update with the edge-count-weighted MEAN of
the per-cluster gradients; at ``dp = 1`` the weight is exactly 1, so a
superstep is bit-equal to the single-device compact step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import Config
from ..parallel.mesh import Mesh, all_reduce_
from .compact import CompactClusters, _step_negatives, compact_cluster_loss
from .train import TrainState, loss_and_grads, make_optimizer


def make_compact_sharded_epoch_fn(cfg: Config, mesh: Mesh):
    """``build(cc) -> epoch_fn(state, cc, generator, perm=None, neg=None) ->
    (state, mean_loss)``, one update per ``dp`` clusters.

    Every rank holds the whole state and ``cc``, and draws the epoch's
    permutation and every step's negatives in the single-device epoch's
    order (``compact._epoch_fn``: ``neg[j]`` belongs to the cluster trained
    j-th, ``perm[j]``), from a generator seeded alike on all ranks; ``perm``
    and ``neg`` inject them. Superstep ``s`` gives data rank ``d`` the
    cluster ``perm[s·dp + d]``. ``build`` raises when ``num_clusters % dp
    != 0`` (build the partitioner with a multiple). The optimizer is
    ``adam`` (clip + Adam, ``train.make_optimizer``); ``mean_loss`` is the
    edge-weighted mean over the epoch's clusters."""
    if cfg.train.optimizer != "adam":
        raise ValueError(f"the data-parallel compact trainer runs optimizer='adam', "
                         f"not {cfg.train.optimizer!r}")
    pd, d_rank = mesh.dp, mesh.coords[0]
    opt = make_optimizer(cfg)

    def build(cc: CompactClusters):
        if cc.num_clusters % pd != 0:
            raise ValueError(
                f"num_clusters={cc.num_clusters} must divide by data axis {pd}")

        def superstep(state: TrainState, cc: CompactClusters, sel, neg_c: torch.Tensor
                      ) -> Tuple[TrainState, torch.Tensor]:
            """One update from the clusters ``sel`` (one per data rank)."""
            c = sel[d_rank]
            loss, grads = loss_and_grads(
                compact_cluster_loss, state.params, cc.cluster(c), neg_c, cfg,
                cc.u_pad, cc.i_pad, None if cc.adj is None else cc.adj[c], cc.lists(c))
            # the edge-count-weighted mean over the superstep's clusters
            ecount = cc.edge_counts[c]
            weight = ecount / cc.edge_counts[list(sel)].sum()
            with torch.no_grad():
                flat = torch.cat([g.reshape(-1) for g in grads]) * weight
                all_reduce_(flat, mesh.data_group)
                gu, gi = flat.split([grads[0].numel(), grads[1].numel()])
                grads = (gu.view_as(grads[0]), gi.view_as(grads[1]))
                wloss = all_reduce_(loss * ecount, mesh.data_group)
            params, opt_state = opt.update(state.params, grads, state.opt_state)
            return TrainState(params, opt_state, state.step + 1), wloss

        def epoch_fn(state: TrainState, cc: CompactClusters,
                     generator: Optional[torch.Generator], perm=None,
                     neg: Optional[torch.Tensor] = None) -> Tuple[TrainState, float]:
            num_items = state.params.item_emb.shape[0]
            k = cc.num_clusters
            if perm is None:
                perm = torch.randperm(k, generator=generator, device=generator.device)
            order = [int(c) for c in (perm.tolist() if isinstance(perm, torch.Tensor)
                                      else perm)]
            wloss = torch.zeros((), dtype=torch.float32, device=cc.src.device)
            for s in range(k // pd):
                sel = order[s * pd:(s + 1) * pd]
                # every rank draws every cluster's negatives, in epoch order,
                # so the generators stay alike; it keeps its own cluster's
                negs = [neg[s * pd + j] if neg is not None else
                        _step_negatives(cfg, generator, cc, c, num_items)
                        for j, c in enumerate(sel)]
                state, wl = superstep(state, cc, sel, negs[d_rank])
                wloss = wloss + wl
            mean_loss = float(wloss / cc.edge_counts.sum().clamp_min(1.0))
            return state, mean_loss

        return epoch_fn

    return build
