"""Distributed training driver: the multi-epoch loop over the mesh-sharded
trainer (JAX package ``training/distributed.py``).

Glues ``parallel/sharding.py``'s step into the contract of
``training.train.train_model`` (histories, best-val checkpoint callback, val
eval each epoch, a final test eval), so one moves from one card to several
by setting the mesh. Every epoch is full-graph steps over row-sharded tables
with fresh negatives: one step over all train positives, or
``len(positives) // batch_size`` steps over uniform samples of them.

Every rank draws the WHOLE step's batch indices and negatives from a
generator seeded as ``train.epoch_generator`` seeds it and then takes its
data shard, so a run does not depend on the mesh's shape beyond the order of
float sums. Only rank 0 saves the checkpoint, writes the metrics rows and
prints.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, check_model
from ..models.lightgcn import LightGCNParams, init_params
from ..ops.sampling import TripletBatch, sample_negative, triplets_from_edges
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.sharding import (ShardPlan, gather_params, make_sharded_train_step,
                                 pad_batch, pad_params, shard_coos, shard_graph,
                                 shard_params, unpad_params)
from .train import TrainState, epoch_generator, make_adam, make_eval_step


def train_model_sharded(
    cfg: Config,
    num_users: int,
    num_items: int,
    train_edges: np.ndarray,
    val: Tuple,
    test: Tuple,
    mesh: Optional[Mesh] = None,
    save_checkpoint: Optional[Callable[[LightGCNParams, float], None]] = None,
    metrics_logger=None,
    params: Optional[LightGCNParams] = None,
) -> Tuple[LightGCNParams, Dict[str, List[float]]]:
    """Multi-epoch sharded training; returns the UNPADDED tables (on every
    rank) and the histories.

    ``mesh`` defaults to ``make_mesh(cfg.mesh.data_parallel,
    cfg.mesh.model_parallel)`` on the card. ``val`` / ``test`` are
    ``train.build_eval_batch`` tuples on the mesh's device; ``params`` the
    initial tables, the same on every rank (default: drawn from
    ``cfg.train.seed`` as ``train.create_train_state`` draws them). LightGCN
    only: another model raises ``ValueError``."""
    check_model(cfg, "sharded")
    if mesh is None:
        mesh = make_mesh(cfg.mesh.data_parallel, cfg.mesh.model_parallel)
    dev, pd, pm = mesh.device, mesh.dp, mesh.mp
    plan = ShardPlan.create(num_users, num_items, pm)
    if params is None:
        params = init_params(num_users, num_items, cfg.model.dim, cfg.model.init_std,
                             generator=torch.Generator().manual_seed(cfg.train.seed),
                             device=dev)
    local = shard_params(pad_params(LightGCNParams(*(t.to(dev) for t in params)), plan),
                         plan, mesh.coords[1])
    lr = cfg.train.lr
    adam = make_adam(cfg, lr_of=lambda t: lr)      # JAX: optax.adam(cfg.train.lr)
    state = TrainState(local, adam.init(local), 0)
    step = make_sharded_train_step(cfg, mesh, plan, opt=adam)
    coos = shard_coos(shard_graph(train_edges, plan), plan, mesh.coords[1], dev,
                      cfg.train.spmm_chunks)

    all_triplets = triplets_from_edges(train_edges, num_users, device=dev)
    true_b = int(all_triplets.user.shape[0])
    bs = cfg.train.batch_size
    whole = bs is None or bs >= true_b
    if whole:
        batch = pad_batch(all_triplets, pd)
        steps_per_epoch = 1
    else:
        bs = (bs // pd) * pd or pd
        steps_per_epoch = max(1, true_b // bs)
    eval_step = make_eval_step(cfg)
    kneg = cfg.train.num_negatives

    def draw(gen: torch.Generator) -> Tuple[TripletBatch, torch.Tensor]:
        """One step's whole batch and negatives (the same on every rank)."""
        if whole:
            neg = sample_negative(gen, true_b, num_items, kneg, device=dev)
            pad = batch.user.shape[0] - true_b
            if pad:
                neg = torch.cat([neg, neg.new_zeros((pad,) + tuple(neg.shape[1:]))])
            return batch, neg
        idx = torch.randint(0, true_b, (bs,), generator=gen, device=gen.device).to(dev)
        b = TripletBatch(all_triplets.user[idx], all_triplets.pos_item[idx],
                         torch.ones(bs, dtype=torch.bool, device=dev))
        return b, sample_negative(gen, bs, num_items, kneg, device=dev)

    hist: Dict[str, List[float]] = {"train_loss": [], "val_loss": [],
                                    "val_recall": [], "epoch_time_s": []}
    best_recall = 0.0
    for epoch in range(cfg.train.epochs):
        gen = epoch_generator(cfg, epoch, dev)
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps_per_epoch):
            state, loss = step(state, coos, *draw(gen))
            losses.append(loss)
        train_loss = float(torch.stack(losses).mean())
        up = unpad_params(gather_params(state.params, mesh), plan)
        val_loss, val_recall = eval_step(up, val[0], val[1], gen)
        val_loss, val_recall = float(val_loss), float(val_recall)
        dt = time.perf_counter() - t0
        hist["train_loss"].append(train_loss)
        hist["val_loss"].append(val_loss)
        hist["val_recall"].append(val_recall)
        hist["epoch_time_s"].append(dt)
        if mesh.is_main:
            print(f"[sharded {pd}x{pm}] Epoch: {epoch:03d}, Train Loss: "
                  f"{train_loss:.4f}, Val Loss: {val_loss:.4f}, "
                  f"Recall@k: {val_recall:.6f} ({dt:.2f}s)")
            if metrics_logger is not None:
                metrics_logger.log(epoch, train_loss=train_loss, val_loss=val_loss,
                                   val_recall=val_recall, epoch_time_s=dt)
        if val_recall > best_recall:
            best_recall = val_recall
            if save_checkpoint is not None and mesh.is_main:
                save_checkpoint(up, val_recall)

    up = unpad_params(gather_params(state.params, mesh), plan)
    test_loss, test_recall = eval_step(up, test[0], test[1],
                                       epoch_generator(cfg, cfg.train.epochs, dev))
    if mesh.is_main:
        print(f"[sharded] Test Loss: {float(test_loss):.4f}, "
              f"Recall@k: {float(test_recall):.6f}")
    hist["test_loss"] = [float(test_loss)]
    hist["test_recall"] = [float(test_recall)]
    return up, hist
