"""End-to-end glue: dataset -> split -> partitions -> padded device batches
(JAX package ``training/pipeline.py``).

The replacement for the reference's entry path
``MovieLensDataHandler.get_data_training`` + ``__main__``
(data/dataset_handler.py:256-288, utils/train_test.py:259-293), with static
padded shapes: ``trainer="compact"`` (the default), ``"full"`` and
``"fullgraph"``.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..data.graph import COOGraph
from ..data.movielens import (MovieLensData, load_movielens,
                              make_synthetic_movielens, split_edges)
from ..data.partition import partition_bipartite_greedy, partition_edges_random
from ..ops.sampling import check_negatives_mode, triplets_from_edges
from ..ops.spmm import DeviceCOO
from ..utils.device import DeviceLike, resolve_device
from .train import ClusterBatch, build_eval_batch


class TrainingBundle:
    """Everything :func:`prepare_training_data` produces. Unpacks like the
    4-tuple ``data, train_obj, val, test``; the raw split edge arrays are on
    ``.splits`` (train_e, val_e, test_e)."""

    def __init__(self, data, train_obj, val, test, splits):
        self.data, self.train, self.val, self.test = data, train_obj, val, test
        self.splits = splits

    def __iter__(self):
        return iter((self.data, self.train, self.val, self.test))


def _bucket(n: int, floor: int = 1024) -> int:
    """Smallest power-of-two-ish bucket ≥ n (limits distinct padded shapes)."""
    b = floor
    while b < n:
        b *= 2
    return b


def build_cluster_batches(
    parts: List[np.ndarray],
    num_users: int,
    num_nodes: int,
    bucket_floor: int = 1024,
    shared_shape: bool = True,
    device: DeviceLike = None,
) -> List[ClusterBatch]:
    """Pad each cluster's edges/triplets to bucketed static shapes and upload.

    ``shared_shape=True`` pads every cluster to ONE common bucket; padding is
    zero-weight edges + masked triplets, which are loss-neutral. Each graph
    carries its row runs, so the full-node trainer's step propagates through
    ``spmm_rows`` and is bit-reproducible on the card.
    """
    dev = resolve_device(device)
    sizes = [e.shape[1] for e in parts if e.shape[1] > 0]
    if not sizes:
        return []
    common = _bucket(max(sizes), bucket_floor) if shared_shape else None
    out: List[ClusterBatch] = []
    for e in parts:
        if e.shape[1] == 0:
            continue  # reference also skips empty clusters (dataset_handler.py:310-312)
        e_pad = common if common is not None else _bucket(e.shape[1], bucket_floor)
        g = DeviceCOO.from_host(COOGraph.build(e, num_nodes, pad_to=e_pad), dev,
                                row_runs=True)
        # positives = the user→item half; pad to half the edge bucket
        b = triplets_from_edges(e, num_users, pad_to=e_pad // 2, device=dev)
        out.append(ClusterBatch(graph=g, batch=b, num_edges=int(e.shape[1])))
    return out


def load_and_split(cfg: Config, data: Optional[MovieLensData] = None
                   ) -> Tuple[MovieLensData, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Dataset -> (data, (train_e, val_e, test_e)); host only.

    Loads the CSVs (or generates the synthetic graph) and splits 90/5/5 with
    persisted indices. Serving needs no more than this.

    A real dataset whose CSVs are absent falls back to the synthetic
    generator with a loud notice, as the JAX package does after its download
    attempt; the port does not download.
    """
    if data is None:
        if cfg.data.dataset != "synthetic" and not _csvs_exist(cfg):
            print(f"[data] REAL DATASET UNAVAILABLE (no CSVs under "
                  f"{cfg.data.data_dir}); falling back to the SYNTHETIC "
                  "generator — numbers from this run are on synthetic data")
        if cfg.data.dataset == "synthetic" or not _csvs_exist(cfg):
            data = make_synthetic_movielens(
                cfg.data.synthetic_users,
                cfg.data.synthetic_items,
                cfg.data.synthetic_interactions,
                seed=cfg.data.split_seed,
                num_communities=cfg.data.synthetic_communities,
                power=cfg.data.synthetic_power,
            )
        else:
            data = load_movielens(
                os.path.join(cfg.data.data_dir, "ratings.csv"),
                os.path.join(cfg.data.data_dir, "movies.csv"),
                min_rating=cfg.data.min_rating,
            )
    splits = split_edges(
        data, cfg.data.indexes_dir, cfg.data.train_size,
        cfg.data.val_test_ratio, cfg.data.split_seed,
        split_level=cfg.data.split_level,
    )
    return data, splits


def densify_if_fits(clusters, tc):
    """The compact trainer's propagation route: dense per-cluster adjacency
    blocks (``densify_adjacency``) when ``tc.dense_adjacency`` is set and the
    local width fits ``tc.dense_adjacency_max_nodes``; otherwise the clusters
    come back unchanged and the segment path runs."""
    from .compact import densify_adjacency

    if (tc.dense_adjacency
            and clusters.u_pad + clusters.i_pad <= tc.dense_adjacency_max_nodes):
        return densify_adjacency(
            clusters, max_local_nodes=tc.dense_adjacency_max_nodes)
    return clusters


def prepare_training_data(cfg: Config,
                          data: Optional[MovieLensData] = None,
                          device: DeviceLike = None) -> TrainingBundle:
    """Dataset -> (train clusters, val batch, test batch) on ``device``.

    :func:`load_and_split`, then partitions the train edges and builds the
    trainer's padded batches.
    """
    dev = resolve_device(device)
    data, splits = load_and_split(cfg, data)
    train_e, val_e, test_e = splits
    num_nodes = data.num_users + data.num_items
    tc = cfg.train
    if tc.trainer == "fullgraph":
        from .fullgraph import build_fullgraph_data

        train_obj = build_fullgraph_data(cfg, train_e, data.num_users, num_nodes,
                                         device=dev)
        val = build_eval_batch(val_e, num_nodes, data.num_users, dev)
        test = build_eval_batch(test_e, num_nodes, data.num_users, dev)
        return TrainingBundle(data, train_obj, val, test, splits)
    if tc.trainer not in ("compact", "full"):
        raise ValueError(f"unknown trainer {tc.trainer!r}")
    check_negatives_mode(tc.negatives)
    if tc.negatives == "feasible" and tc.trainer != "compact":
        warnings.warn(
            "negatives='feasible' is implemented on the fullgraph and "
            f"compact trainers; trainer={tc.trainer!r} draws the "
            "reference's uniform negatives (helpers.py:79-80)", stacklevel=2)
    if tc.optimizer in ("hybrid_adam", "lazy_item_adam") and tc.partitioner == "random_edges":
        raise ValueError(
            f"optimizer={tc.optimizer!r} requires the greedy node partitioner: "
            "its user-row update assumes each user's edges live in exactly one "
            "cluster, which partitioner='random_edges' violates (a user spans "
            "many parts)")

    if tc.use_clusters and tc.num_clusters > 1:
        if tc.partitioner == "random_edges":
            parts = partition_edges_random(
                train_e, data.num_users, tc.num_clusters, seed=cfg.data.split_seed)
        else:
            parts = partition_bipartite_greedy(
                train_e, data.num_users, num_nodes, tc.num_clusters,
                seed=cfg.data.split_seed, balance_tol=tc.partition_balance_tol)
    else:
        parts = [train_e]

    if tc.trainer == "compact":
        from .compact import attach_member_table, build_compact_clusters

        train_obj = densify_if_fits(
            build_compact_clusters(parts, data.num_users, device=dev), tc)
        if tc.negatives == "feasible":
            train_obj = attach_member_table(train_obj, train_e, data.num_users)
    else:
        train_obj = build_cluster_batches(parts, data.num_users, num_nodes,
                                          device=dev)

    val = build_eval_batch(val_e, num_nodes, data.num_users, dev)
    test = build_eval_batch(test_e, num_nodes, data.num_users, dev)
    return TrainingBundle(data, train_obj, val, test, splits)


def _csvs_exist(cfg: Config) -> bool:
    return all(os.path.exists(os.path.join(cfg.data.data_dir, f))
               for f in ("ratings.csv", "movies.csv"))
