"""Dataset -> split: the data half of the JAX package's ``prepare_training_data``
(``training/pipeline.py:75-112``).

Serving reads ``bundle.data`` and ``bundle.splits[0]`` only. Cluster
partitioning, padded batches and eval batches wait for the training slice;
until then the bundle's ``train``, ``val`` and ``test`` are None.
"""

from __future__ import annotations

import os
from typing import Optional

from ..config import Config
from ..data.movielens import (MovieLensData, load_movielens,
                              make_synthetic_movielens, split_edges)


class TrainingBundle:
    """What :func:`prepare_training_data` produces: ``data``, the
    (train_e, val_e, test_e) edge arrays on ``.splits``, and the training
    objects (None in this slice)."""

    def __init__(self, data, train_obj, val, test, splits):
        self.data, self.train, self.val, self.test = data, train_obj, val, test
        self.splits = splits

    def __iter__(self):
        return iter((self.data, self.train, self.val, self.test))


def prepare_training_data(cfg: Config,
                          data: Optional[MovieLensData] = None) -> TrainingBundle:
    """Load the CSVs (or generate the synthetic graph) and split 90/5/5 with
    persisted indices.

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
    return TrainingBundle(data, None, None, None, splits)


def _csvs_exist(cfg: Config) -> bool:
    return all(os.path.exists(os.path.join(cfg.data.data_dir, f))
               for f in ("ratings.csv", "movies.csv"))
