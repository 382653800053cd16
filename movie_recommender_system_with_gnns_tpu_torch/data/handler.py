"""Drop-in ``MovieLensDataHandler``: the reference's data-handler API over the
port's pipeline (JAX package ``data/handler.py``).

A user of the reference constructs ``MovieLensDataHandler(ratings_path,
movies_path)``, calls ``get_datasets()`` / ``get_data_training()`` /
``get_num_users_items()`` and reads ``user_id_map`` / ``movie_id_map`` /
``id_user_map`` / ``id_movie_map`` / ``movies`` / ``edge_index`` (reference
data/dataset_handler.py:66-298). The "datasets" are int32 (2, E) edge arrays
over the shared user + movie node ids, and the "train loader" is the list of
per-cluster batches that ``training/pipeline.py::build_cluster_batches``
builds, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..utils.device import DeviceLike, resolve_device
from .movielens import (MovieLensData, download_and_extract_dataset, load_movielens,
                        make_synthetic_movielens, split_edges)
from .partition import partition_bipartite_greedy


class MovieLensDataHandler:
    """Reference-API adapter over the port's data pipeline."""

    def __init__(self, ratings_path: str, movies_path: str,
                 min_rating: float = 4.0, indexes_dir: str = "data/indexes",
                 synthetic_fallback: bool = True):
        self.ratings_path = ratings_path
        self.movies_path = movies_path
        self.indexes_dir = indexes_dir
        if os.path.exists(ratings_path) and os.path.exists(movies_path):
            self._data = load_movielens(ratings_path, movies_path, min_rating)
        elif synthetic_fallback:
            print("Dataset not found and no egress — using the synthetic "
                  "generator (pass synthetic_fallback=False to download).")
            self._data = make_synthetic_movielens()
        else:
            download_and_extract_dataset(os.path.dirname(ratings_path))
            self._data = load_movielens(ratings_path, movies_path, min_rating)
        self.num_users = self._data.num_users
        self.num_movies = self._data.num_items

    # ---- reference public attributes (dataset_handler.py:115-118, :92, :109)

    @property
    def data(self) -> MovieLensData:
        return self._data

    @property
    def user_id_map(self) -> Dict[int, int]:
        return self._data.user_id_map

    @property
    def movie_id_map(self) -> Dict[int, int]:
        return self._data.movie_id_map

    @property
    def id_user_map(self) -> Dict[int, int]:
        return {i: r for r, i in self._data.user_id_map.items()}

    @property
    def id_movie_map(self) -> Dict[int, int]:
        return {i: r for r, i in self._data.movie_id_map.items()}

    @property
    def movies(self):
        return self._data.movie_titles

    @property
    def edge_index(self) -> np.ndarray:
        return self._data.edge_index

    # ---- reference public methods

    def get_datasets(self, train_size: float = 0.9):
        """(train, val, test) edge sets with the persisted split
        (dataset_handler.py:144-253)."""
        return split_edges(self._data, self.indexes_dir, train_size)

    def get_data_training(self, num_train_clusters: int = 100, device: DeviceLike = None):
        """(train_loader, val, test): the clusters' padded batches on
        ``resolve_device(device)`` and the eval edge sets
        (dataset_handler.py:256-288)."""
        from ..training.pipeline import build_cluster_batches

        dev = resolve_device(device)
        train_e, val_e, test_e = self.get_datasets()
        n = self.num_users + self.num_movies
        parts = partition_bipartite_greedy(train_e, self.num_users, n, num_train_clusters)
        loader = build_cluster_batches(parts, self.num_users, n, device=dev)
        return loader, val_e, test_e

    def get_num_users_items(self) -> Tuple[int, int]:
        return self._data.get_num_users_items()
