"""MovieLens ingest on the host: rating filter, dense id maps, edge list, splits.

A copy of the JAX package's host NumPy code (``data/movielens.py``), kept here
because the port imports nothing of that package. Everything returns plain
``np.ndarray``; tensors are made where a device is chosen.

  * rating filter ``>= min_rating``                 — reference dataset_handler.py:106
  * dense id maps, movies offset by ``num_users``    — dataset_handler.py:115-118
  * undirected doubling of the bipartite edge list  — dataset_handler.py:141
  * 90/5/5 split with persisted val/test indices,
    train derived by setdiff on reload              — dataset_handler.py:144-253

``ratings.csv`` is read by the host graph runtime's mmap reader
(``data/native.py``), or through pandas when ``reader="pandas"`` asks for it.
pandas is imported where it is used, and only the titles need it: without it
a dataset has no title table. :func:`download_and_extract_dataset` fetches a
MovieLens zip (JAX ``data/movielens.py:46-72``) with a connection timeout.
"""

from __future__ import annotations

import os
import shutil
import zipfile
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

MOVIELENS_URLS = {
    # dataset_handler.py:16
    "ml-25m": "https://files.grouplens.org/datasets/movielens/ml-25m.zip",
    "ml-1m": "https://files.grouplens.org/datasets/movielens/ml-1m.zip",
    "ml-100k": "https://files.grouplens.org/datasets/movielens/ml-latest-small.zip",
}
#: seconds a download waits to connect or for the next bytes
DOWNLOAD_TIMEOUT_S = 30.0


def pandas_or_none():
    """The pandas module, or None where it is not installed."""
    try:
        import pandas
    except ImportError:
        return None
    return pandas


def download_and_extract_dataset(data_dir: str, dataset: str = "ml-25m") -> None:
    """Download a MovieLens zip and extract ``movies.csv`` + ``ratings.csv``.

    JAX's function with its messages: only those two members are extracted,
    by base name, the zip is removed afterwards, and a failed download
    raises ``RuntimeError`` naming the missing egress. Unlike JAX's
    ``urlretrieve``, the connection has a timeout (:data:`DOWNLOAD_TIMEOUT_S`),
    so a machine without network fails fast instead of waiting.
    """
    import urllib.error
    import urllib.request

    os.makedirs(data_dir, exist_ok=True)
    url = MOVIELENS_URLS[dataset]
    zip_path = os.path.join(data_dir, f"{dataset}.zip")
    print(f"Downloading {dataset} from {url} ...")
    try:
        with urllib.request.urlopen(url, timeout=DOWNLOAD_TIMEOUT_S) as src, \
                open(zip_path, "wb") as dst:
            shutil.copyfileobj(src, dst)
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"Could not download {dataset} ({e}). This environment may have no "
            "network egress — use make_synthetic_movielens() or place "
            "ratings.csv/movies.csv under the data dir manually."
        ) from e
    with zipfile.ZipFile(zip_path, "r") as zf:
        for name in zf.namelist():
            base = os.path.basename(name)
            if base in ("movies.csv", "ratings.csv"):
                with zf.open(name) as src, open(os.path.join(data_dir, base), "wb") as dst:
                    shutil.copyfileobj(src, dst)
    os.remove(zip_path)
    print("Dataset downloaded and extracted successfully.")


@dataclass
class MovieLensData:
    """Processed interaction data in one flat structure.

    ``edge_index`` is the undirected-doubled bipartite edge list with dense
    node ids: users occupy ``[0, num_users)``, movies
    ``[num_users, num_users + num_items)``.
    """

    num_users: int
    num_items: int
    edge_index: np.ndarray                 # int32 (2, E) undirected (doubled+coalesced)
    user_ids: np.ndarray                   # raw userId for dense user index u
    movie_ids: np.ndarray                  # raw movieId for dense item index i
    movie_titles: Optional[object] = None  # a pandas DataFrame: movieId, title
    _user_id_map: Optional[Dict[int, int]] = field(default=None, repr=False)
    _movie_id_map: Optional[Dict[int, int]] = field(default=None, repr=False)

    def user_index(self, raw_user_id) -> np.ndarray:
        """raw userId -> dense user index in [0, num_users); -1 if unknown."""
        return _lookup(self.user_ids, np.asarray(raw_user_id))

    def movie_index(self, raw_movie_id) -> np.ndarray:
        """raw movieId -> dense *node* id in [num_users, num_users+num_items);
        -1 if unknown."""
        idx = _lookup(self.movie_ids, np.asarray(raw_movie_id))
        return np.where(idx >= 0, idx + self.num_users, idx)

    def raw_user_id(self, user_index) -> np.ndarray:
        return self.user_ids[np.asarray(user_index)]

    def raw_movie_id(self, item_index) -> np.ndarray:
        """dense item index in [0, num_items) -> raw movieId."""
        return self.movie_ids[np.asarray(item_index)]

    @property
    def user_id_map(self) -> Dict[int, int]:
        if self._user_id_map is None:
            self._user_id_map = {int(r): i for i, r in enumerate(self.user_ids)}
        return self._user_id_map

    @property
    def movie_id_map(self) -> Dict[int, int]:
        if self._movie_id_map is None:
            self._movie_id_map = {
                int(r): i + self.num_users for i, r in enumerate(self.movie_ids)
            }
        return self._movie_id_map

    @property
    def movies(self):
        return self.movie_titles

    def get_num_users_items(self) -> Tuple[int, int]:
        return self.num_users, self.num_items

    def title_of(self, raw_movie_id: int) -> str:
        if self.movie_titles is None:
            return f"movie:{raw_movie_id}"
        rows = self.movie_titles[self.movie_titles["movieId"] == raw_movie_id]
        if len(rows) == 0:
            return f"movie:{raw_movie_id}"
        return str(rows.iloc[0]["title"])


def _lookup(sorted_source_unsorted: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Vectorized raw-id -> dense-index lookup via a sorted side index."""
    order = np.argsort(sorted_source_unsorted, kind="stable")
    srt = sorted_source_unsorted[order]
    pos = np.searchsorted(srt, queries)
    pos = np.clip(pos, 0, len(srt) - 1)
    hit = srt[pos] == queries
    out = np.where(hit, order[pos], -1)
    return out.astype(np.int64)


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of a 1-D array by one sort: the same sorted values.
    NumPy 2.3's ``np.unique`` hashes first, which on tens of millions of
    distinct int64 keys is several times slower than sorting them."""
    a = np.sort(a)
    keep = np.ones(a.shape[0], bool)
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def to_undirected(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Double and coalesce edges: {(u,v)} -> {(u,v)} ∪ {(v,u)}, sorted, deduped."""
    src = np.concatenate([edge_index[0], edge_index[1]])
    dst = np.concatenate([edge_index[1], edge_index[0]])
    key = src.astype(np.int64) * np.int64(num_nodes) + dst.astype(np.int64)
    uniq = sorted_unique(key)
    return np.stack([uniq // num_nodes, uniq % num_nodes]).astype(np.int32)


def load_movielens(
    ratings_path: str,
    movies_path: Optional[str] = None,
    min_rating: float = 4.0,
    reader: str = "native",
) -> MovieLensData:
    """Load MovieLens CSVs: ``rating >= min_rating`` filter,
    first-appearance-ordered dense id maps, undirected doubling.

    ``reader="native"`` (default) parses ``ratings.csv`` with the host graph
    runtime (mmap + threads, filter fused; raises if the library cannot be
    built); ``reader="pandas"`` reads it through pandas."""
    if reader == "native":
        from . import native

        user_raw, movie_raw = native.load_ratings_csv(ratings_path, min_rating)
    elif reader == "pandas":
        pd = pandas_or_none()
        if pd is None:
            raise RuntimeError("pandas is required for reader='pandas'")
        ratings = pd.read_csv(ratings_path, usecols=["userId", "movieId", "rating"])
        ratings = ratings[ratings["rating"] >= min_rating]
        user_raw = ratings["userId"].to_numpy()
        movie_raw = ratings["movieId"].to_numpy()
    else:
        raise ValueError(f"unknown reader {reader!r}")
    pd = pandas_or_none()
    movies = (pd.read_csv(movies_path, usecols=["movieId", "title"])
              if pd is not None and movies_path else None)
    # first-appearance order, like a dict comprehension over .unique()
    first_user_ids = user_raw[np.sort(np.unique(user_raw, return_index=True)[1])]
    first_movie_ids = movie_raw[np.sort(np.unique(movie_raw, return_index=True)[1])]

    u_dense = _lookup(first_user_ids, user_raw)
    m_dense = _lookup(first_movie_ids, movie_raw)
    num_users = len(first_user_ids)
    num_items = len(first_movie_ids)

    edge_index = np.stack([u_dense, m_dense + num_users]).astype(np.int64)
    edge_index = to_undirected(edge_index, num_users + num_items)
    return MovieLensData(
        num_users=num_users,
        num_items=num_items,
        edge_index=edge_index,
        user_ids=first_user_ids,
        movie_ids=first_movie_ids,
        movie_titles=movies,
    )


#: the ML-25M-statistics synthetic graph (the JAX package's ``bench.py``
#: ``SCALES["full"]``): ML-25M's users, movies and interactions, 200 planted
#: taste communities
ML25M_SYNTHETIC = dict(users=162_541, items=59_047, interactions=18_000_000,
                       communities=200, power=0.9)


def make_synthetic_movielens(
    num_users: int = 1000,
    num_items: int = 1700,
    num_interactions: int = 100_000,
    seed: int = 0,
    power: float = 1.1,
    num_communities: int = 0,
    intra_prob: float = 0.85,
) -> MovieLensData:
    """Synthetic power-law bipartite interaction graph shaped like MovieLens.

    User activity and item popularity follow Zipf-like laws. With
    ``num_communities > 0``, users and items belong to latent communities and
    ``intra_prob`` of the interactions stay inside the user's community.
    Bit-identical to the JAX package's generator for the same arguments.
    """
    rng = np.random.default_rng(seed)
    u_p = (1.0 / np.arange(1, num_users + 1) ** power)
    i_p = (1.0 / np.arange(1, num_items + 1) ** power)
    u_p /= u_p.sum()
    i_p /= i_p.sum()
    users = rng.choice(num_users, size=num_interactions, p=u_p)
    items = rng.choice(num_items, size=num_interactions, p=i_p)
    if num_communities > 1:
        u_comm = users % num_communities
        i_comm = items % num_communities
        intra = rng.random(num_interactions) < intra_prob
        mism = intra & (i_comm != u_comm)
        # shift mismatched items to the nearest item of the user's community
        delta = (u_comm[mism] - i_comm[mism]) % num_communities
        items = items.copy()
        items[mism] = (items[mism] + delta) % num_items
    pairs = np.unique(users.astype(np.int64) * num_items + items)
    users = (pairs // num_items).astype(np.int64)
    items = (pairs % num_items).astype(np.int64)
    # re-index densely in case some user/item was never sampled
    uu = np.unique(users)
    ii = np.unique(items)
    users = _lookup(uu, users)
    items = _lookup(ii, items)
    n_u, n_i = len(uu), len(ii)
    edge_index = np.stack([users, items + n_u])
    edge_index = to_undirected(edge_index, n_u + n_i)
    titles = None
    pd = pandas_or_none()
    if pd is not None:
        titles = pd.DataFrame(
            {"movieId": np.arange(1, n_i + 1),
             "title": [f"Synthetic Movie {i}" for i in range(1, n_i + 1)]}
        )
    return MovieLensData(
        num_users=n_u,
        num_items=n_i,
        edge_index=edge_index,
        user_ids=np.arange(1, n_u + 1),
        movie_ids=np.arange(1, n_i + 1),
        movie_titles=titles,
    )


def _load_persisted(val_file: str, test_file: str, count: int, what: str,
                    indexes_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    val_idx = np.sort(np.load(val_file))
    test_idx = np.sort(np.load(test_file))
    top = max(val_idx[-1] if val_idx.size else -1,
              test_idx[-1] if test_idx.size else -1)
    if top >= count:
        raise ValueError(
            f"persisted split indices in {indexes_dir} reference {what} "
            f"{top} but this dataset has only {count} {what}s — the indices "
            "belong to a DIFFERENT dataset; delete the dir or point "
            "indexes_dir elsewhere")
    return val_idx, test_idx


def split_edges(
    data: MovieLensData,
    indexes_dir: str,
    train_size: float = 0.9,
    val_test_ratio: float = 0.5,
    seed: int = 0,
    split_level: str = "edge",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """90/5/5 split with persisted val/test indices.

    First run: shuffle, split, sort, persist ``val_indices.npy`` /
    ``test_indices.npy``. Rerun: load them and derive train by setdiff.
    Returns (train_edges, val_edges, test_edges), each int32 (2, E_split).
    ``split_level="edge"`` splits the directed edges of the doubled graph (the
    reference's split); ``"interaction"`` splits unique pairs, then doubles.
    The JAX package's files load unchanged, and vice versa.
    """
    if split_level == "interaction":
        return _split_interactions(data, indexes_dir, train_size,
                                   val_test_ratio, seed)
    if split_level != "edge":
        raise ValueError(f"unknown split_level {split_level!r}")
    num_edges = data.edge_index.shape[1]
    val_file = os.path.join(indexes_dir, "val_indices.npy")
    test_file = os.path.join(indexes_dir, "test_indices.npy")

    if not (os.path.exists(val_file) and os.path.exists(test_file)):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(num_edges)
        n_train = int(round(train_size * num_edges))
        train_idx = np.sort(perm[:n_train])
        rest = perm[n_train:]
        n_val = int(round(val_test_ratio * len(rest)))
        val_idx = np.sort(rest[:n_val])
        test_idx = np.sort(rest[n_val:])
        os.makedirs(indexes_dir, exist_ok=True)
        np.save(val_file, val_idx)
        np.save(test_file, test_idx)
    else:
        val_idx, test_idx = _load_persisted(val_file, test_file, num_edges,
                                            "edge", indexes_dir)
        # setdiff1d(arange, val ∪ test) by a mask (no hash of every index)
        train = np.ones(num_edges, bool)
        train[val_idx] = False
        train[test_idx] = False
        train_idx = np.flatnonzero(train)
        for arr in (train_idx, val_idx, test_idx):
            if not np.all(np.diff(arr) > 0):
                raise ValueError(f"split indices in {indexes_dir} repeat an edge")

    ei = data.edge_index
    return (
        ei[:, train_idx].astype(np.int32),
        ei[:, val_idx].astype(np.int32),
        ei[:, test_idx].astype(np.int32),
    )


def _double(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Directed (2, 2P) edge array holding both directions of P pairs."""
    return np.stack([np.concatenate([u, v]),
                     np.concatenate([v, u])]).astype(np.int32)


def _split_interactions(
    data: MovieLensData,
    indexes_dir: str,
    train_size: float,
    val_test_ratio: float,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Interaction-level 90/5/5: split unique (user, item) pairs, then emit
    each split direction-doubled. Persists ``{val,test}_pair_indices.npy``."""
    head, tail = data.edge_index[0], data.edge_index[1]
    fwd = (head < data.num_users) & (tail >= data.num_users)
    u, v = head[fwd].astype(np.int64), tail[fwd].astype(np.int64)
    num_pairs = u.shape[0]
    val_file = os.path.join(indexes_dir, "val_pair_indices.npy")
    test_file = os.path.join(indexes_dir, "test_pair_indices.npy")

    if not (os.path.exists(val_file) and os.path.exists(test_file)):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(num_pairs)
        n_train = int(round(train_size * num_pairs))
        rest = perm[n_train:]
        n_val = int(round(val_test_ratio * len(rest)))
        val_idx = np.sort(rest[:n_val])
        test_idx = np.sort(rest[n_val:])
        os.makedirs(indexes_dir, exist_ok=True)
        np.save(val_file, val_idx)
        np.save(test_file, test_idx)
    else:
        val_idx, test_idx = _load_persisted(val_file, test_file, num_pairs,
                                            "pair", indexes_dir)
    train_idx = np.setdiff1d(np.arange(num_pairs),
                             np.concatenate([val_idx, test_idx]))
    return (
        _double(u[train_idx], v[train_idx]),
        _double(u[val_idx], v[val_idx]),
        _double(u[test_idx], v[test_idx]),
    )
