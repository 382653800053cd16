"""Exploratory data analysis: the dataset statistics report (JAX package
``utils/eda.py``).

Heads, unique user and movie counts, ratings-per-user and per-movie
distributions, the average movie degree, and the count and fraction of
ratings >= ``min_rating`` (reference data/eda.py:76-108), with the JAX
function's numbers and stat lines. A table is a pandas DataFrame or a
mapping of equal-length columns (numpy arrays or lists), so the report
runs where pandas is not installed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np


def describe(series) -> Dict[str, float]:
    a = np.asarray(series, dtype=np.float64)
    return {
        "count": float(a.size),
        "mean": float(a.mean()) if a.size else 0.0,
        "std": float(a.std(ddof=1)) if a.size > 1 else 0.0,
        "min": float(a.min()) if a.size else 0.0,
        "25%": float(np.percentile(a, 25)) if a.size else 0.0,
        "50%": float(np.percentile(a, 50)) if a.size else 0.0,
        "75%": float(np.percentile(a, 75)) if a.size else 0.0,
        "max": float(a.max()) if a.size else 0.0,
    }


def _columns(table) -> list:
    return list(table.columns) if hasattr(table, "columns") else list(table.keys())


def _num_rows(table) -> int:
    """Rows of a DataFrame, or the length of a mapping's first column."""
    if hasattr(table, "columns"):
        return len(table)
    return len(next(iter(table.values()))) if len(table) else 0


def _print_head(table, n: int = 5) -> None:
    if hasattr(table, "head"):
        print(table.head(n))
        return
    cols = _columns(table)
    rows = [[str(table[c][i]) for c in cols] for i in range(min(n, _num_rows(table)))]
    widths = [max([len(c)] + [len(r[j]) for r in rows]) for j, c in enumerate(cols)]
    print("  ".join(c.rjust(w) for c, w in zip(cols, widths)))
    for r in rows:
        print("  ".join(v.rjust(w) for v, w in zip(r, widths)))


def _present(values) -> list:
    """A text column's values that are not missing (pandas reads an empty
    field as NaN)."""
    return [v for v in values
            if not (v is None or v == "" or (isinstance(v, float) and np.isnan(v)))]


def eda_report(ratings, movies=None, tags=None, min_rating: float = 4.0,
               verbose: bool = True, show_heads: bool = True,
               num_ge: Optional[int] = None) -> Dict[str, object]:
    """The reference EDA statistics (eda.py:76-108) of a ratings table with
    columns userId, movieId and rating. ``movies`` may carry a ``genres``
    column and ``tags`` a ``tag`` column, both reported when present.

    ``num_ge`` is the count of ratings >= ``min_rating`` when the caller
    has it from a reader that filters (``cmd_eda``'s second pass of the
    native reader); ``ratings`` then needs no rating column."""
    if verbose and show_heads:
        print("ratings head:")
        _print_head(ratings)
        if movies is not None:
            print("movies head:")
            _print_head(movies)
        if tags is not None:
            print("tags head:")
            _print_head(tags)
    n = _num_rows(ratings)
    users = np.asarray(ratings["userId"])
    movies_col = np.asarray(ratings["movieId"])

    num_users = int(np.unique(users).size)
    num_movies = int(np.unique(movies_col).size)
    per_user = np.bincount(np.unique(users, return_inverse=True)[1])
    per_movie = np.bincount(np.unique(movies_col, return_inverse=True)[1])
    ge = (int(num_ge) if num_ge is not None
          else int((np.asarray(ratings["rating"]) >= min_rating).sum()))

    rep: Dict[str, object] = {
        "num_ratings": n,
        "num_users": num_users,
        "num_movies": num_movies,
        "ratings_per_user": describe(per_user),
        "ratings_per_movie": describe(per_movie),
        "avg_movie_degree": float(per_movie.mean()) if per_movie.size else 0.0,
        f"ratings_ge_{min_rating}": ge,
        f"fraction_ge_{min_rating}": ge / max(n, 1),
    }
    if movies is not None:
        rep["num_movie_titles"] = _num_rows(movies)
        if "genres" in _columns(movies):
            genre_counts: Dict[str, int] = {}
            for g in movies["genres"]:
                for tok in str(g).split("|"):
                    genre_counts[tok] = genre_counts.get(tok, 0) + 1
            rep["genres"] = dict(sorted(genre_counts.items(), key=lambda kv: -kv[1]))
    if tags is not None:
        rep["num_tags"] = _num_rows(tags)
        if "tag" in _columns(tags):
            rep["num_unique_tags"] = len(set(_present(tags["tag"])))

    if verbose:
        print(f"ratings: {n}")
        print(f"unique users: {num_users}, unique movies: {num_movies}")
        print(f"ratings/user: mean {rep['ratings_per_user']['mean']:.1f}, "
              f"median {rep['ratings_per_user']['50%']:.0f}, "
              f"max {rep['ratings_per_user']['max']:.0f}")
        print(f"ratings/movie: mean {rep['ratings_per_movie']['mean']:.1f}, "
              f"median {rep['ratings_per_movie']['50%']:.0f}, "
              f"max {rep['ratings_per_movie']['max']:.0f}")
        print(f"avg movie degree: {rep['avg_movie_degree']:.2f}")
        print(f"ratings >= {min_rating}: {ge} ({rep[f'fraction_ge_{min_rating}']:.1%})")
    return rep


def read_csv_columns(path: str) -> Mapping[str, list]:
    """A CSV file as a mapping of its header's names to lists of strings,
    through the standard ``csv`` module (quoted fields may hold commas)."""
    import csv

    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = [[] for _ in header]
        for row in reader:
            for j, col in enumerate(cols):
                col.append(row[j] if j < len(row) else "")
    return dict(zip(header, cols))
