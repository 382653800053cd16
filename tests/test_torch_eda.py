"""The EDA report and ``cli eda``: the port against the JAX package on the
CPU, with pandas and with pandas made unimportable (the card's machine has
none)."""

import math
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from movie_recommender_system_with_gnns_tpu import cli as jcli
from movie_recommender_system_with_gnns_tpu.utils import eda as jeda
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.utils import eda as teda

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "ml100k"
STAT_PREFIXES = ("ratings:", "unique users:", "ratings/user:", "ratings/movie:",
                 "avg movie degree:", "ratings >= ")


def _assert_report_equal(t, j):
    assert list(t) == list(j)
    for key, a in t.items():
        b = j[key]
        if isinstance(b, dict):
            _assert_report_equal(a, b)
        elif isinstance(b, float):
            assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (key, a, b)
        else:
            assert a == b and type(a) is type(b), (key, a, b)


def _stat_lines(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith(STAT_PREFIXES)]
    assert len(lines) == len(STAT_PREFIXES), out
    return lines


@pytest.fixture(scope="module")
def frames():
    return (pd.read_csv(FIXTURE / "ratings.csv", usecols=["userId", "movieId", "rating"]),
            pd.read_csv(FIXTURE / "movies.csv"), pd.read_csv(FIXTURE / "tags.csv"))


def test_describe_matches_jax():
    rng = np.random.default_rng(0)
    for a in (rng.integers(1, 500, 1000), np.array([3]), np.array([], np.int64)):
        assert teda.describe(a) == jeda.describe(a)


@pytest.mark.parametrize("min_rating", [4.0, 3.5])
def test_eda_report_on_frames_matches_jax(frames, min_rating, capsys):
    ratings, movies, tags = frames
    j = jeda.eda_report(ratings, movies=movies, tags=tags, min_rating=min_rating)
    out_j = capsys.readouterr().out
    t = teda.eda_report(ratings, movies=movies, tags=tags, min_rating=min_rating)
    out_t = capsys.readouterr().out
    _assert_report_equal(t, j)
    assert out_t == out_j          # pandas' heads print alike too


def test_eda_report_on_arrays_matches_jax(frames, capsys):
    ratings, movies, tags = frames
    j = jeda.eda_report(ratings, movies=movies, tags=tags)
    out_j = capsys.readouterr().out
    arrays = {c: ratings[c].to_numpy() for c in ("userId", "movieId", "rating")}
    t = teda.eda_report(arrays, movies=teda.read_csv_columns(str(FIXTURE / "movies.csv")),
                        tags=teda.read_csv_columns(str(FIXTURE / "tags.csv")))
    out_t = capsys.readouterr().out
    _assert_report_equal(t, j)
    assert _stat_lines(out_t) == _stat_lines(out_j)
    assert "ratings head:" in out_t and "movies head:" in out_t
    # a count from a filtering reader in place of the rating column
    no_rating = {c: arrays[c] for c in ("userId", "movieId")}
    ge = int((arrays["rating"] >= 4.0).sum())
    _assert_report_equal(teda.eda_report(no_rating, movies=movies, tags=tags, num_ge=ge,
                                         verbose=False), j)


def test_read_csv_columns_keeps_quoted_commas(tmp_path):
    p = tmp_path / "movies.csv"
    p.write_text('movieId,title,genres\n1,"Good, the Bad, and the Ugly, The (1966)",'
                 'Action|Western\n2,Heat (1995),Crime\n')
    cols = teda.read_csv_columns(str(p))
    assert cols == {"movieId": ["1", "2"],
                    "title": ["Good, the Bad, and the Ugly, The (1966)", "Heat (1995)"],
                    "genres": ["Action|Western", "Crime"]}
    assert list(pd.read_csv(p)["title"]) == cols["title"]


def _eda_both(argv, capsys, no_pandas=False):
    assert jcli.main(argv + ["eda"]) == 0
    out_j = capsys.readouterr().out
    with pytest.MonkeyPatch.context() as mp:
        if no_pandas:       # pandas unimportable in the port's run
            mp.setitem(sys.modules, "pandas", None)
            with pytest.raises(ImportError):
                import pandas  # noqa: F401
        assert tcli.main(argv + ["eda"]) == 0
    out_t = capsys.readouterr().out
    return out_j, out_t


@pytest.mark.parametrize("pandas_missing", [False, True])
def test_cli_eda_on_fixture_csvs_matches_jax(pandas_missing, capsys):
    out_j, out_t = _eda_both(["--dataset", "ml-100k", "--data-dir", str(FIXTURE)],
                             capsys, pandas_missing)
    assert _stat_lines(out_t) == _stat_lines(out_j)
    assert "ratings >= 4.0: 64308 (62.6%)" in out_t
    for head in ("ratings head:", "movies head:", "tags head:"):
        assert head in out_t


@pytest.mark.parametrize("pandas_missing", [False, True])
def test_cli_eda_on_synthetic_graph_matches_jax(pandas_missing, tmp_path, capsys):
    argv = ["--data-dir", str(tmp_path / "none")]
    out_j, out_t = _eda_both(argv, capsys, pandas_missing)
    assert "(no CSVs found — reporting on the synthetic dataset)" in out_t
    assert _stat_lines(out_t) == _stat_lines(out_j)
    small = ["--synthetic-users", "40", "--synthetic-items", "70",
             "--synthetic-interactions", "900"] + argv
    out_j, out_t = _eda_both(small, capsys, pandas_missing)
    assert _stat_lines(out_t) == _stat_lines(out_j)


def test_cli_eda_min_rating_count_is_a_second_pass(tmp_path, capsys):
    """The native reader's count at min_rating, against pandas' filter, on a
    file with every half-star rating."""
    rows = ["userId,movieId,rating,timestamp"]
    rng = np.random.default_rng(3)
    for n in range(400):
        rows.append(f"{rng.integers(1, 30)},{rng.integers(1, 50)},"
                    f"{rng.integers(1, 11) / 2:.1f},{n}")
    (tmp_path / "ratings.csv").write_text("\n".join(rows) + "\n")
    out_j, out_t = _eda_both(["--data-dir", str(tmp_path)], capsys)
    assert _stat_lines(out_t) == _stat_lines(out_j)
    ratings = pd.read_csv(tmp_path / "ratings.csv")
    assert f"ratings >= 4.0: {int((ratings['rating'] >= 4.0).sum())} " in out_t
