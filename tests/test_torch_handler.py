"""The reference's data-handler API, the dataset download and the milestone
configs: the port against the JAX package on the CPU.

No test reaches the network: the download runs on a zip archive that the
test builds, with ``urlopen`` (the port's) and ``urlretrieve`` (JAX's)
replaced by functions that read it.
"""

import io
import os
import shutil
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu import config as jcfg
from movie_recommender_system_with_gnns_tpu.data import handler as jh
from movie_recommender_system_with_gnns_tpu.data import movielens as jml
from movie_recommender_system_with_gnns_tpu.training import pipeline as jpipe
from movie_recommender_system_with_gnns_tpu_torch import config as tcfg
from movie_recommender_system_with_gnns_tpu_torch.data import handler as th
from movie_recommender_system_with_gnns_tpu_torch.data import movielens as tml
from movie_recommender_system_with_gnns_tpu_torch.training import pipeline as tpipe
from torch_parity import to_np

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "ml100k"
RATINGS, MOVIES = str(FIXTURE / "ratings.csv"), str(FIXTURE / "movies.csv")


@pytest.fixture(scope="module")
def handlers(tmp_path_factory):
    root = tmp_path_factory.mktemp("handlers")
    return (jh.MovieLensDataHandler(RATINGS, MOVIES, indexes_dir=str(root / "j")),
            th.MovieLensDataHandler(RATINGS, MOVIES, indexes_dir=str(root / "t")))


def test_handler_maps_and_edges_match_jax(handlers):
    j, t = handlers
    assert t.get_num_users_items() == j.get_num_users_items()
    assert (t.num_users, t.num_movies) == (j.num_users, j.num_movies)
    assert t.user_id_map == j.user_id_map and t.movie_id_map == j.movie_id_map
    assert t.id_user_map == j.id_user_map and t.id_movie_map == j.id_movie_map
    np.testing.assert_array_equal(t.edge_index, j.edge_index)
    np.testing.assert_array_equal(t.data.user_ids, j.data.user_ids)
    np.testing.assert_array_equal(t.data.movie_ids, j.data.movie_ids)
    assert list(t.movies["title"]) == list(j.movies["title"])
    assert (t.ratings_path, t.movies_path) == (RATINGS, MOVIES)


def test_handler_splits_match_jax(handlers):
    j, t = handlers
    for a, b in zip(j.get_datasets(), t.get_datasets()):
        np.testing.assert_array_equal(a, b)
    # the three splits partition the edges
    tr, va, te = t.get_datasets()
    assert tr.shape[1] + va.shape[1] + te.shape[1] == t.edge_index.shape[1]
    n = t.num_users + t.num_movies
    keys = np.concatenate([e[0].astype(np.int64) * n + e[1] for e in (tr, va, te)])
    assert np.array_equal(np.sort(keys), np.sort(t.edge_index[0].astype(np.int64) * n
                                                 + t.edge_index[1]))


def test_handler_cluster_batches_match_jax(handlers):
    j, t = handlers
    lj, vj, tj = j.get_data_training(num_train_clusters=10)
    lt, vt, tt = t.get_data_training(num_train_clusters=10, device="cpu")
    np.testing.assert_array_equal(vj, vt)
    np.testing.assert_array_equal(tj, tt)
    assert len(lt) == len(lj) > 1
    for cj, ct in zip(lj, lt):
        assert ct.num_edges == cj.num_edges
        assert ct.graph.num_nodes == cj.graph.num_nodes
        for f in ("src", "dst", "w"):
            assert getattr(ct.graph, f).device.type == "cpu"
            np.testing.assert_array_equal(to_np(getattr(ct.graph, f)),
                                          to_np(getattr(cj.graph, f)))
        for f in ("user", "pos_item", "mask"):
            np.testing.assert_array_equal(to_np(getattr(ct.batch, f)),
                                          to_np(getattr(cj.batch, f)))


def test_handler_training_defaults_to_cuda(handlers):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        handlers[1].get_data_training(num_train_clusters=4)


def test_synthetic_fallback_matches_jax(tmp_path, capsys):
    missing = str(tmp_path / "none" / "ratings.csv"), str(tmp_path / "none" / "movies.csv")
    j = jh.MovieLensDataHandler(*missing, indexes_dir=str(tmp_path / "j"))
    out_j = capsys.readouterr().out
    t = th.MovieLensDataHandler(*missing, indexes_dir=str(tmp_path / "t"))
    out_t = capsys.readouterr().out
    assert out_t == out_j and "synthetic generator" in out_t
    np.testing.assert_array_equal(t.edge_index, j.edge_index)
    assert t.get_num_users_items() == j.get_num_users_items()
    for a, b in zip(j.get_datasets(), t.get_datasets()):
        np.testing.assert_array_equal(a, b)


def test_handler_without_fallback_downloads_then_loads(tmp_path, monkeypatch):
    calls = []

    def fake_download(data_dir, dataset="ml-25m"):
        calls.append((data_dir, dataset))
        for f in ("ratings.csv", "movies.csv"):
            shutil.copy(FIXTURE / f, os.path.join(data_dir, f))

    monkeypatch.setattr(th, "download_and_extract_dataset", fake_download)
    d = tmp_path / "ml"
    d.mkdir()
    t = th.MovieLensDataHandler(str(d / "ratings.csv"), str(d / "movies.csv"),
                                indexes_dir=str(tmp_path / "t"), synthetic_fallback=False)
    assert calls == [(str(d), "ml-25m")]
    ref = tml.load_movielens(RATINGS, MOVIES)
    np.testing.assert_array_equal(t.edge_index, ref.edge_index)


def _zip_archive(path: Path) -> dict:
    """A MovieLens-shaped zip: the two CSVs under a folder, plus members the
    download must skip. Returns the CSVs' bytes."""
    members = {
        "ml-latest-small/ratings.csv": (FIXTURE / "ratings.csv").read_bytes(),
        "ml-latest-small/movies.csv": (FIXTURE / "movies.csv").read_bytes(),
        "ml-latest-small/tags.csv": (FIXTURE / "tags.csv").read_bytes(),
        "ml-latest-small/links.csv": b"movieId,imdbId,tmdbId\n1,114709,862\n",
        "ml-latest-small/README.txt": b"readme\n",
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in members.items():
            zf.writestr(name, data)
    return {os.path.basename(k): v for k, v in members.items()}


def test_download_and_extract_matches_jax(tmp_path, monkeypatch, capsys):
    archive = tmp_path / "served.zip"
    content = _zip_archive(archive)
    seen = []

    def fake_urlretrieve(url, filename, *a, **k):
        seen.append(("urlretrieve", url))
        shutil.copy(archive, filename)
        return filename, None

    def fake_urlopen(url, timeout=None, *a, **k):
        seen.append(("urlopen", url, timeout))
        return io.BytesIO(archive.read_bytes())

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    jml.download_and_extract_dataset(str(tmp_path / "j"), "ml-100k")
    out_j = capsys.readouterr().out
    tml.download_and_extract_dataset(str(tmp_path / "t"), "ml-100k")
    out_t = capsys.readouterr().out
    assert out_t == out_j and "downloaded and extracted successfully" in out_t
    url = tml.MOVIELENS_URLS["ml-100k"]
    assert url == jml.MOVIELENS_URLS["ml-100k"] and url.endswith("ml-latest-small.zip")
    assert tml.MOVIELENS_URLS == jml.MOVIELENS_URLS
    assert seen == [("urlretrieve", url), ("urlopen", url, tml.DOWNLOAD_TIMEOUT_S)]
    for d in ("j", "t"):
        assert sorted(os.listdir(tmp_path / d)) == ["movies.csv", "ratings.csv"]
        for f in ("movies.csv", "ratings.csv"):
            assert (tmp_path / d / f).read_bytes() == content[f]
    assert tml.load_movielens(str(tmp_path / "t" / "ratings.csv")).edge_index.shape[1] > 0


def test_download_without_egress_raises(tmp_path, monkeypatch):
    def no_egress(url, timeout=None, *a, **k):
        raise urllib.error.URLError("no network egress (simulated)")

    monkeypatch.setattr(urllib.request, "urlopen", no_egress)
    with pytest.raises(RuntimeError, match="network egress"):
        tml.download_and_extract_dataset(str(tmp_path), "ml-25m")
    assert not (tmp_path / "ratings.csv").exists()
    with pytest.raises(KeyError):
        tml.download_and_extract_dataset(str(tmp_path), "ml-7b")


def test_load_and_split_falls_back_with_jax_notice(tmp_path, monkeypatch, capsys):
    def no_egress(data_dir, dataset):
        raise RuntimeError("no network egress (simulated)")

    monkeypatch.setattr(jml, "download_and_extract_dataset", no_egress)
    monkeypatch.setattr(tpipe, "download_and_extract_dataset", no_egress)
    synth = dict(dataset="ml-25m", data_dir=str(tmp_path / "nope"),
                 synthetic_users=50, synthetic_items=80, synthetic_interactions=1500)
    bj = jpipe.prepare_training_data(jcfg.Config(
        data=jcfg.DataConfig(indexes_dir=str(tmp_path / "j"), **synth),
        train=jcfg.TrainConfig(num_clusters=2)))
    out_j = capsys.readouterr().out
    data, splits = tpipe.load_and_split(tcfg.Config(
        data=tcfg.DataConfig(indexes_dir=str(tmp_path / "t"), **synth)))
    out_t = capsys.readouterr().out
    notice = [ln for ln in out_j.splitlines() if "REAL DATASET UNAVAILABLE" in ln]
    assert len(notice) == 1 and notice[0] in out_t.splitlines()
    np.testing.assert_array_equal(data.edge_index, bj.data.edge_index)
    for a, b in zip(bj.splits, splits):
        np.testing.assert_array_equal(a, b)


def test_load_and_split_loads_what_the_download_wrote(tmp_path, monkeypatch, capsys):
    def fixture_download(data_dir, dataset):
        os.makedirs(data_dir, exist_ok=True)
        for f in ("ratings.csv", "movies.csv"):
            shutil.copy(FIXTURE / f, os.path.join(data_dir, f))

    monkeypatch.setattr(tpipe, "download_and_extract_dataset", fixture_download)
    data, _ = tpipe.load_and_split(tcfg.Config(data=tcfg.DataConfig(
        dataset="ml-100k", data_dir=str(tmp_path / "ml"),
        indexes_dir=str(tmp_path / "t"))))
    assert "REAL DATASET UNAVAILABLE" not in capsys.readouterr().out
    np.testing.assert_array_equal(data.edge_index,
                                  tml.load_movielens(RATINGS, MOVIES).edge_index)


@pytest.mark.parametrize("name", ["ml100k_config", "ml25m_config"])
def test_milestone_configs_match_jax(name):
    t, j = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert t.to_json() == j.to_json()
    assert tcfg.Config.from_json(j.to_json()) == t
