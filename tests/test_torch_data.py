"""The port's config, data and split code against the JAX package's on the CPU.

Host NumPy arrays must match exactly; configs must round-trip through one JSON.
"""

import numpy as np
import pandas as pd
import pytest

from movie_recommender_system_with_gnns_tpu import config as jcfg
from movie_recommender_system_with_gnns_tpu.data import movielens as jml
from movie_recommender_system_with_gnns_tpu.training.evaluate import (
    _np_group_by_user as j_group,
)
from movie_recommender_system_with_gnns_tpu_torch import config as tcfg
from movie_recommender_system_with_gnns_tpu_torch.data import movielens as tml
from movie_recommender_system_with_gnns_tpu_torch.training.evaluate import (
    _np_group_by_user as t_group,
)
from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
    load_and_split,
    prepare_training_data,
)


def _assert_same_data(a, b):
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    np.testing.assert_array_equal(a.edge_index, b.edge_index)
    assert a.edge_index.dtype == b.edge_index.dtype
    np.testing.assert_array_equal(a.user_ids, b.user_ids)
    np.testing.assert_array_equal(a.movie_ids, b.movie_ids)
    pd.testing.assert_frame_equal(a.movie_titles, b.movie_titles)


def test_config_json_is_shared():
    assert tcfg.Config().to_json() == jcfg.Config().to_json()
    custom = jcfg.Config(
        data=jcfg.DataConfig(dataset="synthetic", split_level="interaction",
                             synthetic_communities=7),
        model=jcfg.ModelConfig(dim=128, num_layers=4),
        train=jcfg.TrainConfig(batch_size=4096, trainer="fullgraph"),
        serve=jcfg.ServeConfig(top_k=20))
    text = custom.to_json()
    assert tcfg.Config.from_json(text).to_json() == text
    assert jcfg.Config.from_json(tcfg.Config.from_json(text).to_json()) == custom
    assert tcfg.Config.from_json(text).replace(
        serve=tcfg.ServeConfig(top_k=5)).serve.top_k == 5


@pytest.mark.parametrize("communities", [0, 5])
def test_synthetic_graph_identical(communities):
    kw = dict(num_users=70, num_items=110, num_interactions=2500, seed=3,
              power=0.9, num_communities=communities)
    _assert_same_data(jml.make_synthetic_movielens(**kw),
                      tml.make_synthetic_movielens(**kw))


@pytest.mark.parametrize("level", ["edge", "interaction"])
def test_split_edges_identical_and_interchangeable(tmp_path, level):
    data = tml.make_synthetic_movielens(60, 90, 2000, seed=0)
    jdata = jml.make_synthetic_movielens(60, 90, 2000, seed=0)
    kw = dict(train_size=0.9, val_test_ratio=0.5, seed=1, split_level=level)
    j_out = jml.split_edges(jdata, str(tmp_path / "j"), **kw)
    t_out = tml.split_edges(data, str(tmp_path / "t"), **kw)
    # the port reloads the JAX package's persisted indices, and vice versa
    t_reload = tml.split_edges(data, str(tmp_path / "j"), **kw)
    j_reload = jml.split_edges(jdata, str(tmp_path / "t"), **kw)
    for a, b, c, d in zip(j_out, t_out, t_reload, j_reload):
        for other in (b, c, d):
            np.testing.assert_array_equal(a, other)
            assert other.dtype == np.int32


def test_split_rejects_foreign_indices(tmp_path):
    big = tml.make_synthetic_movielens(60, 90, 2000, seed=0)
    small = tml.make_synthetic_movielens(20, 30, 200, seed=0)
    tml.split_edges(big, str(tmp_path))
    with pytest.raises(ValueError, match="DIFFERENT dataset"):
        tml.split_edges(small, str(tmp_path))


def test_load_movielens_csv_identical(tmp_path):
    ratings = pd.DataFrame({
        "userId": [7, 7, 7, 12, 12, 31, 31, 31, 31, 44],
        "movieId": [100, 200, 300, 100, 400, 200, 300, 400, 500, 100],
        "rating": [5.0, 4.0, 3.5, 4.5, 2.0, 4.0, 5.0, 4.0, 4.0, 1.0],
        "timestamp": range(10),
    })
    movies = pd.DataFrame({"movieId": [100, 200, 300, 400, 500],
                           "title": ["A", "B", "C", "D", "E"], "genres": ["x"] * 5})
    ratings.to_csv(tmp_path / "ratings.csv", index=False)
    movies.to_csv(tmp_path / "movies.csv", index=False)
    args = (str(tmp_path / "ratings.csv"), str(tmp_path / "movies.csv"))
    t = tml.load_movielens(*args)
    _assert_same_data(jml.load_movielens(*args), t)
    assert int(t.user_index(31)) == 2 and int(t.user_index(44)) == -1
    assert int(t.movie_index(500)) == t.num_users + 4
    assert t.title_of(300) == "C" and t.title_of(999) == "movie:999"
    assert t.user_id_map == {7: 0, 12: 1, 31: 2}


def test_prepare_training_data_splits_as_jax(tmp_path):
    cfg = tcfg.Config(data=tcfg.DataConfig(
        dataset="synthetic", synthetic_users=50, synthetic_items=80,
        synthetic_interactions=1500, indexes_dir=str(tmp_path / "t")))
    data, splits = load_and_split(cfg)
    jdata = jml.make_synthetic_movielens(50, 80, 1500, seed=0, power=1.1)
    _assert_same_data(jdata, data)
    for a, b in zip(jml.split_edges(jdata, str(tmp_path / "j")), splits):
        np.testing.assert_array_equal(a, b)
    bundle = prepare_training_data(cfg, data=data, device="cpu")
    assert bundle.data is data
    for a, b in zip(splits, bundle.splits):
        np.testing.assert_array_equal(a, b)


def test_group_by_user_identical(tiny_data):
    edges = tiny_data.edge_index
    dup = np.concatenate([edges, edges[:, :50]], axis=1)   # duplicated pairs collapse
    for e in (edges, dup):
        for a, b in zip(j_group(e, tiny_data.num_users), t_group(e, tiny_data.num_users)):
            np.testing.assert_array_equal(a, b)
