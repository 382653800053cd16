"""The port's serving path against the JAX package's on the CPU: the batch
index, batched retrieval, single-query recommendations and the CLI.

The same numpy tables go to both packages. The JAX fused lane runs its Pallas
kernel in interpret mode; the port's runs the kernel's plain version.
"""

import jax
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu import cli as jcli
from movie_recommender_system_with_gnns_tpu.models.lightgcn import (
    LightGCNParams as JParams,
)
from movie_recommender_system_with_gnns_tpu.serving import recommend as J
from movie_recommender_system_with_gnns_tpu.training.checkpoint import (
    save_params as j_save,
)
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.config import Config as TConfig
from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
    make_synthetic_movielens,
)
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import (
    params_from_numpy,
)
from movie_recommender_system_with_gnns_tpu_torch.serving import recommend as T
from torch_parity import assert_topk_bf16_close


def _tables(nu, ni, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nu, d)).astype(np.float32),
            rng.standard_normal((ni, d)).astype(np.float32))


def _both(u, i):
    return (JParams(jax.numpy.asarray(u), jax.numpy.asarray(i)),
            params_from_numpy(u, i, device="cpu"))


def _seen(data):
    head, tail = data.edge_index
    fwd = (head < data.num_users) & (tail >= data.num_users)
    m = np.zeros((data.num_users, data.num_items), bool)
    m[head[fwd], tail[fwd] - data.num_users] = True
    return m


@pytest.fixture(scope="module")
def port_data():
    return make_synthetic_movielens(num_users=60, num_items=90,
                                    num_interactions=2000, seed=0)


def test_serving_index_matches_jax(tiny_data, port_data):
    nu, ni = tiny_data.num_users, tiny_data.num_items
    jp, tp = _both(*_tables(nu, ni))
    users = np.arange(0, nu, 3)
    j_idx = J.ServingIndex.build(jp, tiny_data.edge_index, nu)
    t_idx = T.ServingIndex.build(tp, port_data.edge_index, nu)
    np.testing.assert_array_equal(t_idx.mask.numpy(), np.asarray(j_idx.mask))
    s_j, i_j = j_idx.batch_recommend(users, top_k=8)
    s_t, i_t = t_idx.batch_recommend(users, top_k=7)
    assert s_t.shape == (users.size, 7) and s_t.dtype == torch.float32
    assert_topk_bf16_close(s_t.numpy(), i_t.numpy(), np.asarray(s_j), np.asarray(i_j))
    assert not _seen(port_data)[users[:, None], i_t.numpy()].any()


def test_serving_index_user_range(port_data):
    nu, ni = port_data.num_users, port_data.num_items
    _, tp = _both(*_tables(nu, ni))
    full = T.ServingIndex.build(tp, port_data.edge_index, nu)
    shard = T.ServingIndex.build(tp, port_data.edge_index, nu, user_range=(20, 45))
    assert shard.mask.shape[0] == 25
    users = np.arange(20, 45, 2)
    for a, b in zip(shard.batch_recommend(users), full.batch_recommend(users)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shard"):
        shard.batch_recommend(np.array([3]))


def test_serving_index_build_in_row_blocks(port_data, monkeypatch):
    """The packed mask built in several row blocks equals the one-block build."""
    nu, ni = port_data.num_users, port_data.num_items
    _, tp = _both(*_tables(nu, ni))
    whole = T.ServingIndex.build(tp, port_data.edge_index, nu).mask
    monkeypatch.setattr(T, "_BUILD_ROWS", 16)
    assert torch.equal(T.ServingIndex.build(tp, port_data.edge_index, nu).mask, whole)


def test_batch_recommend_users_matches_jax(rng):
    nu, ni = 90, 120
    jp, tp = _both(*_tables(nu, ni, d=8, seed=1))
    users = np.arange(nu)
    lens = rng.integers(0, 5, nu)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    items = rng.integers(0, ni, indptr[-1]).astype(np.int64)
    dense = np.zeros((nu, ni), bool)
    for u in range(nu):
        dense[u, items[indptr[u]:indptr[u + 1]]] = True
    runs = [dict(), dict(exclude_mask=dense), dict(exclude_pairs=(indptr, items)),
            # forced query chunking must not change the result
            dict(exclude_pairs=(indptr, items), max_flat_bytes=600 * ni)]
    for kw in runs:
        s_j, i_j = J.batch_recommend_users(jp, users, top_k=5, **kw)
        s_t, i_t = T.batch_recommend_users(tp, users, top_k=5, **kw)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6, atol=1e-7)
        if kw:
            assert not dense[users[:, None], i_t.numpy()].any()
    # the fused lane on request, and normalize=False ranks by raw inner product
    s_j, i_j = J.batch_recommend_users(jp, users, top_k=5, method="fused",
                                       exclude_pairs=(indptr, items), score_dtype="float32")
    s_t, i_t = T.batch_recommend_users(tp, users, top_k=5, method="fused",
                                       exclude_pairs=(indptr, items), score_dtype="float32")
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    s_j, i_j = J.batch_recommend_users(jp, users, top_k=5, normalize=False)
    s_t, i_t = T.batch_recommend_users(tp, users, top_k=5, normalize=False)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    with pytest.raises(ValueError, match="not both"):
        T.batch_recommend_users(tp, users, exclude_mask=dense, exclude_pairs=(indptr, items))


def test_recommend_from_user_and_movie_match_jax(tiny_data, port_data):
    jp, tp = _both(*_tables(tiny_data.num_users, tiny_data.num_items))
    uid, mid = int(tiny_data.user_ids[4]), int(tiny_data.movie_ids[2])
    seen = J.train_seen_items(tiny_data.edge_index, tiny_data.num_users, 4)
    np.testing.assert_array_equal(
        T.train_seen_items(port_data.edge_index, port_data.num_users, 4), seen)
    pairs = [
        (J.recommend_from_user(jp, uid, tiny_data, top_k=10),
         T.recommend_from_user(tp, uid, port_data, top_k=10), "recommendations"),
        (J.recommend_from_user(jp, uid, tiny_data, excluded_train_items=set(seen.tolist())),
         T.recommend_from_user(tp, uid, port_data, excluded_train_items=set(seen.tolist())),
         "recommendations"),
        (J.recommend_from_movie(jp, mid, tiny_data, excluded_train_users=[0, 1]),
         T.recommend_from_movie(tp, mid, port_data, excluded_train_users=[0, 1]),
         "top_users"),
    ]
    for j, t, key in pairs:
        assert list(t) == [key] and len(t[key]) == len(j[key])
        for a, b in zip(j[key], t[key]):
            assert a.keys() == b.keys()
            assert {k: v for k, v in a.items() if k != "score"} == \
                {k: v for k, v in b.items() if k != "score"}
            assert b["score"] == pytest.approx(a["score"], rel=1e-6, abs=1e-6)
    assert T.recommend_from_user(tp, -123456, port_data) == \
        J.recommend_from_user(jp, -123456, tiny_data) == {"error": "Invalid user ID"}
    assert T.recommend_from_movie(tp, -99999, port_data) == \
        J.recommend_from_movie(jp, -99999, tiny_data) == {"error": "Invalid movie ID"}


def test_compute_serving_tables(port_data):
    _, tp = _both(*_tables(port_data.num_users, port_data.num_items))
    assert T.compute_serving_tables(tp) is tp
    with pytest.raises(ValueError, match="train_edges"):
        T.compute_serving_tables(tp, port_data.edge_index, mode="propagated")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        T.compute_serving_tables(tp, port_data.edge_index, TConfig(),
                                 mode="propagated", mesh=object())
    with pytest.raises(ValueError, match="unknown serving mode"):
        T.compute_serving_tables(tp, mode="other")


@pytest.mark.parametrize("layers,readout", [(1, "reference"), (3, "reference"),
                                            (2, "standard")])
def test_propagated_serving_tables_match_jax(tiny_data, port_data, layers, readout):
    """``mode="propagated"`` against the JAX package on the same tables and
    train graph, within 1e-5 (f32 sums in another order), through the plain
    segment path and through forced edge chunking."""
    from movie_recommender_system_with_gnns_tpu.config import Config as JConfig
    from movie_recommender_system_with_gnns_tpu.config import ModelConfig as JModel
    from movie_recommender_system_with_gnns_tpu_torch.config import ModelConfig as TModel

    jp, tp = _both(*_tables(tiny_data.num_users, tiny_data.num_items))
    cj = JConfig(model=JModel(num_layers=layers, dim=16, readout=readout))
    ct = TConfig(model=TModel(num_layers=layers, dim=16, readout=readout))
    ref = J.compute_serving_tables(jp, tiny_data.edge_index, cj, mode="propagated")
    for kw in ({}, {"chunk_budget_bytes": 40_000}):
        out = T.compute_serving_tables(tp, port_data.edge_index, ct, mode="propagated", **kw)
        assert out.user_emb.shape == tp.user_emb.shape and out.user_emb.device.type == "cpu"
        np.testing.assert_allclose(out.user_emb.numpy(), np.asarray(ref.user_emb), atol=1e-5)
        np.testing.assert_allclose(out.item_emb.numpy(), np.asarray(ref.item_emb), atol=1e-5)
    assert not torch.equal(out.item_emb, tp.item_emb)


def test_batch_recommend_users_block_lane_matches_jax(rng):
    """``method="pallas"`` through ``batch_recommend_users`` with train-seen
    pairs: the items of the JAX package's Pallas lane (interpret mode) and of
    the port's own twophase lane."""
    nu, ni = 40, 300
    jp, tp = _both(*_tables(nu, ni, d=8, seed=2))
    users = np.arange(0, nu, 2)
    lens = rng.integers(0, 6, users.size)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    items = rng.integers(0, ni, indptr[-1]).astype(np.int64)
    kw = dict(top_k=5, exclude_pairs=(indptr, items))
    s_j, i_j = J.batch_recommend_users(jp, users, method="pallas", **kw)
    s_t, i_t = T.batch_recommend_users(tp, users, method="pallas", **kw)
    s_2, i_2 = T.batch_recommend_users(tp, users, method="twophase", **kw)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-5)
    assert torch.equal(i_t, i_2)


def _cli_args(tmp_path, *extra):
    return ["--dataset", "synthetic", "--synthetic-users", "80",
            "--synthetic-items", "120", "--synthetic-interactions", "3000",
            "--indexes-dir", str(tmp_path / "idx"),
            "--checkpoint", str(tmp_path / "model.npz"), *extra]


@pytest.mark.parametrize("mode", [["--user-id", "3"], ["--movie-id", "5"],
                                  ["--user-id", "99999"]])
def test_cli_recommend_matches_jax(tmp_path, capsys, mode):
    data = make_synthetic_movielens(80, 120, 3000, seed=0, power=1.1)
    u, i = _tables(data.num_users, data.num_items)
    j_save(str(tmp_path / "model.npz"), JParams(u, i))
    rc_j = jcli.main(["--clusters", "3"] + _cli_args(tmp_path, "recommend", *mode))
    out_j = capsys.readouterr().out
    rc_t = tcli.main(["--device", "cpu"] + _cli_args(tmp_path, "recommend", *mode))
    out_t = capsys.readouterr().out
    assert rc_t == rc_j and out_t == out_j
    assert ("Top 10" in out_t) == (rc_t == 0)


def test_cli_batch_recommend(tmp_path, capsys):
    data = make_synthetic_movielens(80, 120, 3000, seed=0, power=1.1)
    u, i = _tables(data.num_users, data.num_items)
    j_save(str(tmp_path / "model.npz"), JParams(u, i))
    (tmp_path / "users.txt").write_text("1\n2\n999999\n3\n")
    outs = []
    for main, extra in ((jcli.main, ["--clusters", "3"]), (tcli.main, ["--device", "cpu"])):
        rc = main(extra + _cli_args(tmp_path, "recommend", "--users-file",
                                    str(tmp_path / "users.txt"), "--top-k", "4",
                                    "--out", str(tmp_path / "recs.csv")))
        assert rc == 0
        assert "3 users" in capsys.readouterr().out
        outs.append((tmp_path / "recs.csv").read_text())
    assert outs[0] == outs[1]
    assert outs[1].splitlines()[0] == "userId,rank,movieId,title,score"
    assert len(outs[1].splitlines()) == 1 + 3 * 4


def test_cli_unported_commands_and_missing_checkpoint(tmp_path, capsys):
    """``eda``, once a stub, now reports (the synthetic graph where the data
    dir has no CSVs); ``recommend`` without a checkpoint still fails."""
    assert tcli.main(["--device", "cpu", "--data-dir", str(tmp_path / "none"), "eda"]) == 0
    captured = capsys.readouterr()
    assert "not ported" not in captured.err
    assert "reporting on the synthetic dataset" in captured.out
    assert "ratings >= 4.0:" in captured.out
    assert tcli.main(["--device", "cpu"] + _cli_args(tmp_path, "recommend",
                                                     "--user-id", "1")) == 1
    assert "train first" in capsys.readouterr().out
