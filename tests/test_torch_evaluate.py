"""Full-ranking evaluation of the port (``training/evaluate.py``) against the
JAX package's on the CPU, and the CLI flags that reach it.

The same numpy tables and edge arrays go to both packages. Both rank with exact
f32 scores and the same tie order, so Recall@k and NDCG@k must agree within
1e-6 (they are float64 sums of the same hit bits; the bound leaves room for
one near-tie flip in thousands of ranks, none observed).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from movie_recommender_system_with_gnns_tpu import cli as jcli
from movie_recommender_system_with_gnns_tpu.config import Config as JConfig
from movie_recommender_system_with_gnns_tpu.config import ModelConfig as JModel
from movie_recommender_system_with_gnns_tpu.data.movielens import split_edges as j_split
from movie_recommender_system_with_gnns_tpu.models.lightgcn import LightGCNParams as JParams
from movie_recommender_system_with_gnns_tpu.training import evaluate as J
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.config import Config as TConfig
from movie_recommender_system_with_gnns_tpu_torch.config import ModelConfig as TModel
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import params_from_numpy
from movie_recommender_system_with_gnns_tpu_torch.training import evaluate as T

from torch_parity import np_tables

TOL = 1e-6


@pytest.fixture(scope="module")
def splits(tiny_data, tmp_path_factory):
    return j_split(tiny_data, str(tmp_path_factory.mktemp("idx")))


def _both(tiny_data, dim=16, seed=0):
    u, i = np_tables(tiny_data.num_users, tiny_data.num_items, dim, seed, std=1.0)
    return JParams(jnp.asarray(u), jnp.asarray(i)), params_from_numpy(u, i, "cpu")


def _cfgs(layers, readout="reference"):
    return (JConfig(model=JModel(num_layers=layers, dim=16, readout=readout)),
            TConfig(model=TModel(num_layers=layers, dim=16, readout=readout)))


@pytest.mark.parametrize("kw", [
    dict(), dict(normalize=False), dict(k=5), dict(k=200),
    dict(max_users=20), dict(max_users=20, sample_seed=7),
    dict(batch_users=16, groups=2), dict(score_dtype="float32"),
    dict(use_propagated=True), dict(use_propagated=True, normalize=False),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_evaluate_full_ranking_matches_jax(tiny_data, splits, kw):
    train_e, _, test_e = splits
    pj, pt = _both(tiny_data)
    kj, kt = dict(kw), dict(kw)
    if kw.get("use_propagated"):
        kj["cfg"], kt["cfg"] = _cfgs(2)
    rj, nj = J.evaluate_full_ranking(pj, train_e, test_e, tiny_data.num_users, **kj)
    rt, nt = T.evaluate_full_ranking(pt, train_e, test_e, tiny_data.num_users, **kt)
    assert abs(rt - rj) <= TOL and abs(nt - nj) <= TOL
    assert 0.0 < rt <= 1.0 and 0.0 < nt <= 1.0
    tj, tt = J.evaluate_full_ranking.last_timings, T.evaluate_full_ranking.last_timings
    assert set(tt) == set(tj)
    for key in ("eval_users", "sharded", "dispatch_users", "score_dtype"):
        assert tt[key] == tj[key]


def test_empty_eval_set(tiny_data, splits):
    pj, pt = _both(tiny_data)
    empty = np.zeros((2, 0), np.int32)
    assert T.evaluate_full_ranking(pt, splits[0], empty, tiny_data.num_users) == \
        J.evaluate_full_ranking(pj, splits[0], empty, tiny_data.num_users) == (0.0, 0.0)
    assert T.evaluate_full_ranking.last_timings["eval_users"] == 0
    # no train edges: nothing is excluded
    rj = J.evaluate_full_ranking(pj, empty, splits[2], tiny_data.num_users)
    rt = T.evaluate_full_ranking(pt, empty, splits[2], tiny_data.num_users)
    np.testing.assert_allclose(rt, rj, atol=TOL)


def test_duplicate_held_out_edges_do_not_count_twice(tiny_data, splits):
    train_e, _, test_e = splits
    pj, pt = _both(tiny_data)
    doubled = np.concatenate([test_e, test_e[:, ::2]], axis=1)
    once = T.evaluate_full_ranking(pt, train_e, test_e, tiny_data.num_users)
    twice = T.evaluate_full_ranking(pt, train_e, doubled, tiny_data.num_users)
    ref = J.evaluate_full_ranking(pj, train_e, doubled, tiny_data.num_users)
    np.testing.assert_allclose(twice, once, atol=1e-12)
    np.testing.assert_allclose(twice, ref, atol=TOL)


def test_perfect_model_and_train_seen_exclusion():
    """A model that scores each user's held-out item highest reaches recall 1;
    an item seen in train is never ranked even when it scores highest."""
    nu, ni = 6, 9
    u = np.eye(nu, 8, dtype=np.float32)
    i = np.zeros((ni, 8), np.float32)
    i[:nu] = np.eye(nu, 8) * 0.9           # item r matches user r
    i[nu:] = 0.01
    pt = params_from_numpy(u, i, "cpu")
    users = np.arange(nu)
    held = np.stack([users, users + nu])    # user r -> item r
    none = np.zeros((2, 0), np.int64)
    assert T.evaluate_full_ranking(pt, none, held, nu, k=1) == (1.0, 1.0)
    # now the best item is train-seen and the held-out one scores lowest
    held2 = np.stack([users, np.full(nu, ni - 1) + nu])
    r, _ = T.evaluate_full_ranking(pt, held, held2, nu, k=ni - 1)
    assert r == 1.0                         # ni - 1 ranks left once item r is out
    r, _ = T.evaluate_full_ranking(pt, none, held2, nu, k=1)
    assert r == 0.0


def test_group_cache_and_rejected_arguments(tiny_data, splits):
    train_e, _, test_e = splits
    _, pt = _both(tiny_data)
    T._GROUP_CACHE.clear()
    T.evaluate_full_ranking(pt, train_e, test_e, tiny_data.num_users)
    assert T.evaluate_full_ranking.last_timings["groupby_cached"] is False
    T.evaluate_full_ranking(pt, train_e, test_e, tiny_data.num_users)
    assert T.evaluate_full_ranking.last_timings["groupby_cached"] is True
    with pytest.raises(ValueError, match="requires cfg"):
        T.evaluate_full_ranking(pt, train_e, test_e, tiny_data.num_users,
                                use_propagated=True)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        T.evaluate_full_ranking(pt, train_e, test_e, tiny_data.num_users, mesh=object())


def test_bf16_scores_stay_close_to_f32(tiny_data, splits):
    """bf16 scores reorder near-ties only: the metrics move by a few ranks
    out of hundreds (bound 0.05, as the JAX suite's bf16 test allows)."""
    train_e, _, test_e = splits
    _, pt = _both(tiny_data)
    f32 = T.evaluate_full_ranking(pt, train_e, test_e, tiny_data.num_users)
    bf16 = T.evaluate_full_ranking(pt, train_e, test_e, tiny_data.num_users,
                                   score_dtype="bfloat16")
    assert T.evaluate_full_ranking.last_timings["score_dtype"] == "bfloat16"
    np.testing.assert_allclose(bf16, f32, atol=0.05)


def _cli_args(tmp_path, *extra):
    return ["--dataset", "synthetic", "--synthetic-users", "80",
            "--synthetic-items", "120", "--synthetic-interactions", "3000",
            "--indexes-dir", str(tmp_path / "idx"), "--epochs", "1", "--dim", "8",
            "--layers", "2", "--clusters", "3",
            "--checkpoint", str(tmp_path / "model.npz"), *extra]


def test_cli_train_full_eval(tmp_path, capsys):
    """``train --full-eval`` prints Recall@k / NDCG@k of the test split and the
    evaluator's timings; on the checkpoint it wrote, the port's evaluator and
    the JAX package's agree."""
    from movie_recommender_system_with_gnns_tpu.training.checkpoint import load_params
    from movie_recommender_system_with_gnns_tpu_torch.config import DataConfig as TData
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        load_params as t_load)
    from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import load_and_split

    args = _cli_args(tmp_path, "train", "--full-eval", "--full-eval-k", "7",
                     "--full-eval-users", "10")
    assert tcli.main(["--device", "cpu", "--histories-dir", str(tmp_path / "h")] + args) == 0
    out = capsys.readouterr().out
    m = re.search(r"Full-ranking test Recall@7: ([0-9.]+), NDCG@7: ([0-9.]+)", out)
    assert m and "full-ranking eval timings" in out and "'eval_users': 10" in out
    assert 0.0 <= float(m.group(1)) <= 1.0 and 0.0 <= float(m.group(2)) <= 1.0
    data, (train_e, _, test_e) = load_and_split(TConfig(data=TData(
        dataset="synthetic", synthetic_users=80, synthetic_items=120,
        synthetic_interactions=3000, indexes_dir=str(tmp_path / "idx"))))
    pj, _ = load_params(str(tmp_path / "model.npz"))
    pt, _ = t_load(str(tmp_path / "model.npz"), "cpu")
    rj, nj = J.evaluate_full_ranking(pj, train_e, test_e, data.num_users, k=7, max_users=10)
    rt, nt = T.evaluate_full_ranking(pt, train_e, test_e, data.num_users, k=7, max_users=10)
    assert abs(rt - rj) <= TOL and abs(nt - nj) <= TOL


@pytest.mark.parametrize("mode", [["--user-id", "3"], ["--movie-id", "5"]])
def test_cli_recommend_propagated_matches_jax(tmp_path, capsys, mode):
    from movie_recommender_system_with_gnns_tpu.training.checkpoint import save_params
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens)

    data = make_synthetic_movielens(80, 120, 3000, seed=0, power=1.1)
    u, i = np_tables(data.num_users, data.num_items, 8, seed=1, std=1.0)
    save_params(str(tmp_path / "model.npz"), JParams(u, i))
    args = _cli_args(tmp_path, "recommend", "--propagated", *mode)
    assert tcli.main(["--device", "cpu"] + args) == 0
    out_t = capsys.readouterr().out
    assert jcli.main(args) == 0
    out_j = capsys.readouterr().out
    assert "Top 10" in out_t
    # same items in the same order; scores printed to 4 decimals may differ in
    # the last digit (propagation sums in another order)
    strip = lambda s: re.sub(r"\(Score: [-0-9.]+\)", "", s)
    assert strip(out_t) == strip(out_j)
    st = [float(x) for x in re.findall(r"Score: ([-0-9.]+)", out_t)]
    sj = [float(x) for x in re.findall(r"Score: ([-0-9.]+)", out_j)]
    np.testing.assert_allclose(st, sj, atol=2e-4)
    # and they differ from the layer-0 answer
    assert tcli.main(["--device", "cpu"] + _cli_args(tmp_path, "recommend", *mode)) == 0
    assert capsys.readouterr().out != out_t
