"""The visualizations: the port against the JAX package on the CPU.

Mirrors ``tests/test_visualizations.py`` (every public function renders a
non-trivial image; ``cli recommend --plots`` writes its two plots and ``cli
train`` its history plot), holds the analysis' selection and projection
against JAX's, shows the reference's fault C7 (the user is its own first
"dissimilar user"), and checks that the module works without matplotlib up
to the point of rendering.
"""

import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.data.movielens import (
    make_synthetic_movielens as j_synthetic)
from movie_recommender_system_with_gnns_tpu.models.lightgcn import LightGCNParams as JParams
from movie_recommender_system_with_gnns_tpu.utils import visualizations as jviz
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
    make_synthetic_movielens as t_synthetic)
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import params_from_numpy
from movie_recommender_system_with_gnns_tpu_torch.utils import visualizations as viz
from torch_parity import np_tables

NO_PLOTS = ("matplotlib", "matplotlib.pyplot")


def _assert_png(path, min_bytes=4000):
    assert os.path.exists(path), path
    size = os.path.getsize(path)
    assert size > min_bytes, f"{path} suspiciously small ({size} B)"


@pytest.fixture(scope="module")
def small_model():
    """The JAX suite's small model (60 x 90, 1,800 interactions, d 8), with
    numpy tables given to both packages."""
    jd, td = j_synthetic(60, 90, 1800, seed=0), t_synthetic(60, 90, 1800, seed=0)
    u, i = np_tables(td.num_users, td.num_items, 8, seed=0, std=1.0)
    return (jd, JParams(jax.numpy.asarray(u), jax.numpy.asarray(i)),
            td, params_from_numpy(u, i, device="cpu"), (u, i))


def test_plot_histories(tmp_path):
    d = tmp_path / "hist"
    d.mkdir()
    n = 12
    np.save(d / "hist_train_loss.npy", -np.linspace(0.3, 1.2, n))
    np.save(d / "hist_val_loss.npy", -np.linspace(0.2, 0.9, n))
    np.save(d / "hist_val_recall.npy", np.linspace(1e-4, 8e-4, n))
    out = viz.plot_histories(str(d), out_path=str(tmp_path / "h.png"))
    _assert_png(out)
    assert viz.plot_histories(str(d)) == str(d / "histories_training.png")
    _assert_png(d / "histories_training.png")


def test_plot_recommendations(tmp_path):
    recs = [{"title": f"Movie {i} with a fairly long descriptive title",
             "score": 1.0 - 0.07 * i} for i in range(10)]
    out = viz.plot_recommendations(recs, user_id=42, out_path=str(tmp_path / "recs.png"))
    _assert_png(out)


def test_analyze_user_recommendations(tmp_path, small_model):
    _, _, data, params, _ = small_model
    raw_uid = int(data.user_ids[3])
    out = viz.analyze_user_recommendations(
        params, raw_uid, data, out_path=str(tmp_path / "analysis.png"),
        num_similar_users=10, num_top_movies=20)
    _assert_png(out)


def test_analyze_user_invalid_id(tmp_path, small_model):
    _, _, data, params, _ = small_model
    with pytest.raises(ValueError, match="Invalid user ID"):
        viz.analyze_user_recommendations(params, -999, data,
                                         out_path=str(tmp_path / "x.png"))
    with pytest.raises(ValueError, match="Invalid user ID"):
        viz.user_neighbourhood(params, -999, data)


def test_user_item_graph(tmp_path, small_model):
    pytest.importorskip("networkx")
    _, jp, _, params, (u, i) = small_model
    g = viz.create_user_item_graph(params.user_emb, params.item_emb,
                                   num_users=20, num_items=30, top_k=3)
    assert g.number_of_nodes() == 50
    assert all(g.degree(f"U{k}") == 3 for k in range(20))
    gj = jviz.create_user_item_graph(u, i, num_users=20, num_items=30, top_k=3)
    assert sorted(map(sorted, g.edges())) == sorted(map(sorted, gj.edges()))
    g_np = viz.create_user_item_graph(u, i, num_users=20, num_items=30, top_k=3)
    assert sorted(map(sorted, g_np.edges())) == sorted(map(sorted, g.edges()))
    out = viz.plot_user_item_graph(g, out_path=str(tmp_path / "graph.png"))
    _assert_png(out)


def test_user_item_graph_needs_networkx(monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "networkx", None)
    monkeypatch.setattr(viz, "_as_numpy", lambda x: calls.append(x))
    with pytest.raises(RuntimeError, match="networkx is not available"):
        viz.create_user_item_graph(np.zeros((3, 2)), np.zeros((4, 2)))
    assert calls == []      # raised before computing anything


def _cli_common(tmp_path):
    return ["--device", "cpu", "--dataset", "synthetic",
            "--synthetic-users", "60", "--synthetic-items", "90",
            "--synthetic-interactions", "2000",
            "--indexes-dir", str(tmp_path / "idx"),
            "--checkpoint", str(tmp_path / "model.npz"),
            "--histories-dir", str(tmp_path / "hist"),
            "--clusters", "2", "--epochs", "1", "--dim", "8", "--layers", "2"]


def test_cli_recommend_writes_plots(tmp_path, monkeypatch, capsys):
    """``recommend --plots`` renders both figures and ``train`` its history
    plot (JAX's test_cli_recommend_writes_plots); a silent "skipped" fails."""
    monkeypatch.chdir(tmp_path)
    common = _cli_common(tmp_path)
    assert tcli.main(common + ["train"]) == 0
    out = capsys.readouterr().out
    assert f"history plot: {tmp_path / 'hist' / 'histories_training.png'}" in out
    _assert_png(tmp_path / "hist" / "histories_training.png")
    rc = tcli.main(common + ["recommend", "--user-id", "1", "--top-k", "5", "--plots"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "plots skipped" not in out, out
    assert "bar chart: recommendations.png" in out and "analysis: user_analysis.png" in out
    _assert_png(tmp_path / "recommendations.png")
    _assert_png(tmp_path / "user_analysis.png")


def test_cli_plots_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for mod in NO_PLOTS:
        monkeypatch.setitem(sys.modules, mod, None)
    common = _cli_common(tmp_path)
    assert tcli.main(common + ["train"]) == 0
    out = capsys.readouterr().out
    assert "history plot skipped: plot_histories needs matplotlib" in out
    assert tcli.main(common + ["recommend", "--user-id", "1", "--plots"]) == 0
    out = capsys.readouterr().out
    assert "plots skipped: plot_recommendations needs matplotlib" in out
    assert not (tmp_path / "recommendations.png").exists()


def test_cli_plots_device_fault_fails_the_command(tmp_path, monkeypatch):
    """The analysis' device work runs outside the rendering's guard."""
    monkeypatch.chdir(tmp_path)
    common = _cli_common(tmp_path)
    assert tcli.main(common + ["train"]) == 0

    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(viz, "user_neighbourhood", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tcli.main(common + ["recommend", "--user-id", "1", "--plots"])


def _jax_stack(monkeypatch, tmp_path, jd, jp, raw_uid, k, m):
    """The stack JAX's analyze_user_recommendations projects: its selection."""
    seen = []

    def capture(x, **kw):
        seen.append(np.array(x))
        return np.zeros((x.shape[0], 2))

    monkeypatch.setattr(jviz, "_embed_2d", capture)
    jviz.analyze_user_recommendations(jp, raw_uid, jd, out_path=str(tmp_path / "j.png"),
                                      num_similar_users=k, num_top_movies=m)
    return seen[0]


def _rows_of(stack, table):
    return [int(np.flatnonzero((table == r).all(axis=1))[0]) for r in stack]


@pytest.mark.parametrize("user", [3, 0, 17])
def test_selection_matches_jax_without_the_user(user, tmp_path, monkeypatch, small_model):
    jd, jp, td, tp, (u, i) = small_model
    raw_uid, k, m = int(td.user_ids[user]), 10, 20
    stack_j = _jax_stack(monkeypatch, tmp_path, jd, jp, raw_uid, k, m)
    hood = viz.user_neighbourhood(tp, raw_uid, td, num_similar_users=k, num_top_movies=m)
    assert hood.user_index == user and hood.stack.shape == (1 + 2 * k + m, 8)
    sim_j = _rows_of(stack_j[1:1 + k], u)
    dis_j = _rows_of(stack_j[1 + k:1 + 2 * k], u)
    top_j = _rows_of(stack_j[1 + 2 * k:], i)
    assert hood.similar.tolist() == sim_j
    assert hood.top_movies.tolist() == top_j
    # C7: JAX's least similar users start with the user; the port's do not
    assert dis_j[0] == user
    assert hood.dissimilar.tolist()[:k - 1] == dis_j[1:]
    assert user not in hood.similar.tolist() + hood.dissimilar.tolist()
    np.testing.assert_array_equal(hood.stack[0], u[user])
    np.testing.assert_array_equal(hood.stack[1 + 2 * k:], stack_j[1 + 2 * k:])
    # scores ordered, best first (least similar first)
    for s, desc in ((hood.similar_scores, True), (hood.movie_scores, True),
                    (hood.dissimilar_scores, False)):
        assert torch.equal(s, torch.sort(s, descending=desc, stable=True).values)


def test_jax_fault_c7_user_is_its_own_first_dissimilar_user(tmp_path, monkeypatch,
                                                            small_model):
    """The reference fault: ``user_sims[uidx] = -inf`` and then the least
    similar users are taken in ascending order, so the user comes first."""
    jd, jp, td, _, (u, _) = small_model
    raw_uid, k = int(td.user_ids[3]), 25
    stack_j = _jax_stack(monkeypatch, tmp_path, jd, jp, raw_uid, k, 50)
    np.testing.assert_array_equal(stack_j[1 + k], u[3])
    np.testing.assert_array_equal(stack_j[0], u[3])


def test_selection_ties_are_stable():
    """Equal rows tie; a stable sort keeps the lower index first."""
    u = np.tile(np.array([[1.0, 0.0]], np.float32), (6, 1))
    u[5] = [0.0, 1.0]
    it = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    data = t_synthetic(6, 3, 30, seed=0)
    data.user_ids = np.arange(1, 7)
    hood = viz.user_neighbourhood(params_from_numpy(u, it, device="cpu"), 3, data,
                                  num_similar_users=3, num_top_movies=2)
    assert hood.user_index == 2
    assert hood.similar.tolist() == [0, 1, 3]
    assert hood.dissimilar.tolist() == [5, 0, 1]
    assert hood.top_movies.tolist() == [0, 1]


def test_embed_2d_matches_jax(small_model):
    _, _, _, _, (u, i) = small_model
    stack = np.concatenate([u[:26], i[:50]])
    np.testing.assert_array_equal(viz._embed_2d(stack), jviz._embed_2d(stack))


def test_embed_2d_pca_without_sklearn_matches_jax(small_model, monkeypatch):
    _, _, _, _, (u, i) = small_model
    stack = np.concatenate([u[:26], i[:50]])
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    xy = viz._embed_2d(stack)
    np.testing.assert_array_equal(xy, jviz._embed_2d(stack))
    assert xy.shape == (76, 2)


def test_module_imports_without_matplotlib(tmp_path, monkeypatch, small_model):
    for mod in NO_PLOTS + ("sklearn", "sklearn.manifold", "networkx", "umap"):
        monkeypatch.setitem(sys.modules, mod, None)
    name = "movie_recommender_system_with_gnns_tpu_torch.utils.visualizations"
    monkeypatch.delitem(sys.modules, name)
    fresh = importlib.import_module(name)
    _, _, data, params, _ = small_model
    hood = fresh.user_neighbourhood(params, int(data.user_ids[3]), data)
    assert hood.stack.shape == (101, 8)
    assert fresh._embed_2d(hood.stack).shape == (101, 2)      # PCA
    for call in (lambda: fresh.plot_histories(str(tmp_path)),
                 lambda: fresh.plot_recommendations([{"title": "a", "score": 1.0}], 1),
                 lambda: fresh.analyze_user_recommendations(params, int(data.user_ids[3]),
                                                            data),
                 lambda: fresh._render_analysis(hood, int(data.user_ids[3]))):
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    with pytest.raises(RuntimeError, match="networkx"):
        fresh.plot_user_item_graph(None)
