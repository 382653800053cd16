"""The compact trainer's lazy, hybrid and lazy-item Adam in the port against
the JAX package, on the same numpy inputs, with the cluster order and the
negatives that the JAX run drew handed to the port.

Tolerances: one row update within 1e-6 (f32 sums of repeated rows in another
order); an epoch's parameters, moments and mean loss within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, DataConfig as JData, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.models.lightgcn import LightGCNParams as JParams
from movie_recommender_system_with_gnns_tpu.training import compact as jcompact
from movie_recommender_system_with_gnns_tpu.training import pipeline as jpipe
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, DataConfig as TData, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.data.partition import (
    partition_edges_random)
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_scatter import sort_rows
from movie_recommender_system_with_gnns_tpu_torch.training import compact as tcompact
from movie_recommender_system_with_gnns_tpu_torch.training import pipeline as tpipe
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

from torch_parity import (both_clusters, both_params, greedy_parts, jax_epoch_draws,
                          to_np)

LAZY = ["lazy_adam", "hybrid_adam", "lazy_item_adam"]


def _cfgs(**train):
    model = dict(num_layers=2, dim=8)
    train = dict(dict(lr=1e-2), **train)
    return (JConfig(model=JModel(**model), train=JTrain(**train)),
            TConfig(model=TModel(**model), train=TTrain(**train)))


@pytest.mark.parametrize("case", ["repeated", "invalid", "clip"])
def test_lazy_row_update_matches_jax(case):
    """``_lazy_row_update`` on 40 rows of a 25-row table: ids that repeat
    (each repeat's delta from the same pre-state, the deltas added), padding
    slots masked out by ``valid`` that repeat a valid id, and a clip scale
    below 1. The port sums a repeated row's deltas over its run first."""
    rng = np.random.default_rng(0)
    rows_n, d, n = 25, 8, 40
    table = rng.standard_normal((rows_n, d)).astype(np.float32) * 0.1
    mu = rng.standard_normal((rows_n, d)).astype(np.float32) * 0.01
    nu = rng.random((rows_n, d)).astype(np.float32) * 1e-4
    g = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.ones(n, bool)
    if case == "invalid":
        rows = np.concatenate([rng.permutation(rows_n), np.full(n - rows_n, 7)])
        valid[rows_n:] = False
    else:
        rows = rng.integers(0, rows_n, n)
    rows = rows.astype(np.int32)
    assert case == "invalid" or len(np.unique(rows)) < n
    scale = 0.3 if case == "clip" else 1.0
    lr_t, b1, b2, eps = 1e-2 * np.sqrt(1 - 0.999 ** 3) / (1 - 0.9 ** 3), 0.9, 0.999, 1e-8
    out_j = jcompact._lazy_row_update(
        jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu), jnp.asarray(rows),
        jnp.asarray(g), jnp.asarray(valid), lr_t, b1, b2, eps, jnp.float32(scale))
    t = lambda a: torch.from_numpy(a.copy())
    idx = torch.from_numpy(rows)
    runs = None if case == "invalid" else tcompact._runs(idx, sort_rows(idx, rows_n))
    out_t = tcompact._lazy_row_update(
        t(table), t(mu), t(nu), idx, t(g), torch.from_numpy(valid), lr_t, b1, b2, eps,
        torch.tensor(scale), runs=runs)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-6, rtol=0)
    assert not np.array_equal(to_np(out_t[0]), table)


@pytest.mark.parametrize("case", ["segment", "dense_fused", "three_negatives", "cosine"])
@pytest.mark.parametrize("optimizer", LAZY)
def test_lazy_epoch_matches_jax(tiny_data, optimizer, case):
    """One epoch from the same tables with the JAX run's cluster order and
    negatives: parameters, both moment tables and the mean loss within 1e-5;
    ``cosine`` runs warmup and decay inside the epoch (the lr law at the
    count before the increment, as optax and the JAX epochs evaluate it)."""
    kw = dict(segment={}, dense_fused=dict(fused_bpr=True),
              three_negatives=dict(num_negatives=3),
              cosine=dict(lr_schedule="cosine", lr_warmup_steps=2, lr_total_steps=6,
                          lr_final_frac=0.1))[case]
    dense = "float32" if case == "dense_fused" else None
    cfg_j, cfg_t = _cfgs(optimizer=optimizer, **kw)
    # the JAX side of the fused case is its f32 row-gather route (its Pallas
    # kernel rounds to bf16; tests/test_torch_bpr.py holds the port to it)
    cfg_j = cfg_j.replace(train=JTrain(**dict(kw, lr=1e-2, optimizer=optimizer,
                                              fused_bpr=False)))
    nu, ni = tiny_data.num_users, tiny_data.num_items
    pj, pt = both_params(nu, ni, 8, seed=5, std=0.05)
    cj, ct = both_clusters(greedy_parts(tiny_data, 4), nu, dense=dense)
    k, b = ct.num_clusters, ct.user_local.shape[1]
    key = jax.random.PRNGKey(11)
    perm, neg = jax_epoch_draws(key, k, b, ni, cfg_j.train.num_negatives)
    u0 = to_np(pt.user_emb).copy()

    st_j, mean_j = jcompact.make_compact_epoch_fn(cfg_j)(
        jcompact.create_lazy_train_state(cfg_j, pj), cj, key)
    st_t, mean_t = tcompact.make_compact_epoch_fn(cfg_t)(
        tcompact.create_lazy_train_state(cfg_t, pt), ct, None,
        perm=torch.from_numpy(perm.copy()), neg=torch.from_numpy(neg))
    assert abs(mean_t - float(mean_j)) < 1e-5
    assert isinstance(st_t.opt_state, tcompact.LazyAdamState)
    assert st_t.step == k and st_t.opt_state.count == k == int(st_j.opt_state.count)
    for a, b_ in zip(st_t.params + st_t.opt_state.mu + st_t.opt_state.nu,
                     st_j.params + st_j.opt_state.mu + st_j.opt_state.nu):
        np.testing.assert_allclose(to_np(a), to_np(b_), atol=1e-5, rtol=0)
    assert not np.array_equal(to_np(st_t.params.user_emb), u0)


@pytest.mark.parametrize("optimizer", LAZY)
def test_lazy_epoch_fns_need_a_cosine_horizon(optimizer):
    """As in the JAX package, a cosine schedule without ``lr_total_steps``
    raises when the epoch fn is built."""
    for pkg, cfg in zip((jcompact, tcompact), _cfgs(optimizer=optimizer,
                                                   lr_schedule="cosine",
                                                   lr_total_steps=0)):
        with pytest.raises(ValueError, match="lr_total_steps"):
            pkg.make_compact_epoch_fn(cfg)


def test_lazy_state_bridges_match_jax():
    """From the same optax/Adam state after one step: ``lazy_state_from_optax``
    gives JAX's (mu, nu, count), ``lazy_state_to_optax`` gives back JAX's
    ``ScaleByAdamState`` fields, and the round trip returns the same tensors."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = both_params(30, 40, 8, seed=3)
    rng = np.random.default_rng(4)
    gu, gi = (rng.standard_normal(s).astype(np.float32) for s in ((30, 8), (40, 8)))
    opt_j = jtrain.make_optimizer(cfg_j)
    _, ost_j = opt_j.update(JParams(jnp.asarray(gu), jnp.asarray(gi)), opt_j.init(pj), pj)
    opt_t = ttrain.make_optimizer(cfg_t)
    _, ost_t = opt_t.update(pt, LightGCNParams(torch.from_numpy(gu), torch.from_numpy(gi)),
                            opt_t.init(pt))

    lz_j = jcompact.lazy_state_from_optax(ost_j)
    lz_t = tcompact.lazy_state_from_optax(ost_t)
    assert isinstance(lz_t, tcompact.LazyAdamState) and lz_t.count == int(lz_j.count) == 1
    for a, b in zip(lz_t.mu + lz_t.nu, lz_j.mu + lz_j.nu):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-7, rtol=1e-6)

    back_j = jcompact.lazy_state_to_optax(lz_j, jax.eval_shape(opt_j.init, pj))
    adam_j = [s for s in jax.tree_util.tree_leaves(
        back_j, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    back_t = tcompact.lazy_state_to_optax(lz_t)
    assert isinstance(back_t, ttrain.AdamState) and back_t.count == int(adam_j.count)
    for a, b in zip(back_t.mu + back_t.nu, adam_j.mu + adam_j.nu):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-7, rtol=1e-6)
    # round trip: a relabelling of the same tensors, both ways
    for x, y in zip(back_t.mu + back_t.nu, ost_t.mu + ost_t.nu):
        assert x is y
    again = tcompact.lazy_state_from_optax(back_t)
    assert again.count == lz_t.count and all(
        x is y for x, y in zip(again.mu + again.nu, lz_t.mu + lz_t.nu))
    with pytest.raises(ValueError, match="AdamState"):
        tcompact.lazy_state_from_optax(lz_t)


def test_adam_and_hybrid_epochs_bridge(tiny_data):
    """An Adam epoch, its state bridged into a hybrid epoch, then back into an
    Adam epoch (the JAX package's trainer-switch recipe): finite losses, the
    last below the first, one count carried through."""
    _, cfg_a = _cfgs()
    _, cfg_h = _cfgs(optimizer="hybrid_adam")
    nu, ni = tiny_data.num_users, tiny_data.num_items
    _, ct = both_clusters(greedy_parts(tiny_data, 2), nu)
    state = ttrain.create_train_state(cfg_a, nu, ni, device="cpu")
    fn_a, fn_h = (tcompact.make_compact_epoch_fn(c) for c in (cfg_a, cfg_h))
    gen = torch.Generator().manual_seed(0)
    state, l0 = fn_a(state, ct, gen)
    state = ttrain.TrainState(state.params, tcompact.lazy_state_from_optax(state.opt_state),
                              state.step)
    state, l1 = fn_h(state, ct, gen)
    state = ttrain.TrainState(state.params, tcompact.lazy_state_to_optax(state.opt_state),
                              state.step)
    state, l2 = fn_a(state, ct, gen)
    assert np.isfinite([l0, l1, l2]).all() and l2 < l0
    assert state.opt_state.count == state.step == 3 * ct.num_clusters


def test_hybrid_first_step_matches_adam_and_lazy_items(tiny_data):
    """One step from fresh moments on the same cluster and negatives: hybrid's
    item table equals Adam's (the same dense gradient and optax-form update;
    the clip norms sum in another order), and ``lazy_item_adam``'s two tables
    equal hybrid's at the JAX suite's rtol 1e-6 / atol 1e-7 (untouched rows
    have zero gradient and zero moments, so dense Adam leaves them too)."""
    nu, ni = tiny_data.num_users, tiny_data.num_items
    _, ct = both_clusters(greedy_parts(tiny_data, 3), nu)
    b = ct.user_local.shape[1]
    neg = torch.from_numpy(np.random.default_rng(12).integers(0, ni, (1, b)).astype(np.int32))
    out = {}
    for opt in ["adam"] + LAZY[1:]:
        _, cfg = _cfgs(optimizer=opt)
        _, pt = both_params(nu, ni, 8, seed=7, std=0.05)
        ost = (ttrain.make_optimizer(cfg).init(pt) if opt == "adam"
               else tcompact.init_lazy_adam(pt))
        out[opt], _ = tcompact.make_compact_epoch_fn(cfg)(
            ttrain.TrainState(pt, ost, 0), ct, None, perm=[1], neg=neg)
    item = lambda o: to_np(out[o].params.item_emb)
    assert np.abs(item("hybrid_adam") - item("adam")).max() <= 1e-6 * np.abs(item("adam")).max()
    for a, b_ in zip(out["lazy_item_adam"].params, out["hybrid_adam"].params):
        np.testing.assert_allclose(to_np(a), to_np(b_), rtol=1e-6, atol=1e-7)


def test_hybrid_needs_disjoint_users(tiny_data):
    """Random edge parts put a user in several clusters: hybrid (and
    lazy-item) Adam raise JAX's ``ValueError``; lazy Adam trains on them."""
    nu, ni = tiny_data.num_users, tiny_data.num_items
    parts = [p for p in partition_edges_random(tiny_data.edge_index, nu, 3, seed=0)
             if p.shape[1] > 0]
    ct = tcompact.build_compact_clusters(parts, nu, align=8, device="cpu")
    assert not ct.users_disjoint
    for opt in LAZY:
        _, cfg = _cfgs(optimizer=opt)
        state = tcompact.create_lazy_train_state(
            cfg, ttrain.create_train_state(cfg, nu, ni, device="cpu").params)
        fn = tcompact.make_compact_epoch_fn(cfg)
        if opt == "lazy_adam":
            assert np.isfinite(fn(state, ct, torch.Generator().manual_seed(0))[1])
        else:
            with pytest.raises(ValueError, match="disjoint per-cluster user sets"):
                fn(state, ct, torch.Generator().manual_seed(0))


def _pipeline_cfgs(tmp_path, **train):
    data = dict(dataset="synthetic", synthetic_users=60, synthetic_items=90,
                synthetic_interactions=2000)
    train = dict(dict(num_clusters=3, lr=1e-2), **train)
    model = dict(num_layers=2, dim=8)
    return (JConfig(data=JData(indexes_dir=str(tmp_path / "j"), **data),
                    model=JModel(**model), train=JTrain(**train)),
            TConfig(data=TData(indexes_dir=str(tmp_path / "t"), **data),
                    model=TModel(**model), train=TTrain(**train)))


@pytest.mark.parametrize("optimizer", ["hybrid_adam", "lazy_item_adam"])
def test_pipeline_refuses_hybrid_with_random_edges(tmp_path, optimizer):
    cfg_j, cfg_t = _pipeline_cfgs(tmp_path, optimizer=optimizer,
                                  partitioner="random_edges")
    for prepare in (jpipe.prepare_training_data,
                    lambda cfg: tpipe.prepare_training_data(cfg, device="cpu")):
        with pytest.raises(ValueError, match="requires the greedy node partitioner"):
            prepare(cfg_j if prepare is jpipe.prepare_training_data else cfg_t)


@pytest.mark.parametrize("optimizer", LAZY)
def test_train_model_with_lazy_optimizers(tmp_path, optimizer):
    """``train_model`` from an Adam state (fresh lazy moments swapped in, as
    the JAX loop does): the loss falls, the best-val checkpoint is written,
    the count advances one per step."""
    _, cfg = _pipeline_cfgs(tmp_path, optimizer=optimizer, fused_bpr=True, epochs=3,
                            dense_adjacency_max_nodes=4096)
    data, clusters, val, test = tpipe.prepare_training_data(cfg, device="cpu")
    state = ttrain.create_train_state(cfg, data.num_users, data.num_items, device="cpu")
    saved = []
    state, hist = ttrain.train_model(cfg, state, clusters, val, test,
                                     save_checkpoint=lambda st, r: saved.append(r))
    assert isinstance(state.opt_state, tcompact.LazyAdamState)
    steps = 3 * clusters.num_clusters
    assert state.step == state.opt_state.count == steps
    assert all(np.isfinite(v) for k in hist for v in hist[k])
    assert hist["train_loss"][-1] < hist["train_loss"][0] and saved


@pytest.mark.parametrize("optimizer", LAZY)
def test_cli_train_lazy_optimizers(tmp_path, capsys, optimizer):
    args = ["--device", "cpu", "--checkpoint", str(tmp_path / "m.npz"),
            "--histories-dir", str(tmp_path / "h"), "--dataset", "synthetic",
            "--synthetic-users", "80", "--synthetic-items", "120",
            "--synthetic-interactions", "3000", "--indexes-dir", str(tmp_path / "idx"),
            "--epochs", "2", "--dim", "8", "--layers", "2", "--clusters", "3",
            "train", "--optimizer", optimizer, "--fused-bpr"]
    assert tcli.main(args) == 0
    out = capsys.readouterr().out
    assert "Epoch: 001" in out and "Test Loss" in out
    assert (tmp_path / "m.npz").exists() and (tmp_path / "h" / "hist_train_loss.npy").exists()
