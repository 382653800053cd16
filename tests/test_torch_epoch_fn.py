"""The full-node trainer's fused epoch (``StackedClusters``, ``make_epoch_fn``)
of the port against the JAX package's on the same clusters, tables and draws:
the stack, two epochs from JAX's own order and negatives, the per-cluster
loop it replaces, and ``train_model``'s choice between the two. On the CPU
the epoch's step runs eagerly; on the card it is a captured CUDA graph,
which ``chip_smoke.py`` phase 5h holds against this eager route."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.training import pipeline as jpipe
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
from movie_recommender_system_with_gnns_tpu_torch.training import pipeline as tpipe
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

from torch_parity import both_params, greedy_parts, jax_epoch_draws, to_np

STACKED = ("src", "dst", "w", "user", "pos_item", "mask", "edge_counts")


def _cfgs(**train):
    model = dict(num_layers=2, dim=8)
    train = dict(dict(lr=1e-2), **train)
    return (JConfig(model=JModel(**model), train=JTrain(**train)),
            TConfig(model=TModel(**model), train=TTrain(**train)))


def _batches(data, num_parts=4, shared_shape=True):
    """Both packages' cluster batches of the same greedy parts."""
    n = data.num_users + data.num_items
    parts = greedy_parts(data, num_parts)
    kw = dict(bucket_floor=64, shared_shape=shared_shape)
    return (jpipe.build_cluster_batches(parts, data.num_users, n, **kw),
            tpipe.build_cluster_batches(parts, data.num_users, n, device="cpu", **kw))


def _jax_adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _state(cfg, params):
    return ttrain.TrainState(params, ttrain.make_optimizer(cfg).init(params), 0)


def _copy(st):
    tables = lambda p: LightGCNParams(*(t.clone() for t in p))
    ost = st.opt_state
    return ttrain.TrainState(tables(st.params), ttrain.AdamState(
        ost.count, tables(ost.mu), tables(ost.nu)), st.step)


def _leaves(st):
    return list(st.params) + list(st.opt_state.mu) + list(st.opt_state.nu)


def _assert_leaves_close(got, ref, tol):
    """The tables within ``tol``; each Adam moment within ``tol`` times its
    own largest entry, so that the second moments (about ``(1-b2)·g²``, far
    below ``tol``) are checked in their own right."""
    for i, (a, r) in enumerate(zip(got, ref)):
        r = np.asarray(to_np(r))
        scale = 1.0 if i < 2 else float(np.abs(r).max())
        np.testing.assert_allclose(to_np(a), r, atol=tol * scale, rtol=0)


def test_stacked_clusters_match_jax(tiny_data):
    """Every stacked array equal to JAX's, the edge counts, the node and
    cluster counts; the stacked row runs are each cluster's own; clusters of
    several padded shapes raise ValueError in both packages."""
    jb, tb = _batches(tiny_data)
    sj, st = jtrain.StackedClusters.from_batches(jb), ttrain.StackedClusters.from_batches(tb)
    for f in STACKED:
        np.testing.assert_array_equal(to_np(getattr(st, f)), to_np(getattr(sj, f)))
    assert st.edge_counts.dtype == torch.float32
    assert (st.num_nodes, st.num_clusters) == (sj.num_nodes, sj.num_clusters) == (
        tiny_data.num_users + tiny_data.num_items, len(tb))
    e_pad = st.src.shape[1]
    assert torch.equal(st.order, torch.arange(e_pad, dtype=torch.int32))
    for c, cb in enumerate(tb):
        for f in ("starts", "src_order", "src_starts"):
            assert torch.equal(getattr(st, f)[c], getattr(cb.graph, f))
        graph, batch = st.cluster(torch.tensor([c]))
        for f in ("src", "dst", "w", "order", "starts", "src_order", "src_starts"):
            assert torch.equal(getattr(graph, f), getattr(cb.graph, f))
        for a, b in zip(batch, cb.batch):
            assert torch.equal(a, b)
    # graphs without row runs stack without them
    bare = [ttrain.ClusterBatch(dataclasses.replace(
        cb.graph, order=None, starts=None, src_order=None, src_starts=None),
        cb.batch, cb.num_edges) for cb in tb]
    assert ttrain.StackedClusters.from_batches(bare).starts is None
    jd, td = _batches(tiny_data, shared_shape=False)
    assert len({cb.graph.src.shape for cb in td}) > 1
    for stack, batches in ((jtrain.StackedClusters.from_batches, jd),
                           (ttrain.StackedClusters.from_batches, td)):
        with pytest.raises(ValueError, match="share one padded shape"):
            stack(batches)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("kneg", [1, 4])
def test_epoch_fn_matches_jax(tiny_data, kneg, schedule):
    """Two epochs from the order and negatives JAX's keys draw: tables within
    1e-5 of JAX's ``make_epoch_fn``, each Adam moment within 1e-5 of its
    largest entry, the count equal, the mean losses within rtol 1e-5."""
    cfg_j, cfg_t = _cfgs(num_negatives=kneg, lr_schedule=schedule, lr_warmup_steps=2,
                         lr_total_steps=8)
    jb, tb = _batches(tiny_data)
    sj, st = jtrain.StackedClusters.from_batches(jb), ttrain.StackedClusters.from_batches(tb)
    k, b = st.num_clusters, st.user.shape[1]
    nu, ni = tiny_data.num_users, tiny_data.num_items
    pj, pt = both_params(nu, ni, 8, seed=3, std=0.05)
    opt = jtrain.make_optimizer(cfg_j)
    state_j = jtrain.TrainState(pj, opt.init(pj), jnp.zeros((), jnp.int32))
    state_t = _state(cfg_t, pt)
    epoch_j, epoch_t = jtrain.make_epoch_fn(cfg_j), ttrain.make_epoch_fn(cfg_t)
    for key in (jax.random.PRNGKey(21), jax.random.PRNGKey(22)):
        perm, neg = jax_epoch_draws(key, k, b, ni, kneg)
        state_j, loss_j = epoch_j(state_j, sj, key)
        state_t, loss_t = epoch_t(state_t, st, None, perm=torch.from_numpy(perm.copy()),
                                  neg=torch.from_numpy(neg))
        np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
        adam = _jax_adam(state_j.opt_state)
        _assert_leaves_close(_leaves(state_t), tuple(state_j.params) + tuple(adam.mu)
                             + tuple(adam.nu), 1e-5)
    assert state_t.opt_state.count == int(_jax_adam(state_j.opt_state).count) == 2 * k
    assert state_t.step == int(state_j.step) == 2 * k


@pytest.mark.parametrize("kneg", [1, 4])
def test_epoch_fn_equals_the_cluster_loop(tiny_data, kneg):
    """The fused epoch with injected draws against ``train_epoch`` driven
    step by step over the same order and negatives (``make_train_step``,
    ``make_optimizer``'s scalar Adam): tables and loss within 1e-6, each
    moment within 1e-6 of its largest entry; the generator, when it draws,
    is read only at the epoch's start."""
    _, cfg = _cfgs(num_negatives=kneg)
    _, tb = _batches(tiny_data)
    st = ttrain.StackedClusters.from_batches(tb)
    k, b = st.num_clusters, st.user.shape[1]
    ni = tiny_data.num_items
    _, pt = both_params(tiny_data.num_users, ni, 8, seed=4, std=0.05)
    s0 = _state(cfg, pt)
    gen = torch.Generator().manual_seed(7)
    perm = torch.randperm(k, generator=gen)
    neg = ttrain.sample_negative(gen, k * b, ni, kneg).view((k, b) if kneg == 1 else (k, b, kneg))
    after = gen.get_state()

    fused, loss_f = ttrain.make_epoch_fn(cfg)(_copy(s0), st, torch.Generator().manual_seed(7))
    drawn, _ = ttrain.make_epoch_fn(cfg)(_copy(s0), st, None, perm=perm, neg=neg)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(fused), _leaves(drawn)))

    negs = iter(neg)
    train_step = ttrain.make_train_step(cfg)
    step = lambda s, g, bt, gen_: train_step(s, g, bt, None, neg=next(negs))
    loop, loss_l = ttrain.train_epoch(_copy(s0), [tb[int(c)] for c in perm], step, None,
                                      shuffle=False)
    np.testing.assert_allclose(loss_f, loss_l, rtol=1e-6)
    _assert_leaves_close(_leaves(fused), _leaves(loop), 1e-6)
    assert (fused.opt_state.count, fused.step) == (loop.opt_state.count, loop.step) == (k, k)
    # the fused epoch read its generator for the order and the negatives only
    gen2 = torch.Generator().manual_seed(7)
    ttrain.make_epoch_fn(cfg)(_copy(s0), st, gen2)
    assert torch.equal(gen2.get_state(), after)


def test_epoch_fn_runs_on_cpu_and_cuda_only(tiny_data):
    """The fused epoch takes its eager route only for tensors on the CPU; a
    stack on another device raises rather than running the steps there."""
    _, cfg = _cfgs()
    _, tb = _batches(tiny_data)
    st = ttrain.StackedClusters.from_batches(tb)
    meta = dataclasses.replace(st, src=st.src.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ttrain.make_epoch_fn(cfg)(None, meta, None)


@pytest.mark.parametrize("shared_shape", [True, False])
def test_train_model_routes_like_jax(tiny_data, monkeypatch, shared_shape):
    """``train_model`` takes the fused epoch for cluster batches of one
    padded shape and the per-cluster loop otherwise, as JAX's does."""
    cfg_j, cfg_t = _cfgs(epochs=1, eval_top_k=5)
    jb, tb = _batches(tiny_data, shared_shape=shared_shape)
    routes = {}
    for pkg, batches, cfg in ((jtrain, jb, cfg_j), (ttrain, tb, cfg_t)):
        seen = []
        for name in ("make_epoch_fn", "train_epoch"):
            real = getattr(pkg, name)
            monkeypatch.setattr(pkg, name, lambda *a, _n=name, _r=real, **kw: (
                seen.append(_n), _r(*a, **kw))[1])
        if pkg is jtrain:
            state = jtrain.create_train_state(cfg, tiny_data.num_users, tiny_data.num_items)
            graph_j = jb[0].graph, jb[0].batch
            pkg.train_model(cfg, state, batches, graph_j, graph_j)
        else:
            state = ttrain.create_train_state(cfg, tiny_data.num_users, tiny_data.num_items,
                                              device="cpu")
            graph_t = tb[0].graph, tb[0].batch
            pkg.train_model(cfg, state, batches, graph_t, graph_t)
        routes[pkg.__name__.split(".")[0]] = sorted(set(seen))
    assert routes["movie_recommender_system_with_gnns_tpu"] == \
        routes["movie_recommender_system_with_gnns_tpu_torch"] == \
        (["make_epoch_fn"] if shared_shape else ["train_epoch"])


@pytest.mark.parametrize("fault", ["adam_step_table_", "compute_loss"])
def test_epoch_fn_reaches_adam_and_loss_through_train_globals(tiny_data, monkeypatch, fault):
    """The fused epoch looks Adam's body and its loss up in
    ``training/train.py``'s globals at every step, where the benchmark's
    faults swap them (``benchmark/faults.py``): with ``adam_step_table_`` a
    no-op an epoch leaves the tables and moments as they were; a wrapped
    ``compute_loss`` is called once a step, and the epoch trains."""
    _, cfg = _cfgs()
    _, tb = _batches(tiny_data)
    st = ttrain.StackedClusters.from_batches(tb)
    _, pt = both_params(tiny_data.num_users, tiny_data.num_items, 8, seed=5, std=0.05)
    s0 = _state(cfg, pt)
    epoch_fn = ttrain.make_epoch_fn(cfg)
    calls = []
    if fault == "adam_step_table_":
        monkeypatch.setattr(ttrain, fault, lambda *a, **kw: None)
    else:
        real = ttrain.compute_loss
        monkeypatch.setattr(ttrain, fault, lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    out, _ = epoch_fn(_copy(s0), st, torch.Generator().manual_seed(3))
    moved = [not torch.equal(a, b) for a, b in zip(_leaves(out), _leaves(s0))]
    if fault == "adam_step_table_":
        assert not any(moved) and not calls
    else:
        assert len(calls) == st.num_clusters and all(moved)
