"""The compact trainer's frozen boundary correction in the port
(``training/compact.py::build_boundary_correction``,
``CompactClusters.with_correction`` and the corrected propagation, loss and
epochs) against the JAX package on the same numpy inputs, on the CPU: the
kernel wrappers take their plain versions there. The epochs replay the JAX
run's cluster order and negatives.

Tolerances: ``corr`` and ``neg_rest`` rtol 1e-5, atol 1e-6 in f32 (f32 sums
in another order; a correction term can cancel to near zero, hence the
absolute part); in bf16 one bf16 ulp of the larger value, or 1e-6 where that
is smaller (an f32 difference of 1e-8 rounds to neighbouring bf16 values).
The induction and the corrected loss at JAX's own tolerances
(``tests/test_compact.py:441``, ``:483``); an epoch's parameters, moments and
mean loss within 1e-5 (``tests/test_torch_compact.py``,
``tests/test_torch_lazy_adam.py``).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.ops import spmm as jspmm
from movie_recommender_system_with_gnns_tpu.training import compact as jcompact
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph
from movie_recommender_system_with_gnns_tpu_torch.data.partition import partition_assignments
from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_bpr
from movie_recommender_system_with_gnns_tpu_torch.ops import spmm as tspmm
from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import triplets_from_edges
from movie_recommender_system_with_gnns_tpu_torch.training import compact as tcompact
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

from torch_parity import (bf16_ulp, both_clusters, both_params, greedy_parts, jax_cluster,
                          jax_epoch_draws, to_np)

PARTS = 3
LAYERS, DIM = 2, 8


def _cfgs(model=None, **train):
    model = dict(dict(num_layers=LAYERS, dim=DIM), **(model or {}))
    train = dict(dict(lr=1e-2), **train)
    return (JConfig(model=JModel(**model), train=JTrain(**train)),
            TConfig(model=TModel(**model), train=TTrain(**train)))


def _both_hybrids(data, block_dtype="float32"):
    """The full train graph as both packages' HybridGraph (the correction's
    full-graph propagation), over the same node partition."""
    nu = data.num_users
    n = nu + data.num_items
    pu, pi = partition_assignments(data.edge_index, nu, n, PARTS)
    node_part = np.concatenate([pu, pi])
    hj = jspmm.build_hybrid_graph(data.edge_index, n, node_part, PARTS, align=8,
                                  block_dtype=jnp.dtype(block_dtype), ell_width=4)
    ht = tspmm.build_hybrid_graph(data.edge_index, n, node_part, PARTS, align=8,
                                  block_dtype=block_dtype, device="cpu")
    return hj, ht


def _setup(data, dense=None, seed=0):
    """(parts, JAX clusters, port clusters, JAX hybrid, port hybrid, JAX
    params, port params)."""
    parts = greedy_parts(data, PARTS)
    cj, ct = both_clusters(parts, data.num_users, dense=dense)
    hj, ht = _both_hybrids(data)
    pj, pt = both_params(data.num_users, data.num_items, DIM, seed=seed, std=0.1)
    return parts, cj, ct, hj, ht, pj, pt


def _assert_corr_close(a, b, dtype):
    a, b = to_np(a.float()), np.asarray(jnp.asarray(b).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    else:
        tol = np.maximum(bf16_ulp(np.maximum(np.abs(a), np.abs(b))), 1e-6)
        assert np.all(np.abs(a - b) <= tol), float(np.max(np.abs(a - b) - tol))


@pytest.mark.parametrize("corr_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["segment", "dense"])
def test_build_boundary_correction_matches_jax(tiny_data, path, corr_dtype):
    """``corr`` (K, L, n_local, d) and ``neg_rest`` (num_items, d) against
    JAX's ``build_boundary_correction`` from the same tables over the same
    hybrid graph, on the segment path and on dense bf16 adjacency blocks,
    in f32 and in bf16."""
    cfg_j, cfg_t = _cfgs()
    nu, ni = tiny_data.num_users, tiny_data.num_items
    _, cj, ct, hj, ht, pj, pt = _setup(tiny_data, None if path == "segment" else "bfloat16")
    corr_j, rest_j = jcompact.build_boundary_correction(pj, hj, cj, cfg_j, nu,
                                                        corr_dtype=corr_dtype)
    corr_t, rest_t = tcompact.build_boundary_correction(pt, ht, ct, cfg_t, nu,
                                                        corr_dtype=corr_dtype)
    n_local = ct.u_pad + ct.i_pad
    assert tuple(corr_t.shape) == (ct.num_clusters, LAYERS, n_local, DIM) == corr_j.shape
    assert tuple(rest_t.shape) == (ni, DIM) == rest_j.shape
    assert corr_t.dtype == rest_t.dtype == getattr(torch, corr_dtype)
    assert not corr_t.requires_grad and not rest_t.requires_grad
    _assert_corr_close(corr_t, corr_j, corr_dtype)
    _assert_corr_close(rest_t, rest_j, corr_dtype)
    # the correction is not trivial: the clusters miss inter-cluster messages
    assert np.abs(to_np(corr_t.float())).max() > 1e-3


def test_build_boundary_correction_with_bf16_compute_matches_jax(tiny_data):
    """With ``compute_dtype="bfloat16"`` each hop's source is rounded to bf16
    (the full-graph trainer's cast), the layers stay f32, as in JAX."""
    cfg_j, cfg_t = _cfgs(model=dict(compute_dtype="bfloat16"))
    _, cj, ct, hj, ht, pj, pt = _setup(tiny_data, seed=4)
    corr_j, rest_j = jcompact.build_boundary_correction(pj, hj, cj, cfg_j, tiny_data.num_users)
    corr_t, rest_t = tcompact.build_boundary_correction(pt, ht, ct, cfg_t, tiny_data.num_users)
    _assert_corr_close(corr_t, corr_j, "float32")
    _assert_corr_close(rest_t, rest_j, "float32")


@pytest.mark.parametrize("dense", [None, "float32", "bfloat16"])
def test_boundary_correction_reproduces_full_propagation(tiny_data, dense):
    """At frozen tables, the corrected compact propagation of every cluster
    equals the full-graph accumulator on the cluster's nodes, padding rows
    included (the induction in ``_propagate_local``): rtol 1e-4, atol 1e-6,
    as JAX's test; on the segment path and on dense f32 and bf16 blocks."""
    _, cfg = _cfgs()
    nu = tiny_data.num_users
    _, _, ct, _, ht, _, pt = _setup(tiny_data, dense)
    corr, _ = tcompact.build_boundary_correction(pt, ht, ct, cfg, nu)
    emb = torch.cat(list(pt))
    acc_full, x = emb, emb
    for _ in range(LAYERS):
        x = tspmm.spmm_hybrid(ht, x)
        acc_full = acc_full + x
    n_local = ct.u_pad + ct.i_pad
    worst = 0.0
    for c in range(ct.num_clusters):
        ids = torch.cat([ct.user_ids[c], ct.item_ids[c] + nu]).long()
        local = torch.cat([pt.user_emb[ct.user_ids[c].long()],
                           pt.item_emb[ct.item_ids[c].long()]])
        adj = None if ct.adj is None else ct.adj[c]
        hop = (local, ct.src[c], ct.dst[c], ct.w[c], adj, LAYERS, n_local)
        acc_c = tcompact._propagate_local(*hop, corr=corr[c], lists=ct.lists(c))
        np.testing.assert_allclose(to_np(acc_c), to_np(acc_full[ids]), rtol=1e-4, atol=1e-6)
        plain = tcompact._propagate_local(*hop, lists=ct.lists(c))
        worst = max(worst, float((plain - acc_full[ids]).abs().max()))
    # without the correction the clusters are far from the full graph
    assert worst > 1e-2


def test_boundary_correction_loss_closer_to_fullgraph(tiny_data):
    """At frozen tables the corrected cluster loss equals the loss of the same
    triplets under full-graph propagation (rtol 2e-4, atol 1e-6) and is closer
    to it than the uncorrected loss, as JAX's acceptance test; it also equals
    JAX's corrected cluster loss within 1e-5."""
    cfg_j, cfg_t = _cfgs()
    nu, ni = tiny_data.num_users, tiny_data.num_items
    n = nu + ni
    parts, cj, ct, hj, ht, pj, pt = _setup(tiny_data, seed=2)
    corr_j, rest_j = jcompact.build_boundary_correction(pj, hj, cj, cfg_j, nu)
    corr, neg_rest = tcompact.build_boundary_correction(pt, ht, ct, cfg_t, nu)
    full_graph = tspmm.DeviceCOO.from_host(COOGraph.build(tiny_data.edge_index, n), "cpu")
    rng = np.random.default_rng(100)
    worse = better = 0.0
    for c, part in enumerate(parts):
        batch = triplets_from_edges(part, nu, device="cpu")
        neg = rng.integers(0, ni, batch.user.shape[0]).astype(np.int32)
        loss_full = float(ttrain.compute_loss(pt, full_graph, batch, torch.from_numpy(neg),
                                              cfg_t))
        b_pad = ct.user_local.shape[1]
        neg_pad = np.concatenate([neg, np.zeros(b_pad - neg.shape[0], np.int32)])
        args = (pt, ct.cluster(c), torch.from_numpy(neg_pad), cfg_t, ct.u_pad, ct.i_pad)
        l_nocorr = float(tcompact.compact_cluster_loss(*args))
        l_corr = float(tcompact.compact_cluster_loss(*args, corr=corr[c], neg_rest=neg_rest))
        l_jax = float(jcompact.compact_cluster_loss(
            pj, jax_cluster(cj, c), jnp.asarray(neg_pad), cfg_j, cj.u_pad, cj.i_pad,
            corr=corr_j[c], neg_rest=rest_j))
        worse += abs(l_nocorr - loss_full)
        better += abs(l_corr - loss_full)
        np.testing.assert_allclose(l_corr, loss_full, rtol=2e-4, atol=1e-6)
        assert abs(l_corr - l_jax) < 1e-5
    assert better < worse


def _jax_state(optimizer, cfg_j, pj):
    if optimizer == "adam":
        opt = jtrain.make_optimizer(cfg_j)
        return jtrain.TrainState(pj, opt.init(pj), jnp.zeros((), jnp.int32))
    return jcompact.create_lazy_train_state(cfg_j, pj)


def _port_state(optimizer, cfg_t, pt):
    if optimizer == "adam":
        return ttrain.TrainState(pt, ttrain.make_optimizer(cfg_t).init(pt), 0)
    return tcompact.create_lazy_train_state(cfg_t, pt)


def _moments(st):
    ost = st.opt_state
    if isinstance(ost, (ttrain.AdamState, jcompact.LazyAdamState, tcompact.LazyAdamState)):
        return tuple(ost.mu) + tuple(ost.nu)
    adam = [s for s in jax.tree_util.tree_leaves(
        ost, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"][0]
    return tuple(adam.mu) + tuple(adam.nu)


@pytest.mark.parametrize("path", ["segment", "dense"])
@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam", "hybrid_adam", "lazy_item_adam"])
def test_corrected_compact_epoch_matches_jax(tiny_data, optimizer, path):
    """One corrected epoch (each package's own correction from the same
    tables) with the JAX run's cluster order and negatives: parameters, both
    moment tables and the mean loss within 1e-5, under each optimizer, on
    the segment path and on dense f32 blocks; and not the uncorrected
    epoch."""
    cfg_j, cfg_t = _cfgs(optimizer=optimizer, num_negatives=2)
    nu, ni = tiny_data.num_users, tiny_data.num_items
    _, cj, ct, hj, ht, pj, pt = _setup(tiny_data, None if path == "segment" else "float32",
                                       seed=5)
    cj = cj.with_correction(*jcompact.build_boundary_correction(pj, hj, cj, cfg_j, nu))
    ct = ct.with_correction(*tcompact.build_boundary_correction(pt, ht, ct, cfg_t, nu))
    k, b = ct.num_clusters, ct.user_local.shape[1]
    key = jax.random.PRNGKey(11)
    perm, neg = jax_epoch_draws(key, k, b, ni, 2)
    st_j, mean_j = jcompact.make_compact_epoch_fn(cfg_j)(_jax_state(optimizer, cfg_j, pj),
                                                         cj, key)
    fn = tcompact.make_compact_epoch_fn(cfg_t)
    draws = dict(perm=torch.from_numpy(perm.copy()), neg=torch.from_numpy(neg))
    st_t, mean_t = fn(_port_state(optimizer, cfg_t, pt), ct, None, **draws)
    assert abs(mean_t - float(mean_j)) < 1e-5
    assert st_t.step == k and st_t.opt_state.count == k
    for a, b_ in zip(tuple(st_t.params) + _moments(st_t),
                     tuple(st_j.params) + _moments(st_j)):
        np.testing.assert_allclose(to_np(a), to_np(b_), atol=1e-5, rtol=0)
    _, pt0 = both_params(nu, ni, DIM, seed=5, std=0.1)
    st_u, mean_u = fn(_port_state(optimizer, cfg_t, pt0),
                      dataclasses.replace(ct, corr=None, neg_rest=None), None, **draws)
    assert abs(mean_u - mean_t) > 1e-4


@pytest.mark.parametrize("optimizer", ["adam", "hybrid_adam"])
def test_fused_bpr_on_a_corrected_set_warns_and_takes_the_row_route(tiny_data, monkeypatch,
                                                                    optimizer):
    """``fused_bpr=True`` on a corrected set warns with JAX's words, once per
    epoch fn, never calls the fused kernel's wrapper, and gives the result of
    ``fused_bpr=False``; on an uncorrected set it still takes the kernel's
    route, without the warning."""
    cfg_j, cfg_t = _cfgs(optimizer=optimizer, fused_bpr=True)
    cfg_off = cfg_t.replace(train=dataclasses.replace(cfg_t.train, fused_bpr=False))
    nu, ni = tiny_data.num_users, tiny_data.num_items
    _, cj, ct, hj, ht, pj, pt = _setup(tiny_data, "float32", seed=6)
    ctc = ct.with_correction(*tcompact.build_boundary_correction(pt, ht, ct, cfg_t, nu))
    k, b = ct.num_clusters, ct.user_local.shape[1]
    key = jax.random.PRNGKey(3)
    perm, neg = jax_epoch_draws(key, k, b, ni, 1)
    draws = dict(perm=torch.from_numpy(perm.copy()), neg=torch.from_numpy(neg))
    # JAX's words: its corrected epoch under fused_bpr warns the same
    cjc = cj.with_correction(*jcompact.build_boundary_correction(pj, hj, cj, cfg_j, nu))
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        jcompact.make_compact_epoch_fn(cfg_j)(_jax_state(optimizer, cfg_j, pj), cjc, key)
    words = {str(w.message) for w in wj if "boundary correction" in str(w.message)}
    assert words == {tcompact.FUSED_CORRECTION_WARNING}

    real = cuda_bpr.fused_bpr_loss
    calls = []
    monkeypatch.setattr(cuda_bpr, "fused_bpr_loss",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    fn = tcompact.make_compact_epoch_fn(cfg_t)
    fresh = lambda: _port_state(optimizer, cfg_t, both_params(nu, ni, DIM, seed=6,
                                                              std=0.1)[1])
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        st_on, loss_on = fn(fresh(), ctc, None, **draws)
        fn(fresh(), ctc, None, **draws)
    assert [str(w.message) for w in wt] == [tcompact.FUSED_CORRECTION_WARNING]
    assert not calls
    st_off, loss_off = tcompact.make_compact_epoch_fn(cfg_off)(fresh(), ctc, None, **draws)
    assert loss_on == loss_off
    for a, b_ in zip(tuple(st_on.params) + _moments(st_on),
                     tuple(st_off.params) + _moments(st_off)):
        assert torch.equal(a, b_)
    with warnings.catch_warnings(record=True) as wu:
        warnings.simplefilter("always")
        fn(fresh(), ct, None, **draws)
    assert not wu and len(calls) == k


def test_with_correction_keeps_every_other_field(tiny_data):
    """``with_correction`` shares every other field (no table is copied) and
    carries the given tensors themselves; ``densify_adjacency`` and
    ``attach_member_table`` keep a correction."""
    _, cfg = _cfgs()
    nu = tiny_data.num_users
    _, _, ct, _, ht, _, pt = _setup(tiny_data)
    corr, neg_rest = tcompact.build_boundary_correction(pt, ht, ct, cfg, nu)
    cc = ct.with_correction(corr, neg_rest)
    assert cc is not ct and ct.corr is None and ct.neg_rest is None
    assert cc.corr is corr and cc.neg_rest is neg_rest
    for f in dataclasses.fields(ct):
        if f.name not in ("corr", "neg_rest"):
            assert getattr(cc, f.name) is getattr(ct, f.name), f.name
    dense = tcompact.densify_adjacency(cc, dtype="float32")
    member = tcompact.attach_member_table(cc, tiny_data.edge_index, nu)
    assert dense.corr is corr and member.corr is corr and member.neg_rest is neg_rest
    # a refresh keeps the shapes
    corr2, rest2 = tcompact.build_boundary_correction(
        type(pt)(*(t * 2 for t in pt)), ht, cc, cfg, nu)
    again = cc.with_correction(corr2, rest2)
    assert again.corr.shape == corr.shape and again.neg_rest.shape == neg_rest.shape
    assert not torch.equal(again.corr, corr)
