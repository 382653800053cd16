"""The full-graph trainer's microbatched loss in the port
(``training/train.py::compute_loss_grads_microbatched`` and its wiring in
``training/fullgraph.py``) against the JAX package on the same numpy inputs,
on the CPU: the kernel wrappers take their plain versions there. The epochs
replay the JAX run's permutation and negatives.

Tolerances: the loss within 1e-5 and the table gradients within 1e-4 of
their largest entry (``tests/test_torch_fullgraph.py``'s
``test_compute_loss_on_hybrid_matches_jax``); an epoch's parameters, moments
and mean loss within 1e-5 (``test_fullgraph_epoch_matches_jax``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.data.partition import partition_assignments
from movie_recommender_system_with_gnns_tpu.ops import spmm as jspmm
from movie_recommender_system_with_gnns_tpu.ops.sampling import TripletBatch as JBatch
from movie_recommender_system_with_gnns_tpu.training import fullgraph as jfg
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.ops import spmm as tspmm
from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import TripletBatch
from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph as tfg
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

from torch_parity import both_params, jax_fullgraph_draws, rel_err, to_np

PARTS = 4


def _cfgs(**train):
    model = dict(num_layers=2, dim=8)
    train = dict(dict(trainer="fullgraph", lr=1e-2, num_clusters=PARTS, fullgraph_steps=3,
                      hybrid_block_dtype="float32"), **train)
    return (JConfig(model=JModel(**model), train=JTrain(**train)),
            TConfig(model=TModel(**model), train=TTrain(**train)))


def _graph(data, asymmetric=False):
    """(edge_index, num_nodes, node_part): the whole doubled graph, or with a
    seeded quarter of its directed edges dropped (single directions, as the
    edge-level split leaves them)."""
    n = data.num_users + data.num_items
    e = data.edge_index
    if asymmetric:
        e = e[:, np.random.default_rng(5).random(e.shape[1]) > 0.25]
    pu, pi = partition_assignments(e, data.num_users, n, PARTS)
    return e, n, np.concatenate([pu, pi])


def _hybrids(data):
    e, n, node_part = _graph(data)
    hj = jspmm.build_hybrid_graph(e, n, node_part, PARTS, align=8,
                                  block_dtype=jnp.float32, ell_width=4)
    ht = tspmm.build_hybrid_graph(e, n, node_part, PARTS, align=8, block_dtype="float32",
                                  device="cpu")
    return hj, ht


def _batch(data, kneg, b=256, valid=200, seed=8):
    """A batch of ``b`` triplets with a masked tail (the last chunks of 16
    hold no real triplet), as numpy arrays."""
    rng = np.random.default_rng(seed)
    nu, ni = data.num_users, data.num_items
    user = rng.integers(0, nu, b).astype(np.int32)
    pos = rng.integers(0, ni, b).astype(np.int32)
    mask = np.arange(b) < valid
    neg = rng.integers(0, ni, (b,) if kneg == 1 else (b, kneg)).astype(np.int32)
    return user, pos, mask, neg


def _port_batch(user, pos, mask):
    return TripletBatch(torch.from_numpy(user), torch.from_numpy(pos), torch.from_numpy(mask))


@pytest.mark.parametrize("loss", ["reference", "standard"])
@pytest.mark.parametrize("kneg", [1, 4])
@pytest.mark.parametrize("num_micro", [1, 4, 16])
def test_microbatched_matches_jax(tiny_data, num_micro, kneg, loss):
    """Loss and table gradients of ``compute_loss_grads_microbatched``
    through the symmetric hybrid propagation, with injected negatives and a
    masked tail, against JAX's: |Δloss| < 1e-5, grad rel < 1e-4."""
    cfg_j, cfg_t = _cfgs(loss=loss)
    hj, ht = _hybrids(tiny_data)
    nu, ni = tiny_data.num_users, tiny_data.num_items
    user, pos, mask, neg = _batch(tiny_data, kneg)
    pj, pt = both_params(nu, ni, 8, seed=9, std=0.1)
    l_j, g_j = jtrain.compute_loss_grads_microbatched(
        pj, hj, JBatch(jnp.asarray(user), jnp.asarray(pos), jnp.asarray(mask)),
        jnp.asarray(neg), cfg_j, jspmm.spmm_hybrid_sym, num_micro)
    l_t, g_t = ttrain.compute_loss_grads_microbatched(
        pt, ht, _port_batch(user, pos, mask), torch.from_numpy(neg), cfg_t,
        tspmm.spmm_hybrid_sym, num_micro)
    assert abs(float(l_t) - float(l_j)) < 1e-5
    for a, b in zip(g_t, g_j):
        assert rel_err(a, b) < 1e-4
    # the tables are read, not changed, and the result holds no graph
    assert not l_t.requires_grad and not any(g.requires_grad for g in g_t)
    assert not pt.user_emb.requires_grad and pt.user_emb.grad is None


@pytest.mark.parametrize("spmm", ["sym", "transpose"])
@pytest.mark.parametrize("kneg", [1, 4])
def test_one_microbatch_matches_the_unmicrobatched_step(tiny_data, kneg, spmm):
    """At ``num_micro`` = 1 the function lies within 1e-6 relative of
    ``loss_and_grads(compute_loss, ...)`` (the chunk's loss is scaled by
    w / total_w = 1 up to rounding), through the symmetric VJP and through
    autograd over the remainder's transpose."""
    _, cfg = _cfgs(loss="standard")
    e, n, node_part = _graph(tiny_data, asymmetric=spmm == "transpose")
    h = tspmm.build_hybrid_graph(e, n, node_part, PARTS, align=8, block_dtype="float32",
                                 transpose=spmm == "transpose", device="cpu")
    fn = tspmm.spmm_hybrid_sym if spmm == "sym" else tspmm.spmm_hybrid
    user, pos, mask, neg = _batch(tiny_data, kneg, seed=3)
    _, pt = both_params(tiny_data.num_users, tiny_data.num_items, 8, seed=2, std=0.1)
    tb, neg = _port_batch(user, pos, mask), torch.from_numpy(neg)
    l_m, g_m = ttrain.compute_loss_grads_microbatched(pt, h, tb, neg, cfg, fn, 1)
    l_1, g_1 = ttrain.loss_and_grads(ttrain.compute_loss, pt, h, tb, neg, cfg, fn)
    assert abs(float(l_m) - float(l_1)) <= 1e-6 * abs(float(l_1))
    for a, b in zip(g_m, g_1):
        assert rel_err(a, b) <= 1e-6


def test_microbatches_must_divide_the_batch(tiny_data):
    """A count that does not divide the batch raises ``ValueError``, as in
    JAX (``training/train.py:151``)."""
    cfg_j, cfg_t = _cfgs()
    hj, ht = _hybrids(tiny_data)
    user, pos, mask, neg = _batch(tiny_data, 1)
    pj, pt = both_params(tiny_data.num_users, tiny_data.num_items, 8, seed=1)
    with pytest.raises(ValueError, match="must divide"):
        jtrain.compute_loss_grads_microbatched(
            pj, hj, JBatch(jnp.asarray(user), jnp.asarray(pos), jnp.asarray(mask)),
            jnp.asarray(neg), cfg_j, jspmm.spmm_hybrid_sym, 3)
    with pytest.raises(ValueError, match="loss_microbatches=3 must divide the padded "
                                         "batch 256"):
        ttrain.compute_loss_grads_microbatched(
            pt, ht, _port_batch(user, pos, mask), torch.from_numpy(neg), cfg_t,
            tspmm.spmm_hybrid_sym, 3)


def _jax_moments(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam[0].mu, adam[0].nu


@pytest.mark.parametrize("negatives,kneg", [("uniform", 1), ("popularity", 4)])
def test_microbatched_fullgraph_epoch_matches_jax(tiny_data, negatives, kneg):
    """One epoch with ``loss_microbatches=4`` from the permutation and
    negatives JAX's key draws: parameters, both Adam moments and the mean
    loss within 1e-5 of JAX's microbatched epoch fn (cosine schedule, the
    padding masked at the tail)."""
    cfg_j, cfg_t = _cfgs(negatives=negatives, num_negatives=kneg, lr_schedule="cosine",
                         lr_warmup_steps=1, lr_total_steps=6, loss="standard",
                         loss_microbatches=4)
    e, n, _ = _graph(tiny_data)
    nu, ni = tiny_data.num_users, tiny_data.num_items
    fj = jfg.build_fullgraph_data(cfg_j, e, nu, n)
    ft = tfg.build_fullgraph_data(cfg_t, e, nu, n, device="cpu")
    assert ft.num_steps * ft.batch > ft.e_real and ft.batch % 4 == 0
    pj, pt = both_params(nu, ni, 8, seed=10, std=0.1)
    key = jax.random.PRNGKey(12)
    perm, neg = jax_fullgraph_draws(key, fj.e_real, fj.num_steps, fj.batch, ni, kneg,
                                    fj.alias_table)
    opt = jtrain.make_optimizer(cfg_j)
    st_j, loss_j = jfg.make_fullgraph_epoch_fn(cfg_j, fj)(
        jtrain.TrainState(pj, opt.init(pj), jnp.zeros((), jnp.int32)), fj, key)
    st_t, loss_t = tfg.make_fullgraph_epoch_fn(cfg_t, ft)(
        ttrain.TrainState(pt, ttrain.make_optimizer(cfg_t).init(pt), 0), ft, None,
        perm=torch.from_numpy(perm.copy()), neg=torch.from_numpy(neg))
    assert st_t.step == ft.num_steps and st_t.opt_state.count == ft.num_steps
    np.testing.assert_allclose(loss_t, float(loss_j), atol=1e-5)
    mu_j, nu_j = _jax_moments(st_j.opt_state)
    for a, b in zip(st_t.params + st_t.opt_state.mu + st_t.opt_state.nu,
                    tuple(st_j.params) + tuple(mu_j) + tuple(nu_j)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-5, rtol=0)


def _copy(st):
    tables = lambda p: type(p)(*(t.clone() for t in p))
    return ttrain.TrainState(tables(st.params), ttrain.AdamState(
        st.opt_state.count, tables(st.opt_state.mu), tables(st.opt_state.nu)), st.step)


@pytest.mark.parametrize("micro", [0, 1])
def test_fullgraph_epoch_without_microbatches_is_the_unmicrobatched_path(tiny_data, micro):
    """At ``loss_microbatches`` 0 or 1 the epoch is ``torch.equal`` to the
    same epoch written out with ``loss_and_grads(compute_loss, ...)``, clip
    and Adam step by step: the microbatched function is not on its path."""
    _, cfg = _cfgs(negatives="popularity", num_negatives=2, loss_microbatches=micro)
    e, n, _ = _graph(tiny_data)
    nu, ni = tiny_data.num_users, tiny_data.num_items
    fg = tfg.build_fullgraph_data(cfg, e, nu, n, device="cpu")
    state = ttrain.create_train_state(cfg, nu, ni, device="cpu")
    gen = torch.Generator().manual_seed(6)
    perm = torch.randperm(fg.e_real, generator=gen)
    neg = torch.randint(0, ni, (fg.num_steps, fg.batch, 2), generator=gen, dtype=torch.int32)
    st_e, loss_e = tfg.make_fullgraph_epoch_fn(cfg, fg)(_copy(state), fg, None, perm=perm,
                                                        neg=neg)
    # the epoch by hand
    opt, spmm = ttrain.make_optimizer(cfg), tfg.fullgraph_spmm(cfg, fg)
    st = _copy(state)
    idx = torch.cat([perm.long(), torch.arange(fg.e_real, fg.num_steps * fg.batch)])
    u, p = (t[idx].view(fg.num_steps, fg.batch) for t in (fg.user, fg.pos_item))
    m = (idx < fg.e_real).view(fg.num_steps, fg.batch)
    wloss = torch.zeros(())
    for s in range(fg.num_steps):
        loss, grads = ttrain.loss_and_grads(ttrain.compute_loss, st.params, fg.hybrid,
                                            TripletBatch(u[s], p[s], m[s]), neg[s], cfg,
                                            spmm)
        params, ost = opt.update(st.params, grads, st.opt_state)
        st = ttrain.TrainState(params, ost, st.step + 1)
        wloss = wloss + loss * m[s].sum()
    assert loss_e == float(wloss / fg.e_real)
    for a, b in zip(st_e.params + st_e.opt_state.mu + st_e.opt_state.nu,
                    st.params + st.opt_state.mu + st.opt_state.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("split", ["interaction", "edge"])
def test_microbatched_step_bit_equal_over_two_runs(tiny_data, split):
    """A microbatched step (4 chunks) run twice from the same state, shuffle
    and negatives gives bit-equal parameters and moments, on the symmetric
    VJP and on the transposed backward."""
    _, cfg = _cfgs(hybrid_block_dtype="bfloat16", num_negatives=2, negatives="popularity",
                   loss_microbatches=4)
    e, n, _ = _graph(tiny_data, asymmetric=split == "edge")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fg = tfg.build_fullgraph_data(cfg, e, tiny_data.num_users, n, device="cpu")
    assert fg.symmetric_ok == (split == "interaction")
    one = tfg.FullGraphTrainData(fg.hybrid, fg.user[:fg.batch], fg.pos_item[:fg.batch],
                                 fg.batch, 1, fg.batch, fg.symmetric_ok,
                                 alias_table=fg.alias_table)
    state = ttrain.create_train_state(cfg, tiny_data.num_users, tiny_data.num_items,
                                      device="cpu")
    fn = tfg.make_fullgraph_epoch_fn(cfg, one)
    runs = [fn(_copy(state), one, torch.Generator().manual_seed(4)) for _ in range(2)]
    (a, la), (b, lb) = runs
    assert la == lb and np.isfinite(la)
    for x, y in zip(a.params + a.opt_state.mu + a.opt_state.nu,
                    b.params + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert not torch.equal(a.params.item_emb, state.params.item_emb)
