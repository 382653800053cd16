"""The full-graph trainer of the port (``ops/spmm.py``'s hybrid propagation and
symmetric VJP, the ELL SpMM kernel's transposed backward, the popularity
law of ``ops/sampling.py``, ``training/fullgraph.py`` and its wiring)
against the JAX package on the same numpy inputs, on the CPU: the kernel
wrappers take their plain versions there. Random streams differ between the
two frameworks, so the epochs replay the JAX run's permutation and negatives,
and the sampler is tested by its law.
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
from movie_recommender_system_with_gnns_tpu.ops import sampling as jsampling
from movie_recommender_system_with_gnns_tpu.ops import spmm as jspmm
from movie_recommender_system_with_gnns_tpu.ops.sampling import TripletBatch as JBatch
from movie_recommender_system_with_gnns_tpu.training import fullgraph as jfg
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, DataConfig as TData, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.data import graph as tgraph
from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_spmm
from movie_recommender_system_with_gnns_tpu_torch.ops import sampling as tsampling
from movie_recommender_system_with_gnns_tpu_torch.ops import spmm as tspmm
from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import TripletBatch
from movie_recommender_system_with_gnns_tpu_torch.training import compact as tcompact
from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph as tfg
from movie_recommender_system_with_gnns_tpu_torch.training import pipeline as tpipe
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

from torch_parity import both_params, jax_fullgraph_draws, rel_err, to_np

PARTS = 4


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


def _both_hybrids(e, n, node_part, block_dtype="float32", off_format="ell", **kw):
    hj = jspmm.build_hybrid_graph(e, n, node_part, PARTS, align=8,
                                  block_dtype=jnp.dtype(block_dtype),
                                  off_format=off_format, ell_width=4)
    ht = tspmm.build_hybrid_graph(e, n, node_part, PARTS, align=8, block_dtype=block_dtype,
                                  off_format=off_format, device="cpu", **kw)
    return hj, ht


def _table(n, d, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _remainder_jax(hj, n):
    """JAX's remainder edges as sorted (dst, src, w) rows."""
    if hj.off_ell is not None:
        c = hj.off_ell
        nbr, w = np.asarray(c.nbr), np.asarray(c.w)
        dst = np.broadcast_to(np.asarray(c.dst)[:, None], nbr.shape)
        live = nbr != c.num_src
        rows = np.stack([dst[live], nbr[live], w[live]], 1)
    else:
        src, dst, w = (np.asarray(a) for a in (hj.off.src, hj.off.dst, hj.off.w))
        rows = np.stack([dst, src, w], 1)[w != 0]
    return rows[np.lexsort(rows.T[::-1])]


def _remainder_port(ht, n):
    """The port's remainder edges as sorted (dst, src, w) rows."""
    if ht.off_ell is not None:
        parts = []
        for b in ht.off_ell.blocks:
            nbr, w = b.nbr.numpy(), b.w.numpy()
            dst = np.broadcast_to(b.node_ids.numpy()[:, None], nbr.shape)
            live = nbr != n
            parts.append(np.stack([dst[live], nbr[live], w[live]], 1))
        rows = np.concatenate(parts)
    else:
        rows = np.stack([ht.off.dst.numpy(), ht.off.src.numpy(), ht.off.w.numpy()], 1)
        rows = rows[rows[:, 2] != 0]
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("off_format", ["ell", "coo"])
@pytest.mark.parametrize("block_dtype", ["float32", "bfloat16"])
def test_build_hybrid_graph_matches_jax(tiny_data, block_dtype, off_format):
    """ids, pos and cov equal JAX's; adj equals it exactly (each cell holds
    one edge's weight, rounded once to the block type); the remainder's
    (src, dst, w) multiset equals JAX's (its chunked ELL's, or its COO's)."""
    e, n, node_part = _graph(tiny_data)
    hj, ht = _both_hybrids(e, n, node_part, block_dtype, off_format)
    for f in ("ids", "pos", "cov"):
        np.testing.assert_array_equal(to_np(getattr(ht, f)), np.asarray(getattr(hj, f)))
    assert ht.adj.dtype == getattr(torch, block_dtype)
    np.testing.assert_array_equal(to_np(ht.adj.float()), np.asarray(hj.adj.astype(jnp.float32)))
    rj, rt = _remainder_jax(hj, n), _remainder_port(ht, n)
    assert len(rt) > 0 and len(rj) == len(rt)
    np.testing.assert_array_equal(rt, rj)
    if off_format == "coo":
        np.testing.assert_array_equal(to_np(ht.off.dst), np.asarray(hj.off.dst))
    assert ht.off_ell_t is None


@pytest.mark.parametrize("block_dtype,off_format,table", [
    ("float32", "ell", "float32"), ("float32", "coo", "float32"),
    ("bfloat16", "ell", "float32"), ("bfloat16", "coo", "float32"),
    ("float32", "ell", "bfloat16"), ("bfloat16", "ell", "bfloat16")])
def test_spmm_hybrid_matches_jax(tiny_data, block_dtype, off_format, table):
    """``spmm_hybrid`` against JAX's with its chunked-ELL remainder, an f32
    result: rtol 1e-5, atol 1e-6 with either block type. bf16 blocks keep the
    same bound: both packages round the same operands to bf16 the same way,
    and their products are exact in f32, so only the f32 summation order
    differs. A bf16 table is read in f32 by the remainder, as JAX's einsum
    promotes it."""
    e, n, node_part = _graph(tiny_data)
    hj, ht = _both_hybrids(e, n, node_part, block_dtype, off_format)
    hj_ell = hj if off_format == "ell" else _both_hybrids(e, n, node_part, block_dtype)[0]
    x = _table(n, 16)
    xj = jnp.asarray(x).astype(jnp.dtype(table))
    xt = torch.from_numpy(x).to(getattr(torch, table))
    a = np.asarray(jspmm.spmm_hybrid(hj_ell, xj))
    b = tspmm.spmm_hybrid(ht, xt)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(to_np(b), a, rtol=1e-5, atol=1e-6)
    # and the f32 hybrid equals the segment-sum propagation of the whole graph
    if block_dtype == table == "float32":
        full = tspmm.DeviceCOO.from_host(tgraph.COOGraph.build(e, n), "cpu")
        np.testing.assert_allclose(to_np(b), to_np(tspmm.spmm_segment(full, xt)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("block_dtype,off_format", [
    ("float32", "ell"), ("float32", "coo"), ("bfloat16", "ell"), ("bfloat16", "coo")])
def test_spmm_hybrid_sym_grad_matches_autodiff_and_jax(tiny_data, block_dtype, off_format):
    """The symmetric VJP's gradient against autodiff through ``spmm_hybrid``
    and against JAX's ``spmm_hybrid_sym`` gradient: rel < 1e-5 (the JAX
    suite's bound, tests/test_fullgraph.py:54)."""
    e, n, node_part = _graph(tiny_data)
    hj, ht = _both_hybrids(e, n, node_part, block_dtype, off_format)
    x, cot = _table(n, 16, 1), _table(n, 16, 2)
    _, vjp_j = jax.vjp(lambda v: jspmm.spmm_hybrid_sym(hj, v), jnp.asarray(x))
    (g_j,) = vjp_j(jnp.asarray(cot))
    grads = []
    for fn in (tspmm.spmm_hybrid_sym, tspmm.spmm_hybrid):
        xt = torch.from_numpy(x).requires_grad_(True)
        (g,) = torch.autograd.grad(fn(ht, xt), xt, torch.from_numpy(cot))
        grads.append(g)
    assert rel_err(grads[0], grads[1]) < 1e-5
    assert rel_err(grads[0], g_j) < 1e-5


def test_spmm_segment_sym_grad_matches_autodiff(tiny_data):
    e, n, _ = _graph(tiny_data)
    coo = tspmm.DeviceCOO.from_host(tgraph.COOGraph.build(e, n), "cpu")
    x, cot = _table(n, 8, 3), _table(n, 8, 4)
    grads = []
    for fn in (tspmm.spmm_segment_sym, tspmm.spmm_segment):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = fn(coo, xt)
        np.testing.assert_allclose(to_np(out), to_np(tspmm.spmm_segment(coo, xt)), rtol=1e-6)
        grads.append(torch.autograd.grad(out, xt, torch.from_numpy(cot))[0])
    assert rel_err(grads[0], grads[1]) < 1e-5


@pytest.mark.parametrize("d", [8, 16])
def test_transposed_backward_matches_autodiff(tiny_data, d):
    """On an asymmetric graph: the ELL op's backward over the transpose
    equals autodiff through the plain ``spmm_ell``, and the hybrid
    propagation built with ``transpose=True`` differentiates like
    ``spmm_segment`` of the whole graph (rel < 1e-5)."""
    e, n, node_part = _graph(tiny_data, asymmetric=True)
    assert not tgraph.adjacency_is_symmetric(e, n)
    x, cot = _table(n, d, 6), torch.from_numpy(_table(n, d, 7))
    ell = tspmm.DeviceELL.from_host(tgraph.EllGraph.build(e, n), "cpu")
    ell_t = tspmm.DeviceELL.from_host(
        tgraph.EllGraph.build(e[::-1], n, weights=tgraph.gcn_norm(e, n)), "cpu")
    grads = []
    for fn in (lambda v: cuda_spmm.spmm_ell_cuda(ell, v, transpose=ell_t),
               lambda v: tspmm.spmm_ell(ell, v)):
        xt = torch.from_numpy(x).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xt), xt, cot)[0])
    assert rel_err(grads[0], grads[1]) < 1e-5

    _, ht = _both_hybrids(e, n, node_part, transpose=True)
    assert ht.off_ell_t is not None
    full = tspmm.DeviceCOO.from_host(tgraph.COOGraph.build(e, n), "cpu")
    grads = []
    for fn in (lambda v: tspmm.spmm_hybrid(ht, v), lambda v: tspmm.spmm_segment(full, v)):
        xt = torch.from_numpy(x).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xt), xt, cot)[0])
    assert rel_err(grads[0], grads[1]) < 1e-5
    # the symmetric VJP would be wrong here: the transposed backward is needed
    xt = torch.from_numpy(x).requires_grad_(True)
    g_sym = torch.autograd.grad(tspmm.spmm_hybrid_sym(ht, xt), xt, cot)[0]
    assert rel_err(g_sym, grads[1]) > 1e-3


def test_ell_weights_override_gcn_norm(tiny_graph):
    """``EllGraph.build(weights=)`` keeps the given weights, edge for edge;
    the default stays ``gcn_norm`` of the given edges."""
    e, n = tiny_graph
    half = e[:, ::2]
    w = np.random.default_rng(0).random(half.shape[1]).astype(np.float32)
    x = torch.from_numpy(_table(n, 4))
    got = tspmm.spmm_ell(tspmm.DeviceELL.from_host(
        tgraph.EllGraph.build(half, n, weights=w), "cpu"), x)
    coo = tgraph.COOGraph.build(half, n)
    order = np.argsort(half[1], kind="stable")
    coo_w = tspmm.DeviceCOO(torch.from_numpy(coo.src), torch.from_numpy(coo.dst),
                            torch.from_numpy(np.concatenate(
                                [w[order], np.zeros(len(coo.w) - len(w), np.float32)])), n)
    np.testing.assert_allclose(to_np(got), to_np(tspmm.spmm_segment(coo_w, x)),
                               rtol=1e-5, atol=1e-6)
    default = tgraph.EllGraph.build(half, n)
    again = tgraph.EllGraph.build(half, n, weights=tgraph.gcn_norm(half, n))
    for a, b in zip(default.blocks, again.blocks):
        np.testing.assert_array_equal(a.w, b.w)
    with pytest.raises(ValueError, match="weights must be"):
        tgraph.EllGraph.build(half, n, weights=w[:-1])


# --- the popularity law ----------------------------------------------------


@pytest.mark.parametrize("power", [0.0, 0.75, 1.0])
def test_alias_table_matches_jax(tiny_data, power):
    """``item_popularity`` and ``build_alias_table`` equal JAX's element for
    element, also for an all-zero count array (the uniform law)."""
    nu, ni = tiny_data.num_users, tiny_data.num_items
    counts = tsampling.item_popularity(tiny_data.edge_index, nu, ni)
    np.testing.assert_array_equal(counts, jsampling.item_popularity(tiny_data.edge_index, nu, ni))
    for c in (counts, np.zeros_like(counts)):
        for a, b in zip(tsampling.build_alias_table(c, power),
                        jsampling.build_alias_table(c, power)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num", [1, 4])
def test_sample_negative_alias_law(tiny_data, num):
    """The draws follow count^0.75 / Σ within 0.01 (tests/test_fullgraph.py's
    bound) and are the same for the same generator."""
    nu, ni = tiny_data.num_users, tiny_data.num_items
    counts = tsampling.item_popularity(tiny_data.edge_index, nu, ni)
    prob, alias = (torch.from_numpy(a) for a in tsampling.build_alias_table(counts, 0.75))
    draw = lambda: tsampling.sample_negative_alias(
        torch.Generator().manual_seed(3), 100_000 // num, ni, prob, alias, num=num)
    neg = draw()
    assert neg.dtype == torch.int32 and neg.shape == ((100_000,) if num == 1 else (25_000, 4))
    emp = np.bincount(to_np(neg).reshape(-1), minlength=ni) / neg.numel()
    w = counts.astype(np.float64) ** 0.75
    assert np.abs(emp - w / w.sum()).max() < 0.01
    assert torch.equal(neg, draw())


def test_negatives_modes():
    """Every law runs: uniform, popularity and feasible; others raise."""
    tsampling.check_negatives_mode("popularity")
    tsampling.check_negatives_mode("uniform")
    tsampling.check_negatives_mode("feasible")
    with pytest.raises(ValueError, match="unknown negatives"):
        tsampling.check_negatives_mode("hard")


# --- training/fullgraph.py -------------------------------------------------


def _cfgs(**train):
    model = dict(num_layers=2, dim=8)
    train = dict(dict(trainer="fullgraph", lr=1e-2, num_clusters=PARTS, fullgraph_steps=3,
                      hybrid_block_dtype="float32"), **train)
    return (JConfig(model=JModel(**model), train=JTrain(**train)),
            TConfig(model=TModel(**model), train=TTrain(**train)))


@pytest.mark.parametrize("case", ["interaction", "edge", "batch_size", "popularity",
                                  "feasible"])
def test_build_fullgraph_data_matches_jax(tiny_data, case):
    """batch, num_steps, e_real, the padded user / pos_item, symmetric_ok, the
    alias table, the member table (as its search keys) and the warnings
    equal JAX's."""
    kw = dict(batch_size=dict(batch_size=1000), popularity=dict(negatives="popularity"),
              feasible=dict(negatives="feasible"),
              edge=dict(partitioner="random_edges")).get(case, {})
    cfg_j, cfg_t = _cfgs(**kw)
    e, n, _ = _graph(tiny_data, asymmetric=case == "edge")
    nu = tiny_data.num_users
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        fj = jfg.build_fullgraph_data(cfg_j, e, nu, n)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        ft = tfg.build_fullgraph_data(cfg_t, e, nu, n, device="cpu")
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert len(wt) == dict(interaction=0, edge=2, batch_size=1, popularity=0,
                           feasible=0)[case]
    for f in ("batch", "num_steps", "e_real", "symmetric_ok"):
        assert getattr(ft, f) == getattr(fj, f), f
    for f in ("user", "pos_item"):
        assert getattr(ft, f).dtype == torch.int32
        np.testing.assert_array_equal(to_np(getattr(ft, f)), np.asarray(getattr(fj, f)))
    if case == "feasible":
        assert torch.equal(ft.member_table,
                           tsampling.member_keys(np.asarray(fj.member_table), "cpu"))
    else:
        assert ft.member_table is None and fj.member_table is None
    assert (ft.hybrid.off_ell_t is not None) == (case == "edge")
    if case == "popularity":
        for a, b in zip(ft.alias_table, fj.alias_table):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    else:
        assert ft.alias_table is None


@pytest.mark.parametrize("micro", [2, 3])
def test_fullgraph_unported_raise(tiny_data, micro):
    """``loss_microbatches > 1`` is ported: the data and the epoch fn build as
    JAX's do, and an epoch trains when the count divides the batch (a
    multiple of 1,024); a count that does not divide it raises
    ``ValueError`` at the first step, as in JAX (``training/train.py:151``).
    Its values: ``tests/test_torch_microbatched.py``."""
    _, cfg = _cfgs(loss_microbatches=micro)
    e, n, _ = _graph(tiny_data)
    fg = tfg.build_fullgraph_data(cfg, e, tiny_data.num_users, n, device="cpu")
    fn = tfg.make_fullgraph_epoch_fn(cfg, fg)
    state = ttrain.create_train_state(cfg, tiny_data.num_users, tiny_data.num_items,
                                      device="cpu")
    gen = torch.Generator().manual_seed(0)
    if fg.batch % micro:
        with pytest.raises(ValueError, match=f"loss_microbatches={micro} must divide"):
            fn(state, fg, gen)
    else:
        state, loss = fn(state, fg, gen)
        assert state.step == fg.num_steps and np.isfinite(loss)


def test_fullgraph_epoch_records_its_spans(tiny_data):
    """A traced full-graph epoch records ``fullgraph.epoch`` around one
    ``fullgraph.step`` per step, each around ``fullgraph.optimizer``, and the
    closing ``fullgraph.wait`` marked as a wait; the epoch function's closure
    still holds the optimizer ``opt`` (whose ``update`` the benchmark wraps)."""
    from movie_recommender_system_with_gnns_tpu_torch.utils import observability as obs

    _, cfg = _cfgs()
    e, n, _ = _graph(tiny_data)
    fg = tfg.build_fullgraph_data(cfg, e, tiny_data.num_users, n, device="cpu")
    fn = tfg.make_fullgraph_epoch_fn(cfg, fg)
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    assert hasattr(cells["opt"].cell_contents, "update")
    state = ttrain.create_train_state(cfg, tiny_data.num_users, tiny_data.num_items,
                                      device="cpu")
    obs.clear()
    try:
        with obs.tracing():
            state, loss = fn(state, fg, torch.Generator().manual_seed(0))
        recs = obs.span_records()
    finally:
        obs.clear()
    assert np.isfinite(loss) and state.step == fg.num_steps
    names = [r.name for r in recs]
    assert names == ["fullgraph.optimizer", "fullgraph.step"] * fg.num_steps + [
        "fullgraph.wait", "fullgraph.epoch"]
    epoch = recs[-1]
    assert all(epoch.t0_ns <= r.t0_ns <= r.t1_ns <= epoch.t1_ns for r in recs)
    assert [r.name for r in recs if r.wait] == ["fullgraph.wait"]
    for opt_rec, step_rec in zip(recs[0::2], recs[1::2]):
        assert step_rec.t0_ns <= opt_rec.t0_ns <= opt_rec.t1_ns <= step_rec.t1_ns


@pytest.mark.parametrize("loss,kneg", [("reference", 1), ("reference", 4),
                                       ("standard", 1), ("standard", 4)])
def test_compute_loss_on_hybrid_matches_jax(tiny_data, loss, kneg):
    """``compute_loss`` and its table gradients through the hybrid graph
    against JAX's, with injected negatives and a masked tail: |Δloss| < 1e-5,
    grad rel < 1e-4 (tests/test_fullgraph.py:124-128)."""
    cfg_j, cfg_t = _cfgs(loss=loss)
    e, n, node_part = _graph(tiny_data)
    nu, ni = tiny_data.num_users, tiny_data.num_items
    hj, ht = _both_hybrids(e, n, node_part)
    rng = np.random.default_rng(8)
    b = 256
    user = rng.integers(0, nu, b).astype(np.int32)
    pos = rng.integers(0, ni, b).astype(np.int32)
    mask = np.arange(b) < 200
    neg = rng.integers(0, ni, (b,) if kneg == 1 else (b, kneg)).astype(np.int32)
    pj, pt = both_params(nu, ni, 8, seed=9, std=0.1)
    l_j, g_j = jax.value_and_grad(jtrain.compute_loss)(
        pj, hj, JBatch(jnp.asarray(user), jnp.asarray(pos), jnp.asarray(mask)),
        jnp.asarray(neg), cfg_j, jspmm.spmm_hybrid_sym)
    tb = TripletBatch(torch.from_numpy(user), torch.from_numpy(pos), torch.from_numpy(mask))
    l_t, g_t = ttrain.loss_and_grads(ttrain.compute_loss, pt, ht, tb,
                                     torch.from_numpy(neg), cfg_t, tspmm.spmm_hybrid_sym)
    assert abs(float(l_t) - float(l_j)) < 1e-5
    for a, b_ in zip(g_t, g_j):
        assert rel_err(a, b_) < 1e-4


def test_compute_embeddings_sorts_rows_only_for_gradients(tiny_data, monkeypatch):
    """Without a gradient (the eval step) ``compute_embeddings`` gathers the
    triplet rows with plain ``index_select`` and builds no row lists; with
    one it builds one list per index set. Both give the same rows, equal to
    JAX's ``compute_embeddings``."""
    cfg_j, cfg_t = _cfgs(loss="standard")
    e, n, node_part = _graph(tiny_data)
    nu, ni = tiny_data.num_users, tiny_data.num_items
    hj, ht = _both_hybrids(e, n, node_part)
    rng = np.random.default_rng(3)
    b = 64
    user, pos = rng.integers(0, nu, b), rng.integers(0, ni, b)
    neg = rng.integers(0, ni, (b, 2))
    pj, pt = both_params(nu, ni, 8, seed=4, std=0.1)
    ref = jtrain.compute_embeddings(
        pj, hj, JBatch(jnp.asarray(user), jnp.asarray(pos), jnp.ones(b, bool)),
        jnp.asarray(neg), cfg_j, jspmm.spmm_hybrid)
    tb = TripletBatch(torch.from_numpy(user), torch.from_numpy(pos), torch.ones(b, dtype=bool))
    calls = []
    sort_rows = ttrain.sort_rows
    monkeypatch.setattr(ttrain, "sort_rows", lambda *a: calls.append(1) or sort_rows(*a))
    with torch.no_grad():
        plain = ttrain.compute_embeddings(pt, ht, tb, torch.from_numpy(neg), cfg_t,
                                          tspmm.spmm_hybrid)
    assert not calls
    leaves = type(pt)(*(t.clone().requires_grad_(True) for t in pt))
    sorted_ = ttrain.compute_embeddings(leaves, ht, tb, torch.from_numpy(neg), cfg_t,
                                        tspmm.spmm_hybrid)
    assert len(calls) == 2
    for a, c, r in zip(plain, sorted_, ref):
        assert torch.equal(a, c.detach())
        np.testing.assert_allclose(to_np(a), np.asarray(r), rtol=1e-5, atol=1e-6)


def _jax_moments(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam[0].mu, adam[0].nu


@pytest.mark.parametrize("negatives", ["uniform", "popularity"])
@pytest.mark.parametrize("kneg", [1, 4])
def test_fullgraph_epoch_matches_jax(tiny_data, negatives, kneg):
    """One epoch from the permutation and negatives JAX's key draws:
    parameters, both Adam moments and the mean loss within 1e-5 of JAX's
    epoch fn (cosine schedule, the padding masked at the tail)."""
    cfg_j, cfg_t = _cfgs(negatives=negatives, num_negatives=kneg, lr_schedule="cosine",
                         lr_warmup_steps=1, lr_total_steps=6, loss="standard")
    e, n, _ = _graph(tiny_data)
    nu, ni = tiny_data.num_users, tiny_data.num_items
    fj = jfg.build_fullgraph_data(cfg_j, e, nu, n)
    ft = tfg.build_fullgraph_data(cfg_t, e, nu, n, device="cpu")
    assert ft.num_steps * ft.batch > ft.e_real
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


@pytest.mark.parametrize("split", ["interaction", "edge"])
def test_fullgraph_step_bit_equal_over_two_runs(tiny_data, split):
    """One step run twice from the same state, shuffle and negatives gives
    bit-equal parameters and moments, on the symmetric VJP and on the
    transposed backward."""
    _, cfg = _cfgs(hybrid_block_dtype="bfloat16", num_negatives=2, negatives="popularity")
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
    assert la == lb
    for x, y in zip(a.params + a.opt_state.mu + a.opt_state.nu,
                    b.params + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert not torch.equal(a.params.item_emb, state.params.item_emb)


# --- the wiring -------------------------------------------------------------


def _pipeline_cfg(tmp_path, **train):
    return TConfig(
        data=TData(dataset="synthetic", synthetic_users=60, synthetic_items=90,
                   synthetic_interactions=2000, split_level="interaction",
                   indexes_dir=str(tmp_path / "idx")),
        model=TModel(num_layers=2, dim=8),
        train=TTrain(**dict(dict(trainer="fullgraph", num_clusters=3, lr=1e-2, epochs=2,
                                 fullgraph_steps=2, negatives="popularity",
                                 num_negatives=2, loss="standard"), **train)))


def test_pipeline_fullgraph_trains(tmp_path):
    """prepare_training_data → train_model, 2 epochs on the CPU with
    popularity negatives: finite losses, a best-val checkpoint, moving
    tables."""
    cfg = _pipeline_cfg(tmp_path)
    bundle = tpipe.prepare_training_data(cfg, device="cpu")
    assert isinstance(bundle.train, tfg.FullGraphTrainData)
    assert bundle.train.symmetric_ok and bundle.train.alias_table is not None
    state = ttrain.create_train_state(cfg, bundle.data.num_users, bundle.data.num_items,
                                      device="cpu")
    before = state.params.item_emb.clone()
    saved = []
    state, hist = ttrain.train_model(cfg, state, bundle.train, bundle.val, bundle.test,
                                     save_checkpoint=lambda st, r: saved.append(r))
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert state.step == 2 * bundle.train.num_steps
    assert not torch.equal(state.params.item_emb, before)


def test_popularity_on_compact_draws_uniform(tiny_data):
    """On the compact trainer popularity negatives are the uniform draws, as
    in the JAX package (its compact epoch samples uniformly under it)."""
    from torch_parity import greedy_parts

    nu, ni = tiny_data.num_users, tiny_data.num_items
    ct = tcompact.build_compact_clusters(greedy_parts(tiny_data, 3), nu, device="cpu")
    runs = []
    for negatives in ("uniform", "popularity"):
        cfg = TConfig(model=TModel(num_layers=2, dim=8),
                      train=TTrain(lr=1e-2, negatives=negatives))
        state = ttrain.create_train_state(cfg, nu, ni, device="cpu")
        runs.append(tcompact.make_compact_epoch_fn(cfg)(
            state, ct, torch.Generator().manual_seed(2)))
    assert runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][0].params.item_emb, runs[1][0].params.item_emb)


@pytest.mark.parametrize("extra", [[], ["--full-eval",
                                        "--lr-schedule", "cosine"]])
def test_cli_train_fullgraph(tmp_path, capsys, monkeypatch, extra):
    """``cli train --trainer fullgraph --negatives popularity`` trains 2 epochs
    on the CPU; with a cosine schedule its horizon is the epochs' steps."""
    args = ["--device", "cpu", "--dataset", "synthetic", "--synthetic-users", "80",
            "--synthetic-items", "120", "--synthetic-interactions", "3000",
            "--indexes-dir", str(tmp_path / "idx"), "--epochs", "2", "--dim", "8",
            "--layers", "2", "--clusters", "3", "--readout", "standard",
            "--checkpoint", str(tmp_path / "m.npz"), "--histories-dir", str(tmp_path / "h"),
            "train", "--trainer", "fullgraph", "--fullgraph-steps", "3",
            "--negatives", "popularity", "--num-negatives", "2", "--loss", "standard",
            "--split-level", "interaction", *extra]
    seen = {}
    train_model = ttrain.train_model

    def spy(cfg, state, clusters, *a, **kw):
        seen.update(total=cfg.train.lr_total_steps, steps=clusters.num_steps)
        return train_model(cfg, state, clusters, *a, **kw)

    monkeypatch.setattr(ttrain, "train_model", spy)
    assert tcli.main(args) == 0
    out = capsys.readouterr().out
    assert "Epoch: 001" in out and "Test Loss" in out
    assert (tmp_path / "m.npz").exists() and (tmp_path / "h" / "hist_train_loss.npy").exists()
    if extra:
        assert "Full-ranking test Recall@10" in out
        assert seen["total"] == 2 * seen["steps"]


def test_fullgraph_quality_tool(tmp_path, capsys):
    """``tools/fullgraph_quality.py`` trains through ``cli train`` on the CPU
    and scores the final propagated tables by dot products (the JAX run's
    ``--eval-propagated`` protocol under ``--loss standard``); the CLI itself
    has no such option."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "fullgraph_quality.py"
    spec = importlib.util.spec_from_file_location("fullgraph_quality", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = ["--device", "cpu", "--dataset", "synthetic", "--synthetic-users", "80",
            "--synthetic-items", "120", "--synthetic-interactions", "3000",
            "--indexes-dir", str(tmp_path / "idx"), "--epochs", "2", "--dim", "8",
            "--layers", "2", "--clusters", "3", "--readout", "standard",
            "--checkpoint", str(tmp_path / "m.npz"), "--histories-dir", str(tmp_path / "h"),
            "train", "--trainer", "fullgraph", "--fullgraph-steps", "3",
            "--negatives", "popularity", "--num-negatives", "2", "--loss", "standard",
            "--split-level", "interaction", "--full-eval-users", "50"]
    assert tool.main(args) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("TEST full-ranking Recall@10 ") and "(propagated, dot scores)" in last
    recall, ndcg = float(last.split()[3]), float(last.split()[5])
    assert 0.0 <= recall <= 1.0 and 0.0 <= ndcg <= 1.0
    with pytest.raises(SystemExit):
        tcli.main(args + ["--full-eval-propagated"])
