"""The compact cluster trainer of the port against its own full-node path and
against the JAX package, on the same numpy inputs, with the cluster order and
the negatives that the JAX run drew handed to the port.

Tolerances: losses and parameters within 1e-5 (f32 sums in another order),
gradients rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.training import compact as jcompact
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph
from movie_recommender_system_with_gnns_tpu_torch.ops import sampling as tsampling
from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import triplets_from_edges
from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceCOO
from movie_recommender_system_with_gnns_tpu_torch.training import compact as tcompact
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

from torch_parity import (both_clusters, both_params, greedy_parts, jax_cluster,
                          jax_epoch_draws, to_np)


def _cfgs(**train):
    model = dict(num_layers=2, dim=8)
    train = dict(dict(lr=1e-2), **train)
    return (JConfig(model=JModel(**model), train=JTrain(**train)),
            TConfig(model=TModel(**model), train=TTrain(**train)))


@pytest.mark.parametrize("kneg", [1, 3])
def test_compact_matches_full_space(tiny_data, kneg):
    """compact_cluster_loss ≡ the port's full-node compute_loss on the same
    cluster and negatives (the equivalence the JAX suite proves for its own),
    in value and in gradient."""
    _, cfg = _cfgs()
    nu, ni = tiny_data.num_users, tiny_data.num_items
    parts = greedy_parts(tiny_data, 3)
    _, pt = both_params(nu, ni, cfg.model.dim, seed=0)
    _, ct = both_clusters(parts, nu)
    rng = np.random.default_rng(0)
    for ci, part in enumerate(parts):
        graph = DeviceCOO.from_host(COOGraph.build(part, nu + ni), "cpu")
        batch = triplets_from_edges(part, nu, device="cpu")
        b = batch.user.shape[0]
        neg = torch.from_numpy(rng.integers(
            0, ni, (b,) if kneg == 1 else (b, kneg)).astype(np.int32))
        l_full, g_full = ttrain.loss_and_grads(ttrain.compute_loss, pt, graph,
                                               batch, neg, cfg)
        # the compact path wants neg padded to its static width
        pad = ct.user_local.shape[1] - b
        neg_pad = torch.cat([neg, neg.new_zeros((pad,) + tuple(neg.shape[1:]))])
        l_comp, g_comp = ttrain.loss_and_grads(
            tcompact.compact_cluster_loss, pt, ct.cluster(ci), neg_pad, cfg,
            ct.u_pad, ct.i_pad)
        np.testing.assert_allclose(float(l_comp), float(l_full), rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(to_np(g_comp.user_emb), to_np(g_full.user_emb),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(to_np(g_comp.item_emb), to_np(g_full.item_emb),
                                   rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("loss,readout,dense", [
    ("reference", "reference", None), ("reference", "standard", "float32"),
    ("standard", "reference", "float32"), ("reference", "reference", "bfloat16")])
def test_compact_cluster_loss_matches_jax(tiny_data, loss, readout, dense):
    nu, ni = tiny_data.num_users, tiny_data.num_items
    cj_cfg, ct_cfg = (c.replace(model=type(c.model)(num_layers=2, dim=8, readout=readout))
                      for c in _cfgs(loss=loss))
    parts = greedy_parts(tiny_data, 3)
    pj, pt = both_params(nu, ni, 8, seed=1)
    cj, ct = both_clusters(parts, nu, dense=dense)
    neg = np.random.default_rng(1).integers(0, ni, ct.user_local.shape[1]).astype(np.int32)
    lj, gj = jax.value_and_grad(jcompact.compact_cluster_loss)(
        pj, jax_cluster(cj, 1), jnp.asarray(neg), cj_cfg, cj.u_pad, cj.i_pad,
        None if dense is None else cj.adj[1])
    lt, gt = ttrain.loss_and_grads(
        tcompact.compact_cluster_loss, pt, ct.cluster(1), torch.from_numpy(neg),
        ct_cfg, ct.u_pad, ct.i_pad, None if dense is None else ct.adj[1])
    if dense == "bfloat16":
        # operands rounded to bf16 in both; the backward rounds the cotangent
        # to bf16 at another place than JAX does: bf16-level agreement
        assert abs(float(lt) - float(lj)) < 5e-4
        scale = np.abs(to_np(gj.item_emb)).max()
        assert np.abs(to_np(gt.item_emb) - to_np(gj.item_emb)).max() < 2e-2 * scale
        return
    assert abs(float(lt) - float(lj)) < 1e-5
    np.testing.assert_allclose(to_np(gt.user_emb), to_np(gj.user_emb), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(to_np(gt.item_emb), to_np(gj.item_emb), rtol=1e-4, atol=1e-7)


def test_dense_adjacency_matches_segment_path(tiny_data):
    _, cfg = _cfgs()
    nu, ni = tiny_data.num_users, tiny_data.num_items
    parts = greedy_parts(tiny_data, 3)
    _, pt = both_params(nu, ni, 8, seed=2)
    _, ct = both_clusters(parts, nu, dense="float32")
    neg = torch.from_numpy(np.random.default_rng(2).integers(
        0, ni, ct.user_local.shape[1]).astype(np.int32))
    for c in range(ct.num_clusters):
        l_seg, g_seg = ttrain.loss_and_grads(
            tcompact.compact_cluster_loss, pt, ct.cluster(c), neg, cfg, ct.u_pad, ct.i_pad)
        l_den, g_den = ttrain.loss_and_grads(
            tcompact.compact_cluster_loss, pt, ct.cluster(c), neg, cfg, ct.u_pad,
            ct.i_pad, ct.adj[c])
        np.testing.assert_allclose(float(l_den), float(l_seg), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(to_np(g_den.item_emb), to_np(g_seg.item_emb),
                                   rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_hop_dense_matches_jax(tiny_data, dtype):
    """The adjacency product keeps an f32 result for a bf16 adjacency. On the
    CPU the port takes an f32 product of the upcast operands (the CPU build
    has no ``mm`` with a wider output type); the card takes
    ``torch.mm(..., out_dtype=float32)``."""
    nu = tiny_data.num_users
    cj, ct = both_clusters(greedy_parts(tiny_data, 3), nu, dense=dtype)
    n_local = ct.u_pad + ct.i_pad
    cur = np.random.default_rng(3).standard_normal((n_local, 8)).astype(np.float32)
    out_j = jcompact._one_hop(jnp.asarray(cur), cj.src[0], cj.dst[0], cj.w[0],
                              cj.adj[0], n_local)
    x = torch.from_numpy(cur).requires_grad_(True)
    out_t = tcompact._one_hop(x, ct.src[0], ct.dst[0], ct.w[0], ct.adj[0], n_local)
    assert out_t.dtype == torch.float32 and str(ct.adj.dtype) == f"torch.{dtype}"
    # same rounded operands, f32 sums in another order
    np.testing.assert_allclose(to_np(out_t), to_np(out_j), rtol=1e-5, atol=1e-6)
    if dtype == "bfloat16":
        # the result is NOT rounded to bf16
        assert not np.array_equal(to_np(out_t), to_np(out_t.detach().bfloat16().float()))
    (g,) = torch.autograd.grad(out_t.sum(), x)
    seg = tcompact._one_hop(torch.from_numpy(cur), ct.src[0], ct.dst[0], ct.w[0],
                            None, n_local)
    # against the exact f32 segment path: bf16 operand rounding only
    assert np.abs(to_np(out_t) - to_np(seg)).max() < 2e-2 * np.abs(to_np(seg)).max()
    assert g.shape == x.shape and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("with_lists", [True, False])
def test_one_hop_segment_matches_jax(tiny_data, with_lists):
    """The segment path's hop, gathered and summed through the cluster's
    stable orders of src and dst (or orders sorted on the spot), against the
    JAX package's hop; its gradient against JAX's."""
    nu = tiny_data.num_users
    cj, ct = both_clusters(greedy_parts(tiny_data, 3), nu)
    n_local = ct.u_pad + ct.i_pad
    rng = np.random.default_rng(8)
    cur = rng.standard_normal((n_local, 8)).astype(np.float32)
    cot = rng.standard_normal((n_local, 8)).astype(np.float32)
    for c in range(ct.num_clusters):
        hop_j = lambda x: jcompact._one_hop(x, cj.src[c], cj.dst[c], cj.w[c], None, n_local)
        out_j, vjp = jax.vjp(hop_j, jnp.asarray(cur))
        (g_j,) = vjp(jnp.asarray(cot))
        x = torch.from_numpy(cur).requires_grad_(True)
        lists = ct.lists(c) if with_lists else None
        out_t = tcompact._one_hop(x, ct.src[c], ct.dst[c], ct.w[c], None, n_local, lists)
        (g_t,) = torch.autograd.grad((out_t * torch.from_numpy(cot)).sum(), x)
        np.testing.assert_allclose(to_np(out_t), to_np(out_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(to_np(g_t), to_np(g_j), rtol=1e-5, atol=1e-6)
        # the sum is index_add's, bit for bit (sequential on the CPU)
        ref = torch.zeros(n_local, 8).index_add(
            0, ct.dst[c], torch.from_numpy(cur).index_select(0, ct.src[c]) * ct.w[c][:, None])
        assert torch.equal(out_t.detach(), ref)


@pytest.mark.parametrize("kneg", [1, 4])
def test_cluster_lists_equal_bpr_incidence(tiny_data, kneg):
    """The lists ``build_compact_clusters`` makes once per cluster on the host
    equal ``bpr_incidence`` on each cluster's arrays (for K = 4 in the
    trainer's layout, and expanded to the K-expanded arrays' lists), the
    negatives' runs among the step's sorted ids equal its negative lists, and
    ``cluster_lists`` gives the same lists from a cluster's tensors."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_bpr import bpr_incidence
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_scatter import sort_rows

    nu, ni = tiny_data.num_users, tiny_data.num_items
    _, ct = both_clusters(greedy_parts(tiny_data, 3), nu)
    rng = np.random.default_rng(9)
    b = ct.user_local.shape[1]
    for c in range(ct.num_clusters):
        lists = ct.lists(c)
        for got, want in zip(lists, tcompact.cluster_lists(ct.cluster(c), ct.u_pad, ct.i_pad)):
            assert got.dtype == torch.int32 and torch.equal(got, want)
        user_ids, item_ids, _, _, _, ul, pl, mask = ct.cluster(c)
        neg = torch.from_numpy(rng.integers(0, ni, b * kneg).astype(np.int32))
        # a third of the negatives in the cluster, the padding id among them
        valid_items = item_ids[ct.item_valid[c]]
        neg[::3] = valid_items[torch.from_numpy(rng.integers(0, len(valid_items), len(neg[::3])))]
        neg[1] = item_ids[-1]
        loc, inc = tcompact._neg_local_index(item_ids, neg, ct.i_pad)
        x = lambda t: t.repeat_interleave(kneg).to(torch.int32)
        args = (x(ul), x(pl), loc, inc.to(torch.int32), x(mask))
        grouped = bpr_incidence(*args, ct.u_pad, ct.i_pad, kneg=kneg)
        flat = bpr_incidence(*args, ct.u_pad, ct.i_pad)
        for name in ("user", "pos"):
            order, start = getattr(lists, f"{name}_order"), getattr(lists, f"{name}_start")
            assert torch.equal(order, getattr(grouped, f"{name}_order"))
            assert torch.equal(start, getattr(grouped, f"{name}_start"))
            assert torch.equal(kneg * start, getattr(flat, f"{name}_start"))
            n = int(start[-1])
            expanded = (kneg * order[:n, None].long() + torch.arange(kneg)).reshape(-1)
            assert torch.equal(expanded.int(), getattr(flat, f"{name}_order")[:kneg * n])
        assert int(lists.user_start[ct.u_pad]) == int(mask.sum())
        # the trainer's negative lists: runs of the step's sorted global ids
        order, starts = sort_rows(neg, ni)
        rng_ = starts.index_select(0, lists.neg_keys)
        valid = x(mask).bool()
        n_in = 0
        for r in range(ct.i_pad):
            run = order[rng_[r]:rng_[ct.i_pad + r]].long()
            lst = flat.neg_order[flat.neg_range[r]:flat.neg_range[ct.i_pad + r]].long()
            assert torch.equal(run[valid[run]], lst)
            n_in += len(lst)
        assert n_in == int((inc & valid).sum()) > 0


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam", "hybrid_adam",
                                       "lazy_item_adam"])
@pytest.mark.parametrize("case", ["segment", "dense_fused", "segment_fused_k2"])
def test_compact_step_bit_equal_over_two_runs(tiny_data, case, optimizer):
    """One compact step twice from the same state, cluster and negatives:
    parameters and Adam moments equal bit for bit, under each optimizer."""
    kw = dict(segment={}, dense_fused=dict(fused_bpr=True),
              segment_fused_k2=dict(fused_bpr=True, num_negatives=2))[case]
    _, cfg = _cfgs(optimizer=optimizer, **kw)
    nu, ni = tiny_data.num_users, tiny_data.num_items
    _, ct = both_clusters(greedy_parts(tiny_data, 3), nu,
                          dense="float32" if case == "dense_fused" else None)
    b, kneg = ct.user_local.shape[1], cfg.train.num_negatives
    neg = np.random.default_rng(10).integers(0, ni, (1, b) if kneg == 1 else (1, b, kneg))
    epoch_fn = tcompact.make_compact_epoch_fn(cfg)
    runs = []
    for _ in range(2):
        _, pt = both_params(nu, ni, 8, seed=6, std=0.05)
        ost = (ttrain.make_optimizer(cfg).init(pt) if optimizer == "adam"
               else tcompact.init_lazy_adam(pt))
        state = ttrain.TrainState(pt, ost, 0)
        state, _ = epoch_fn(state, ct, None, perm=[1],
                            neg=torch.from_numpy(neg.astype(np.int32)))
        runs.append(state)
    a, b_ = runs
    assert torch.equal(a.params.user_emb, b_.params.user_emb)
    assert torch.equal(a.params.item_emb, b_.params.item_emb)
    for x, y in zip(a.opt_state.mu + a.opt_state.nu, b_.opt_state.mu + b_.opt_state.nu):
        assert torch.equal(x, y)
    assert not torch.equal(a.params.item_emb, both_params(nu, ni, 8, seed=6, std=0.05)[1].item_emb)


def test_neg_local_index_matches_jax(tiny_data):
    nu, ni = tiny_data.num_users, tiny_data.num_items
    cj, ct = both_clusters(greedy_parts(tiny_data, 3), nu)
    rng = np.random.default_rng(4)
    for c in range(ct.num_clusters):
        for shape in ((500,), (100, 4)):
            neg = rng.integers(0, ni, shape).astype(np.int32)
            # the repeated padding id and both ends of the catalog
            neg.reshape(-1)[:3] = [int(ct.item_ids[c, -1]), 0, ni - 1]
            lj, ij = jcompact._neg_local_index(cj.item_ids[c], jnp.asarray(neg),
                                               cj.i_pad, ni)
            lt, it = tcompact._neg_local_index(ct.item_ids[c], torch.from_numpy(neg),
                                               ct.i_pad)
            np.testing.assert_array_equal(to_np(it), to_np(ij))
            # the slot of an absent negative is read by neither package (the
            # JAX inverse table reports i_pad - 1 there, the port the clipped
            # lower bound); the slots of present negatives must agree
            hit = to_np(it)
            np.testing.assert_array_equal(to_np(lt)[hit], to_np(lj)[hit])
            lb = np.searchsorted(to_np(ct.item_ids[c]), neg)
            np.testing.assert_array_equal(to_np(lt), np.minimum(lb, ct.i_pad - 1))
            assert 0 < hit.sum() < hit.size
            assert lt.dtype == torch.int32 and it.dtype == torch.bool
    # first slot wins on the repeated padding id
    valid = int(ct.item_valid[0].sum())
    last = ct.item_ids[0, -1:].clone()
    loc, inc = tcompact._neg_local_index(ct.item_ids[0], last, ct.i_pad)
    assert int(loc) == valid - 1 and bool(inc)


@pytest.mark.parametrize("case", ["segment", "dense_fused", "three_negatives"])
def test_compact_epoch_matches_jax(tiny_data, case):
    """One epoch with the JAX run's cluster order and negatives: parameters
    within 1e-5 after every step, the edge-weighted mean loss within 1e-5."""
    kw = dict(segment={}, dense_fused=dict(fused_bpr=True),
              three_negatives=dict(num_negatives=3))[case]
    dense = "float32" if case == "dense_fused" else None
    cfg_j, cfg_t = _cfgs(**kw)
    # the JAX side of the fused case is its f32 row-gather route (its Pallas
    # kernel rounds to bf16; tests/test_torch_bpr.py holds the port to it)
    cfg_jx = cfg_j.replace(train=JTrain(**dict(kw, lr=1e-2, fused_bpr=False)))
    nu, ni = tiny_data.num_users, tiny_data.num_items
    parts = greedy_parts(tiny_data, 4)
    pj, pt = both_params(nu, ni, 8, seed=5, std=0.05)
    cj, ct = both_clusters(parts, nu, dense=dense)
    k, b = ct.num_clusters, ct.user_local.shape[1]
    key = jax.random.PRNGKey(11)
    perm, neg = jax_epoch_draws(key, k, b, ni, cfg_j.train.num_negatives)

    # the JAX epoch, step by step with the epoch fn's own body ...
    opt = jtrain.make_optimizer(cfg_jx)
    params, ost = pj, opt.init(pj)
    steps_j, wl = [], 0.0
    for j, c in enumerate(perm):
        loss, grads = jax.value_and_grad(jcompact.compact_cluster_loss)(
            params, jax_cluster(cj, int(c)), jnp.asarray(neg[j]), cfg_jx, cj.u_pad,
            cj.i_pad, None if dense is None else cj.adj[int(c)])
        updates, ost = opt.update(grads, ost, params)
        params = optax.apply_updates(params, updates)
        steps_j.append(params)
        wl += float(loss) * float(cj.edge_counts[int(c)])
    mean_j = wl / float(jnp.sum(cj.edge_counts))
    # ... which is what its fused epoch fn computes from the same key
    st_j, mean_scan = jcompact.make_compact_epoch_fn(cfg_jx)(
        jtrain.TrainState(pj, opt.init(pj), jnp.zeros((), jnp.int32)), cj, key)
    np.testing.assert_allclose(float(mean_scan), mean_j, rtol=1e-5)
    np.testing.assert_allclose(to_np(st_j.params.item_emb), to_np(params.item_emb),
                               atol=1e-6)

    # the port: one step at a time (a one-cluster order), then the whole epoch
    epoch_fn = tcompact.make_compact_epoch_fn(cfg_t)
    state = ttrain.TrainState(pt, ttrain.make_optimizer(cfg_t).init(pt), 0)
    for j, c in enumerate(perm):
        state, _ = epoch_fn(state, ct, None, perm=[int(c)],
                            neg=torch.from_numpy(neg[j:j + 1]))
        np.testing.assert_allclose(to_np(state.params.user_emb),
                                   to_np(steps_j[j].user_emb), atol=1e-5, rtol=0)
        np.testing.assert_allclose(to_np(state.params.item_emb),
                                   to_np(steps_j[j].item_emb), atol=1e-5, rtol=0)
    assert state.step == k and state.opt_state.count == k

    _, pt2 = both_params(nu, ni, 8, seed=5, std=0.05)
    state2 = ttrain.TrainState(pt2, ttrain.make_optimizer(cfg_t).init(pt2), 0)
    state2, mean_t = epoch_fn(state2, ct, None, perm=torch.from_numpy(perm.copy()),
                              neg=torch.from_numpy(neg))
    assert abs(mean_t - mean_j) < 1e-5
    np.testing.assert_allclose(to_np(state2.params.item_emb),
                               to_np(state.params.item_emb), atol=1e-7)


def test_compact_epoch_draws_its_own_order_and_negatives(tiny_data):
    _, cfg = _cfgs()
    nu, ni = tiny_data.num_users, tiny_data.num_items
    _, ct = both_clusters(greedy_parts(tiny_data, 3), nu)
    epoch_fn = tcompact.make_compact_epoch_fn(cfg)
    losses, finals = [], []
    for run in range(2):
        state = ttrain.create_train_state(cfg, nu, ni, device="cpu")
        gen = torch.Generator().manual_seed(3)
        for _ in range(4):
            state, loss = epoch_fn(state, ct, gen)
            losses.append(loss)
        finals.append(state.params.item_emb.clone())
    assert losses[3] < losses[0] and all(np.isfinite(losses))
    # same seeds, same draws (f32 sums may still differ in their last bits)
    np.testing.assert_allclose(losses[:4], losses[4:], rtol=1e-6)
    np.testing.assert_allclose(to_np(finals[0]), to_np(finals[1]), atol=1e-7)


def test_unported_compact_routes_raise(tiny_data):
    """The boundary correction still raises and names ROADMAP A6; the member
    table and the feasible epoch fn run now (their values:
    tests/test_torch_feasible.py)."""
    _, cfg = _cfgs()
    cj, ct = both_clusters(greedy_parts(tiny_data, 3), tiny_data.num_users)
    withm = tcompact.attach_member_table(ct, tiny_data.edge_index, tiny_data.num_users)
    mj = jcompact.attach_member_table(cj, tiny_data.edge_index, tiny_data.num_users)
    assert torch.equal(withm.member_table, tsampling.member_keys(
        np.asarray(mj.member_table), "cpu")) and ct.member_table is None
    with pytest.raises(NotImplementedError, match="ROADMAP queue A 6"):
        tcompact.build_boundary_correction(None, None, ct, cfg, tiny_data.num_users)
    with pytest.raises(NotImplementedError, match="boundary correction"):
        tcompact._propagate_local(torch.zeros(4, 2), None, None, None, None, 1, 4,
                                  corr=torch.zeros(1, 4, 2))
    fn = tcompact.make_compact_epoch_fn(_cfgs(negatives="feasible")[1])
    _, pt = both_params(tiny_data.num_users, tiny_data.num_items, 8, seed=1)
    state, loss = fn(ttrain.TrainState(pt, ttrain.make_optimizer(cfg).init(pt), 0), withm,
                     torch.Generator().manual_seed(0))
    assert state.step == ct.num_clusters and np.isfinite(loss)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tcompact.make_compact_epoch_fn(_cfgs(optimizer="sgd")[1])


def test_densify_adjacency_refuses_wide_clusters(tiny_data):
    _, ct = both_clusters(greedy_parts(tiny_data, 3), tiny_data.num_users)
    with pytest.raises(ValueError, match="dense adjacency would need"):
        tcompact.densify_adjacency(ct, max_local_nodes=ct.u_pad + ct.i_pad - 1)
    dense = tcompact.densify_adjacency(ct, dtype="float32")
    n_local = ct.u_pad + ct.i_pad
    assert dense.adj.shape == (ct.num_clusters, n_local, n_local) and ct.adj is None
    # Â is symmetric and its padded rows are empty
    assert torch.equal(dense.adj, dense.adj.transpose(1, 2))
