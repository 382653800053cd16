"""The port's sharded hybrid path (``parallel/sharding.py``: ``shard_hybrid_graph``,
the hybrid layer and its symmetric VJP, ``make_sharded_epoch_fn``; B4's
rectangular ELL in ``ops/spmm.py`` / ``ops/cuda_spmm.py``) against the JAX
package on the same numpy inputs, on the CPU.

Ranks are gloo processes (``torch_dist_ranks.spawn``, one 4-rank spawn for
the module: 2×2, 4×1 and 1×4, then rank 0 alone as 1×1); the JAX side runs
on conftest's 8 virtual CPU devices. Tolerances, from the task and
``tests/test_sharding.py``: the host arrays equal; the rectangular
propagation within rtol 1e-5 / atol 1e-6 of JAX's chunked ELL; a step's loss
within rtol 2e-5, its clipped gradient (SGD(1.0)) and Adam's first moments
``(1 - b1)·g`` within 1e-5 of the reference's largest entry (with bf16
blocks the gradient within 1e-4, :data:`BF16_TOL`); propagated
tables within rtol 2e-5 / atol 1e-6; an epoch's tables within rtol 2e-4 /
atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.data.partition import (
    forward_half, partition_assignments)
from movie_recommender_system_with_gnns_tpu.models.lightgcn import LightGCNParams as JParams
from movie_recommender_system_with_gnns_tpu.ops.sampling import TripletBatch as JBatch
from movie_recommender_system_with_gnns_tpu.ops.sampling import triplets_from_edges
from movie_recommender_system_with_gnns_tpu.ops.spmm import ChunkedEll, spmm_chunked_ell
from movie_recommender_system_with_gnns_tpu.parallel import mesh as jmesh
from movie_recommender_system_with_gnns_tpu.parallel import sharding as jsh
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.data.graph import EllGraph
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import (
    params_from_numpy, propagate)
from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_spmm
from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import (
    DeviceELL, build_hybrid_graph, spmm_ell, spmm_hybrid)
from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as tsh

import torch_dist_ranks as ranks
from torch_parity import jax_fullgraph_draws, np_tables

LAYERS, DIM, B, PARTS = 2, 8, 2048, 4
#: bf16 blocks: the clipped gradient's distance to JAX's, of its largest
#: entry. On these inputs the two packages part by 5.4e-6 with bf16 blocks
#: (a gathered entry rounded to the other bf16 neighbour moves by up to
#: 2^-8 of itself), and f32 blocks lie 1.2e-3 from bf16 ones: 1e-4 holds
#: the first and refuses the second.
BF16_TOL = 1e-4


def _jcfg(**train):
    return JConfig(model=JModel(num_layers=LAYERS, dim=DIM), train=JTrain(lr=1e-2, **train))


def _jmesh(dp, mp):
    return jmesh.make_mesh(dp, mp, devices=jax.devices()[:dp * mp])


@pytest.fixture(scope="module")
def graph(tiny_data):
    """(edges, num_users, num_items, node_part): the doubled tiny graph in
    four parts of JAX's partitioner."""
    nu, ni = tiny_data.num_users, tiny_data.num_items
    e = tiny_data.edge_index
    pu, pi = partition_assignments(e, nu, nu + ni, PARTS)
    return e, nu, ni, np.concatenate([pu, pi])


def _both_builds(graph, pm, ghost, dtype="float32", off_format="ell"):
    e, nu, ni, part = graph
    pj, pt = jsh.ShardPlan.create(nu, ni, pm), tsh.ShardPlan.create(nu, ni, pm)
    gj = jsh.shard_hybrid_graph(e, pj, part, PARTS, align=8, block_dtype=jnp.dtype(dtype),
                                ghost_cap=ghost, off_format=off_format)
    stats = dict(jsh.shard_hybrid_graph.last_stats)
    gt = tsh.shard_hybrid_graph(e, pt, part, PARTS, align=8, block_dtype=dtype,
                                ghost_cap=ghost, off_format=off_format)
    return pj, pt, gj, stats, gt


def _local_to_padded(local, m, plan):
    """A rank's local row (users then items) → its padded global id."""
    return np.where(local < plan.u_loc, m * plan.u_loc + local,
                    plan.u_pad + m * plan.i_loc + (local - plan.u_loc))


def _sorted_rows(a):
    a = np.asarray(a, np.float64)
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("ghost", [0, 64])
@pytest.mark.parametrize("pm", [1, 2, 4])
def test_shard_hybrid_graph_equals_jax(graph, pm, ghost):
    """Ids, positions, coverage, f32 and bf16 blocks and stats equal JAX's;
    each rank's remainder, as (src, dst_local, w), equals the live entries of
    JAX's chunked ELL and of the port's rectangular ELL; the segment form's
    shards equal JAX's ``off_format="coo"`` arrays."""
    for dtype in ("float32", "bfloat16"):
        pj, pt, gj, stats, gt = _both_builds(graph, pm, ghost, dtype)
        assert gt.stats == stats
        for f in ("blk_ids", "blk_pos", "blk_cov"):
            a, b = np.asarray(getattr(gj, f)), getattr(gt, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        adj = torch.stack([tsh.dense_blocks(gt, m, "cpu") for m in range(pm)])
        assert adj.dtype == getattr(torch, dtype)
        assert np.array_equal(np.asarray(gj.blk_adj.astype(jnp.float32)), adj.float().numpy())
    if ghost:
        assert 0 < stats["absorbed_edges"] and stats["remainder_edges"] < stats["off_diag_edges"]
    for m in range(pm):
        nbr, w, dst = (np.asarray(a[m]) for a in (gj.ell_nbr, gj.ell_w, gj.ell_dst))
        live = nbr != pj.n_pad
        want = _sorted_rows(np.stack([nbr[live], np.broadcast_to(dst[:, None], nbr.shape)[live],
                                      w[live]], 1))
        k = gt.off_counts[m]
        got = _sorted_rows(np.stack([gt.off.src[m, :k], gt.off.dst_local[m, :k],
                                     gt.off.w[m, :k]], 1))
        np.testing.assert_array_equal(got, want)
        ell = tsh.remainder_ell(gt, pt, m)
        assert (ell.num_nodes, ell.num_src) == (pt.u_loc + pt.i_loc, pt.n_pad)
        rows = [np.stack([np.broadcast_to(b.node_ids[:, None], b.nbr.shape)[b.nbr != pt.n_pad],
                          b.nbr[b.nbr != pt.n_pad], b.w[b.nbr != pt.n_pad]], 1)
                for b in ell.blocks]
        np.testing.assert_array_equal(_sorted_rows(np.concatenate(rows)[:, [1, 0, 2]]), want)
    _, _, gjc, _, gtc = _both_builds(graph, pm, ghost, off_format="coo")
    for f in ("src", "dst_local", "w"):
        a, b = np.asarray(getattr(gjc, f)), getattr(gtc.off, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("ghost", [0, 64])
@pytest.mark.parametrize("pm", [2, 4])
def test_blocks_plus_remainder_hold_each_edge_once(graph, pm, ghost):
    """Summed back into one padded (n_pad, n_pad) matrix, every rank's blocks
    and remainder give ``Â`` exactly (each edge once, its global weight),
    and each node's output slot is claimed by at most one rank, in its own
    part's block."""
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import gcn_norm

    e, nu, ni, part = graph
    plan = tsh.ShardPlan.create(nu, ni, pm)
    g = tsh.shard_hybrid_graph(e, plan, part, PARTS, align=8, block_dtype="float32",
                               ghost_cap=ghost)
    pad = lambda x: tsh._to_padded_ids(x.astype(np.int64), plan)
    want = np.zeros((plan.n_pad, plan.n_pad))
    np.add.at(want, (pad(e[1]), pad(e[0])), gcn_norm(e, nu + ni))
    got = np.zeros_like(want)
    k_loc, p = g.blk_ids.shape[1:]
    for m in range(pm):
        adj = tsh.dense_blocks(g, m, "cpu").numpy()
        ids = g.blk_ids[m]
        for k in range(k_loc):
            np.add.at(got, (ids[k][:, None], ids[k][None, :]), adj[k])
        c = g.off_counts[m]
        np.add.at(got, (_local_to_padded(g.off.dst_local[m, :c], m, plan), g.off.src[m, :c]),
                  g.off.w[m, :c])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert g.blk_cov.sum(0).max() <= 1
    node_part = np.full(plan.n_pad, -1)
    node_part[pad(np.arange(nu + ni))] = part
    m, nodes = np.nonzero(g.blk_cov)
    slot_block = m * k_loc + g.blk_pos[m, nodes] // p
    assert np.array_equal(slot_block, node_part[nodes])
    assert np.array_equal(g.blk_ids.reshape(-1, p)[slot_block, g.blk_pos[m, nodes] % p], nodes)


def test_shard_hybrid_graph_refuses_a_wide_block(graph):
    e, nu, ni, part = graph
    with pytest.raises(ValueError, match="block width .* > 16: use more parts"):
        tsh.shard_hybrid_graph(e, tsh.ShardPlan.create(nu, ni, 2), part, PARTS, align=8,
                               max_block_nodes=16)
    with pytest.raises(ValueError, match="unknown off_format"):
        tsh.shard_hybrid_graph(e, tsh.ShardPlan.create(nu, ni, 2), part, PARTS,
                               off_format="csr")


def test_build_sharded_hybrid_doubles_the_parts_as_bench_does(graph):
    """``build_sharded_hybrid`` is ``bench.py``'s loop: one part of the
    150-node graph is a 256-wide block, past a 128 cap, so the parts double
    to 2, partitioned as JAX's partitioner does and built as JAX builds
    them; given a partition that does not fit, or no room to double, the
    ``ValueError`` stands."""
    e, nu, ni, _ = graph
    pt = tsh.ShardPlan.create(nu, ni, 1)
    g, part, parts, t_part, t_build = tsh.build_sharded_hybrid(e, pt, 1, max_block_nodes=128)
    assert parts == 2 and t_part >= 0 and t_build >= 0
    pu, pi = partition_assignments(e, nu, nu + ni, 2, seed=0, balance_tol=1.1,
                                   uv=forward_half(e, nu))
    np.testing.assert_array_equal(part, np.concatenate([pu, pi]))
    gj = jsh.shard_hybrid_graph(e, jsh.ShardPlan.create(nu, ni, 1), part, 2,
                                max_block_nodes=128)
    np.testing.assert_array_equal(g.blk_ids, np.asarray(gj.blk_ids))
    np.testing.assert_array_equal(g.blk_pos, np.asarray(gj.blk_pos))
    with pytest.raises(ValueError, match="use more parts"):
        tsh.build_sharded_hybrid(e, pt, 1, max_block_nodes=128, node_part=np.zeros(nu + ni))
    with pytest.raises(ValueError, match="use more parts"):
        tsh.build_sharded_hybrid(e, pt, 1, max_block_nodes=128, max_parts=1)


@pytest.mark.parametrize("d", [8, 30])
def test_rectangular_spmm_ell_matches_jax_chunked_ell(graph, d):
    """A rank's remainder through the port's rectangular ELL (``l_rows``
    rows from the ``n_pad``-row table) against JAX's ``spmm_chunked_ell``
    on the same shard; the transpose is the adjoint, ⟨A·x, y⟩ = ⟨x, Aᵀ·y⟩,
    and ``spmm_ell_cuda``'s backward over it (plain on the CPU) is its hop
    of the cotangent."""
    pj, pt, gj, _, gt = _both_builds(graph, 2, 0)
    m = 1
    l_rows = pt.u_loc + pt.i_loc
    rng = np.random.default_rng(d)
    x = rng.standard_normal((pt.n_pad, d)).astype(np.float32)
    ce = ChunkedEll(nbr=gj.ell_nbr[m], w=gj.ell_w[m], dst=gj.ell_dst[m], num_nodes=l_rows,
                    num_chunks=int(gj.ell_nbr.shape[1]), num_src=pj.n_pad)
    want = np.asarray(spmm_chunked_ell(ce, jnp.asarray(x)))
    ell = DeviceELL.from_host(tsh.remainder_ell(gt, pt, m), "cpu", src_split=pt.u_pad)
    ell_t = DeviceELL.from_host(tsh.remainder_ell(gt, pt, m, transpose=True), "cpu",
                                src_split=pt.u_loc)
    assert (ell.num_nodes, ell.num_src, ell_t.num_nodes, ell_t.num_src) == \
        (l_rows, pt.n_pad, pt.n_pad, l_rows)
    xt = torch.from_numpy(x)
    got = spmm_ell(ell, xt)
    assert got.shape == (l_rows, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    y = torch.from_numpy(rng.standard_normal((l_rows, d)).astype(np.float32))
    back = spmm_ell(ell_t, y)
    assert back.shape == (pt.n_pad, d)
    np.testing.assert_allclose(float((got.double() * y.double()).sum()),
                               float((xt.double() * back.double()).sum()), rtol=1e-5)
    xr = xt.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(cuda_spmm.spmm_ell_cuda(ell, xr, transpose=ell_t), xr, y)
    assert torch.equal(grad, back)
    with pytest.raises(ValueError, match="the table has 10 rows, the graph reads"):
        spmm_ell(ell, xt[:10])


def _rect_schedule_case(graph):
    _, pt, _, _, gt = _both_builds(graph, 2, 64)
    return pt, tsh.remainder_ell(gt, pt, 0)


def test_rectangular_schedule_covers_every_live_slot_once(graph):
    """The work list of a rectangular ELL: the padding id is ``num_src``, not
    ``num_nodes``; every live slot lies in one item, every real row in one;
    with ``src_split`` the rows reading items come first, then the rows
    reading users; without it a rectangular graph has one side."""
    pt, g = _rect_schedule_case(graph)
    for budget in (32, 256):
        sch = cuda_spmm.ell_schedule(g.blocks, g.num_nodes, "cpu", budget=budget,
                                     num_src=g.num_src, src_split=pt.u_pad)
        seg = sch.items[:, 0] < 0
        bucket = sch.item_bucket
        for b, blk in enumerate(g.blocks):
            live = (blk.nbr != g.num_src).sum(1)
            covered = np.zeros(blk.rows, np.int64)
            for _, y, z, _ in sch.items[~seg & (bucket == b)]:
                covered[y:z] += np.maximum(live[y:z], 1)
            for x, _, s0, s1 in sch.items[seg & (bucket == b)]:
                covered[sch.split_rows[-1 - x, 1]] += s1 - s0
            real = blk.node_ids < g.num_nodes
            np.testing.assert_array_equal(covered[real], np.maximum(live[real], 1))
            assert not covered[~real].any()
        assert np.all(np.diff(sch.item_side) >= 0) and set(sch.item_side.tolist()) == {0, 1}
        for (x, y, z, _), side in zip(sch.items, sch.item_side):
            blk = g.blocks[x] if x >= 0 else g.blocks[sch.split_rows[-1 - x, 0]]
            r = np.arange(y, z) if x >= 0 else np.array([sch.split_rows[-1 - x, 1]])
            assert np.all((blk.nbr[r, 0] < pt.u_pad) == side)
            # local rows below u_loc are users and read items (an empty row
            # reads nothing: the first side)
            has = blk.nbr[r, 0] != g.num_src
            assert np.all(((blk.node_ids[r] >= pt.u_loc) == side)[has])
    one = cuda_spmm.ell_schedule(g.blocks, g.num_nodes, "cpu", num_src=g.num_src)
    assert not one.item_side.any()


def test_rectangular_device_ell_checks(graph):
    """``from_host`` reads the padding id as ``num_src``: a slot past the
    source table, or a neighbour behind a padding slot, raises; an
    all-empty rectangular shard (every row zero) is valid."""
    pt, g = _rect_schedule_case(graph)
    blk = g.blocks[0]
    bad = blk.nbr.copy()
    bad[0, 0] = g.num_src + 1
    with pytest.raises(ValueError, match="source table of"):
        DeviceELL.from_host(EllGraph([type(blk)(blk.node_ids, bad, blk.w)] + g.blocks[1:],
                                     g.inv_perm, g.num_nodes, g.num_edges, g.num_src), "cpu")
    wide = next(b for b in g.blocks if (b.nbr[:, 0] != g.num_src).any() and b.width > 1)
    r = int(np.flatnonzero(wide.nbr[:, 0] != g.num_src)[0])
    gap = wide.nbr.copy()
    gap[r, 0] = g.num_src
    gap[r, -1] = 0
    blocks = [type(b)(b.node_ids, gap if b is wide else b.nbr, b.w) for b in g.blocks]
    with pytest.raises(ValueError, match="padding must trail"):
        DeviceELL.from_host(EllGraph(blocks, g.inv_perm, g.num_nodes, g.num_edges, g.num_src),
                            "cpu")
    empty = EllGraph.build(np.zeros((2, 0), np.int64), 7, num_src=11)
    out = spmm_ell(DeviceELL.from_host(empty, "cpu"), torch.ones(11, 3))
    assert out.shape == (7, 3) and not out.any()
    assert empty.blocks[0].nbr.max() == 11


# ---------------------------------------------------------------------------
# the mesh: one 4-rank spawn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs(graph):
    e, nu, ni, part = graph
    u, i = np_tables(nu, ni, DIM, seed=4, std=0.3)
    b = triplets_from_edges(e, nu, pad_to=B)
    uv = forward_half(e, nu)
    return dict(edges=e, node_part=part, parts=PARTS, u=u, i=i, layers=LAYERS, dim=DIM,
                user=np.asarray(b.user), pos=np.asarray(b.pos_item), mask=np.asarray(b.mask),
                neg=np.random.default_rng(9).integers(0, ni, B).astype(np.int32),
                fw_user=uv[0].astype(np.int32), fw_pos=uv[1].astype(np.int32), seed=11)


@pytest.fixture(scope="module")
def jax_epoch(inputs):
    """JAX's fused sharded epoch on 2×2 from PRNG key 3 (ghost cap 64, the
    symmetric VJP): its plan, permutation and negatives, loss, tables and
    first moments."""
    e, nu, ni = inputs["edges"], inputs["u"].shape[0], inputs["i"].shape[0]
    cfg = JConfig(model=JModel(num_layers=LAYERS, dim=DIM),
                  train=JTrain(lr=5e-2, fullgraph_steps=2))
    plan = jsh.ShardPlan.create(nu, ni, 2)
    g = jsh.shard_hybrid_graph(e, plan, inputs["node_part"], PARTS, align=8,
                               block_dtype=jnp.float32, ghost_cap=64)
    params = jsh.pad_params(JParams(jnp.asarray(inputs["u"]), jnp.asarray(inputs["i"])), plan)
    adam = optax.adam(cfg.train.lr)
    state = (params, adam.init(params), jnp.zeros((), jnp.int32))
    epoch = jsh.make_sharded_epoch_fn(cfg, _jmesh(2, 2), plan, opt=adam, hybrid=True,
                                      symmetric=True)(state)
    key = jax.random.PRNGKey(3)
    state2, loss = epoch(state, g, jnp.asarray(inputs["fw_user"]),
                         jnp.asarray(inputs["fw_pos"]), key)
    lp = dict(epoch.last_plan)
    perm, negs = jax_fullgraph_draws(key, lp["e_real"], lp["num_steps"], lp["batch"], ni, 1)
    cat = lambda p: np.concatenate([np.asarray(x) for x in jsh.unpad_params(p, plan)])
    return dict(plan=lp, perm=perm, negs=negs, loss=float(loss), tables=cat(state2[0]),
                mu=cat(state2[1][0].mu), step=int(state2[2]))


@pytest.fixture(scope="module")
def out(inputs, jax_epoch, tmp_path_factory):
    return ranks.spawn(ranks.hybrid_ranks, 4, tmp_path_factory.mktemp("hybrid"),
                       dict(inputs, perm=jax_epoch["perm"], negs=jax_epoch["negs"]))


@pytest.fixture(scope="module")
def jax_step(inputs):
    """``(dp, mp, ghost, sym, dtype="float32") -> (loss, clipped gradient)``:
    JAX's hybrid step under SGD(1.0) on its dp×mp mesh (users then items),
    blocks in ``dtype``, each case compiled and run once."""
    e, nu, ni = inputs["edges"], inputs["u"].shape[0], inputs["i"].shape[0]
    batch = JBatch(*(jnp.asarray(inputs[k]) for k in ("user", "pos", "mask")))

    @functools.lru_cache(maxsize=None)
    def run(dp, mp, ghost, sym, dtype="float32"):
        plan = jsh.ShardPlan.create(nu, ni, mp)
        g = jsh.shard_hybrid_graph(e, plan, inputs["node_part"], PARTS, align=8,
                                   block_dtype=jnp.dtype(dtype), ghost_cap=ghost)
        p = jsh.pad_params(JParams(jnp.asarray(inputs["u"]), jnp.asarray(inputs["i"])), plan)
        sgd = optax.sgd(1.0)
        state = (p, sgd.init(p), jnp.zeros((), jnp.int32))
        step = jsh.make_sharded_train_step(_jcfg(), _jmesh(dp, mp), plan, opt=sgd,
                                           hybrid=True, symmetric=sym)(state)
        state2, loss = step(state, g, batch, jnp.asarray(inputs["neg"]))
        before, after = jsh.unpad_params(p, plan), jsh.unpad_params(state2[0], plan)
        return float(loss), np.concatenate([np.asarray(x) - np.asarray(y)
                                            for x, y in zip(before, after)])

    return run


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("ghost", [0, 64])
@pytest.mark.parametrize("dp,mp", ranks.HYBRID_SHAPES)
def test_hybrid_step_matches_jax(jax_step, out, dp, mp, ghost, sym, opt):
    """One hybrid step on the same mesh shape, tables, batch and negatives as
    JAX's ``make_sharded_train_step(hybrid=True)``: under SGD(1.0) the
    clipped gradient, under Adam the first moments ``(1 - b1)·g``, which a
    stray ``pm`` or ``dp`` factor would change (post-Adam tables would not
    show it)."""
    ref_loss, ref_g = jax_step(dp, mp, ghost, sym)
    if opt == "adam":
        ref_g = ref_g * (1.0 - _jcfg().train.adam_b1)
    tag = f"{dp}x{mp}_g{ghost}_s{int(sym)}_{opt}"
    np.testing.assert_allclose(float(out[f"{tag}_loss"]), ref_loss, rtol=2e-5)
    err = np.abs(out[f"{tag}_g"] - ref_g).max()
    assert err <= 1e-5 * np.abs(ref_g).max(), (err, np.abs(ref_g).max())


@pytest.mark.parametrize("dp,mp", ranks.BF16_SHAPES)
def test_hybrid_step_with_bf16_blocks_matches_jax(jax_step, out, dp, mp):
    """The shipped configuration's bf16 blocks (ghost cap 64, the symmetric
    VJP, SGD(1.0)): the clipped gradient of JAX's step with bf16 blocks
    within BF16_TOL of its largest entry, the loss within rtol 2e-5. Both
    round the same gathered rows to bf16 and sum the products in f32, so
    they part only where f32 sums of another order round a row to the
    other bf16 neighbour. The f32 blocks' gradient lies farther from
    JAX's bf16 one than that, so the check tells the block types apart."""
    ref_loss, ref_g = jax_step(dp, mp, 64, True, "bfloat16")
    tag = f"{dp}x{mp}_g64_s1_sgd"
    np.testing.assert_allclose(float(out[f"{tag}_bf16_loss"]), ref_loss, rtol=2e-5)
    top = np.abs(ref_g).max()
    err, f32_port, f32_jax = (np.abs(g - ref_g).max() / top for g in (
        out[f"{tag}_bf16_g"], out[f"{tag}_g"], jax_step(dp, mp, 64, True)[1]))
    assert err <= BF16_TOL < min(f32_port, f32_jax), (err, f32_port, f32_jax)


def test_autograd_step_needs_the_transpose(out):
    """A step without the symmetric VJP over an ELL shard built without
    the remainder's transpose is refused before it runs."""
    assert "shard_hybrid(..., transpose=True)" in str(out["no_transpose_error"])


@pytest.mark.parametrize("dp,mp", ranks.HYBRID_SHAPES)
def test_hybrid_step_with_a_coo_remainder_matches_jax(jax_step, out, dp, mp):
    """The remainder in the segment form (``off_format="coo"``: the rank's
    dst-sorted COO through ``spmm_rows``) gives JAX's clipped gradient too
    (ghost cap 64, the symmetric VJP, SGD(1.0))."""
    ref_loss, ref_g = jax_step(dp, mp, 64, True)
    tag = f"{dp}x{mp}_g64_s1_sgd_coo"
    np.testing.assert_allclose(float(out[f"{tag}_loss"]), ref_loss, rtol=2e-5)
    assert np.abs(out[f"{tag}_g"] - ref_g).max() <= 1e-5 * np.abs(ref_g).max()


@pytest.mark.parametrize("sym", [True, False])
def test_hybrid_step_collectives(out, sym):
    """A step's collective calls at L = 2 (``COLLECTIVES``): 2 all-gathers a
    layer, 4 for the loss's tables, 2 reduce-scatters a layer; the
    symmetric backward runs each layer's again, autograd transposes them
    (all-gathers into reduce-scatters and back); 4 all-reduces."""
    ag, rs, rs_rows, ar = out[f"2x2_g64_s{int(sym)}_adam_calls"]
    L = LAYERS
    want = (4 * L + 4, 4, 4 * L, 4) if sym else (4 * L + 4, 4 + 2 * L, 2 * L, 4)
    assert (ag, rs, rs_rows, ar) == want
    assert rs + rs_rows == 4 * L + 4


def test_sharded_propagate_hybrid_matches_jax_and_single_device(inputs, out):
    """``make_sharded_propagate(hybrid=True)`` on 2×2 (ghost cap 64) against
    JAX's and the port's single-device ``spmm_hybrid`` propagation."""
    e, nu, ni = inputs["edges"], inputs["u"].shape[0], inputs["i"].shape[0]
    cfg = _jcfg()
    plan = jsh.ShardPlan.create(nu, ni, 2)
    g = jsh.shard_hybrid_graph(e, plan, inputs["node_part"], PARTS, align=8,
                               block_dtype=jnp.float32, ghost_cap=64)
    p = jsh.pad_params(JParams(jnp.asarray(inputs["u"]), jnp.asarray(inputs["i"])), plan)
    jt = jsh.unpad_params(jsh.make_sharded_propagate(cfg, _jmesh(2, 2), plan, hybrid=True)(p, g),
                          plan)
    h = build_hybrid_graph(e, nu + ni, inputs["node_part"], PARTS, align=8,
                           block_dtype="float32", device="cpu")
    tt = propagate(params_from_numpy(inputs["u"], inputs["i"], "cpu"), h, spmm_hybrid,
                   num_layers=LAYERS, readout=cfg.model.readout)
    for want in (np.concatenate([np.asarray(x) for x in jt]),
                 torch.cat(list(tt)).numpy()):
        np.testing.assert_allclose(out["prop"], want, rtol=2e-5, atol=1e-6)


def test_sharded_epoch_matches_jax(out, jax_epoch):
    """One ``make_sharded_epoch_fn`` epoch on 2×2, given JAX's permutation
    and negatives: JAX's plan, loss, first moments and tables."""
    lp = jax_epoch["plan"]
    assert out["epoch_plan"].tolist() == [lp["e_real"], lp["num_steps"], lp["batch"]]
    assert int(out["epoch_step"]) == jax_epoch["step"] == lp["num_steps"]
    np.testing.assert_allclose(float(out["epoch_loss"]), jax_epoch["loss"], rtol=2e-5)
    mu = jax_epoch["mu"]
    assert np.abs(out["epoch_mu"] - mu).max() <= 1e-5 * np.abs(mu).max()
    np.testing.assert_allclose(out["epoch_tables"], jax_epoch["tables"], rtol=2e-4, atol=1e-6)


def test_sharded_epoch_learns_and_repeats(out):
    """Four epochs from a seeded generator: finite, falling losses (as
    ``tests/test_sharding.py::test_sharded_epoch_fn_learns``); two runs
    ``torch.equal`` in loss, tables and moments; a state of the padded
    tables instead of this rank's shards is refused."""
    losses = out["epoch_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert out["epoch_runs_equal"].all()
    assert "this rank's shards" in str(out["epoch_rows_error"])


def test_reduce_scatter_rows_backward_is_the_all_gather(out):
    """``reduce_scatter_rows``' forward (checked in the ranks: each rank's
    rows summed over the model group) and its backward: the all-gather of
    the ranks' cotangents."""
    assert np.array_equal(out["rs_grad"], out["rs_want"])


def test_sharded_epoch_plan_matches_jax_sizing():
    """The batch is ceil(e / fullgraph_steps) (or batch_size) rounded up to
    1,024 and at least dp·8; the steps cover every positive (the full
    graph's interaction split: 16 steps of 349,184, 11,739 masked)."""
    cfg = lambda **kw: TConfig(train=TTrain(**kw))
    assert tsh.sharded_epoch_plan(cfg(fullgraph_steps=16), 5_575_205, 1) == dict(
        e_real=5_575_205, num_steps=16, batch=349_184)
    assert tsh.sharded_epoch_plan(cfg(batch_size=1000), 5000, 2) == dict(
        e_real=5000, num_steps=5, batch=1024)
    assert tsh.sharded_epoch_plan(cfg(fullgraph_steps=4), 100, 256)["batch"] == 2048
