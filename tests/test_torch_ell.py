"""The port's degree-bucketed ELL graph and its propagation (``data/graph.py``,
``ops/spmm.py``, ``ops/cuda_spmm.py``) against the JAX package's on the CPU.

Host arrays must be EQUAL. Propagation is held to the JAX ``spmm_ell`` and to
the Pallas kernel ``spmm_ell_pallas`` run in interpret mode within rtol 1e-3,
atol 1e-4 (the JAX suite's own bound in ``tests/test_pallas.py``: the three
sum the same f32 products in different orders). On CPU tensors the kernel's
wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.data import graph as jgraph
from movie_recommender_system_with_gnns_tpu.ops import spmm as jspmm
from movie_recommender_system_with_gnns_tpu.ops.pallas_spmm import spmm_ell_pallas
from movie_recommender_system_with_gnns_tpu_torch.data import graph as tgraph
from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
    make_synthetic_movielens)
from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_spmm
from movie_recommender_system_with_gnns_tpu_torch.ops import spmm as tspmm

RTOL, ATOL = 1e-3, 1e-4


def _hub_graph(n=120):
    """One node linked to all others: its bucket is wider than any default."""
    hub = np.stack([np.arange(1, n, dtype=np.int64), np.zeros(n - 1, np.int64)])
    return np.concatenate([hub, hub[::-1]], axis=1), n


def _isolated_graph():
    """A small graph whose nodes 5 and 11 have no edge."""
    d = make_synthetic_movielens(20, 30, 300, seed=2)
    e = d.edge_index
    keep = ~np.isin(e, [5, 11]).any(axis=0)
    return e[:, keep], d.num_users + d.num_items


def _graphs(tiny_graph):
    return {"tiny": tiny_graph, "hub": _hub_graph(), "isolated": _isolated_graph()}


@pytest.fixture(params=["tiny", "hub", "isolated"])
def graph(request, tiny_graph):
    return _graphs(tiny_graph)[request.param]


@pytest.mark.parametrize("kw", [dict(), dict(row_align=4), dict(row_align=128),
                                dict(width_buckets=(4, 16))],
                         ids=["default", "align4", "align128", "buckets"])
def test_ell_graph_build_equals_jax(graph, kw):
    e, n = graph
    t = tgraph.EllGraph.build(e, n, **kw)
    j = jgraph.EllGraph.build(e, n, **kw)
    assert len(t.blocks) == len(j.blocks) > 0
    for bt, bj in zip(t.blocks, j.blocks):
        for f in ("node_ids", "nbr", "w"):
            a, b = getattr(bt, f), getattr(bj, f)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert (bt.rows, bt.width) == (bj.rows, bj.width)
    np.testing.assert_array_equal(t.inv_perm, j.inv_perm)
    assert t.inv_perm.dtype == j.inv_perm.dtype
    assert (t.num_nodes, t.num_edges, t.padding_ratio) == (
        j.num_nodes, j.num_edges, j.padding_ratio)


def test_ell_graph_conventions(graph):
    """What the kernel relies on: padding slots name ``num_nodes`` with weight
    0, padding rows name ``num_nodes``, every node sits in exactly one row."""
    e, n = graph
    g = tgraph.EllGraph.build(e, n)
    ids = np.concatenate([b.node_ids for b in g.blocks])
    assert sorted(ids[ids < n].tolist()) == list(range(n))
    deg = np.bincount(e[1], minlength=n)
    for b in g.blocks:
        assert np.all(b.w[b.nbr == n] == 0) and np.all(b.nbr <= n)
        real = b.node_ids < n
        np.testing.assert_array_equal((b.nbr[real] < n).sum(1), deg[b.node_ids[real]])
        assert np.all(b.nbr[~real] == n)
    assert g.blocks[-1].width >= deg.max()


@pytest.mark.parametrize("row_align,d,pallas", [(8, 16, True), (4, 16, True),
                                                (128, 16, False), (8, 7, False)])
def test_spmm_ell_matches_jax_and_pallas_interpret(graph, rng, row_align, d, pallas):
    """Plain ``spmm_ell`` and the wrapper on CPU tensors against the JAX
    ``spmm_ell``, the Pallas kernel in interpret mode (where ``pallas``: it
    takes seconds per call) and ``spmm_segment``; ``row_align=4`` gives bucket
    row counts that are no multiple of 8, the hub graph a bucket wider than
    the Pallas unroll bound."""
    e, n = graph
    x = rng.standard_normal((n, d)).astype(np.float32)
    gj = jgraph.EllGraph.build(e, n, row_align=row_align)
    # the carrier: the JAX package's host arrays go straight into the port
    ell_t = tspmm.DeviceELL.from_host(gj, "cpu")
    ell_j = jspmm.DeviceELL.from_host(gj)
    out = tspmm.spmm_ell(ell_t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jspmm.spmm_ell(ell_j, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    if pallas:
        np.testing.assert_allclose(out, np.asarray(spmm_ell_pallas(ell_j, jnp.asarray(x))),
                                   rtol=RTOL, atol=ATOL)
    coo = tspmm.DeviceCOO.from_host(tgraph.COOGraph.build(e, n), "cpu")
    np.testing.assert_allclose(out, tspmm.spmm_segment(coo, torch.from_numpy(x)).numpy(),
                               rtol=RTOL, atol=ATOL)
    before = _build.LAUNCHES["ell_spmm"]
    wrapped = cuda_spmm.spmm_ell_cuda(ell_t, torch.from_numpy(x))
    assert torch.equal(wrapped, torch.from_numpy(out))
    assert _build.LAUNCHES["ell_spmm"] == before      # no kernel on CPU tensors


def test_spmm_ell_isolated_rows_are_zero(rng):
    e, n = _isolated_graph()
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    out = tspmm.spmm_ell(tspmm.DeviceELL.from_host(tgraph.EllGraph.build(e, n), "cpu"), x)
    assert torch.all(out[[5, 11]] == 0) and torch.any(out[0] != 0)


def test_spmm_ell_bf16_matches_pallas_interpret(tiny_graph, rng):
    """bf16 tables: both sides round the table to bf16, sum in f32 and round
    the result once, so they agree within one bf16 ulp (rtol 2^-7)."""
    e, n = tiny_graph
    x = rng.standard_normal((n, 16)).astype(np.float32)
    g = tgraph.EllGraph.build(e, n)
    out = tspmm.spmm_ell(tspmm.DeviceELL.from_host(g, "cpu"),
                         torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    ref = spmm_ell_pallas(jspmm.DeviceELL.from_host(jgraph.EllGraph.build(e, n)),
                          jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=2 ** -7, atol=1e-4)


@pytest.mark.parametrize("chunks", [1, 4])
def test_make_spmm_chunked_matches_jax(tiny_graph, rng, chunks):
    e, n = tiny_graph
    pad = -(-e.shape[1] // (128 * chunks)) * 128 * chunks
    x = rng.standard_normal((n, 8)).astype(np.float32)
    gt = tspmm.DeviceCOO.from_host(tgraph.COOGraph.build(e, n, pad_to=pad), "cpu")
    gj = jspmm.DeviceCOO.from_host(jgraph.COOGraph.build(e, n, pad_to=pad))
    out = tspmm.make_spmm_chunked(chunks)(gt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jspmm.make_spmm_chunked(chunks)(gj, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        tspmm.make_spmm_chunked(7)(gt, torch.from_numpy(x))


def test_device_ell_rejects_blocks_that_do_not_cover_the_nodes(tiny_graph):
    e, n = tiny_graph
    g = tgraph.EllGraph.build(e, n)
    short = tgraph.EllGraph(blocks=g.blocks[1:], inv_perm=g.inv_perm,
                            num_nodes=g.num_nodes, num_edges=g.num_edges)
    with pytest.raises(ValueError, match="cover every node"):
        tspmm.DeviceELL.from_host(short, "cpu")
    dev = tspmm.DeviceELL.from_host(g, "cpu")
    assert dev.inv_perm.dtype == torch.int64 and dev.blocks[0].nbr.dtype == torch.int32


def test_device_ell_rejects_padding_before_a_neighbour(tiny_graph):
    """The kernel reads a row up to its first padding id, so the upload
    refuses a block whose padding does not trail."""
    e, n = tiny_graph
    g = tgraph.EllGraph.build(e, n)
    b0 = g.blocks[0]
    row = int(np.flatnonzero((b0.nbr != n).sum(axis=1) >= 2)[0])
    nbr, w = b0.nbr.copy(), b0.w.copy()
    nbr[row, 0], w[row, 0] = n, 0.0
    bad = tgraph.EllGraph(blocks=[tgraph.EllBlock(b0.node_ids, nbr, w)] + g.blocks[1:],
                          inv_perm=g.inv_perm, num_nodes=n, num_edges=g.num_edges)
    with pytest.raises(ValueError, match="padding must trail"):
        tspmm.DeviceELL.from_host(bad, "cpu")


def test_ell_spmm_into_checks_its_tensors(tiny_graph):
    """The kernel's checked entry launches only on CUDA tensors of one shape
    and type; anything else raises before the library is built."""
    e, n = tiny_graph
    ell = tspmm.DeviceELL.from_host(tgraph.EllGraph.build(e, n), "cpu")
    x = torch.zeros(n, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_spmm.ell_spmm_into(ell, x, torch.empty_like(x))
    meta = torch.zeros(n, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_spmm.ell_spmm_into(ell, meta, torch.empty_like(meta))


def test_select_spmm_and_wrapper_checks(tiny_graph):
    assert cuda_spmm.select_spmm(1000, 64) is cuda_spmm.spmm_ell_cuda
    assert cuda_spmm.select_spmm(10 ** 7, 64, use_kernel=True) is cuda_spmm.spmm_ell_cuda
    assert cuda_spmm.select_spmm(1000, 64, use_kernel=False) is tspmm.spmm_ell
    with pytest.raises(ValueError, match="at most 512"):
        cuda_spmm.select_spmm(1000, 1024)
    e, n = tiny_graph
    ell = tspmm.DeviceELL.from_host(tgraph.EllGraph.build(e, n), "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_spmm.spmm_ell_cuda(ell, torch.zeros(n, 8, device="meta"))


def test_kernel_backward_names_what_is_missing():
    """Without a transposed graph the kernel route has no backward: asking
    for a gradient raises and names the transpose and the symmetric-adjacency
    VJP that training needs instead."""
    from types import SimpleNamespace

    with pytest.raises(NotImplementedError, match="transpose(.|\n)*spmm_symmetric"):
        cuda_spmm._EllSpmm.backward(SimpleNamespace(transpose=None), torch.zeros(2, 2))
    # the plain version on CPU tensors stays differentiable
    e, n = _hub_graph(12)
    ell = tspmm.DeviceELL.from_host(tgraph.EllGraph.build(e, n), "cpu")
    x = torch.ones(n, 3, requires_grad=True)
    cuda_spmm.spmm_ell_cuda(ell, x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# --- the kernel's work list (ops/cuda_spmm.py::ell_schedule) ---------------


def _narrow_graph(users=50, items=40, per=3):
    """A bipartite graph whose every node has at most 8 neighbours: one
    bucket of width 8, no split row."""
    u = np.repeat(np.arange(users), per)
    i = users + (u + np.tile(np.arange(per), users) * 7) % items
    e = np.stack([u, i])
    return np.concatenate([e, e[::-1]], axis=1), users + items, users


def _schedule_graphs(tiny_data, name):
    """(edge_index, num_nodes, num_users or None, row_align, budget)."""
    e, nu = tiny_data.edge_index, tiny_data.num_users
    n = nu + tiny_data.num_items
    return {
        "tiny-a8": (e, n, nu, 8, 32),
        "tiny-a4": (e, n, nu, 4, 64),
        "hub-a8": _hub_graph() + (None, 8, 32),
        "hub-a4": _hub_graph() + (None, 4, cuda_spmm.SLOT_BUDGET),
        "narrow": _narrow_graph() + (8, 32),
        # one row of 1,499 live slots: 47 segments of at most 32
        "wide": _hub_graph(1500) + (None, 8, 32),
    }[name]


SCHEDULE_GRAPHS = ["tiny-a8", "tiny-a4", "hub-a8", "hub-a4", "narrow", "wide"]


@pytest.mark.parametrize("name", SCHEDULE_GRAPHS)
def test_ell_schedule_covers_every_live_slot_once(tiny_data, name):
    e, n, nu, align, budget = _schedule_graphs(tiny_data, name)
    g = tgraph.EllGraph.build(e, n, row_align=align)
    sch = cuda_spmm.ell_schedule(g.blocks, n, "cpu", budget=budget)
    items, splits = sch.items, sch.split_rows
    assert items.dtype == splits.dtype == np.int32
    np.testing.assert_array_equal(sch.device_items.numpy(), items)
    assert sch.counters.shape == (1 + len(splits),) and not sch.counters.any()
    bucket = sch.item_bucket
    seg = items[:, 0] < 0
    for b, blk in enumerate(g.blocks):
        live = (blk.nbr != n).sum(1)
        count = np.zeros(blk.nbr.shape, np.int64)
        rows_seen = np.zeros(blk.rows, np.int64)
        for x, y, z, w in items[~seg & (bucket == b)]:
            rows_seen[y:z] += 1
            # no item exceeds its budget; a row alone may fill it
            assert z - y == 1 or np.maximum(live[y:z], 1).sum() <= budget
        count += (np.arange(blk.width) < live[:, None]) * rows_seen[:, None]
        for x, k, s0, s1 in items[seg & (bucket == b)]:
            _, row, _, _ = splits[-1 - x]
            assert 0 < s1 - s0 <= budget and s0 % 32 == 0
            count[row, s0:s1] += 1
            rows_seen[row] += k == 0
        # every live slot in exactly one item; padding rows and slots never
        np.testing.assert_array_equal(count, (blk.nbr != n).astype(np.int64))
        np.testing.assert_array_equal(rows_seen, (blk.node_ids < n).astype(np.int64))
    # a split row's segments: contiguous in the list, in order, covering it
    first = 0
    for i, (b, row, base, nseg) in enumerate(splits):
        pos = np.flatnonzero(items[:, 0] == -1 - i)
        assert nseg > 1 and pos.size == nseg and np.all(np.diff(pos) == 1)
        k, s0, s1 = items[pos, 1], items[pos, 2], items[pos, 3]
        np.testing.assert_array_equal(k, np.arange(nseg))
        assert s0[0] == 0 and np.all(s0[1:] == s1[:-1])
        assert s1[-1] == (g.blocks[b].nbr[row] != n).sum() > budget
        assert base == first
        first += nseg
    assert sch.num_segments == first
    if name == "wide":
        assert splits[:, 3].max() > 40
    if name == "narrow":
        assert len(g.blocks) == 1 and len(splits) == 0
    # one side's rows, then the other's; every row of an item on its side
    assert np.all(np.diff(sch.item_side) >= 0)
    for (x, y, z, _), side in zip(items, sch.item_side):
        blk = g.blocks[x] if x >= 0 else g.blocks[splits[-1 - x, 0]]
        r = np.arange(y, z) if x >= 0 else np.array([splits[-1 - x, 1]])
        assert np.all((blk.nbr[r, 0] < blk.node_ids[r]) == side)
        if nu is not None:      # a bipartite graph: users read items, items users
            has = blk.nbr[r, 0] < n
            assert np.all((blk.node_ids[r][has] >= nu) == side)
    flat = cuda_spmm.ell_schedule(g.blocks, n, "cpu", budget=budget, by_side=False)
    assert not flat.item_side.any() and len(flat.items) >= len(items) - 2 * len(g.blocks)


def _mirror(g, sch, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic over its work list, in PyTorch: in each row or
    segment, group ``q`` of ``ng`` lane groups sums slots ``q, q + ng, ...``
    in order (32 slots a chunk, ``ng`` groups a warp), the groups meet by a
    halving tree, and a split row's partials are summed in segment order.
    f32 products and sums, one rounding to the table type."""
    n, d = x.shape
    table = x.float()
    dv = d // 4 if d % 4 == 0 else d
    ng = 32 // min(32, 1 << (dv - 1).bit_length())

    def row_sum(ids, ws):
        prods = torch.from_numpy(ws)[:, None] * table[torch.from_numpy(ids).long()]
        acc = torch.zeros(ng, d)
        for q in range(min(ng, len(ids))):
            acc[q] = prods[q::ng].cumsum(0)[-1]
        h = ng
        while h > 1:
            h //= 2
            acc = acc[:h] + acc[h:2 * h]
        return acc[0]

    out = torch.zeros(n, d)
    part = torch.zeros(sch.num_segments, d)
    for x0, y, z, w in sch.items:
        if x0 >= 0:
            blk = g.blocks[x0]
            for r in range(y, z):
                live = int((blk.nbr[r] != n).sum())
                out[blk.node_ids[r]] = row_sum(blk.nbr[r, :live], blk.w[r, :live])
        else:
            b, row, base, _ = sch.split_rows[-1 - x0]
            blk = g.blocks[b]
            part[base + y] = row_sum(blk.nbr[row, z:w], blk.w[row, z:w])
    for b, row, base, nseg in sch.split_rows:
        acc = torch.zeros(d)
        for k in range(nseg):
            acc = acc + part[base + k]
        out[g.blocks[b].node_ids[row]] = acc
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,d,pallas", [("tiny-a8", 16, True), ("hub-a4", 16, True),
                                           ("wide", 8, False), ("narrow", 7, False),
                                           ("tiny-a4", 100, False)])
def test_ell_schedule_mirror_matches_plain_and_jax(tiny_data, rng, name, d, pallas, dtype):
    """The work list and the kernel's sum order give ``spmm_ell``'s result:
    within 1e-6 of the largest entry of ``Â·|x|`` of the port's plain version
    at f32 (one
    bf16 ulp at bf16, where both round an f32 sum once), and within the JAX
    suite's bounds (one bf16 ulp at bf16, as ``test_spmm_ell_bf16_*``) of the
    JAX ``spmm_ell`` and of the Pallas kernel in interpret mode (where
    ``pallas``)."""
    e, n, _, align, budget = _schedule_graphs(tiny_data, name)
    x = rng.standard_normal((n, d)).astype(np.float32)
    gj = jgraph.EllGraph.build(e, n, row_align=align)
    sch = cuda_spmm.ell_schedule(gj.blocks, n, "cpu", budget=budget)
    ell_t = tspmm.DeviceELL.from_host(gj, "cpu")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = _mirror(gj, sch, xt)
    plain = tspmm.spmm_ell(ell_t, xt)
    assert got.dtype == plain.dtype == xt.dtype
    got, plain = got.float().numpy(), plain.float().numpy()
    if dtype == "float32":
        # f32 sums of one set of products in two orders: the scale of their
        # difference is Σ|w·x| (the hub row's 1,499 products sum to about
        # 1.5 of about 30 in absolute value)
        scale = tspmm.spmm_ell(ell_t, xt.abs()).max().item()
        assert np.abs(got - plain).max() <= 1e-6 * scale
        tol = dict(rtol=RTOL, atol=ATOL)
    else:
        tol = dict(rtol=2 ** -7, atol=1e-4)
        np.testing.assert_allclose(got, plain, **tol)
    ell_j = jspmm.DeviceELL.from_host(gj)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    # the JAX spmm_ell multiplies in the table's type: it gets the rounded
    # table in f32, and its result is rounded once
    refs = [jspmm.spmm_ell(ell_j, xj.astype(jnp.float32)).astype(xj.dtype)]
    if pallas:
        refs.append(spmm_ell_pallas(ell_j, xj))
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)), **tol)


def test_ell_schedule_select_keeps_split_rows_whole(tiny_data):
    """A bucket's or a side's items alone (what the probe and the smoke time)
    share the split rows and counters; a selection that cuts a split row
    raises."""
    e, n, _, align, budget = _schedule_graphs(tiny_data, "wide")
    g = tgraph.EllGraph.build(e, n, row_align=align)
    sch = tspmm.DeviceELL.from_host(g, "cpu").schedule
    assert sch.budget == cuda_spmm.SLOT_BUDGET
    sch = cuda_spmm.ell_schedule(g.blocks, n, "cpu", budget=budget)
    parts = [sch.select(sch.item_bucket == b) for b in range(len(g.blocks))]
    assert sum(len(p.items) for p in parts) == len(sch.items)
    assert all(p.counters is sch.counters and p.num_segments == sch.num_segments
               for p in parts)
    np.testing.assert_array_equal(parts[-1].device_items.numpy(), parts[-1].items)
    cut = np.zeros(len(sch.items), bool)
    cut[np.flatnonzero(sch.items[:, 0] < 0)[0]] = True
    with pytest.raises(ValueError, match="all of a split row"):
        sch.select(cut)
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_spmm.ell_schedule(g.blocks, n, "cpu", budget=48)


#: sha256 of the square build's arrays on the tiny graph (node ids, slots,
#: weights per bucket, with their types and shapes; the inverse permutation;
#: the node and edge counts), taken before ``EllGraph.build`` learned
#: ``num_src``: the square layout stays as it was, byte for byte
SQUARE_LAYOUT = {
    "default": "436dab87e3f1f60558c6a6d3078eaa4b08c1a8c4410d8b7e55070e103db16451",
    "row_align4": "3f6bfe548dcda691698b726b310c41eea1330fad34edc01f6b6067d5dd6d123d",
    "buckets4_16": "6b9d584030e316676bee9438c3d982cf0d3f0a6a3c81afc183bc6d45ff052774",
    "weights": "d1845af89dbf74370ef8061ec9a17f97f200e7323eb913d63f0e76a3e962d51b",
}


@pytest.mark.parametrize("case", sorted(SQUARE_LAYOUT))
def test_ell_graph_square_layout_is_frozen(tiny_graph, case):
    import hashlib

    e, n = tiny_graph
    kw = {"default": {}, "row_align4": dict(row_align=4),
          "buckets4_16": dict(width_buckets=(4, 16)),
          "weights": dict(weights=np.random.default_rng(3).uniform(
              0.1, 1, e.shape[1]).astype(np.float32))}[case]
    g = tgraph.EllGraph.build(e, n, **kw)
    h = hashlib.sha256()
    for b in g.blocks:
        for a in (b.node_ids, b.nbr, b.w):
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
    h.update(g.inv_perm.tobytes())
    h.update(str((g.num_nodes, g.num_edges)).encode())
    assert h.hexdigest() == SQUARE_LAYOUT[case]
    assert g.num_src == n
    assert tgraph.EllGraph.build(e, n, num_src=n, **kw).blocks[0].nbr.tobytes() == \
        g.blocks[0].nbr.tobytes()
