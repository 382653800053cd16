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


def test_ell_spmm_block_checks_its_tensors(tiny_graph):
    """The per-bucket entry launches only on CUDA tensors of one shape and
    type; anything else raises before the library is built."""
    e, n = tiny_graph
    ell = tspmm.DeviceELL.from_host(tgraph.EllGraph.build(e, n), "cpu")
    x = torch.zeros(n, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_spmm.ell_spmm_block(ell.blocks[0], x, torch.empty_like(x), n)
    meta = torch.zeros(n, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_spmm.ell_spmm_block(ell.blocks[0], meta, torch.empty_like(meta), n)


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
    """The kernel route has no backward kernel: asking for a gradient raises
    and names the symmetric-adjacency VJP that training needs."""
    with pytest.raises(NotImplementedError, match="spmm_symmetric(.|\n)*queue A 7"):
        cuda_spmm._EllSpmm.backward(None, torch.zeros(2, 2))
    # the plain version on CPU tensors stays differentiable
    e, n = _hub_graph(12)
    ell = tspmm.DeviceELL.from_host(tgraph.EllGraph.build(e, n), "cpu")
    x = torch.ones(n, 3, requires_grad=True)
    cuda_spmm.spmm_ell_cuda(ell, x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
