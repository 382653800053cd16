"""Host graph, partition and cluster arrays of the port against the JAX
package's: the same numpy inputs must give equal arrays, element for element.

Both packages partition natively by default (``tests/test_torch_native.py``
holds those assignments equal). The NumPy path is compared here: the JAX
package is switched to it (``torch_parity.numpy_partitioner``) and the port is
asked for it with ``backend="numpy"``.
"""

import numpy as np
import pytest

from movie_recommender_system_with_gnns_tpu.data import graph as jgraph
from movie_recommender_system_with_gnns_tpu.data import partition as jpart
from movie_recommender_system_with_gnns_tpu.data.movielens import make_synthetic_movielens
from movie_recommender_system_with_gnns_tpu.ops import sampling as jsampling
from movie_recommender_system_with_gnns_tpu.training import pipeline as jpipe
from movie_recommender_system_with_gnns_tpu_torch.data import graph as tgraph
from movie_recommender_system_with_gnns_tpu_torch.data import partition as tpart
from movie_recommender_system_with_gnns_tpu_torch.ops import sampling as tsampling
from movie_recommender_system_with_gnns_tpu_torch.training import pipeline as tpipe

from torch_parity import (CLUSTER_FIELDS, both_clusters, greedy_parts,
                          numpy_partitioner, to_np)


def _assert_same(a, b):
    a, b = to_np(a), to_np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


GRAPHS = {"tiny": (60, 90, 2000, 0), "skewed": (96, 160, 4000, 3)}


@pytest.fixture(params=sorted(GRAPHS))
def data(request):
    nu, ni, e, seed = GRAPHS[request.param]
    return make_synthetic_movielens(nu, ni, e, seed=seed)


def test_gcn_norm_and_degrees(data):
    n = data.num_users + data.num_items
    _assert_same(tgraph.compute_degrees(data.edge_index, n),
                 jgraph.compute_degrees(data.edge_index, n))
    _assert_same(tgraph.gcn_norm(data.edge_index, n),
                 jgraph.gcn_norm(data.edge_index, n))


def test_gcn_norm_zero_degree_is_zero():
    e = np.array([[0, 3], [3, 0]], np.int32)
    w = tgraph.gcn_norm(e, 5)
    _assert_same(w, jgraph.gcn_norm(e, 5))
    assert np.all(np.isfinite(w)) and w.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("pad_to", [None, 8192])
def test_coo_graph_build(data, pad_to):
    n = data.num_users + data.num_items
    t = tgraph.COOGraph.build(data.edge_index, n, pad_to=pad_to)
    j = jgraph.COOGraph.build(data.edge_index, n, pad_to=pad_to)
    for f in ("src", "dst", "w"):
        _assert_same(getattr(t, f), getattr(j, f))
    assert (t.num_nodes, t.num_edges) == (j.num_nodes, j.num_edges)
    assert np.all(np.diff(t.dst) >= 0) and np.all(t.w[t.num_edges:] == 0)


def test_coo_graph_pad_too_small(data):
    with pytest.raises(ValueError, match="pad_to"):
        tgraph.COOGraph.build(data.edge_index, 1000, pad_to=8)


def test_build_csr_and_symmetry(data):
    n = data.num_users + data.num_items
    for a, b in zip(tgraph.build_csr(data.edge_index, n),
                    jgraph.build_csr(data.edge_index, n)):
        _assert_same(a, b)
    assert tgraph.adjacency_is_symmetric(data.edge_index, n)
    half = data.edge_index[:, : data.edge_index.shape[1] // 3]
    assert (tgraph.adjacency_is_symmetric(half, n)
            == jgraph.adjacency_is_symmetric(half, n) is False)


def test_forward_half(data):
    for a, b in zip(tpart.forward_half(data.edge_index, data.num_users),
                    jpart.forward_half(data.edge_index, data.num_users)):
        _assert_same(a, b)


@pytest.mark.parametrize("num_parts,balance_tol", [(3, 0.0), (7, 0.0), (5, 1.1)])
def test_partition_greedy_numpy_path(data, monkeypatch, num_parts, balance_tol):
    numpy_partitioner(monkeypatch)
    n = data.num_users + data.num_items
    kw = dict(seed=1, balance_tol=balance_tol)
    for a, b in zip(
            tpart.partition_assignments(data.edge_index, data.num_users, n, num_parts,
                                        backend="numpy", **kw),
            jpart.partition_assignments(data.edge_index, data.num_users, n, num_parts, **kw)):
        _assert_same(a, b)
    tp = tpart.partition_bipartite_greedy(data.edge_index, data.num_users, n, num_parts,
                                          backend="numpy", **kw)
    jp = jpart.partition_bipartite_greedy(data.edge_index, data.num_users, n, num_parts, **kw)
    assert len(tp) == len(jp) == num_parts
    for a, b in zip(tp, jp):
        _assert_same(a, b)
    total = data.edge_index.shape[1]
    assert tpart.edge_retention(tp, total) == jpart.edge_retention(jp, total)
    assert 0 < tpart.edge_retention(tp, total) <= 1


def test_partition_edges_random(data):
    tp = tpart.partition_edges_random(data.edge_index, data.num_users, 4, seed=2)
    jp = jpart.partition_edges_random(data.edge_index, data.num_users, 4, seed=2)
    for a, b in zip(tp, jp):
        _assert_same(a, b)
    assert tpart.edge_retention(tp, data.edge_index.shape[1]) == 1.0


@pytest.mark.parametrize("partitioner,align", [("greedy", 8), ("greedy", 128),
                                               ("random", 8)])
def test_build_compact_clusters(data, partitioner, align):
    if partitioner == "greedy":
        parts = greedy_parts(data, 3)
    else:
        parts = tpart.partition_edges_random(data.edge_index, data.num_users, 3)
    cj, ct = both_clusters(parts, data.num_users, align=align)
    for f in CLUSTER_FIELDS:
        _assert_same(getattr(ct, f), getattr(cj, f))
    assert (ct.u_pad, ct.i_pad, ct.users_disjoint, ct.num_clusters) == (
        cj.u_pad, cj.i_pad, cj.users_disjoint, cj.num_clusters)
    assert ct.users_disjoint == (partitioner == "greedy")
    # the padding conventions the kernels rely on
    n_local = ct.u_pad + ct.i_pad
    w, dst = to_np(ct.w), to_np(ct.dst)
    assert ct.src.shape[1] == 2 * ct.user_local.shape[1]
    assert np.all(dst[w == 0] <= n_local - 1) and np.all(np.diff(dst, axis=1) >= 0)
    ids, valid = to_np(ct.item_ids), to_np(ct.item_valid)
    for c in range(ct.num_clusters):
        assert np.all(ids[c][~valid[c]] == ids[c][valid[c]][-1])


@pytest.mark.parametrize("pad_to", [None, 2048])
def test_triplets_from_edges(data, pad_to):
    t = tsampling.triplets_from_edges(data.edge_index, data.num_users, pad_to, device="cpu")
    j = jsampling.triplets_from_edges(data.edge_index, data.num_users, pad_to)
    for a, b in zip(t, j):
        _assert_same(a, b)
    with pytest.raises(ValueError, match="pad_to"):
        tsampling.triplets_from_edges(data.edge_index, data.num_users, 4, device="cpu")


@pytest.mark.parametrize("shared_shape", [True, False])
def test_build_cluster_batches(data, shared_shape):
    n = data.num_users + data.num_items
    parts = tpart.partition_bipartite_greedy(data.edge_index, data.num_users, n, 4)
    tb = tpipe.build_cluster_batches(parts, data.num_users, n, bucket_floor=64,
                                     shared_shape=shared_shape, device="cpu")
    jb = jpipe.build_cluster_batches(parts, data.num_users, n, bucket_floor=64,
                                     shared_shape=shared_shape)
    assert len(tb) == len(jb) > 0
    for t, j in zip(tb, jb):
        for f in ("src", "dst", "w"):
            _assert_same(getattr(t.graph, f), getattr(j.graph, f))
        for a, b in zip(t.batch, j.batch):
            _assert_same(a, b)
        assert (t.num_edges, t.graph.num_nodes) == (j.num_edges, j.graph.num_nodes)
    assert tpipe.build_cluster_batches([np.zeros((2, 0), np.int32)], 3, 9,
                                       device="cpu") == []
