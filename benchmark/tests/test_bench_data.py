"""The benchmark's frozen copies of the data set's generator and splits give
the port's output bit for bit."""

import numpy as np
import pytest

from benchmark.data import synthetic

# bench.py's SCALES["tiny"] and ["small"]: users, items, draws, communities
SCALES = {"tiny": (943, 1682, 100_000, 8), "small": (16_254, 5_905, 1_800_000, 40)}


@pytest.fixture(params=sorted(SCALES))
def graphs(request):
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens)

    u, i, n, c = SCALES[request.param]
    ours = synthetic.make_graph(u, i, n, seed=0, power=0.9, num_communities=c)
    port = make_synthetic_movielens(u, i, n, seed=0, power=0.9, num_communities=c)
    return ours, port


def _equal(a, b):
    return a.dtype == b.dtype and np.array_equal(a, b)


def test_generator_bit_equal(graphs):
    (nu, ni, edges), port = graphs
    assert (nu, ni) == (port.num_users, port.num_items)
    assert _equal(edges, port.edge_index)


@pytest.mark.parametrize("level", ["edge", "interaction"])
def test_split_bit_equal(graphs, level, tmp_path):
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import split_edges

    (nu, _, edges), port = graphs
    ours = (synthetic.split_edges(edges) if level == "edge"
            else synthetic.split_interactions(edges, nu))
    theirs = split_edges(port, str(tmp_path), split_level=level)
    assert all(_equal(a, b) for a, b in zip(ours, theirs))


def test_sorted_unique_matches_numpy():
    a = np.random.default_rng(3).integers(0, 50, 400)
    assert np.array_equal(synthetic.sorted_unique(a), np.unique(a))


@pytest.mark.parametrize("parts,tol", [(4, 0.0), (10, 1.1)])
def test_partition_bit_equal(graphs, parts, tol):
    from benchmark.data import partition
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import (
        partition_bipartite_greedy)

    (nu, ni, edges), _ = graphs
    ours = partition.cluster_edges(edges, nu, ni, parts, seed=0, balance_tol=tol)
    theirs = partition_bipartite_greedy(edges, nu, nu + ni, parts, seed=0, balance_tol=tol)
    assert len(ours) == len(theirs) == parts
    assert all(_equal(a, b) for a, b in zip(ours, theirs))
    assert sum(p.shape[1] for p in ours) > 0
