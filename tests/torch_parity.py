"""Helpers shared by the tests that hold the PyTorch port against the JAX package."""

import numpy as np


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 1e-30)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_topk_bf16_close(s_port, i_port, s_ref, i_ref):
    """Port top-k (Q, k) against a reference top-(k+1) (Q, k+1) on bf16 scores.

    Tolerance: scores within one bf16 ulp, because JAX and PyTorch sum the
    f32 products in different orders and a sum near a rounding boundary can
    round to the neighbouring bf16 value. Indices agree except at a rank where
    the reference's score lies within one ulp of the next or previous rank's,
    since a one-ulp shift can reorder such a near tie. Returns the number of
    rows with such a swap.
    """
    s_port, i_port = np.asarray(s_port, np.float64), np.asarray(i_port)
    s_ref, i_ref = np.asarray(s_ref, np.float64), np.asarray(i_ref)
    k = s_port.shape[1]
    assert s_ref.shape[1] == k + 1, "reference must be top-(k+1)"
    ulp = np.maximum(bf16_ulp(s_port), bf16_ulp(s_ref[:, :k]))
    np.testing.assert_array_less(np.abs(s_port - s_ref[:, :k]), ulp * 1.0001)
    diff = i_port != i_ref[:, :k]
    prev = np.concatenate([np.full_like(s_ref[:, :1], np.inf), s_ref[:, :k - 1]],
                          axis=1)
    tie = ((np.abs(s_ref[:, :k] - prev) <= ulp)
           | (np.abs(s_ref[:, :k] - s_ref[:, 1:]) <= ulp))
    assert np.all(~diff | tie), "top-k index differs without a near tie"
    return int(diff.any(axis=1).sum())


# ---------------------------------------------------------------------------
# same seed -> numpy -> both packages
# ---------------------------------------------------------------------------


#: the tensor fields of CompactClusters that must equal the JAX package's
CLUSTER_FIELDS = ("user_ids", "item_ids", "src", "dst", "w", "user_local",
                  "pos_local", "mask", "edge_counts", "user_valid", "item_valid",
                  "user_cluster", "user_slot")


def to_np(x):
    """A torch tensor, a JAX array or anything array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def np_tables(num_users, num_items, dim, seed=0, std=0.1):
    """(user_emb, item_emb) float32 tables from a numpy seed."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((num_users, dim)) * std).astype(np.float32),
            (rng.standard_normal((num_items, dim)) * std).astype(np.float32))


def both_params(num_users, num_items, dim, seed=0, std=0.1):
    """The same numpy tables as (JAX params, port params on the CPU)."""
    import jax.numpy as jnp

    from movie_recommender_system_with_gnns_tpu.models.lightgcn import (
        LightGCNParams as JParams)
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import (
        params_from_numpy)

    u, i = np_tables(num_users, num_items, dim, seed, std)
    return JParams(jnp.asarray(u), jnp.asarray(i)), params_from_numpy(u, i, "cpu")


def numpy_partitioner(monkeypatch):
    """Make the JAX package take its NumPy partitioner instead of the native
    library, for the current test only; the port's counterpart is
    ``backend="numpy"``."""
    from movie_recommender_system_with_gnns_tpu.data import native

    monkeypatch.setattr(native, "available", lambda: False)


def greedy_parts(data, num_parts, **kw):
    """Non-empty greedy parts of a dataset, from the port's partitioner."""
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import (
        partition_bipartite_greedy)

    n = data.num_users + data.num_items
    return [p for p in partition_bipartite_greedy(
        data.edge_index, data.num_users, n, num_parts, **kw) if p.shape[1] > 0]


def both_clusters(parts, num_users, align=8, dense=None):
    """(JAX CompactClusters, port CompactClusters on the CPU) of the same
    parts; ``dense`` ("float32" / "bfloat16") densifies both."""
    import jax.numpy as jnp

    from movie_recommender_system_with_gnns_tpu.training import compact as jc
    from movie_recommender_system_with_gnns_tpu_torch.training import compact as tc

    cj = jc.build_compact_clusters(parts, num_users, align=align)
    ct = tc.build_compact_clusters(parts, num_users, align=align, device="cpu")
    if dense is not None:
        cj = jc.densify_adjacency(cj, dtype=jnp.dtype(dense))
        ct = tc.densify_adjacency(ct, dtype=dense)
    return cj, ct


def jax_cluster(cj, c):
    """The 8-tuple the JAX ``compact_cluster_loss`` takes for cluster ``c``."""
    return tuple(x[c] for x in (cj.user_ids, cj.item_ids, cj.src, cj.dst, cj.w,
                                cj.user_local, cj.pos_local, cj.mask))


def rel_err(a, b):
    """max |a - b| over max |b| (the JAX kernel tests' gradient measure)."""
    a, b = to_np(a), to_np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def jax_epoch_draws(key, k, b, num_items, num):
    """The cluster order and per-step negatives a JAX compact epoch fn draws
    from ``key`` (numpy arrays), to hand to the port's epoch fn."""
    import jax

    from movie_recommender_system_with_gnns_tpu.ops.sampling import sample_negative

    perm_key, neg_key = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(perm_key, k))
    keys = jax.random.split(neg_key, k)
    neg = np.stack([np.asarray(sample_negative(keys[j], b, num_items, num=num))
                    for j in range(k)])
    return perm, neg


def jax_fullgraph_draws(key, e_real, num_steps, batch, num_items, num,
                        alias_table=None):
    """The permutation and per-step negatives a JAX full-graph epoch fn draws
    from ``key`` (``training/fullgraph.py::epoch_inner``), as numpy arrays to
    hand to the port's epoch fn; ``alias_table`` (prob, alias) for
    popularity negatives."""
    import jax
    import jax.numpy as jnp

    from movie_recommender_system_with_gnns_tpu.ops.sampling import (
        sample_negative, sample_negative_alias)

    pkey, skey = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(pkey, e_real).astype(jnp.int32))
    keys = jax.random.split(skey, num_steps)
    if alias_table is None:
        draw = lambda k: sample_negative(k, batch, num_items, num)
    else:
        prob, alias = (jnp.asarray(a) for a in alias_table)
        draw = lambda k: sample_negative_alias(k, batch, num_items, prob, alias, num=num)
    return perm, np.stack([np.asarray(draw(keys[s])) for s in range(num_steps)])
