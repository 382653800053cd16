"""The port's deterministic row scatter (``ops/cuda_scatter.py``) on the CPU:
its plain version against ``index_add_`` and its autograd pairs against
``index_select`` / ``index_add``, bit for bit (both sum each row sequentially
in ascending entry order on the CPU), and ``sort_rows`` against numpy's
stable argsort, and ``ops/spmm.py::spmm_rows`` against the JAX package's
``spmm_segment``. The CUDA kernel is held to the plain version by
``chip_smoke.py`` on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_scatter


def _ids(rng, n, rows):
    """Repeated ids over ``rows``: one row with hundreds of entries, rows
    with none."""
    idx = rng.integers(0, rows // 2, n)         # the upper half stays empty
    idx[: n // 3] = 7                           # a hub
    rng.shuffle(idx)
    return torch.from_numpy(idx.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 100])
def test_sorted_index_add_plain_equals_index_add(dtype, d):
    rng = np.random.default_rng(d)
    n, rows = 1500, 300
    idx = _ids(rng, n, rows)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(
        getattr(torch, dtype))
    order, starts = cuda_scatter.sort_rows(idx, rows)
    got = cuda_scatter.sorted_index_add(x, order, starts, rows)
    want = torch.zeros(rows, d, dtype=x.dtype).index_add_(0, idx.long(), x)
    assert got.dtype == x.dtype and got.shape == (rows, d)
    assert torch.equal(got, want)
    assert not bool(got[rows // 2:].any()) and int((idx == 7).sum()) >= 500


def test_sort_rows_matches_numpy():
    rng = np.random.default_rng(1)
    rows = 50
    idx = rng.integers(0, rows + 1, 400)        # the value ``rows`` is a sentinel
    order, starts = cuda_scatter.sort_rows(torch.from_numpy(idx.astype(np.int32)), rows)
    assert order.dtype == torch.int32 and starts.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.argsort(idx, kind="stable"))
    np.testing.assert_array_equal(starts.numpy(), np.searchsorted(
        np.sort(idx, kind="stable"), np.arange(rows + 1)))
    assert int(starts[rows]) == int((idx < rows).sum())


def test_gather_and_scatter_rows_gradients_equal_autograd():
    rng = np.random.default_rng(2)
    n, rows, d = 900, 120, 24
    idx = _ids(rng, n, rows)
    order, starts = cuda_scatter.sort_rows(idx, rows)
    table = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    a, b = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
    out = cuda_scatter.gather_rows(a, idx, order, starts)
    ref = b.index_select(0, idx)
    assert torch.equal(out, ref)
    (ga,) = torch.autograd.grad((out * c).sum(), a)
    (gb,) = torch.autograd.grad((ref * c).sum(), b)
    assert torch.equal(ga, gb)

    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    cr = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = cuda_scatter.scatter_rows(xa, idx, order, starts, rows)
    ref = torch.zeros(rows, d).index_add(0, idx, xb)
    assert torch.equal(out, ref)
    (ga,) = torch.autograd.grad((out * cr).sum(), xa)
    (gb,) = torch.autograd.grad((ref * cr).sum(), xb)
    assert torch.equal(ga, gb)


def test_sorted_index_add_refuses_other_devices():
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        cuda_scatter.sorted_index_add(x, torch.zeros(4, dtype=torch.int32),
                                      torch.zeros(3, dtype=torch.int32), 2)


@pytest.mark.parametrize("pad", [False, True])
def test_spmm_rows_matches_jax_spmm_segment(tiny_data, pad):
    """``DeviceCOO.from_host(..., row_runs=True)`` lists the dst-sorted edges'
    row runs as ``sort_rows`` does (padding edges included), and
    ``spmm_rows`` over them (the evaluations' propagation) gives the JAX
    package's ``spmm_segment`` and its gradient; a graph without row runs is
    refused."""
    import jax
    import jax.numpy as jnp

    from movie_recommender_system_with_gnns_tpu.data.graph import COOGraph as JCOO
    from movie_recommender_system_with_gnns_tpu.ops import spmm as jspmm
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph
    from movie_recommender_system_with_gnns_tpu_torch.ops import spmm

    n = tiny_data.num_users + tiny_data.num_items
    e = tiny_data.edge_index
    pad_to = e.shape[1] + 77 if pad else None
    coo = spmm.DeviceCOO.from_host(COOGraph.build(e, n, pad_to=pad_to), "cpu",
                                   row_runs=True)
    assert coo.order.dtype == coo.starts.dtype == torch.int32
    ref_order, ref_starts = cuda_scatter.sort_rows(coo.dst, n)
    assert torch.equal(coo.order, ref_order) and torch.equal(coo.starts, ref_starts)

    emb = np.random.default_rng(0).standard_normal((n, 16)).astype(np.float32)
    cot = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    gj = jspmm.DeviceCOO.from_host(JCOO.build(e, n, pad_to=pad_to))
    out_j, vjp = jax.vjp(lambda x: jspmm.spmm_segment(gj, x), jnp.asarray(emb))
    (g_j,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(emb).requires_grad_(True)
    out_t = spmm.spmm_rows(coo, x)
    (g_t,) = torch.autograd.grad(out_t, x, torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-7)
    bare = spmm.DeviceCOO.from_host(COOGraph.build(e, n, pad_to=pad_to), "cpu")
    with pytest.raises(ValueError, match="row_runs=True"):
        spmm.spmm_rows(bare, x)


@pytest.mark.parametrize("num_src", [None, 400])
def test_spmm_rows_source_runs_gradient_matches_spmm_segment(tiny_data, num_src):
    """``from_host(..., row_runs=True)`` also lists ``src``'s runs over the
    source table (``sort_rows(src, num_src)``); through them ``spmm_rows``'
    gather is ``gather_rows``, and its gradient (summed by
    ``sorted_index_add``) matches ``spmm_segment``'s (``index_add``) within
    1e-6, on the square graph and on a rectangular one that gathers from a
    larger table (a shard of the sharded trainer)."""
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph
    from movie_recommender_system_with_gnns_tpu_torch.ops import spmm

    n = tiny_data.num_users + tiny_data.num_items
    g = COOGraph.build(tiny_data.edge_index, n)
    coo = spmm.DeviceCOO.from_arrays(g.src, g.dst, g.w, n, "cpu", row_runs=True,
                                     num_src=num_src)
    rows = coo.num_src
    assert rows == (n if num_src is None else num_src)
    ref_order, ref_starts = cuda_scatter.sort_rows(coo.src, rows)
    assert torch.equal(coo.src_order, ref_order) and torch.equal(coo.src_starts, ref_starts)
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(rng.standard_normal((rows, 16)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    grads = []
    for fn in (spmm.spmm_rows, spmm.spmm_segment):
        x = emb.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(fn(coo, x), x, cot)
        grads.append(gx)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="gathers from"):
        spmm.spmm_rows(coo, emb[:-1])
    with pytest.raises(ValueError, match="one set"):
        dataclasses.replace(coo, src_order=None, src_starts=None)
