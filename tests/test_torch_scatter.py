"""The port's deterministic row scatter (``ops/cuda_scatter.py``) on the CPU:
its plain version against ``index_add_`` and its autograd pairs against
``index_select`` / ``index_add``, bit for bit (both sum each row sequentially
in ascending entry order on the CPU), and ``sort_rows`` against numpy's
stable argsort. The CUDA kernel is held to the plain version by
``chip_smoke.py`` on the card.
"""

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
