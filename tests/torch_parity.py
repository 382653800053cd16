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
