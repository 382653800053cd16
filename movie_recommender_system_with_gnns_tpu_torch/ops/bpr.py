"""Embedding normalisation (JAX package ``ops/bpr.py:27-32``).

The BPR losses wait for the training slice.
"""

from __future__ import annotations

import torch


def normalize_embedding(emb: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-row-normalize (reference ``normalize_embedding``, train_test.py:53-64).

    The norm is ``sqrt(sum(x²))`` as the JAX package computes it; a zero row
    gives NaN, as there.
    """
    nrm = emb.square().sum(dim=-1, keepdim=True).sqrt()
    if eps:
        nrm = nrm.clamp_min(eps)
    return emb / nrm
