"""Evaluation metrics: the reference's sampled Recall@k (for parity) plus
standard Recall@k / NDCG@k (JAX package ``ops/metrics.py``).

Reference ``compute_recall_at_k`` (utils/train_test.py:165-212) semantics, kept
bug-for-bug for parity:

  * embeddings are the **initial** (layer-0) per-edge gathered rows
    (train_test.py:157-159)
  * ``num_samples`` draws of ``sample_size`` users WITHOUT replacement
  * score matrix = L2-normalized users × [pos ‖ neg] item embeddings
  * top-k overlap with the positives mask, but the denominator is the TOTAL
    positive count (train_test.py:203-206), hence the tiny absolute values.

Standard metrics operate on full score matrices with train-interaction masking.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .bpr import normalize_embedding
from .topk import _topk_lowest_first


def sampled_recall_at_k(
    generator: Optional[torch.Generator],
    user_embs: torch.Tensor,      # (B, d) initial user rows (one per eval edge)
    pos_item_embs: torch.Tensor,  # (B, d) initial positive-item rows
    neg_item_embs: torch.Tensor,  # (B, d) initial sampled-negative rows
    k: int = 100,
    num_samples: int = 10,
    sample_size: int = 100,
    samples: Optional[torch.Tensor] = None,   # (num_samples, S) user rows to use
) -> torch.Tensor:
    """Reference-parity Monte-Carlo Recall@k (train_test.py:165-212).

    Each draw is ``sample_size`` rows without replacement from ``generator``
    (on the generator's device); ``samples`` injects the rows instead, so a
    test can hand this function and the JAX package's the same draws.
    """
    pos_n = normalize_embedding(pos_item_embs)
    neg_n = normalize_embedding(neg_item_embs)
    items = torch.cat([pos_n, neg_n], dim=0)                  # (2B, d)
    num_users = user_embs.shape[0]
    num_pos = pos_item_embs.shape[0]
    # small eval sets: can't draw more users without replacement than exist
    sample_size = min(sample_size, num_users)
    k = min(k, items.shape[0])

    total = user_embs.new_zeros(())
    n = num_samples if samples is None else samples.shape[0]
    # one draw at a time: each materializes a (sample_size, 2B) score matrix
    for s in range(n):
        if samples is None:
            idx = torch.randperm(num_users, generator=generator,
                                 device=generator.device)[:sample_size]
            idx = idx.to(user_embs.device)
        else:
            idx = samples[s]
        u = normalize_embedding(user_embs[idx])
        scores = u @ items.T                                   # (S, 2B)
        _, topk = _topk_lowest_first(scores, k)
        hits = (topk < num_pos).to(torch.float32).sum(dim=1)
        total = total + (hits / num_pos).mean()
    return total / n


def recall_ndcg_at_k(
    scores: torch.Tensor,        # (U, I) full score matrix (already train-masked)
    relevant: torch.Tensor,      # (U, I) bool, held-out positives
    k: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard per-user Recall@k and NDCG@k, averaged over users with ≥1
    relevant item."""
    _, topk = _topk_lowest_first(scores, k)
    rel_at_topk = torch.gather(relevant, 1, topk).to(torch.float32)   # (U, k)
    num_rel = relevant.sum(dim=1).to(torch.float32)                    # (U,)
    has_rel = num_rel > 0

    recall_u = rel_at_topk.sum(dim=1) / num_rel.clamp_min(1.0)

    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32,
                                              device=scores.device))
    dcg = (rel_at_topk * discounts[None, :]).sum(dim=1)
    ideal_hits = num_rel.clamp_max(float(k))
    # ideal DCG = sum of the first `ideal_hits` discounts
    cum = torch.cat([discounts.new_zeros(1), torch.cumsum(discounts, 0)])
    idcg = cum[ideal_hits.clamp(0, k).to(torch.int64)]
    ndcg_u = dcg / idcg.clamp_min(1e-12)

    denom = has_rel.sum().clamp_min(1)
    recall = torch.where(has_rel, recall_u, 0.0).sum() / denom
    ndcg = torch.where(has_rel, ndcg_u, 0.0).sum() / denom
    return recall, ndcg
