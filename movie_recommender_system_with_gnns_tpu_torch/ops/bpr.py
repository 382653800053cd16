"""BPR-style ranking losses with the reference's (non-standard) math (JAX
package ``ops/bpr.py``).

Reference ``bpr_loss`` (utils/train_test.py:18-64):

  * reg   = bpr_coeff · mean(e_u² + e_p² + e_n²) over the **initial** (layer-0)
            embeddings: elementwise sum of squares, mean over all B·d entries
            (train_test.py:38-40)
  * cos⁺/cos⁻ = cosine similarity of L2-normalized **final** embeddings
            (train_test.py:42-47)
  * score = mean(softplus(10·(cos⁺ − cos⁻)))/10   (train_test.py:49)
  * loss  = −score + reg                          (train_test.py:51). Note the
            sign: the loss goes NEGATIVE during training; the quirk is kept
            for parity and the textbook −log σ(pos−neg) BPR is an option.

Masked variants support padded triplet batches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def normalize_embedding(emb: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-row-normalize (reference ``normalize_embedding``, train_test.py:53-64).

    The norm is ``sqrt(sum(x²))`` as the JAX package computes it; a zero row
    gives NaN, as there.
    """
    nrm = emb.square().sum(dim=-1, keepdim=True).sqrt()
    if eps:
        nrm = nrm.clamp_min(eps)
    return emb / nrm


def _mean_over_negs(x: torch.Tensor) -> torch.Tensor:
    """(B, K, d) → mean over K; (B, d) passes through (K=1 reference shape)."""
    return x.mean(dim=1) if x.dim() == 3 else x


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    return (x * m).sum() / m.expand_as(x).sum().clamp_min(1.0)


def bpr_loss(
    emb_users_final: torch.Tensor,
    emb_users: torch.Tensor,
    emb_pos_items_final: torch.Tensor,
    emb_pos_items: torch.Tensor,
    emb_neg_items_final: torch.Tensor,
    emb_neg_items: torch.Tensor,
    bpr_coeff: float = 5e-3,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference-parity BPR loss; with ``mask`` (B,) bool, padded rows are
    ignored in every mean (so a padded batch computes the same value as the
    unpadded one).

    Negative embeddings may be (B, d), the reference's single uniform negative
    (helpers.py:79-80), or (B, K, d) for K negatives per positive; the pairwise
    term averages over K, so K=1 reproduces the reference exactly.
    """
    sq = (emb_users.square() + emb_pos_items.square()
          + _mean_over_negs(emb_neg_items.square()))
    reg_loss = bpr_coeff * _masked_mean(sq, mask)

    nu = normalize_embedding(emb_users_final)
    npos = normalize_embedding(emb_pos_items_final)
    nneg = normalize_embedding(emb_neg_items_final)

    cos_pos = (nu * npos).sum(dim=-1)
    if nneg.dim() == 3:
        cos_neg = (nu[:, None, :] * nneg).sum(dim=-1)             # (B, K)
        pair = F.softplus(10.0 * (cos_pos[:, None] - cos_neg)).mean(dim=1)
    else:
        cos_neg = (nu * nneg).sum(dim=-1)
        pair = F.softplus(10.0 * (cos_pos - cos_neg))
    score = _masked_mean(pair, mask) / 10.0
    return -score + reg_loss


def bpr_loss_standard(
    emb_users_final: torch.Tensor,
    emb_users: torch.Tensor,
    emb_pos_items_final: torch.Tensor,
    emb_pos_items: torch.Tensor,
    emb_neg_items_final: torch.Tensor,
    emb_neg_items: torch.Tensor,
    bpr_coeff: float = 5e-3,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Textbook BPR: −mean log σ(⟨u,p⟩ − ⟨u,n⟩) + L2 reg, the 'fixed'
    alternative to the reference quirk (selectable via config). Accepts
    (B, K, d) negatives (the pairwise term averages over K)."""
    sq = (emb_users.square() + emb_pos_items.square()
          + _mean_over_negs(emb_neg_items.square()))
    reg_loss = bpr_coeff * _masked_mean(sq, mask)
    pos = (emb_users_final * emb_pos_items_final).sum(dim=-1)
    if emb_neg_items_final.dim() == 3:
        neg = (emb_users_final[:, None, :] * emb_neg_items_final).sum(dim=-1)
        pair = F.softplus(neg - pos[:, None]).mean(dim=1)
    else:
        neg = (emb_users_final * emb_neg_items_final).sum(dim=-1)
        pair = F.softplus(neg - pos)
    return _masked_mean(pair, mask) + reg_loss


def select_bpr_loss(name: str):
    """Loss selector for config wiring: 'reference' | 'standard'."""
    if name == "reference":
        return bpr_loss
    if name == "standard":
        return bpr_loss_standard
    raise ValueError(f"unknown loss {name!r}")
