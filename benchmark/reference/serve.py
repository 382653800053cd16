"""Plain reference of masked top-k serving, and the judge of what was served.

Scores are the dot products (``normalize=False``) or the cosine
similarities (``normalize=True``) of the user and item rows in float32 (TF32
off), a user's train-seen items excluded, the k best kept. Nothing here
imports the port: the train-seen sets come from the raw train edges.

:func:`judge` reads what the program served for some users and compares it
with the reference:

  * ``invalid_rows``: rows whose served ids fall outside the catalog, repeat,
    or name a train-seen item (limit 0);
  * ``rank_gap``: the widest gap, over rows and ranks, between the
    reference's j-th best score and the j-th best exact score of the served
    items: how much better the best answer was than what was served;
  * ``score_gap``: the widest gap between a served score and the exact score
    of the item it names.

Both gaps are in units of the row's score scale: 1 for cosines, and for dot
products the user row's norm times the largest item row's norm, so that the
two scorings read alike.

:func:`serve_topk` with ``precision="fp8"`` is the control: the reference in
the next precision below the served bfloat16 (each row scaled by a power of
two to a norm near 1, rounded to float8 e4m3 and scaled back; float32
products and sums), put in the program's place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

ROW_BLOCK = 4096


def seen_csr(train_edges: np.ndarray, num_users: int) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr (U+1,), item ids) of each user's train-seen items."""
    head, tail = train_edges[0].astype(np.int64), train_edges[1].astype(np.int64)
    fwd = (head < num_users) & (tail >= num_users)
    u, it = head[fwd], tail[fwd] - num_users
    order = np.argsort(u, kind="stable")
    indptr = np.zeros(num_users + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=num_users), out=indptr[1:])
    return indptr, it[order]


def _seen_mask(users: np.ndarray, seen: Tuple[np.ndarray, np.ndarray], num_items: int,
               device) -> torch.Tensor:
    indptr, items = seen
    lens = indptr[users + 1] - indptr[users]
    rows = np.repeat(np.arange(users.shape[0]), lens)
    cols = np.concatenate([items[indptr[u]:indptr[u + 1]] for u in users]) if len(users) \
        else np.zeros(0, np.int64)
    m = torch.zeros((users.shape[0], num_items), dtype=torch.bool, device=device)
    m[torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)] = True
    return m


def _rows(x: torch.Tensor, normalize: bool) -> torch.Tensor:
    x = x.float()
    return x / x.square().sum(dim=1, keepdim=True).sqrt() if normalize else x


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Rows rounded to float8 e4m3 after a power-of-two scale that brings
    each row's norm near 1 (exact, and 1 for unit rows), then scaled back."""
    norm = x.square().sum(dim=1, keepdim=True).sqrt().clamp_min(1e-30)
    scale = torch.exp2(-torch.round(torch.log2(norm)))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def scores(user_tab: torch.Tensor, item_tab: torch.Tensor, users: np.ndarray,
           seen, precision: str = "float32", normalize: bool = True) -> torch.Tensor:
    """(R, N) float32 scores of the users' rows against every item,
    train-seen items at -inf. ``precision="fp8"`` rounds the rows to float8
    e4m3 (:func:`_fp8`) before the float32 products."""
    q = _rows(user_tab[torch.from_numpy(users).to(user_tab.device)], normalize)
    c = _rows(item_tab, normalize)
    if precision == "fp8":
        q, c = _fp8(q), _fp8(c)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    with _NoTF32():
        s = q @ c.T
    mask = _seen_mask(users, seen, item_tab.shape[0], s.device)
    return s.masked_fill(mask, float("-inf"))


def serve_topk(user_tab: torch.Tensor, item_tab: torch.Tensor, users: np.ndarray,
               seen, k: int, precision: str = "float32", normalize: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (R, k) float32, ids (R, k) int64) of the k best unseen items."""
    out_s, out_i = [], []
    for lo in range(0, users.shape[0], ROW_BLOCK):
        s = scores(user_tab, item_tab, users[lo:lo + ROW_BLOCK], seen, precision, normalize)
        v, i = torch.topk(s, k, dim=1)
        out_s.append(v)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def judge(user_tab: torch.Tensor, item_tab: torch.Tensor, users: np.ndarray,
          served_ids: np.ndarray, served_scores: np.ndarray, seen, k: int,
          normalize: bool = True) -> Dict[str, float]:
    """``invalid_rows``, ``rank_gap`` and ``score_gap`` of the served rows
    (R, k) for ``users`` (R,), against the float32 reference."""
    n = item_tab.shape[0]
    dev = item_tab.device
    item_norm = float(item_tab.float().square().sum(dim=1).sqrt().max())
    invalid = 0
    rank_gap = score_gap = 0.0
    for lo in range(0, users.shape[0], ROW_BLOCK):
        u = users[lo:lo + ROW_BLOCK]
        ids = np.asarray(served_ids[lo:lo + ROW_BLOCK], np.int64)
        sv = torch.from_numpy(np.asarray(served_scores[lo:lo + ROW_BLOCK], np.float32)).to(dev)
        s = scores(user_tab, item_tab, u, seen, normalize=normalize)
        if normalize:
            unit = torch.ones((u.shape[0], 1), device=dev)
        else:
            q = user_tab[torch.from_numpy(u).to(dev)].float()
            unit = q.square().sum(dim=1, keepdim=True).sqrt() * item_norm
        best = torch.topk(s, k, dim=1).values
        in_range = (ids >= 0) & (ids < n)
        srt = np.sort(np.where(in_range, ids, -1), axis=1)
        distinct = (srt[:, 1:] != srt[:, :-1]).all(axis=1)
        ok = in_range.all(axis=1) & distinct
        idt = torch.from_numpy(np.where(in_range, ids, 0)).to(dev)
        exact = torch.gather(s, 1, idt)                       # -inf where seen
        ok_t = torch.from_numpy(ok).to(dev) & torch.isfinite(exact).all(dim=1)
        invalid += int((~ok_t).sum())
        if bool(ok_t.any()):
            e, scale = exact[ok_t], unit[ok_t]
            got = torch.sort(e, dim=1, descending=True).values
            rank_gap = max(rank_gap, float(((best[ok_t] - got) / scale).max()))
            score_gap = max(score_gap, float(((sv[ok_t] - e).abs() / scale).max()))
    return {"invalid_rows": float(invalid), "rank_gap": rank_gap, "score_gap": score_gap}
