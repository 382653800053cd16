"""Triplet construction + negative sampling (JAX package ``ops/sampling.py``).

Capability parity with reference ``utils/helpers.py``:

  * :func:`triplets_from_edges` (host): users/pos-items from an edge batch
    (helpers.py:84-103): users are edge heads with id < num_users, positives
    are edge tails ≥ num_users shifted down by num_users. For the
    undirected-doubled bipartite graph both masks select exactly the user→item
    half. Done on the host at graph-build time and padded to a static batch.
  * :func:`sample_negative`: uniform random item ids, no positive-collision
    check, matching the reference's simplification (helpers.py:64-82), drawn
    from an explicit ``torch.Generator``. The stream differs from
    ``jax.random``'s for the same seed.
  * popularity negatives, count^power over the train interactions (the
    word2vec law): :func:`item_popularity` and :func:`build_alias_table` on
    the host, arrays equal to the JAX package's, and
    :func:`sample_negative_alias`, O(1) per draw on the device (Walker's
    alias method: one uniform slot, one coin against its probability).
  * exact-feasible negatives (the reference's feasibility idea,
    helpers.py:11-62): the host tables :func:`build_member_table` (sorted,
    deduplicated ``(2, L)`` int32 train pairs, arrays equal to the JAX
    package's), :func:`build_membership_hash`, :func:`get_user_items` and
    :func:`is_in_feasible`; on the device :func:`sample_negative_feasible`,
    which redraws a candidate for ``num_rounds`` rounds wherever ``(user,
    candidate)`` is a train pair. The probe searches an int64 key ``u·2^31 +
    i`` (:func:`member_keys`) with ``torch.searchsorted``: order on the key is
    lexicographic order on ``(u, i)``, so its answers are the JAX package's
    int32 pair search's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


class TripletBatch(NamedTuple):
    """Padded (static-shape) positive pairs for one training step."""

    user: torch.Tensor       # (B,) int32 dense user index
    pos_item: torch.Tensor   # (B,) int32 dense item index (0-based, no offset)
    mask: torch.Tensor       # (B,) bool, False on padding rows


def triplets_from_edges(edge_index: np.ndarray, num_users: int,
                        pad_to: Optional[int] = None,
                        device: DeviceLike = None) -> TripletBatch:
    """Host-side positive-pair extraction (helpers.py:98-100) with padding."""
    dev = resolve_device(device)
    head = edge_index[0]
    tail = edge_index[1]
    m = (head < num_users) & (tail >= num_users)
    users = head[m].astype(np.int32)
    pos = (tail[m] - num_users).astype(np.int32)
    b = users.shape[0]
    pad = b if pad_to is None else pad_to
    if pad < b:
        raise ValueError(f"pad_to={pad} < batch={b}")
    mask = np.zeros(pad, bool)
    mask[:b] = True
    users = np.concatenate([users, np.zeros(pad - b, np.int32)])
    pos = np.concatenate([pos, np.zeros(pad - b, np.int32)])
    return TripletBatch(torch.from_numpy(users).to(dev),
                        torch.from_numpy(pos).to(dev),
                        torch.from_numpy(mask).to(dev))


def sample_negative(generator: torch.Generator, batch: int, num_items: int,
                    num: int = 1, device: DeviceLike = None) -> torch.Tensor:
    """Uniform negatives over the item catalog (helpers.py:79-80), int32.

    ``num > 1`` draws K negatives per positive, shape (batch, num), for the
    multi-negative BPR extension. The draw happens on the generator's device
    and then moves to ``device`` (default: the generator's), so a generator
    on the card keeps the step free of host copies.
    """
    shape = (batch,) if num <= 1 else (batch, num)
    neg = torch.randint(0, num_items, shape, generator=generator,
                        device=generator.device, dtype=torch.int32)
    return neg if device is None else neg.to(resolve_device(device))


def cantor_hash_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cantor pairing (helpers.py:11-22), int64."""
    s = x.to(torch.int64) + y.to(torch.int64)
    return (s * (s + 1)) // 2 + y.to(torch.int64)


def build_membership_hash(user: np.ndarray, item: np.ndarray,
                          num_slots: int) -> np.ndarray:
    """Host-side sorted Cantor-hash table of observed (user, item) pairs,
    padded with int64-max to ``num_slots``; host membership checks only (the
    device probe searches :func:`member_keys`)."""
    s = user.astype(np.int64) + item.astype(np.int64)
    h = np.unique((s * (s + 1)) // 2 + item.astype(np.int64))
    pad = np.full(max(num_slots - h.shape[0], 0), np.iinfo(np.int64).max, np.int64)
    return np.concatenate([h, pad])


def build_member_table(user: np.ndarray, item: np.ndarray,
                       align: int = 128) -> np.ndarray:
    """Host-side ``(2, L)`` int32 table of observed (user, item) pairs, sorted
    lexicographically by (user, item) and deduplicated; padded with int32-max
    sentinels (greater than every real pair) to a multiple of ``align``."""
    pairs = np.unique(np.stack([user.astype(np.int64), item.astype(np.int64)]), axis=1)
    big = np.iinfo(np.int32).max
    pad = (-pairs.shape[1]) % align
    pairs = np.concatenate([pairs, np.full((2, pad), big, np.int64)], axis=1)
    return pairs.astype(np.int32)


def member_keys(table, device: DeviceLike = None) -> torch.Tensor:
    """The ``(L,)`` int64 search keys ``u·2^31 + i`` of a ``(2, L)`` member
    table (numpy or tensor), on ``device``. Ascending, since the table is
    sorted by (u, i) and 0 ≤ u, i < 2^31."""
    t = (table if isinstance(table, torch.Tensor)
         else torch.from_numpy(np.array(table, np.int64)))
    t = t.to(resolve_device(device), torch.int64)
    return (t[0] << 31) | t[1]


def _probe_keys(member: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Whether each int64 key of ``q`` is in the sorted ``member`` keys: a
    lower-bound search, then one compare (a key past the last one finds the
    last, which is smaller)."""
    lo = torch.searchsorted(member, q.reshape(-1)).reshape(q.shape)
    return member[lo.clamp_max(member.shape[0] - 1)] == q


def _member_probe(member: torch.Tensor, u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Bool tensor shaped like ``u``: whether each (u, i) is in the member
    table, given as its :func:`member_keys`. A lower-bound search of the
    int64 key, the answers of the JAX package's lexicographic int32 search
    (its sentinel pairs included); ``u`` and ``i`` must lie in [0, 2^31)."""
    return _probe_keys(member, (u.to(torch.int64) << 31) | i.to(torch.int64))


def get_user_items(edge_index: np.ndarray) -> dict:
    """User → interacted-items dict (reference helpers.py:24-41), from one
    stable sort of the edge heads."""
    head = np.asarray(edge_index[0])
    tail = np.asarray(edge_index[1])
    order = np.argsort(head, kind="stable")
    h, t = head[order], tail[order]
    uniq, starts = np.unique(h, return_index=True)
    ends = np.append(starts[1:], h.shape[0])
    return {int(u): t[s:e].tolist() for u, s, e in zip(uniq, starts, ends)}


def is_in_feasible(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Columns of ``a`` (2, n) whose (x, y) pairs do NOT appear in ``b`` (2, m)
    (reference helpers.py:43-62) by a Cantor-hash set difference."""
    def h(e):
        s = e[0].astype(np.int64) + e[1].astype(np.int64)
        return s * (s + 1) // 2 + e[1].astype(np.int64)

    mask = ~np.isin(h(np.asarray(a)), h(np.asarray(b)))
    return np.asarray(a)[:, mask]


def feasible_from_draws(user: torch.Tensor, draws: torch.Tensor,
                        member: torch.Tensor) -> torch.Tensor:
    """The exact-feasible rule on given candidates: ``draws`` (R+1, *shape)
    int32, ``shape`` ``(B,)`` or ``(B, K)``. Start from ``draws[0]``; in round
    r a candidate whose (user, candidate) is a member (:func:`_member_probe`)
    is replaced by ``draws[r]`` (JAX ``sample_negative_feasible``)."""
    neg = draws[0]
    base = user.to(torch.int64) << 31          # the user's half of the key, once
    if neg.dim() == 2:
        base = base[:, None]
    for r in range(1, draws.shape[0]):
        neg = torch.where(_probe_keys(member, base | neg.to(torch.int64)), draws[r], neg)
    return neg


def sample_negative_feasible(generator: torch.Generator, user: torch.Tensor,
                             num_items: int, member: torch.Tensor, num_rounds: int = 4,
                             num: int = 1) -> torch.Tensor:
    """Rejection-resampled negatives, int32 on the member keys' device, shape
    ``(B,)`` for ``num <= 1`` or ``(B, num)``: ``num_rounds + 1`` uniform
    candidate draws from ``generator`` in one call, then
    :func:`feasible_from_draws`. Static shapes and no host sync; a candidate
    is still a train pair after the last round with probability
    ``(deg_u / num_items)^(num_rounds + 1)``."""
    shape = (user.shape[0],) if num <= 1 else (user.shape[0], num)
    draws = torch.randint(0, num_items, (num_rounds + 1, *shape), generator=generator,
                          device=generator.device, dtype=torch.int32)
    return feasible_from_draws(user, draws.to(member.device), member)


def build_alias_table(counts: np.ndarray, power: float = 0.75
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side Walker alias table of the law ``count^power / Σ``: returns
    ``(prob (N,) float32, alias (N,) int32)``, element for element the JAX
    package's (the same float64 arithmetic and the same stack order). All
    counts zero gives the uniform law."""
    w = np.asarray(counts, np.float64) ** power
    if w.sum() <= 0:
        w = np.ones_like(w)
    p = w / w.sum() * w.shape[0]          # mean 1
    prob = np.zeros(w.shape[0], np.float32)
    alias = np.zeros(w.shape[0], np.int32)
    small = [i for i, x in enumerate(p) if x < 1.0]
    large = [i for i, x in enumerate(p) if x >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
        alias[i] = i
    return prob, alias


def item_popularity(edge_index: np.ndarray, num_users: int,
                    num_items: int) -> np.ndarray:
    """(num_items,) train interaction counts per item (the popularity law's
    input): the user→item half of the doubled edge list."""
    head, tail = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    m = (head < num_users) & (tail >= num_users)
    return np.bincount(tail[m] - num_users, minlength=num_items)


def sample_negative_alias(generator: torch.Generator, batch: int, num_items: int,
                          prob: torch.Tensor, alias: torch.Tensor,
                          num: int = 1) -> torch.Tensor:
    """Popularity^power negatives through the alias table, int32, shape
    ``(batch,)`` or ``(batch, num)``: per draw a slot ``j ~ U[0, N)``, kept
    with probability ``prob[j]``, else ``alias[j]``. The draws happen on the
    generator's device and the result lies on the table's."""
    shape = (batch,) if num <= 1 else (batch, num)
    j = torch.randint(0, num_items, shape, generator=generator,
                      device=generator.device, dtype=torch.int32).to(prob.device)
    u = torch.rand(shape, generator=generator, device=generator.device).to(prob.device)
    jl = j.long()
    return torch.where(u < prob[jl], j, alias[jl])


def check_negatives_mode(negatives: str) -> None:
    """Raise for an unknown negative-sampling law. ``"popularity"`` is drawn
    by the full-graph trainer and ``"feasible"`` by the full-graph and the
    compact trainers; the others draw uniform negatives under them, as the
    JAX package's do."""
    if negatives not in ("uniform", "popularity", "feasible"):
        raise ValueError(f"unknown negatives {negatives!r}")
