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

Exact-feasible (rejection-resampled) negatives are not ported yet:
:func:`check_negatives_mode` raises for them.
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
    """Raise for a negative-sampling law that is not ported yet or unknown.
    ``"popularity"`` is drawn by the full-graph trainer; the compact and
    full-node trainers draw uniform negatives under it, as the JAX package's
    do."""
    if negatives == "feasible":
        raise NotImplementedError(
            "negatives='feasible' is not ported to the PyTorch package yet "
            "(ROADMAP queue A 4: the exact-feasible law and its member table); "
            "use negatives='uniform' or 'popularity'")
    if negatives not in ("uniform", "popularity"):
        raise ValueError(f"unknown negatives {negatives!r}")
