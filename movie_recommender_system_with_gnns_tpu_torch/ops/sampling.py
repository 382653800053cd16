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

Exact-feasible (rejection-resampled) and popularity (alias-table) negatives
are not ported yet: :func:`check_negatives_mode` raises for them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


def check_negatives_mode(negatives: str) -> None:
    """Raise for the negative-sampling laws that are not ported yet."""
    if negatives in ("feasible", "popularity"):
        raise NotImplementedError(
            f"negatives={negatives!r} is not ported to the PyTorch package yet "
            "(ROADMAP queue A: feasible and alias-table negatives); use "
            "negatives='uniform'")
    if negatives != "uniform":
        raise ValueError(f"unknown negatives {negatives!r}")
