"""LightGCN parameters as plain tensors (JAX package ``models/lightgcn.py``).

  * parameters are one NamedTuple ``(user_emb, item_emb)``, init N(0, 0.01²)
    (reference light_gcn.py:25-26), the same public surface as the JAX package
    so tests compare like with like;
  * :func:`get_embeddings` returns layer-0 table rows — the reference's
    serving contract (light_gcn.py:42-64);
  * :func:`params_from_numpy` carries weights across from the JAX package's
    arrays (or any ``.npz``) bit for bit.

``propagate`` waits for the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


class LightGCNParams(NamedTuple):
    user_emb: torch.Tensor   # (num_users, d)
    item_emb: torch.Tensor   # (num_items, d)


def init_params(
    num_users: int,
    num_items: int,
    dim: int = 64,
    init_std: float = 0.01,
    dtype: torch.dtype = torch.float32,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> LightGCNParams:
    """N(0, init_std²) init for both tables.

    The draw happens on the generator's device (the CPU's default generator
    when none is given) and the tables then move to ``device``, so one seeded
    CPU generator gives the same tables on every device. The numbers differ
    from ``jax.random``'s for the same seed.
    """
    dev = resolve_device(device)
    gen_dev = generator.device if generator is not None else torch.device("cpu")

    def draw(n: int) -> torch.Tensor:
        x = torch.randn((n, dim), generator=generator, device=gen_dev) * init_std
        return x.to(device=dev, dtype=dtype)

    return LightGCNParams(user_emb=draw(num_users), item_emb=draw(num_items))


def params_from_numpy(user_emb: np.ndarray, item_emb: np.ndarray,
                      device: DeviceLike = None) -> LightGCNParams:
    """Tables from host arrays (e.g. ``np.asarray`` of the JAX package's
    params), dtype and values unchanged."""
    dev = resolve_device(device)
    return LightGCNParams(
        user_emb=torch.from_numpy(np.array(user_emb, order="C")).to(dev),
        item_emb=torch.from_numpy(np.array(item_emb, order="C")).to(dev),
    )


def get_embeddings(
    params: LightGCNParams,
    user_indices=None,
    item_indices=None,
):
    """Layer-0 table rows for the given indices (reference light_gcn.py:42-64).

    Returns (user_rows | None, item_rows | None) and warns when neither index
    set is given, matching the reference contract.
    """
    u = params.user_emb[user_indices] if user_indices is not None else None
    i = params.item_emb[item_indices] if item_indices is not None else None
    if u is None and i is None:
        import warnings

        warnings.warn("Both indices not provided", UserWarning)
    return u, i
