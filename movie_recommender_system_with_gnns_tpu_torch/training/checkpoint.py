"""Parameter checkpoints in the JAX package's ``.npz`` layout.

``user_emb`` and ``item_emb`` arrays plus an optional ``_meta`` uint8 array
holding JSON (JAX package ``training/checkpoint.py:28-50``), so a checkpoint
written by either package loads in the other unchanged. Full-state and Orbax
checkpoints wait for the recovery slice.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..models.lightgcn import LightGCNParams, params_from_numpy
from ..utils.device import DeviceLike


def save_params(path: str, params: LightGCNParams, meta: Optional[dict] = None) -> None:
    """Write the tables (and ``meta`` as JSON) atomically to ``path``."""
    arrs = {
        "user_emb": params.user_emb.detach().cpu().numpy(),
        "item_emb": params.item_emb.detach().cpu().numpy(),
    }
    if meta is not None:
        arrs["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_params(path: str, device: DeviceLike = None) -> Tuple[LightGCNParams, dict]:
    """(params on ``device``, meta dict) from a ``.npz`` checkpoint."""
    with np.load(path) as z:
        params = params_from_numpy(z["user_emb"], z["item_emb"], device)
        meta = json.loads(bytes(z["_meta"]).decode()) if "_meta" in z else {}
    return params, meta


def load_params_if_exists(path: str, params: LightGCNParams) -> LightGCNParams:
    """Resume-if-exists (train_test.py:279-280): the loaded tables, on the
    given tables' device, when the checkpoint exists AND matches their shapes;
    else the given fresh params."""
    if not os.path.exists(path):
        return params
    loaded, _ = load_params(path, params.user_emb.device)
    if (loaded.user_emb.shape != params.user_emb.shape
            or loaded.item_emb.shape != params.item_emb.shape):
        print(f"checkpoint {path} shape mismatch; starting fresh")
        return params
    print(f"resumed parameters from {path}")
    return loaded
