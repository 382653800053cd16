"""Checkpoints in the JAX package's ``.npz`` layouts, so a file written by
either package loads in the other unchanged.

  * parameters (:func:`save_params` / :func:`load_params`): ``user_emb`` and
    ``item_emb`` arrays plus an optional ``_meta`` uint8 array holding JSON
    (JAX package ``training/checkpoint.py:28-50``);
  * the FULL training state (:func:`save_train_state` /
    :func:`load_train_state`, JAX ``:96-121``): tables, optimizer moments,
    counts and step as ``leaf_0 … leaf_{n-1}`` in the order
    ``jax.tree_util.tree_flatten`` gives the JAX state with the same
    optimizer and schedule, and a ``_meta`` JSON holding ``num_leaves`` (the
    resume point of ``training/recovery.py``).

Both are written atomically (a temporary file, then ``os.replace``).
:func:`save_params_orbax` / :func:`load_params_orbax` keep the names of JAX's
Orbax backend (``:72-94``) over the port's own step-numbered directories of
``params.npz`` files, with Orbax's rules for steps.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.lightgcn import LightGCNParams, params_from_numpy
from ..utils.device import DeviceLike, resolve_device


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _write_npz(path: str, arrs: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def save_params(path: str, params: LightGCNParams, meta: Optional[dict] = None) -> None:
    """Write the tables (and ``meta`` as JSON) atomically to ``path``."""
    arrs = {
        "user_emb": params.user_emb.detach().cpu().numpy(),
        "item_emb": params.item_emb.detach().cpu().numpy(),
    }
    if meta is not None:
        arrs["_meta"] = _meta_array(meta)
    _write_npz(path, arrs)


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


# ---------------------------------------------------------------------------
# Step-numbered parameter checkpoints (the names of JAX's Orbax backend)
# ---------------------------------------------------------------------------

PARAMS_FILE = "params.npz"


def latest_step(directory: str) -> Optional[int]:
    """The largest step saved under ``directory``: the largest name of a
    subdirectory made only of digits (None when there is none). Temporary
    directories of an unfinished save are ignored."""
    if not os.path.isdir(directory):
        return None
    steps = [int(n) for n in os.listdir(directory)
             if n.isdigit() and os.path.isdir(os.path.join(directory, n))]
    return max(steps, default=None)


def save_params_orbax(directory: str, params: LightGCNParams, step: int = 0) -> bool:
    """Save the two tables (no moments) as step ``step`` of ``directory``:
    ``<directory>/<step>/params.npz`` in :func:`save_params`' layout, its
    ``_meta`` holding the step, so either package's ``load_params`` reads it.

    The counterpart of JAX's ``save_params_orbax`` (``training/checkpoint.py:72``),
    in the port's own format: Orbax imports JAX. Its rules are Orbax's: a
    save at a step at or below the latest writes nothing and returns False
    (JAX's wrapper drops that value). The file is written into a temporary
    sibling directory that is then renamed to the step's name, so a crash
    never leaves a step directory without its file. A CUDA table is copied
    to the host once."""
    step = int(step)
    if step < 0:
        raise ValueError(f"step must be >= 0, got {step}")
    os.makedirs(directory, exist_ok=True)
    latest = latest_step(directory)
    if latest is not None and step <= latest:
        return False
    tmp = tempfile.mkdtemp(prefix=f".{step}.tmp-", dir=directory)
    try:
        save_params(os.path.join(tmp, PARAMS_FILE), params, meta={"step": step})
        os.rename(tmp, os.path.join(directory, str(step)))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return True


def load_params_orbax(directory: str, step: Optional[int] = None,
                      device: DeviceLike = None) -> LightGCNParams:
    """The tables of step ``step`` of ``directory`` (the latest when None), on
    ``resolve_device(device)``. The counterpart of JAX's ``load_params_orbax``
    (``training/checkpoint.py:86``) over :func:`save_params_orbax`' format; a
    directory that JAX's Orbax wrote is not read. An empty or missing
    directory, or a step that was not saved, raises ``FileNotFoundError``, as
    Orbax's ``restore`` does."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"No steps found in {directory}.")
    path = os.path.join(directory, str(int(step)), PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: step {step} was not saved by save_params_orbax "
            "(a directory written by JAX's Orbax backend is not read)")
    return load_params(path, resolve_device(device))[0]


# ---------------------------------------------------------------------------
# Full training state (tables + optimizer moments + counts + step)
# ---------------------------------------------------------------------------


def state_leaves(state, schedule_count: bool = False) -> List:
    """The state's leaves in the JAX state's ``tree_flatten`` order: tables
    and moments as tensors, counts and step as Python ints.

    * Adam (``optax.chain(clip, adam)``): ``[user, item, count, mu.user,
      mu.item, nu.user, nu.item, step]``; with a schedule (``lr_schedule=
      "cosine"``) optax also keeps the schedule's count, the same number,
      after ``nu.item``: 9 leaves.
    * :class:`~.compact.LazyAdamState`: ``[user, item, mu.user, mu.item,
      nu.user, nu.item, count, step]`` under any schedule."""
    from .compact import LazyAdamState
    from .train import AdamState

    ost = state.opt_state
    if isinstance(ost, LazyAdamState):
        return [*state.params, *ost.mu, *ost.nu, ost.count, state.step]
    if not isinstance(ost, AdamState):
        raise ValueError(f"unknown optimizer state {type(ost).__name__}")
    sched = [ost.count] if schedule_count else []
    return [*state.params, ost.count, *ost.mu, *ost.nu, *sched, state.step]


def save_train_state(path: str, state, meta: Optional[dict] = None,
                     schedule_count: bool = False) -> None:
    """Full-state checkpoint of a :class:`~.train.TrainState`, atomically:
    tables and moments as float arrays, counts and step as int32 scalars.
    ``schedule_count`` writes an Adam state's count a second time as the lr
    schedule's count, the leaf JAX's Adam state holds under ``lr_schedule=
    "cosine"``."""
    leaves = state_leaves(state, schedule_count)
    arrs = {f"leaf_{i}": (np.asarray(leaf, np.int32) if isinstance(leaf, int)
                          else leaf.detach().cpu().numpy())
            for i, leaf in enumerate(leaves)}
    arrs["_meta"] = _meta_array({"num_leaves": len(leaves), **(meta or {})})
    _write_npz(path, arrs)


def load_train_state(path: str, state_like):
    """The state in ``path``, in the structure of ``state_like`` (its
    optimizer's state type): tables and moments as new tensors on the device
    of ``state_like``'s tables, counts and step as Python ints. A file with
    the schedule's count (9 leaves of an Adam state) must hold the Adam count
    twice; a table must match ``state_like``'s shape and dtype."""
    from .compact import LazyAdamState
    from .train import AdamState, TrainState

    like = state_leaves(state_like, False)
    device = state_like.params.user_emb.device
    with np.load(path) as z:
        n = json.loads(bytes(z["_meta"]).decode())["num_leaves"]
        adam = isinstance(state_like.opt_state, AdamState)
        if n != len(like) + (1 if adam else 0) and n != len(like):
            raise ValueError(f"{path} holds {n} leaves; a "
                             f"{type(state_like.opt_state).__name__} state has "
                             f"{len(like)}" + (f" or {len(like) + 1}" if adam else ""))
        arrs = [z[f"leaf_{i}"] for i in range(n)]
    if n == len(like) + 1:      # Adam with the schedule's count
        sched = arrs.pop(7)
        if int(sched) != int(arrs[2]):
            raise ValueError(f"{path}: the schedule's count {int(sched)} differs "
                             f"from the Adam count {int(arrs[2])}")
    out = []
    for i, (a, ref) in enumerate(zip(arrs, like)):
        if isinstance(ref, int):
            if a.shape != () or not np.issubdtype(a.dtype, np.integer):
                raise ValueError(f"{path}: leaf {i} is not an integer scalar")
            out.append(int(a))
            continue
        t = torch.from_numpy(a)
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"{path}: leaf {i} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {ref.dtype} {tuple(ref.shape)}")
        out.append(t.to(device))
    P = LightGCNParams
    if adam:
        user, item, count, mu_u, mu_i, nu_u, nu_i, step = out
        ost = AdamState(count, P(mu_u, mu_i), P(nu_u, nu_i))
    else:
        user, item, mu_u, mu_i, nu_u, nu_i, count, step = out
        ost = LazyAdamState(P(mu_u, mu_i), P(nu_u, nu_i), count)
    return TrainState(P(user, item), ost, step)


def load_state_meta(path: str) -> dict:
    """The meta dict stored next to a full-state checkpoint (``num_leaves``,
    and e.g. the epoch it was taken after: the resume point of
    ``training/recovery.py``)."""
    with np.load(path) as z:
        return json.loads(bytes(z["_meta"]).decode())
