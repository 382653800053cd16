"""Elastic training driver: retry transient failures from the last full-state
checkpoint (JAX package ``training/recovery.py``).

:func:`train_with_recovery` wraps :func:`training.train.train_model` so that
a transient failure (a dropped connection, a preempted worker, an error whose
message starts with a retryable status) resumes from the newest periodic
full-state checkpoint (tables, optimizer moments, counts and step), and the
recovered run is **bit-identical** to an uninterrupted one:

  * ``save_train_state`` files are atomic (tmp + rename) and carry the epoch
    they were taken after;
  * each epoch's generator is seeded from ``(seed, epoch)`` alone
    (``train.epoch_generator``), so epoch E of a resumed run draws what epoch
    E of the uninterrupted run drew;
  * a step is run-to-run deterministic on the card (every scatter of
    repeated rows sums in an order fixed by the data).

Where it departs from the JAX driver, by design:

  * the port's ``train_model`` updates tables and moments IN PLACE, so the
    state handed in is half-trained by the time a failure arrives. The driver
    keeps a host copy of the initial state and restarts from it when no
    checkpoint of this run exists yet;
  * each checkpoint's meta carries a run identity (a hash of the config and
    an id drawn once per call); a file from another run or another call is
    never resumed from: the run restarts at epoch 0 instead;
  * the checkpoint it turns on lies in the run's directory
    (``dirname(cfg.train.checkpoint_path)``, or ``histories_dir`` when that is
    empty), not in the working directory;
  * a metrics logger gets one row per epoch: epochs re-run after a resume
    are not logged again;
  * status names match only as the message's prefix (``"UNAVAILABLE: …"``)
    or as the exception's type; only the socket-level strings match anywhere.

No fallback: a failure that is not transient propagates at once, and so does
the last one after ``max_retries``; nothing carries on on the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import time
import uuid
from typing import Callable, Dict, List, Optional

import torch

from ..config import Config

#: retryable status names (gRPC's); DATA_LOSS / RESOURCE_EXHAUSTED are not
TRANSIENT_STATUSES = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED",
                      "INTERNAL")
#: socket-level strings of a dropped connection, matched anywhere
TRANSIENT_SOCKET = ("Socket closed", "socket closed", "connection reset",
                    "Connection reset", "failed to connect")
#: everything that marks a failure as transient
TRANSIENT_MARKERS = TRANSIENT_STATUSES + TRANSIENT_SOCKET
#: a CUDA error poisons the process's context (illegal address, ECC, a
#: device-side assert): a retry in the same process cannot succeed
STICKY_CUDA = ("CUDA error", "illegal memory access", "illegal address",
               "uncorrectable ECC", "device-side assert", "CUBLAS_STATUS",
               "CUDNN_STATUS")


def _status_of_type(exc: BaseException) -> str:
    """``DeadlineExceeded`` -> ``DEADLINE_EXCEEDED``."""
    return re.sub(r"(?<!^)(?=[A-Z])", "_", type(exc).__name__).upper()


def is_transient_error(exc: BaseException) -> bool:
    """True when ``exc`` is a transient failure worth a retry: its message
    starts with a status of :data:`TRANSIENT_STATUSES` and a colon, its type
    is named after one (``Unavailable``, ``DeadlineExceeded``), or its message
    holds a socket-level string of :data:`TRANSIENT_SOCKET`.

    Never transient: ``torch.cuda.OutOfMemoryError`` (the same step needs the
    same memory again) and the sticky CUDA errors of :data:`STICKY_CUDA`,
    which poison the CUDA context so that no retry in this process can
    succeed; nor a status named anywhere but the prefix (an ``INTERNAL``
    inside a longer message is a deterministic error)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    msg = str(exc)
    if any(m in msg for m in STICKY_CUDA):
        return False
    head = msg.lstrip()
    return (any(head.startswith(s + ":") for s in TRANSIENT_STATUSES)
            or _status_of_type(exc) in TRANSIENT_STATUSES
            or any(m in msg for m in TRANSIENT_SOCKET))


def recovery_checkpoint_path(cfg: Config) -> str:
    """The full-state checkpoint :func:`train_with_recovery` uses:
    ``cfg.train.state_checkpoint_path`` when periodic checkpoints are on,
    else ``recovery_state.npz`` in the run's directory
    (``dirname(cfg.train.checkpoint_path)``, or ``cfg.train.histories_dir``
    when that is empty)."""
    from .train import state_checkpoint_path

    path = state_checkpoint_path(cfg)
    if path:
        return path
    run_dir = os.path.dirname(cfg.train.checkpoint_path) or cfg.train.histories_dir
    return os.path.join(run_dir, "recovery_state.npz")


def state_to(state, device):
    """A copy of a train state's tables and moments on ``device`` (counts and
    step are ints)."""
    copy = lambda p: type(p)(*(t.detach().to(device, copy=True) for t in p))
    ost = type(state.opt_state)(*(f if isinstance(f, int) else copy(f)
                                  for f in state.opt_state))
    return type(state)(copy(state.params), ost, state.step)


class _OncePerEpoch:
    """A metrics logger's stand-in that forwards each epoch's row once."""

    def __init__(self, logger):
        self.logger = logger
        self.logged = set()

    def log(self, step: int, **metrics) -> None:
        if step not in self.logged:
            self.logged.add(step)
            self.logger.log(step, **metrics)


def train_with_recovery(
    cfg: Config,
    state,
    clusters,
    val,
    test,
    max_retries: int = 2,
    retry_backoff_s: float = 1.0,
    is_transient: Callable[[BaseException], bool] = is_transient_error,
    on_epoch_end: Optional[Callable] = None,
    metrics_logger=None,
    **train_kw,
):
    """Run :func:`train_model` to completion across transient failures.

    Periodic full-state checkpoints are needed: when ``cfg.train`` sets none,
    they are turned on every epoch at :func:`recovery_checkpoint_path` (a
    printed notice says so). Returns ``(state, hist)`` like ``train_model``;
    ``hist`` is stitched across attempts, an epoch that ran twice keeping its
    last values (equal to the first by the bit-exactness above).
    ``state`` is trained in place by the first attempt; the result of a
    recovered run is a new state."""
    from .checkpoint import load_state_meta, load_train_state
    from .compact import LAZY_OPTIMIZERS, CompactClusters, LazyAdamState, init_lazy_adam
    from .train import TrainState, _callback_takes_state, state_checkpoint_path, train_model

    if not state_checkpoint_path(cfg):
        path = recovery_checkpoint_path(cfg)
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, state_checkpoint_path=path, state_checkpoint_every=1))
        print(f"recovery: enabling per-epoch full-state checkpoints at {path} "
              "(cfg.train.state_checkpoint_path was unset)")
    ckpt_path = cfg.train.state_checkpoint_path
    os.makedirs(os.path.dirname(os.path.abspath(ckpt_path)), exist_ok=True)
    run = {"config_sha256": hashlib.sha256(cfg.to_json().encode()).hexdigest(),
           "call": uuid.uuid4().hex}

    # train_model swaps fresh lazy moments in for the lazy optimizers; do it
    # here so the initial copy and every reload have the structure the
    # checkpoints are written with
    if (isinstance(clusters, CompactClusters) and cfg.train.optimizer in LAZY_OPTIMIZERS
            and not isinstance(state.opt_state, LazyAdamState)):
        state = TrainState(state.params, init_lazy_adam(state.params), state.step)
    device = state.params.user_emb.device
    initial = state_to(state, "cpu")

    per_epoch: Dict[int, Dict[str, float]] = {}
    fwd_state = on_epoch_end is not None and _callback_takes_state(on_epoch_end)

    def record(epoch: int, metrics: Dict[str, float], st) -> None:
        # declares 3 params so train_model hands over the live state; it is
        # forwarded only to callbacks that themselves opt in
        per_epoch[epoch] = dict(metrics)
        if on_epoch_end is not None:
            if fwd_state:
                on_epoch_end(epoch, metrics, st)
            else:
                on_epoch_end(epoch, metrics)

    logger = None if metrics_logger is None else _OncePerEpoch(metrics_logger)
    start_epoch, best_recall, attempt = 0, 0.0, 0
    while True:
        try:
            final_state, hist = train_model(
                cfg, state, clusters, val, test, on_epoch_end=record,
                metrics_logger=logger, start_epoch=start_epoch,
                best_recall=best_recall, state_meta={"run": run}, **train_kw)
            break
        except Exception as exc:  # noqa: BLE001 (filtered right below)
            if not is_transient(exc) or attempt >= max_retries:
                raise
            attempt += 1
            meta = load_state_meta(ckpt_path) if os.path.exists(ckpt_path) else {}
            if meta.get("run") == run:
                state = load_train_state(ckpt_path, state)
                start_epoch = int(meta["epoch"]) + 1
            else:   # before this run's first checkpoint
                state = state_to(initial, device)
                start_epoch = 0
            best_recall = max((m["val_recall"] for e, m in per_epoch.items()
                               if e < start_epoch), default=0.0)
            print(f"recovery: transient failure ({type(exc).__name__}: "
                  f"{str(exc)[:200]}); resuming from epoch {start_epoch} (attempt "
                  f"{attempt}/{max_retries}) after {retry_backoff_s:.1f}s")
            time.sleep(retry_backoff_s)

    stitched: Dict[str, List[float]] = {
        k: [per_epoch[e][k] for e in sorted(per_epoch)]
        for k in ("train_loss", "val_loss", "val_recall", "epoch_time_s")}
    stitched["test_loss"] = hist["test_loss"]
    stitched["test_recall"] = hist["test_recall"]
    return final_state, stitched
