"""The port's elastic driver (``training/recovery.py``), case for case the
counterpart of ``tests/test_recovery.py``: a transient failure resumes from
the last full-state checkpoint and the recovered run is BIT-EQUAL
(``torch.equal``) to an uninterrupted one, for the compact trainer under Adam
and ``hybrid_adam``, the full-graph trainer and the full-node trainer; plus
the cases where the port departs from the JAX driver by design (the initial
state copy, the run identity, the checkpoint's directory, one metrics row per
epoch, the anchored classifier)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.training import recovery as jrecovery
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config, DataConfig, ModelConfig, TrainConfig)
from movie_recommender_system_with_gnns_tpu_torch.training import checkpoint as tckpt
from movie_recommender_system_with_gnns_tpu_torch.training.compact import LazyAdamState
from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
    prepare_training_data)
from movie_recommender_system_with_gnns_tpu_torch.training.recovery import (
    is_transient_error, recovery_checkpoint_path, train_with_recovery)
from movie_recommender_system_with_gnns_tpu_torch.training.train import (
    create_train_state, train_model)
from movie_recommender_system_with_gnns_tpu_torch.utils.observability import MetricsLogger

EPOCHS = 4
TRAINERS = {
    "compact_adam": dict(trainer="compact", optimizer="adam"),
    "compact_hybrid_adam": dict(trainer="compact", optimizer="hybrid_adam", fused_bpr=True),
    "fullgraph": dict(trainer="fullgraph", fullgraph_steps=2, hybrid_block_dtype="float32"),
    "full": dict(trainer="full"),
}


@pytest.fixture(autouse=True)
def deterministic():
    """The CPU's autograd scatter sums in a fixed order only in this mode."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _cfg(run_dir, name="compact_adam", every=1, **train):
    split = "interaction" if name == "fullgraph" else "edge"
    kw = dict(dict(epochs=EPOCHS, num_clusters=2, eval_top_k=10, lr=1e-2,
                   checkpoint_path=str(run_dir / "best.npz"),
                   histories_dir=str(run_dir / "hist"),
                   state_checkpoint_path=str(run_dir / "state.npz") if every else None,
                   state_checkpoint_every=every), **TRAINERS[name])
    return Config(
        data=DataConfig(dataset="synthetic", synthetic_users=120, synthetic_items=80,
                        synthetic_interactions=2000, split_level=split,
                        indexes_dir=str(run_dir.parent / f"idx_{split}")),
        model=ModelConfig(num_layers=2, dim=8),
        train=TrainConfig(**dict(kw, **train)))


_BUNDLES = {}


def _bundle(cfg):
    key = (cfg.data, cfg.train.trainer, cfg.train.optimizer)
    if key not in _BUNDLES:
        _BUNDLES[key] = prepare_training_data(cfg, device="cpu")
    return _BUNDLES[key]


def _leaves(st):
    ost = st.opt_state
    return [*st.params, *ost.mu, *ost.nu, ost.count, st.step]


def _assert_states_equal(a, b):
    assert type(a.opt_state) is type(b.opt_state)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


class _Run:
    """One training run with its best-val checkpoint and metrics log in
    ``run_dir``; ``fail_at`` epochs raise ``error`` from ``on_epoch_end`` once
    each (after that epoch's checkpoint)."""

    def __init__(self, cfg, fail_at=(), error=None):
        self.cfg, self.armed = cfg, list(fail_at)
        self.error = error or RuntimeError("UNAVAILABLE: Socket closed (injected drop)")
        self.calls = []
        os.makedirs(os.path.dirname(cfg.train.checkpoint_path) or ".", exist_ok=True)
        self.logger = MetricsLogger(os.path.join(cfg.train.histories_dir, "metrics.jsonl"))

    def on_epoch_end(self, epoch, metrics):
        self.calls.append(epoch)
        if self.armed and self.armed[0] == epoch:
            self.armed.pop(0)
            raise self.error

    def save(self, st, recall):
        tckpt.save_params(self.cfg.train.checkpoint_path, st.params, {"val_recall": recall})

    def __call__(self, recover=True, **kw):
        data, cl, val, test = _bundle(self.cfg)
        st = create_train_state(self.cfg, data.num_users, data.num_items, device="cpu")
        fn = train_with_recovery if recover else train_model
        if recover:
            kw = dict(dict(retry_backoff_s=0.0), **kw)
        return fn(self.cfg, st, cl, val, test, on_epoch_end=self.on_epoch_end,
                  save_checkpoint=self.save, metrics_logger=self.logger, **kw)

    def rows(self):
        return MetricsLogger.read(self.logger.path)


# --- the classifier ---------------------------------------------------------


@pytest.mark.parametrize("exc,want", [
    (RuntimeError("UNAVAILABLE: Socket closed"), True),
    (RuntimeError("DEADLINE_EXCEEDED: rpc timeout"), True),
    (ValueError("shape mismatch (3,) vs (4,)"), False),
    (RuntimeError("RESOURCE_EXHAUSTED: OOM"), False),
])
def test_transient_classifier(exc, want):
    """JAX's cases: the port agrees with JAX's classifier."""
    assert is_transient_error(exc) is want
    assert jrecovery.is_transient_error(exc) is want


class DeadlineExceeded(Exception):
    """A transport library's exception, named after its status."""


@pytest.mark.parametrize("exc,port,jax_says", [
    # a status anywhere but the prefix is a deterministic error here
    (RuntimeError("XLA compile failed with INTERNAL error: bad layout"), False, True),
    (RuntimeError("job notes: preempted twice last week; shape (3,) vs (4,)"), False, True),
    # sticky CUDA errors poison the context: no in-process retry can succeed
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False, False),
    (RuntimeError("UNAVAILABLE: CUDA error: uncorrectable ECC error encountered"), False, True),
    (RuntimeError("INTERNAL: device-side assert triggered"), False, True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False, False),
    # the status as the exception's type, the prefix, socket-level strings
    (DeadlineExceeded("rpc timed out"), True, False),
    (RuntimeError("  ABORTED: preempted"), True, True),
    (RuntimeError("INTERNAL: stream executor failure"), True, True),
    (ConnectionResetError("[Errno 104] Connection reset by peer"), True, True),
    (RuntimeError("failed to connect to all addresses"), True, True),
])
def test_transient_classifier_departures(exc, port, jax_says):
    """Anchored cases: where the port differs from JAX by design (prefix or
    type only, never a sticky CUDA error or an out-of-memory error)."""
    assert is_transient_error(exc) is port
    assert jrecovery.is_transient_error(exc) is jax_says


# --- bit-exact recovery -----------------------------------------------------


@pytest.mark.parametrize("name", list(TRAINERS))
def test_recovery_is_bitexact_vs_uninterrupted(tmp_path, name):
    """A transient drop after epoch 2's checkpoint: the recovered run's
    tables, moments, count, step, stitched histories, test metrics, best-val
    checkpoint and one-row-per-epoch metrics log equal the uninterrupted
    run's."""
    ref = _Run(_cfg(tmp_path / "ref", name))
    ref_state, ref_hist = ref(recover=False)
    rec = _Run(_cfg(tmp_path / "rec", name), fail_at=[2])
    rec_state, rec_hist = rec()
    assert rec.calls == [0, 1, 2, 3] and not rec.armed
    _assert_states_equal(rec_state, ref_state)
    if TRAINERS[name].get("optimizer") == "hybrid_adam":
        assert isinstance(rec_state.opt_state, LazyAdamState)
    for k in ("train_loss", "val_loss", "val_recall", "test_loss", "test_recall"):
        assert rec_hist[k] == ref_hist[k], k
    assert len(rec_hist["epoch_time_s"]) == EPOCHS
    a, _ = tckpt.load_params(rec.cfg.train.checkpoint_path, "cpu")
    b, _ = tckpt.load_params(ref.cfg.train.checkpoint_path, "cpu")
    assert torch.equal(a.user_emb, b.user_emb) and torch.equal(a.item_emb, b.item_emb)
    strip = lambda rows: [{k: v for k, v in r.items() if k not in ("ts", "epoch_time_s")}
                          for r in rows]
    assert strip(rec.rows()) == strip(ref.rows())
    assert [r["step"] for r in rec.rows()] == list(range(EPOCHS))


@pytest.mark.parametrize("name", ["compact_adam", "fullgraph"])
def test_recovery_failure_before_first_checkpoint(tmp_path, name, capsys):
    """A drop in epoch 0 before any checkpoint (one every 2 epochs): the
    port's state was trained in place by then, so the driver restarts from
    its copy of the initial state; the run equals the uninterrupted one."""
    ref_state, ref_hist = _Run(_cfg(tmp_path / "ref", name, every=2))(recover=False)
    rec = _Run(_cfg(tmp_path / "rec", name, every=2), fail_at=[0])
    rec_state, rec_hist = rec()
    assert "resuming from epoch 0" in capsys.readouterr().out
    assert rec.calls == [0, 0, 1, 2, 3]
    _assert_states_equal(rec_state, ref_state)
    assert rec_hist["train_loss"] == ref_hist["train_loss"]
    assert len(rec_hist["train_loss"]) == EPOCHS


@pytest.mark.parametrize("error", [
    ValueError("deterministic bug: must NOT be retried"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")])
def test_recovery_propagates_permanent_errors(tmp_path, error):
    """A failure that is not transient propagates on the first attempt."""
    run = _Run(_cfg(tmp_path / "run"), fail_at=[1, 1, 1], error=error)
    with pytest.raises(type(error), match=str(error)[:10]):
        run()
    assert run.calls == [0, 1]


def test_recovery_exhausts_retries(tmp_path):
    """The last transient failure propagates after ``max_retries``: a drop
    in every epoch from 1 on, each after its epoch's checkpoint."""
    run = _Run(_cfg(tmp_path / "run"), fail_at=[1, 2, 3])
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        run(max_retries=2)
    assert run.calls == [0, 1, 2, 3] and not run.armed


@pytest.mark.parametrize("stale", ["another_run", "an_earlier_call"])
def test_recovery_ignores_a_stale_checkpoint(tmp_path, stale):
    """A full-state file at the checkpoint path that this call did not write
    (another run's, or an earlier call's of the same config) is never
    resumed from: a drop before this call's first checkpoint restarts at
    epoch 0, and the run equals the uninterrupted one."""
    ref_state, _ = _Run(_cfg(tmp_path / "ref", every=2))(recover=False)
    cfg = _cfg(tmp_path / "rec", every=2)
    if stale == "another_run":
        other = _Run(_cfg(tmp_path / "rec", every=2, lr=5e-2))
        other()
    else:
        _Run(cfg)()
    assert tckpt.load_state_meta(cfg.train.state_checkpoint_path)["epoch"] == EPOCHS - 1
    rec = _Run(cfg, fail_at=[0])
    rec_state, _ = rec()
    assert rec.calls == [0, 0, 1, 2, 3]
    _assert_states_equal(rec_state, ref_state)


@pytest.mark.parametrize("ckpt", ["run/best.npz", "best.npz"])
def test_recovery_default_checkpoint_path(tmp_path, monkeypatch, ckpt):
    """With no state checkpoint configured, the driver's file lies in the
    run's directory (the best-val checkpoint's, else ``histories_dir``),
    never in the working directory."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(tmp_path / "r", every=0)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_path=ckpt, histories_dir=str(tmp_path / "hist")))
    want = os.path.join("run", "recovery_state.npz") if "/" in ckpt else str(
        tmp_path / "hist" / "recovery_state.npz")
    assert recovery_checkpoint_path(cfg) == want
    run = _Run(cfg, fail_at=[1])
    run()
    assert tckpt.load_state_meta(want)["epoch"] == EPOCHS - 1
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["hist", "idx_edge", "run"] if "/" in ckpt else ["hist", "idx_edge", "best.npz"])


def test_recovery_no_duplicate_metrics_rows(tmp_path):
    """Checkpoints every 2 epochs and a drop after epoch 2: epoch 2 runs
    twice, yet ``metrics.jsonl`` holds one row per epoch, and its values are
    the stitched history's."""
    run = _Run(_cfg(tmp_path / "run", every=2), fail_at=[2])
    _, hist = run()
    assert run.calls == [0, 1, 2, 2, 3]
    rows = run.rows()
    assert [r["step"] for r in rows] == list(range(EPOCHS))
    for k in ("train_loss", "val_loss", "val_recall"):
        assert [r[k] for r in rows] == hist[k]
    assert np.isfinite(hist["train_loss"]).all()
