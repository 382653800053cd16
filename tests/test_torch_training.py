"""The training engine of the port (clip + Adam, schedules, train step, epoch
loop, ``train_model``, the pipeline's cluster half, ``cli train``) against the
JAX package on the same numpy inputs. Random streams differ between the two
frameworks, so negatives are injected wherever values are compared.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from movie_recommender_system_with_gnns_tpu import cli as jcli
from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, DataConfig as JData, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.models.lightgcn import LightGCNParams as JParams
from movie_recommender_system_with_gnns_tpu.training import checkpoint as jckpt
from movie_recommender_system_with_gnns_tpu.training import pipeline as jpipe
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu.utils import observability as jobs
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, DataConfig as TData, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
from movie_recommender_system_with_gnns_tpu_torch.training import checkpoint as tckpt
from movie_recommender_system_with_gnns_tpu_torch.training import pipeline as tpipe
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain
from movie_recommender_system_with_gnns_tpu_torch.training.compact import CompactClusters
from movie_recommender_system_with_gnns_tpu_torch.utils.observability import MetricsLogger

from torch_parity import CLUSTER_FIELDS, both_params, to_np


@pytest.mark.parametrize("grad_scale", [1e-3, 30.0])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_clip_adam_matches_optax(grad_scale, schedule):
    """Five steps of clip-by-global-norm → Adam on the same gradients: small
    gradients leave the clip idle, large ones trigger it (optax scales by
    max_norm / norm with no epsilon; Adam's eps sits outside the square root).
    Parameters within 1e-6 relative to the accumulated update."""
    kw = dict(lr=1e-2, lr_schedule=schedule, lr_warmup_steps=2, lr_total_steps=6,
              lr_final_frac=0.1)
    opt_j = jtrain.make_optimizer(JConfig(train=JTrain(**kw)))
    opt_t = ttrain.make_optimizer(TConfig(train=TTrain(**kw)))
    pj, pt = both_params(30, 40, 8, seed=0)
    rng = np.random.default_rng(1)
    st_j, st_t = opt_j.init(pj), opt_t.init(pt)
    for step in range(5):
        gu = (rng.standard_normal((30, 8)) * grad_scale).astype(np.float32)
        gi = (rng.standard_normal((40, 8)) * grad_scale).astype(np.float32)
        gi[::3] = 0.0          # rows no triplet touched
        upd, st_j = opt_j.update(JParams(jnp.asarray(gu), jnp.asarray(gi)), st_j, pj)
        pj = optax.apply_updates(pj, upd)
        pt, st_t = opt_t.update(pt, LightGCNParams(torch.from_numpy(gu),
                                                   torch.from_numpy(gi)), st_t)
        np.testing.assert_allclose(to_np(pt.user_emb), to_np(pj.user_emb), atol=2e-7, rtol=1e-6)
        np.testing.assert_allclose(to_np(pt.item_emb), to_np(pj.item_emb), atol=2e-7, rtol=1e-6)
    assert st_t.count == 5


def test_lr_schedules_match_optax():
    kw = dict(lr=3e-3, lr_schedule="cosine", lr_warmup_steps=4, lr_total_steps=20,
              lr_final_frac=0.05)
    lr_of = ttrain.make_lr_schedule(TConfig(train=TTrain(**kw)))
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 4, 20, 3e-3 * 0.05)
    for t in range(26):
        np.testing.assert_allclose(lr_of(t), float(ref(t)), rtol=1e-5, atol=1e-10)
    no_warm = ttrain.make_lr_schedule(TConfig(train=TTrain(
        lr=1e-3, lr_schedule="cosine", lr_total_steps=10)))
    assert no_warm(0) == pytest.approx(1e-3) and no_warm(10) == pytest.approx(0.0, abs=1e-12)
    assert ttrain.make_lr_schedule(TConfig())(7) == 1e-3
    with pytest.raises(ValueError, match="lr_total_steps"):
        ttrain.make_lr_schedule(TConfig(train=TTrain(lr_schedule="cosine")))
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        ttrain.make_lr_schedule(TConfig(train=TTrain(lr_schedule="step")))


def _pipeline_cfgs(tmp_path, trainer, **train):
    data = dict(dataset="synthetic", synthetic_users=60, synthetic_items=90,
                synthetic_interactions=2000)
    train = dict(dict(num_clusters=3, trainer=trainer, lr=1e-2), **train)
    model = dict(num_layers=2, dim=8)
    return (JConfig(data=JData(indexes_dir=str(tmp_path / "j"), **data),
                    model=JModel(**model), train=JTrain(**train)),
            TConfig(data=TData(indexes_dir=str(tmp_path / "t"), **data),
                    model=TModel(**model), train=TTrain(**train)))


def test_prepare_training_data_compact_matches_jax(tmp_path):
    cfg_j, cfg_t = _pipeline_cfgs(tmp_path, "compact", dense_adjacency_max_nodes=4096)
    bj = jpipe.prepare_training_data(cfg_j)
    bt = tpipe.prepare_training_data(cfg_t, device="cpu")
    assert isinstance(bt.train, CompactClusters)
    for f in CLUSTER_FIELDS:
        np.testing.assert_array_equal(to_np(getattr(bt.train, f)), to_np(getattr(bj.train, f)))
    assert bt.train.adj.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(bt.train.adj.float()),
                               np.asarray(bj.train.adj.astype(jnp.float32)), rtol=2 ** -7)
    for (gt, tt), (gj, tj) in ((bt.val, bj.val), (bt.test, bj.test)):
        for f in ("src", "dst", "w"):
            np.testing.assert_array_equal(to_np(getattr(gt, f)), to_np(getattr(gj, f)))
        for a, b in zip(tt, tj):
            np.testing.assert_array_equal(to_np(a), to_np(b))
    # a cluster set too wide for the dense blocks keeps the segment path
    narrow = cfg_t.replace(train=TTrain(num_clusters=3, dense_adjacency_max_nodes=8))
    assert tpipe.prepare_training_data(narrow, device="cpu").train.adj is None


def test_prepare_training_data_routes(tmp_path):
    _, cfg = _pipeline_cfgs(tmp_path, "full", partitioner="random_edges")
    bundle = tpipe.prepare_training_data(cfg, device="cpu")
    assert isinstance(bundle.train, list) and len(bundle.train) == 3
    assert isinstance(bundle.train[0], ttrain.ClusterBatch)
    one = tpipe.prepare_training_data(
        cfg.replace(train=TTrain(trainer="full", use_clusters=False)), device="cpu")
    assert len(one.train) == 1 and one.train[0].num_edges == bundle.splits[0].shape[1]
    with pytest.raises(ValueError, match="unknown trainer"):
        tpipe.prepare_training_data(cfg.replace(train=TTrain(trainer="other")), device="cpu")
    # feasible negatives: the compact and full-graph trainers carry the member
    # table; the full-node trainer warns (as JAX's does) and draws uniform ones
    for trainer, table in (("compact", True), ("fullgraph", True), ("full", False)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            b = tpipe.prepare_training_data(cfg.replace(train=TTrain(
                trainer=trainer, negatives="feasible", num_clusters=3)), device="cpu")
        warned = [x for x in w if "negatives='feasible'" in str(x.message)]
        assert len(warned) == (0 if table else 1)
        if table:
            assert b.train.member_table.dtype == torch.int64
    # the full-graph trainer and popularity negatives are routed
    fg = tpipe.prepare_training_data(cfg.replace(train=TTrain(
        trainer="fullgraph", negatives="popularity", num_clusters=3)), device="cpu")
    assert type(fg.train).__name__ == "FullGraphTrainData"
    assert fg.train.alias_table is not None and fg.train.hybrid.off_ell is not None
    pop = tpipe.prepare_training_data(cfg.replace(train=TTrain(
        trainer="full", negatives="popularity", num_clusters=3)), device="cpu")
    assert isinstance(pop.train, list) and len(pop.train) == 3


def test_full_node_steps_match_jax(tmp_path):
    """Five full-node train steps from the same tables, batches and injected
    negatives: parameters within 1e-5 after every step."""
    cfg_j, cfg_t = _pipeline_cfgs(tmp_path, "full")
    bj = jpipe.prepare_training_data(cfg_j)
    bt = tpipe.prepare_training_data(cfg_t, device="cpu")
    nu, ni = bt.data.num_users, bt.data.num_items
    pj, pt = both_params(nu, ni, 8, seed=2, std=0.05)
    opt = jtrain.make_optimizer(cfg_j)
    ost = opt.init(pj)
    state = ttrain.TrainState(pt, ttrain.make_optimizer(cfg_t).init(pt), 0)
    step = ttrain.make_train_step(cfg_t)
    rng = np.random.default_rng(3)
    for s in range(5):
        cj, ct = bj.train[s % 3], bt.train[s % 3]
        neg = rng.integers(0, ni, ct.batch.user.shape[0]).astype(np.int32)
        loss_j, grads = jax.value_and_grad(jtrain.compute_loss)(
            pj, cj.graph, cj.batch, jnp.asarray(neg), cfg_j)
        upd, ost = opt.update(grads, ost, pj)
        pj = optax.apply_updates(pj, upd)
        state, loss_t = step(state, ct.graph, ct.batch, None, neg=torch.from_numpy(neg))
        assert abs(float(loss_t) - float(loss_j)) < 1e-5
        np.testing.assert_allclose(to_np(state.params.user_emb), to_np(pj.user_emb), atol=1e-5)
        np.testing.assert_allclose(to_np(state.params.item_emb), to_np(pj.item_emb), atol=1e-5)
    assert state.step == 5


def test_full_node_step_bit_equal_over_two_runs(tmp_path):
    """The full-node trainer's graphs carry both kinds of row run, its step
    propagates through ``spmm_rows`` by default, and two steps from one
    state and negatives give the same tables and moments bit for bit (the
    card's counterpart is ``chip_smoke.py``'s check, fault C5)."""
    _, cfg = _pipeline_cfgs(tmp_path, "full")
    bt = tpipe.prepare_training_data(cfg, device="cpu")
    cb = bt.train[0]
    assert cb.graph.starts is not None and cb.graph.src_order is not None
    _, pt = both_params(bt.data.num_users, bt.data.num_items, 8, seed=5, std=0.05)
    step = ttrain.make_train_step(cfg)
    neg = torch.randint(0, bt.data.num_items, cb.batch.user.shape,
                        generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    runs = []
    for _ in range(2):
        p = LightGCNParams(pt.user_emb.clone(), pt.item_emb.clone())
        st, loss = step(ttrain.TrainState(p, ttrain.make_optimizer(cfg).init(p), 0),
                        cb.graph, cb.batch, None, neg=neg)
        runs.append(list(st.params) + list(st.opt_state.mu) + list(st.opt_state.nu) + [loss])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not torch.equal(runs[0][1], pt.item_emb)


def test_eval_step_matches_jax_loss(tmp_path):
    """The eval loss is the train loss on the eval graph; the recall is a
    Monte-Carlo estimate (tests/test_torch_bpr.py holds it to JAX on injected
    draws), here only in range and reproducible."""
    _, cfg = _pipeline_cfgs(tmp_path, "compact")
    bt = tpipe.prepare_training_data(cfg, device="cpu")
    _, pt = both_params(bt.data.num_users, bt.data.num_items, 8, seed=4)
    ev = ttrain.make_eval_step(cfg)
    l1, r1 = ev(pt, *bt.val, torch.Generator().manual_seed(5))
    l2, r2 = ev(pt, *bt.val, torch.Generator().manual_seed(5))
    np.testing.assert_allclose([float(l1), float(r1)], [float(l2), float(r2)], rtol=1e-6)
    assert np.isfinite(float(l1)) and 0.0 <= float(r1) <= 1.0
    assert not l1.requires_grad


@pytest.mark.parametrize("trainer", ["compact", "full"])
def test_train_model_end_to_end(tmp_path, trainer):
    """Three epochs on the tiny graph: the loss decreases, histories and the
    best-val checkpoint are written, the callbacks fire, and the checkpoint
    loads in the JAX package bit for bit."""
    _, cfg = _pipeline_cfgs(tmp_path, trainer, fused_bpr=True, epochs=3,
                            dense_adjacency_max_nodes=4096)
    bundle = tpipe.prepare_training_data(cfg, device="cpu")
    data, clusters, val, test = bundle
    state = ttrain.create_train_state(cfg, data.num_users, data.num_items, device="cpu")
    ckpt = str(tmp_path / "best.npz")
    saved, seen2, seen3, logged = [], [], [], []

    def save_cb(st, recall):
        saved.append(recall)
        tckpt.save_params(ckpt, st.params, meta={"val_recall": recall})

    class Logger:
        def log(self, epoch, **kw):
            logged.append((epoch, sorted(kw)))

    state, hist = ttrain.train_model(
        cfg, state, clusters, val, test, save_checkpoint=save_cb,
        on_epoch_end=lambda e, m, st: seen3.append((e, st.step)),
        metrics_logger=Logger())
    assert len(hist["train_loss"]) == 3 and hist["train_loss"][-1] < hist["train_loss"][0]
    assert all(np.isfinite(v) for k in hist for v in hist[k])
    assert set(hist) == {"train_loss", "val_loss", "val_recall", "epoch_time_s",
                         "test_loss", "test_recall"}
    assert saved and saved == sorted(saved) and saved[-1] == max(hist["val_recall"])
    steps = 3 * (clusters.num_clusters if trainer == "compact" else len(clusters))
    assert state.step == steps and seen3[-1] == (2, steps)
    assert logged[0] == (0, ["epoch_time_s", "train_loss", "val_loss", "val_recall"])
    ttrain.train_model(cfg.replace(train=TTrain(epochs=1, trainer=trainer, num_clusters=3)),
                       state, clusters, val, test,
                       on_epoch_end=lambda e, m: seen2.append(sorted(m)))
    assert seen2 == [["epoch_time_s", "train_loss", "val_loss", "val_recall"]]

    ttrain.save_histories(hist, str(tmp_path / "hist"))
    np.testing.assert_array_equal(np.load(tmp_path / "hist" / "hist_train_loss.npy"),
                                  np.asarray(hist["train_loss"]))
    # the checkpoint loads in the JAX package unchanged
    pj, meta = jckpt.load_params(ckpt)
    pt, meta_t = tckpt.load_params(ckpt, "cpu")
    np.testing.assert_array_equal(np.asarray(pj.user_emb), to_np(pt.user_emb))
    np.testing.assert_array_equal(np.asarray(pj.item_emb), to_np(pt.item_emb))
    assert meta == meta_t == {"val_recall": saved[-1]}


@pytest.mark.parametrize("trainer", ["compact", "full"])
def test_train_model_resumes_with_the_same_draws(tmp_path, trainer):
    """An epoch's generator depends on (seed, epoch) alone: a run continued at
    ``start_epoch`` from a copy of the state reproduces the uninterrupted one
    (the full-node trainer through its fused epoch)."""
    _, cfg = _pipeline_cfgs(tmp_path, trainer, epochs=3)
    data, clusters, val, test = tpipe.prepare_training_data(cfg, device="cpu")
    clone = lambda st: jax.tree_util.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, st)
    s0 = ttrain.create_train_state(cfg, data.num_users, data.num_items, device="cpu")
    full, hist = ttrain.train_model(cfg, clone(s0), clusters, val, test)
    part, _ = ttrain.train_model(cfg.replace(train=TTrain(**dict(
        epochs=2, num_clusters=3, lr=1e-2, trainer=trainer))), clone(s0), clusters, val,
        test)
    rest, hist2 = ttrain.train_model(cfg, part, clusters, val, test, start_epoch=2,
                                     best_recall=1.0)
    # same draws, so the same run up to the last bits of f32 sums
    np.testing.assert_allclose(to_np(rest.params.item_emb), to_np(full.params.item_emb),
                               atol=1e-6)
    np.testing.assert_allclose(hist2["train_loss"], hist["train_loss"][2:], rtol=1e-5)
    np.testing.assert_allclose(hist2["test_recall"], hist["test_recall"], rtol=1e-5)


def test_load_params_if_exists(tmp_path, capsys):
    _, pt = both_params(6, 7, 4, seed=0)
    path = str(tmp_path / "m.npz")
    assert tckpt.load_params_if_exists(path, pt) is pt
    tckpt.save_params(path, pt)
    _, other = both_params(6, 7, 4, seed=1)
    loaded = tckpt.load_params_if_exists(path, other)
    assert torch.equal(loaded.user_emb, pt.user_emb) and "resumed" in capsys.readouterr().out
    _, wrong = both_params(6, 9, 4, seed=1)
    assert tckpt.load_params_if_exists(path, wrong) is wrong
    assert "shape mismatch" in capsys.readouterr().out


def test_state_checkpoints_not_ported(tmp_path):
    """Full-state checkpoints are written now: every ``state_checkpoint_every``
    epochs, the state after that epoch with meta ``{"epoch": ...}``, which
    the JAX package's loader reads back into its own state."""
    path = str(tmp_path / "st.npz")
    assert ttrain.state_checkpoint_path(_pipeline_cfgs(tmp_path, "compact")[1]) is None
    assert ttrain.state_checkpoint_path(_pipeline_cfgs(
        tmp_path, "compact", state_checkpoint_path=path)[1]) is None   # every 0
    cfg_j, cfg = _pipeline_cfgs(tmp_path, "compact", state_checkpoint_path=path,
                                state_checkpoint_every=2, epochs=3)
    assert ttrain.state_checkpoint_path(cfg) == path
    data, cl, val, test = tpipe.prepare_training_data(cfg, device="cpu")
    seen = []
    st = ttrain.create_train_state(cfg, data.num_users, data.num_items, device="cpu")
    st, _ = ttrain.train_model(cfg, st, cl, val, test, state_meta={"run": "r"},
                               on_epoch_end=lambda e, m, s: seen.append(
                                   (e, (tmp_path / "st.npz").exists() and
                                    tckpt.load_state_meta(path)["epoch"],
                                    s.params.item_emb.clone())))
    # written after epoch 1 only (epochs 0..2, every 2)
    assert [(e, m) for e, m, _ in seen] == [(0, False), (1, 1), (2, 1)]
    assert tckpt.load_state_meta(path) == {"num_leaves": 8, "epoch": 1, "run": "r"}
    jst = jckpt.load_train_state(path, jtrain.create_train_state(
        cfg_j, data.num_users, data.num_items))
    np.testing.assert_array_equal(np.asarray(jst.params.item_emb), to_np(seen[1][2]))
    assert int(jst.step) == 2 * cl.num_clusters


def _cli_args(tmp_path, *extra):
    return ["--dataset", "synthetic", "--synthetic-users", "80",
            "--synthetic-items", "120", "--synthetic-interactions", "3000",
            "--indexes-dir", str(tmp_path / "idx"), "--epochs", "2", "--dim", "8",
            "--layers", "2", "--clusters", "3", *extra]


@pytest.mark.parametrize("extra", [["--fused-bpr"], ["--trainer", "full"],
                                   ["--fused-bpr", "--num-negatives", "2",
                                    "--loss", "standard", "--lr-schedule", "cosine"]])
def test_cli_train_then_recommend(tmp_path, capsys, extra):
    ckpt = str(tmp_path / "model.npz")
    common = ["--device", "cpu", "--checkpoint", ckpt,
              "--histories-dir", str(tmp_path / "hist")]
    assert tcli.main(common + _cli_args(tmp_path, "train", *extra)) == 0
    out = capsys.readouterr().out
    assert "Epoch: 001" in out and "Test Loss" in out and "device: cpu" in out
    assert (tmp_path / "hist" / "hist_val_recall.npy").exists()
    # a second run resumes from the checkpoint the first one wrote
    assert tcli.main(common + _cli_args(tmp_path, "train", *extra)) == 0
    assert "resumed parameters" in capsys.readouterr().out
    # the trained checkpoint serves in both packages, with the same answer
    args = ["--checkpoint", ckpt] + _cli_args(tmp_path, "recommend", "--user-id", "3")
    assert tcli.main(["--device", "cpu"] + args) == 0
    out_t = capsys.readouterr().out
    assert jcli.main(args) == 0
    assert capsys.readouterr().out == out_t and "Top 10" in out_t


@pytest.mark.parametrize("flags", [["--mesh", "2x2"], ["--max-retries", "1"]])
def test_cli_train_unported_flags(tmp_path, capsys, flags):
    """``--mesh 2x2`` without a launcher raises with the ``torchrun`` command
    line that runs it (``--mesh 1x1`` runs in one process:
    ``tests/test_torch_sharding.py``); ``--max-retries`` trains through the
    elastic driver, its recovery checkpoint in the run's directory."""
    run = tmp_path / "run"
    args = ["--device", "cpu", "--checkpoint", str(run / "m.npz"),
            "--histories-dir", str(tmp_path / "h")] + _cli_args(tmp_path, "train", *flags)
    if flags[0] == "--mesh":
        with pytest.raises(ValueError, match="torchrun --nproc-per-node=4 -m "
                           "movie_recommender_system_with_gnns_tpu_torch.cli train --mesh 2x2"):
            tcli.main(args)
        return
    run.mkdir()
    assert tcli.main(args) == 0
    out = capsys.readouterr().out
    assert f"full-state checkpoints at {run / 'recovery_state.npz'}" in out
    assert tckpt.load_state_meta(str(run / "recovery_state.npz"))["epoch"] == 1
    rows = MetricsLogger.read(str(tmp_path / "h" / "metrics.jsonl"))
    assert [r["step"] for r in rows] == [0, 1]


@pytest.mark.parametrize("flags,match", [(["--negatives", "feasible"], "feasible")])
def test_cli_train_unported_modes_raise(tmp_path, capsys, flags, match):
    """``--negatives feasible`` trains now (compact trainer, member table
    attached), and every ``train`` writes one metrics row per epoch."""
    hist = tmp_path / "h"
    assert tcli.main(["--device", "cpu", "--checkpoint", str(tmp_path / "m.npz"),
                      "--histories-dir", str(hist)]
                     + _cli_args(tmp_path, "train", *flags, "--fused-bpr")) == 0
    assert "Test Loss" in capsys.readouterr().out
    rows = jobs.MetricsLogger.read(str(hist / "metrics.jsonl"))
    assert [r["step"] for r in rows] == [0, 1]
    assert set(rows[0]) == {"step", "ts", "train_loss", "val_loss", "val_recall",
                            "epoch_time_s"}
    np.testing.assert_array_equal(np.load(hist / "hist_train_loss.npy"),
                                  [r["train_loss"] for r in rows])
