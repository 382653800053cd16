"""The port's example drivers (``examples/torch_*.py``) run in process on the
CPU at a tiny size: their artifacts, the JAX drivers' rules, and each
against the port's modules composed by hand."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
    make_synthetic_movielens)
from movie_recommender_system_with_gnns_tpu_torch.training import compact
from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import load_params
from movie_recommender_system_with_gnns_tpu_torch.training.fullgraph import (
    build_fullgraph_data, make_fullgraph_epoch_fn)
from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
    prepare_training_data)
from movie_recommender_system_with_gnns_tpu_torch.training.train import (
    TrainState, create_train_state, epoch_generator)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TINY = dict(users=600, items=400, interactions=12_000, communities=8, power=0.9)
BRIDGE_GRAPH = ["--users", "1500", "--items", "600", "--interactions", "30000"]


def driver(name: str):
    spec = importlib.util.spec_from_file_location(f"_driver_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def ml25m(monkeypatch):
    mod = driver("torch_train_ml25m_scale")
    monkeypatch.setattr(mod, "GRAPH", TINY)
    return mod


def rows(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def test_ml25m_writes_metrics_histories_and_checkpoints(ml25m, tmp_path):
    out = tmp_path / "run"
    res = ml25m.main(["--epochs", "2", "--eval-every", "1", "--eval-users", "200",
                      "--dim", "8", "--layers", "2", "--device", "cpu", "--out", str(out)])
    recs = rows(out / "metrics.jsonl")
    assert [r["step"] for r in recs if "train_loss" in r] == [0, 1]
    assert [r["step"] for r in recs if "val_full_recall10" in r] == [0, 1]
    test = [r for r in recs if "test_full_recall10" in r]
    assert len(test) == 1 and test[0]["test_full_recall10"] == pytest.approx(res["test"][0])
    assert np.isfinite(res["test"]).all()
    for name in ("hist_train_loss", "hist_val_loss", "hist_val_recall"):
        assert np.load(out / f"{name}.npy").shape == (2,)
    np.testing.assert_array_equal(res["history"]["train_loss"],
                                  np.load(out / "hist_train_loss.npy"))
    for ckpt in ("best_model.npz", "best_fullrank.npz"):
        params, meta = load_params(str(out / ckpt), device="cpu")
        assert params.user_emb.shape == (TINY["users"], 8) and meta


def test_ml25m_microbatched_loss_and_cosine_total(ml25m, tmp_path, capsys):
    """--loss-microbatches 4 gives the first-epoch loss of one batch (A6a's
    tolerance, tests/test_torch_microbatched.py); the cosine schedule spans
    the trainer's steps per epoch times the epochs."""
    base = ["--trainer", "fullgraph", "--dim", "16", "--num-negatives", "2",
            "--negatives", "popularity", "--loss", "standard", "--readout", "standard",
            "--split", "interaction", "--lr", "3e-3", "--lr-schedule", "cosine",
            "--epochs", "2", "--eval-every", "2", "--eval-users", "100", "--device", "cpu"]
    losses, totals = {}, {}
    for micro in ("4", "0"):
        out = tmp_path / f"micro{micro}"
        res = ml25m.main(base + ["--loss-microbatches", micro, "--out", str(out)])
        losses[micro] = rows(out / "metrics.jsonl")[0]["train_loss"]
        totals[micro] = res["lr_total_steps"]
        assert res["lr_total_steps"] == res["state"].step > 2
        assert res["state"].step % 2 == 0
    np.testing.assert_allclose(losses["4"], losses["0"], atol=1e-5)
    assert totals["4"] == totals["0"]
    assert f"cosine lr: {totals['0']} total steps" in capsys.readouterr().out


def test_bridge_schedule_follows_jax_rule(tmp_path, capsys):
    mod = driver("torch_train_bridge")
    res = mod.main(["--epochs", "3", "--refresh-every", "2", "--eval-every", "3",
                    "--dim", "8", "--layers", "2", "--num-negatives", "2",
                    "--eval-users", "200", "--final-eval-users", "300",
                    "--correction", "none", "--device", "cpu", "--out", str(tmp_path)]
                   + BRIDGE_GRAPH)
    # train_bridge.py:232-233: every refresh_every-th epoch is a refresh
    assert res["kinds"] == ["FULL" if (e + 1) % 2 == 0 else "comp" for e in range(3)]
    out = capsys.readouterr().out
    assert "Epoch 001 [FULL]" in out and "Epoch 002 [comp]" in out
    assert "boundary correction" not in out
    args = mod.parse_args(["--refresh-every", "0"])
    assert not any(mod.is_refresh(args, e) for e in range(10))


def test_bridge_hybrid_epochs_equal_a_hand_composition(tmp_path, monkeypatch):
    """Under hybrid_adam a compact epoch and then a refresh leave the tables,
    both moments and the count equal to the port's two epoch fns composed by
    hand from the same state and draws; the correction is built once and
    again after the refresh."""
    mod = driver("torch_train_bridge")
    built = []
    real_build = compact.build_boundary_correction

    def counted(*a, **kw):
        built.append(1)
        return real_build(*a, **kw)

    monkeypatch.setattr(compact, "build_boundary_correction", counted)
    argv = ["--epochs", "2", "--refresh-every", "2", "--eval-every", "2",
            "--compact-optimizer", "hybrid_adam", "--dim", "8", "--layers", "2",
            "--num-negatives", "2", "--eval-users", "200", "--final-eval-users", "300",
            "--device", "cpu", "--out", str(tmp_path)] + BRIDGE_GRAPH
    res = mod.main(argv)
    assert res["kinds"] == ["comp", "FULL"]
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert len(built) == 1 + 1

    cfg_c, cfg_f = mod.configs(mod.parse_args(argv))
    data, cc, _, _ = bundle = prepare_training_data(cfg_c, device="cpu")
    train_e = bundle.splits[0]
    fg = build_fullgraph_data(cfg_f, train_e, data.num_users,
                              data.num_users + data.num_items, device="cpu")
    st = create_train_state(cfg_c, data.num_users, data.num_items, device="cpu")
    st = TrainState(st.params, compact.init_lazy_adam(st.params), st.step)
    cc = cc.with_correction(*real_build(st.params, fg.hybrid, cc, cfg_c, data.num_users))
    cpu = torch.device("cpu")
    st, _ = compact.make_compact_epoch_fn(cfg_c)(st, cc, epoch_generator(cfg_c, 0, cpu))
    fst = TrainState(st.params, compact.lazy_state_to_optax(st.opt_state), st.step)
    fst, _ = make_fullgraph_epoch_fn(cfg_f, fg)(fst, fg, epoch_generator(cfg_c, 1, cpu))
    st = TrainState(fst.params, compact.lazy_state_from_optax(fst.opt_state), fst.step)

    got = res["state"]
    assert isinstance(got.opt_state, compact.LazyAdamState)
    assert got.step == st.step and got.opt_state.count == st.opt_state.count == 100 + fg.num_steps
    for a, b in zip(got.params + got.opt_state.mu + got.opt_state.nu,
                    st.params + st.opt_state.mu + st.opt_state.nu):
        assert torch.equal(a, b)


def test_sharded_1x1_writes_a_checkpoint(tmp_path):
    import torch.distributed as dist

    mod = driver("torch_train_sharded")
    was = dist.is_initialized()
    path = mod.main(["--mesh", "1x1", "--epochs", "1", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert dist.is_initialized() == was    # a group the driver starts, it ends
    params, meta = load_params(path, device="cpu")
    data = make_synthetic_movielens(943, 1682, 100_000, seed=0)
    assert params.user_emb.shape == (data.num_users, 64)
    assert params.item_emb.shape == (data.num_items, 64)
    assert meta["val_recall"] > 0
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=2"):
        mod.main(["--mesh", "2x1", "--device", "cpu", "--out", str(tmp_path)])
    # JAX's --platform spells the same option
    assert mod.parse_args(["--platform", "cpu"]).device == "cpu"
    assert mod.parse_args([]).device == "cuda"


def test_profile_prints_top_ops_and_a_floor(tmp_path, capsys):
    mod = driver("torch_profile_epoch")
    res = mod.main(["--scale", "tiny", "--epochs", "1", "--device", "cpu",
                    "--logdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "top ops by self CPU time" in out and "idle share not measured" in out
    assert "epoch floor" in out and "rowop_util" in out
    assert len(res["top_ops"]) == 30 and res["idle_share"] is None
    assert res["floor_s"] > 0 and res["rowop_util"] == pytest.approx(
        res["floor_s"] / res["epoch_s"])
    assert (tmp_path / "epoch_trace.json").exists()
