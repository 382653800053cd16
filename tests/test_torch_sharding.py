"""The port's multi-device segment path (``parallel/``, ``training/distributed.py``,
the ``mesh`` arguments of eval and serving) against the JAX package.

Ranks are gloo processes on the CPU (``torch_dist_ranks.spawn``); the JAX side
runs on conftest's 8 virtual CPU devices, ``make_mesh(dp, mp,
devices=jax.devices()[:dp * mp])``, as ``tests/test_sharding.py`` does. The
three groups of checks share one 4-rank spawn (``torch_dist_ranks.grouped``,
a module-scoped fixture).

Tolerances, from ``tests/test_sharding.py``: one sharded step's loss within
rtol 2e-5 and its tables within rtol 2e-4 / atol 1e-6 of JAX's sharded step on
the same mesh; the unclipped SGD step's gradient within rtol 1e-4 / atol 1e-6
of JAX's single-device gradient times its clip; serving tables rtol 2e-5 /
atol 1e-6; the mesh eval within 1e-6 of the single-device eval; the sharded
top-k scores rtol 1e-4 / atol 1e-5 of the local one, same indices; the
histories of ``train_model_sharded`` on different meshes within 1e-5 of
each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.data.graph import COOGraph as JCOO
from movie_recommender_system_with_gnns_tpu.data.movielens import split_edges
from movie_recommender_system_with_gnns_tpu.models.lightgcn import LightGCNParams as JParams
from movie_recommender_system_with_gnns_tpu.ops.sampling import TripletBatch as JBatch
from movie_recommender_system_with_gnns_tpu.ops.sampling import triplets_from_edges
from movie_recommender_system_with_gnns_tpu.ops.spmm import DeviceCOO as JDeviceCOO
from movie_recommender_system_with_gnns_tpu.parallel import mesh as jmesh
from movie_recommender_system_with_gnns_tpu.parallel import sharding as jsh
from movie_recommender_system_with_gnns_tpu.serving.recommend import (
    compute_serving_tables as j_tables)
from movie_recommender_system_with_gnns_tpu.training.train import compute_loss
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import params_from_numpy
from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import TripletBatch
from movie_recommender_system_with_gnns_tpu_torch.parallel import mesh as tmesh
from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as tsh
from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
    compute_serving_tables as t_tables)
from movie_recommender_system_with_gnns_tpu_torch.training.evaluate import (
    evaluate_full_ranking as t_eval)
from movie_recommender_system_with_gnns_tpu_torch.utils.observability import MetricsLogger

import torch_dist_ranks as ranks
from torch_parity import np_tables

LAYERS, DIM, B = 2, 8, 2048


def _jcfg(**train):
    return JConfig(model=JModel(num_layers=LAYERS, dim=DIM), train=JTrain(lr=1e-2, **train))


def _jmesh(dp, mp):
    return jmesh.make_mesh(dp, mp, devices=jax.devices()[:dp * mp])


@pytest.mark.parametrize("pm", [1, 2, 4, 3])
def test_host_layout_equals_jax(tiny_data, pm):
    """ShardPlan, shard_graph, pad_params and pad_batch give JAX's arrays
    exactly (pm = 3 leaves uneven shards)."""
    nu, ni = tiny_data.num_users, tiny_data.num_items
    e = tiny_data.edge_index
    pj, pt = jsh.ShardPlan.create(nu, ni, pm), tsh.ShardPlan.create(nu, ni, pm)
    assert (pt.u_pad, pt.i_pad, pt.u_loc, pt.i_loc, pt.n_pad) == \
        (pj.u_pad, pj.i_pad, pj.u_loc, pj.i_loc, pj.n_pad)
    gj, gt = jsh.shard_graph(e, pj), tsh.shard_graph(e, pt)
    for f in ("src", "dst_local", "w"):
        a, b = np.asarray(getattr(gj, f)), getattr(gt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # the pads (the only zero weights) point at the last local row
    pads = gt.w == 0
    assert pads.any() and (gt.dst_local[pads] == pt.u_loc + pt.i_loc - 1).all()
    u, i = np_tables(nu, ni, DIM, seed=1)
    jp = jsh.pad_params(JParams(jnp.asarray(u), jnp.asarray(i)), pj)
    tp = tsh.pad_params(params_from_numpy(u, i, "cpu"), pt)
    for a, b in zip(jp, tp):
        assert np.array_equal(np.asarray(a), b.numpy())
    back = tsh.unpad_params(tp, pt)
    assert np.array_equal(back.user_emb.numpy(), u) and np.array_equal(back.item_emb.numpy(), i)
    # every edge lands once, on the rank that owns its destination
    coos = [c for m in range(pm) for c in tsh.shard_coos(gt, pt, m, "cpu")]
    assert sum(int((c.w != 0).sum()) for c in coos) == int((gt.w != 0).sum())
    assert all(c.num_src == pt.n_pad and c.num_nodes == pt.u_loc + pt.i_loc for c in coos)
    bj = triplets_from_edges(e, nu)
    bt = TripletBatch(*(torch.from_numpy(np.array(x)) for x in bj))
    for a, b in zip(jsh.pad_batch(bj, pm), tsh.pad_batch(bt, pm)):
        assert np.array_equal(np.asarray(a), b.numpy())
    for axis in (0, 1):
        xj, nj = jmesh.pad_to_multiple(u, pm, axis)
        xt, nt = tmesh.pad_to_multiple(u, pm, axis)
        assert nj == nt and np.array_equal(xj, xt)


@pytest.fixture(scope="module")
def step_inputs(tiny_data):
    nu, ni = tiny_data.num_users, tiny_data.num_items
    rng = np.random.default_rng(7)
    u, i = np_tables(nu, ni, DIM, seed=0, std=0.1)
    # std well above the reference's: at a tiny init the standard loss's
    # gradients nearly cancel (JAX test_sharded_multineg_and_loss_match_single_device)
    u3, i3 = np_tables(nu, ni, DIM, seed=3, std=0.3)
    b = triplets_from_edges(tiny_data.edge_index, nu, pad_to=B)
    return dict(edges=tiny_data.edge_index, u=u, i=i, u3=u3, i3=i3,
                user=np.asarray(b.user), pos=np.asarray(b.pos_item), mask=np.asarray(b.mask),
                neg=rng.integers(0, ni, B).astype(np.int32),
                neg3=rng.integers(0, ni, (B, 3)).astype(np.int32),
                layers=LAYERS, dim=DIM)


@pytest.fixture(scope="module")
def spawned(step_inputs, tables_inputs, train_inputs, tmp_path_factory):
    """One 4-rank spawn for the three groups of checks, its outputs split by
    group (``train_runs`` ends the group, so it goes last)."""
    groups = dict(sharded_steps=step_inputs, mesh_tables=tables_inputs,
                  train_runs=train_inputs)
    inputs = {f"{g}__{k}": v for g, inp in groups.items() for k, v in inp.items()}
    out = ranks.spawn(ranks.grouped, 4, tmp_path_factory.mktemp("ranks"),
                      dict(inputs, groups=np.asarray(list(groups))))
    return {g: {k[len(g) + 2:]: v for k, v in out.items() if k.startswith(g + "__")}
            for g in groups}


@pytest.fixture(scope="module")
def steps_out(spawned):
    return spawned["sharded_steps"]


def _jbatch(inp):
    return JBatch(jnp.asarray(inp["user"]), jnp.asarray(inp["pos"]), jnp.asarray(inp["mask"]))


@pytest.mark.parametrize("dp,mp", ranks.SHAPES)
def test_sharded_step_matches_jax(step_inputs, steps_out, dp, mp):
    """One Adam step on the same mesh shape, tables, batch and negatives as
    JAX's ``make_sharded_train_step``."""
    inp, cfg = step_inputs, _jcfg()
    nu, ni = inp["u"].shape[0], inp["i"].shape[0]
    plan = jsh.ShardPlan.create(nu, ni, mp)
    p_pad = jsh.pad_params(JParams(jnp.asarray(inp["u"]), jnp.asarray(inp["i"])), plan)
    adam = optax.adam(cfg.train.lr)
    state = (p_pad, adam.init(p_pad), jnp.zeros((), jnp.int32))
    step = jsh.make_sharded_train_step(cfg, _jmesh(dp, mp), plan, opt=adam)(state)
    state2, loss = step(state, jsh.shard_graph(inp["edges"], plan), _jbatch(inp),
                        jnp.asarray(inp["neg"]))
    ref = jsh.unpad_params(state2[0], plan)
    tag = f"{dp}x{mp}"
    np.testing.assert_allclose(float(steps_out[f"{tag}_loss"]), float(loss), rtol=2e-5)
    np.testing.assert_allclose(steps_out[f"{tag}_u"], np.asarray(ref.user_emb),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(steps_out[f"{tag}_i"], np.asarray(ref.item_emb),
                               rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def jax_grads(step_inputs):
    """JAX's single-device loss and clipped gradient of the three-negative
    step, per loss."""
    inp = step_inputs
    n = inp["u3"].shape[0] + inp["i3"].shape[0]
    coo = JDeviceCOO.from_host(JCOO.build(inp["edges"], n))
    params = JParams(jnp.asarray(inp["u3"]), jnp.asarray(inp["i3"]))
    out = {}
    for lname in ("reference", "standard"):
        cfg = _jcfg(loss=lname, num_negatives=3)
        loss, g = jax.jit(jax.value_and_grad(compute_loss), static_argnums=4)(
            params, coo, _jbatch(inp), jnp.asarray(inp["neg3"]), cfg)
        gn = np.sqrt(sum(float(jnp.sum(x ** 2)) for x in jax.tree.leaves(g)))
        scale = min(1.0, float(cfg.train.grad_clip_norm) / max(gn, 1e-6))
        out[lname] = (float(loss), np.asarray(g.user_emb) * scale,
                      np.asarray(g.item_emb) * scale)
    return out


@pytest.mark.parametrize("loss", ["reference", "standard"])
@pytest.mark.parametrize("dp,mp", ranks.SHAPES)
def test_sharded_sgd_gradient_matches_jax(steps_out, jax_grads, dp, mp, loss):
    """The unclipped SGD(1.0) step exposes the step's clipped gradient, which
    a uniform rescale (a stray ``dp`` or ``pm`` factor) would change, unlike
    post-Adam tables; three negatives per positive, both losses."""
    ref_loss, ref_u, ref_i = jax_grads[loss]
    tag = f"{dp}x{mp}_sgd_{loss}"
    np.testing.assert_allclose(float(steps_out[f"{tag}_loss"]), ref_loss, rtol=2e-5)
    np.testing.assert_allclose(steps_out[f"{tag}_gu"], ref_u, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(steps_out[f"{tag}_gi"], ref_i, rtol=1e-4, atol=1e-6)


def test_make_mesh_refuses_a_shape_that_does_not_fit(steps_out):
    """make_mesh(3, 1) on 4 ranks raises JAX's ValueError (and the
    collectives' backward passed inside the spawn); the hybrid step is not
    ported and says where it is queued."""
    assert str(steps_out["mismatch_error"]) == "mesh 3x1 != 4 devices"
    assert "ROADMAP A7b" in str(steps_out["hybrid_error"])


@pytest.fixture(scope="module")
def tables_inputs(tiny_data, tmp_path_factory):
    nu, ni = tiny_data.num_users, tiny_data.num_items
    u, i = np_tables(nu, ni, DIM, seed=5, std=0.1)
    tr, _, te = split_edges(tiny_data, str(tmp_path_factory.mktemp("idx")), seed=0)
    rng = np.random.default_rng(2)
    return dict(edges=tiny_data.edge_index, u=u, i=i, train_e=tr, test_e=te,
                q=rng.standard_normal((6, 16)).astype(np.float32),
                c=rng.standard_normal((512, 16)).astype(np.float32),
                layers=LAYERS, dim=DIM)


@pytest.fixture(scope="module")
def tables_out(spawned):
    return spawned["mesh_tables"]


def _tcfg():
    return TConfig(model=TModel(num_layers=LAYERS, dim=DIM), train=TTrain(lr=1e-2))


def test_mesh_serving_tables_match_single_device_and_jax(tables_inputs, tables_out):
    """compute_serving_tables(mode="propagated", mesh=2x2), edges in two
    chunks per shard, against the port's single-device tables and JAX's."""
    inp = tables_inputs
    ref = t_tables(params_from_numpy(inp["u"], inp["i"], "cpu"), inp["edges"], _tcfg(),
                   mode="propagated")
    jref = j_tables(JParams(jnp.asarray(inp["u"]), jnp.asarray(inp["i"])), inp["edges"],
                    _jcfg(), mode="propagated")
    for got, want in ((tables_out["tab_u"], ref.user_emb.numpy()),
                      (tables_out["tab_i"], ref.item_emb.numpy()),
                      (tables_out["tab_u"], np.asarray(jref.user_emb)),
                      (tables_out["tab_i"], np.asarray(jref.item_emb))):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("prop", [False, True])
def test_mesh_full_ranking_eval_matches_single_device(tables_inputs, tables_out, prop):
    """evaluate_full_ranking with the catalog over the 4 ranks (90 items: a
    padded tail) against the single-device eval, layer-0 and propagated."""
    inp = tables_inputs
    r, n = t_eval(params_from_numpy(inp["u"], inp["i"], "cpu"), inp["train_e"],
                  inp["test_e"], inp["u"].shape[0], k=10, batch_users=64,
                  use_propagated=prop, cfg=_tcfg())
    got = tables_out[f"eval_{int(prop)}"]
    assert abs(got[0] - r) < 1e-6 and abs(got[1] - n) < 1e-6, (prop, got, r, n)
    assert r > 0.0


def test_mesh_eval_refuses_k_beyond_the_shards(tables_out):
    """k = 200 over 4 shards of 23 rows: JAX's ValueError."""
    assert "cannot produce global top-200 over 4 devices" in str(tables_out["eval_k_error"])


def test_sharded_mips_matches_local(tables_out):
    np.testing.assert_allclose(tables_out["mips_s"], tables_out["mips_s_local"],
                               rtol=1e-4, atol=1e-5)
    assert np.array_equal(tables_out["mips_i"], tables_out["mips_i_local"])


@pytest.fixture(scope="module")
def train_inputs(tiny_data, tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    tr, va, te = split_edges(tiny_data, str(d / "idx"), seed=0)
    return dict(nu=tiny_data.num_users, ni=tiny_data.num_items, train_e=tr, val_e=va,
                test_e=te, batch_size=256, dir=str(d), layers=LAYERS, dim=DIM)


@pytest.fixture(scope="module")
def train_out(spawned):
    return spawned["train_runs"]


@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_train_model_sharded_histories_agree_across_meshes(train_out, tag):
    """Two epochs of minibatch steps, each shard's edges in two chunks: the
    same histories and tables as the 1×1 run within 1e-5, falling losses."""
    for key in ("train_loss", "val_loss", "val_recall", "test_loss", "test_recall"):
        np.testing.assert_allclose(train_out[f"{tag}_{key}"], train_out[f"1x1_{key}"],
                                   rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(train_out[f"{tag}_u"], train_out["1x1_u"], atol=1e-5)
    assert train_out[f"{tag}_train_loss"][1] < train_out[f"{tag}_train_loss"][0]
    assert np.isfinite(train_out[f"{tag}_test_loss"]).all()


@pytest.mark.parametrize("tag", ["2x2", "4x1", "1x1"])
def test_train_model_sharded_only_rank0_writes(train_out, tag):
    """Rank 0 saved the best-val checkpoint and wrote one metrics row per
    epoch; the other ranks (checked inside the spawn) saved nothing."""
    assert int(train_out[f"{tag}_saved"]) >= 1
    assert int(train_out[f"{tag}_rows"]) == 2


def test_cli_train_mesh_1x1_runs_in_process(tmp_path, capsys):
    """``cli train --mesh 1x1 --full-eval`` trains the sharded trainer in
    this process (one-rank gloo group, ended by the command), writes its
    metrics rows and checkpoint."""
    import torch.distributed as dist

    hist = tmp_path / "h"
    args = ["--device", "cpu", "--dataset", "synthetic", "--synthetic-users", "120",
            "--synthetic-items", "150", "--synthetic-interactions", "3000",
            "--indexes-dir", str(tmp_path / "idx"), "--checkpoint", str(tmp_path / "m.npz"),
            "--histories-dir", str(hist), "--epochs", "2", "--dim", "8", "--layers", "2",
            "train", "--mesh", "1x1", "--full-eval", "--full-eval-users", "50"]
    assert tcli.main(args) == 0
    out = capsys.readouterr().out
    assert "[sharded 1x1] Epoch: 001" in out and "Full-ranking test Recall@10" in out
    rows = MetricsLogger.read(str(hist / "metrics.jsonl"))
    assert [r["step"] for r in rows] == [0, 1, 2] and rows[2]["sharded"] is True
    assert (tmp_path / "m.npz").exists() and not dist.is_initialized()
