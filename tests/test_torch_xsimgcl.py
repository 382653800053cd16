"""XSimGCL on the port (``models/xsimgcl.py``, ``ops/distinct.py``,
``ops/cuda_infonce.py``'s plain path, the full-graph trainer's XSimGCL step)
against the plain reference ``tests/xsimgcl_reference.py`` on seeded random
tables at a small size, on the CPU: the same numpy inputs and the same
injected noise on both sides.

Tolerances: float32 against float32, the reference summing each hop by a
sparse CSR product and the port by the hybrid graph's dense blocks and
remainder (or ``index_add_``), so the two differ by float reassociation
alone: about 1e-7 of each value, grown by a few hops and Adam steps. A
dropped term (λ = 0, ε = 0) moves the same numbers by 1e-2 or more.
"""

import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import xsimgcl_reference as ref
from movie_recommender_system_with_gnns_tpu_torch import cli as tcli
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config, DataConfig, ModelConfig, TrainConfig, check_model)
from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph
from movie_recommender_system_with_gnns_tpu_torch.models import xsimgcl
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import params_from_numpy
from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_infonce
from movie_recommender_system_with_gnns_tpu_torch.ops.distinct import distinct_rows
from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceCOO, spmm_segment
from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
    compute_serving_tables)
from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph as tfg
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

D = 16


@pytest.fixture(scope="module")
def graph_data():
    """A synthetic graph of 3,507 train pairs: four full-graph steps of
    1,024 (the batch's alignment), the last one part padding."""
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens)

    return make_synthetic_movielens(num_users=120, num_items=180, num_interactions=12000,
                                    seed=0)


def _cfg(**kw):
    model = dict(num_layers=2, dim=D, init_std=0.1, model="xsimgcl", cl_layer=1, cl_eps=0.2,
                 readout="reference")
    train = dict(trainer="fullgraph", num_clusters=4, fullgraph_steps=4,
                 hybrid_block_dtype="float32", loss="standard", bpr_coeff=1e-4, lr=1e-3,
                 cl_weight=0.2, cl_temperature=0.15, cl_dtype="float32")
    for k, v in kw.items():
        (model if k in model else train)[k] = v
    return Config(model=ModelConfig(**model), train=TrainConfig(**train))


def _ref_dicts(cfg):
    m, t = cfg.model, cfg.train
    return (dict(layers=m.num_layers, cl_layer=m.cl_layer, cl_eps=m.cl_eps),
            dict(bpr_coeff=t.bpr_coeff, cl_weight=t.cl_weight, cl_temperature=t.cl_temperature,
                 grad_clip_norm=t.grad_clip_norm, adam_b1=t.adam_b1, adam_b2=t.adam_b2,
                 adam_eps=t.adam_eps, lr=t.lr, lr_schedule=t.lr_schedule))


def _tables(nu, ni, seed=3):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((nu, D))).astype(np.float32), \
           (0.1 * rng.standard_normal((ni, D))).astype(np.float32)


def _noise(shape, seed=4):
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32))


def rel(a, b):
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# --- propagation ------------------------------------------------------------


@pytest.mark.parametrize("cl_layer", [1, 2])
def test_perturbed_propagation_and_readout(tiny_data, cl_layer):
    """The perturbed propagation with injected noise gives the reference's
    (Z, Z') within 1e-6 of the largest entry (float reassociation), the
    unperturbed readout the reference's readout; the noise is not a no-op."""
    e, nu, ni = tiny_data.edge_index, tiny_data.num_users, tiny_data.num_items
    n = nu + ni
    u0, i0 = _tables(nu, ni)
    params = params_from_numpy(u0, i0, device="cpu")
    graph = DeviceCOO.from_host(COOGraph.build(e, n), "cpu")
    adj = ref.build_adjacency(e, n, "cpu")
    noise = _noise((2, n, D))
    zu, zi, vu, vi = xsimgcl.propagate_perturbed(params, graph, spmm_segment, 2, cl_layer,
                                                 0.2, noise)
    z, view = ref.propagate(torch.from_numpy(np.concatenate([u0, i0])), adj, 2, cl_layer,
                            0.2, noise)
    assert rel(torch.cat([zu, zi]), z) < 1e-6
    assert rel(torch.cat([vu, vi]), view) < 1e-6
    fu, fi = xsimgcl.propagate(params, graph, spmm_segment, 2)
    ru, ri = ref.readout(torch.from_numpy(u0), torch.from_numpy(i0), adj, 2)
    assert rel(fu, ru) < 1e-6 and rel(fi, ri) < 1e-6
    assert rel(fu, zu) > 1e-2


def test_serving_tables_are_the_unperturbed_readout(tiny_data):
    """``compute_serving_tables(mode="propagated")`` of an XSimGCL config
    serves the mean of hops 1..L without noise; LightGCN's is unchanged."""
    e, nu, ni = tiny_data.edge_index, tiny_data.num_users, tiny_data.num_items
    u0, i0 = _tables(nu, ni)
    params = params_from_numpy(u0, i0, device="cpu")
    tabs = compute_serving_tables(params, e, _cfg(), mode="propagated")
    ru, ri = ref.readout(torch.from_numpy(u0), torch.from_numpy(i0),
                         ref.build_adjacency(e, nu + ni, "cpu"), 2)
    assert rel(tabs.user_emb, ru) < 1e-6 and rel(tabs.item_emb, ri) < 1e-6
    light = compute_serving_tables(params, e, _cfg(model="lightgcn", readout="standard"),
                                   mode="propagated")
    assert rel(light.user_emb, ru) > 1e-2


# --- distinct rows and the InfoNCE op ------------------------------------------


@pytest.mark.parametrize("rows,cap,masked", [(50, None, False), (50, 30, True),
                                            (1, None, True), (300, 256, True)])
def test_distinct_rows_against_unique(rows, cap, masked):
    """The ids' first ``count`` entries are ``torch.unique`` of the kept
    values, the whole buffer a prefix of a permutation of the rows."""
    g = torch.Generator().manual_seed(rows)
    idx = torch.randint(0, rows, (200,), generator=g)
    mask = torch.rand(200, generator=g) < 0.7 if masked else None
    ids, count = distinct_rows(idx, rows, mask, cap=cap)
    want = torch.unique(idx if mask is None else idx[mask])
    assert count.dtype == torch.int32 and count.shape == (1,)
    assert int(count) == want.numel()
    assert ids.shape == (min(cap or rows, rows),)
    assert torch.equal(ids[:min(int(count), ids.numel())], want[:ids.numel()])
    assert ids.unique().numel() == ids.numel() and int(ids.max()) < rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_infonce_plain_against_reference(dtype):
    """Value and both views' gradients of the op over a batch with repeated
    ids (distinct rows chosen on the device, count 1 short of a tile
    multiple, padded to a larger buffer) against the reference's blocked
    InfoNCE over ``torch.unique``'s rows. float32 operands: 1e-5 (the
    blocks' sums reassociated); bfloat16: the operands and P rounded to 8
    bits of mantissa, 2e-2 of the largest gradient and 1e-3 of the value."""
    g = torch.Generator().manual_seed(0)
    rows = 200
    batch = torch.randint(0, rows, (400,), generator=g)
    za = torch.randn(rows, D, generator=g)
    zb = za + 0.3 * torch.randn(rows, D, generator=g)
    ids, count = distinct_rows(batch, rows, cap=rows)
    a, b = za.clone().requires_grad_(), zb.clone().requires_grad_()
    loss = cuda_infonce.infonce(a.index_select(0, ids), b.index_select(0, ids), count,
                                0.15, dtype)
    loss.backward()
    ra, rb = za.clone().requires_grad_(), zb.clone().requires_grad_()
    uniq = torch.unique(batch)
    want = ref.infonce(ra[uniq], rb[uniq], 0.15)
    want.backward()
    tol_v, tol_g = (1e-5, 1e-5) if dtype == "float32" else (1e-3, 2e-2)
    assert abs(float(loss.detach()) - float(want.detach())) / abs(float(want.detach())) < tol_v
    assert rel(a.grad, ra.grad) < tol_g and rel(b.grad, rb.grad) < tol_g
    absent = torch.ones(rows, dtype=torch.bool)
    absent[uniq] = False
    assert int(count) < rows and not a.grad[absent].any() and not b.grad[absent].any()


def test_infonce_blocks_and_empty():
    """Over more rows than one block of the plain version, and with no row."""
    g = torch.Generator().manual_seed(1)
    n = cuda_infonce.BLOCK + 37
    a, b = torch.randn(n + 5, 8, generator=g), torch.randn(n + 5, 8, generator=g)
    count = torch.tensor([n], dtype=torch.int32)
    got = cuda_infonce.infonce(a, b, count, 0.5, "float32")
    want = ref.infonce(a[:n], b[:n], 0.5)
    assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))
    zero = cuda_infonce.infonce(a, b, torch.zeros(1, dtype=torch.int32), 0.5, "float32")
    assert float(zero) == 0.0


def test_infonce_kernels_are_named_as_the_benchmark_counts_them():
    """Every kernel that ``benchmark/kernels/infonce.json`` names (the
    kernels whose time ``train.infonce_roofline`` reads) is a ``__global__``
    function template of ``csrc/infonce.cu``, which has no other kernel;
    and the source exports each ``extern "C"`` entry point that
    ``ops/cuda_infonce.py::_library`` binds."""
    src = (Path(cuda_infonce.__file__).resolve().parents[1] / "csrc" / "infonce.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    templates = re.findall(r"template\s*<[^>]*>\s*__global__\s+void\s+"
                           r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(", code)
    kmap = Path(__file__).resolve().parents[1] / "benchmark" / "kernels" / "infonce.json"
    names = json.loads(kmap.read_text())["kernels"]
    assert len(templates) == code.count("__global__") >= 1
    assert sorted(set(templates)) == sorted(names) == ["infonce_bwd_kernel",
                                                       "infonce_fwd_kernel"]
    bound = set(re.findall(r"lib\.(\w+)\.", inspect.getsource(cuda_infonce._library)))
    assert bound == {"infonce_fwd", "infonce_bwd", "infonce_error_string"}
    for entry in bound:
        assert re.search(r'extern\s+"C"\s+[\w\s\*]+?\b' + entry + r"\s*\(", code), entry


# --- one full-graph epoch ---------------------------------------------------------


def _epoch(graph_data, cfg, noise_seed=4):
    """One port epoch from the seed's tables with injected order, negatives
    and noise; returns (port state, mean loss, reference steps, tables)."""
    e, nu, ni = graph_data.edge_index, graph_data.num_users, graph_data.num_items
    n = nu + ni
    fg = tfg.build_fullgraph_data(cfg, e, nu, n, device="cpu")
    g = torch.Generator().manual_seed(7)
    perm = torch.randperm(fg.e_real, generator=g)
    neg = torch.randint(0, ni, (fg.num_steps, fg.batch), generator=g, dtype=torch.int32)
    noise = _noise((fg.num_steps, cfg.model.num_layers, n, D), noise_seed)
    u0, i0 = _tables(nu, ni)
    state = ttrain.TrainState(params_from_numpy(u0, i0, device="cpu"), None, 0)
    state = state._replace(opt_state=ttrain.make_optimizer(cfg).init(state.params))
    state, loss = tfg.make_fullgraph_epoch_fn(cfg, fg)(state, fg, None, perm=perm, neg=neg,
                                                        noise=noise)
    adj = ref.build_adjacency(e, n, "cpu")
    users, items = fg.user[:fg.e_real].long(), fg.pos_item[:fg.e_real].long()
    steps = []
    for s in range(fg.num_steps):
        sl = perm[s * fg.batch:(s + 1) * fg.batch]
        steps.append(ref.Step(adj, users[sl], items[sl], neg[s][:sl.shape[0]],
                              float(sl.shape[0]), noise[s]))
    return state, loss, steps, (torch.from_numpy(u0), torch.from_numpy(i0))


def _against_reference(state, loss, steps, tables, cfg):
    model, train = _ref_dicts(cfg)
    out = ref.train_steps(*tables, steps, model, train)
    rl = sum(w * x for w, x in zip(out.weights, out.losses)) / sum(out.weights)
    return (abs(loss - rl) / abs(rl),
            max(rel(m, r) for m, r in zip(state.opt_state.mu, out.mu)),
            max(rel(x - x0, c) for x, x0, c in zip(state.params, tables, out.change)))


def test_fullgraph_epoch_against_reference(graph_data):
    """One whole epoch (4 steps): mean loss within 1e-6, Adam's first
    moment and the tables' change within 1e-4 of their largest entries (Adam
    divides by the root of a second moment that reassociation moves too)."""
    cfg = _cfg()
    state, loss, steps, tables = _epoch(graph_data, cfg)
    assert len(steps) == 4 and state.step == 4
    loss_gap, mu_gap, change_gap = _against_reference(state, loss, steps, tables, cfg)
    assert loss_gap < 1e-6 and mu_gap < 1e-4 and change_gap < 1e-4


@pytest.mark.parametrize("drop", ["cl_weight", "cl_eps"])
def test_dropped_term_fails_the_comparison(graph_data, drop):
    """The port run with λ = 0 or ε = 0 against the reference with both:
    the same comparison misses by far more than its tolerance."""
    cfg = _cfg()
    state, loss, steps, tables = _epoch(graph_data, _cfg(**{drop: 0.0}))
    loss_gap, mu_gap, change_gap = _against_reference(state, loss, steps, tables, cfg)
    assert loss_gap > 1e-2 and mu_gap > 1e-2


def test_epoch_draws_its_noise_from_the_generator(graph_data):
    """Without ``noise=`` the epoch draws each step's noise from its
    generator: two runs from one seed agree bit for bit, another seed
    differs."""
    cfg = _cfg()
    e, nu, ni = graph_data.edge_index, graph_data.num_users, graph_data.num_items
    fg = tfg.build_fullgraph_data(cfg, e, nu, nu + ni, device="cpu")
    fn = tfg.make_fullgraph_epoch_fn(cfg, fg)
    losses = []
    for seed in (1, 1, 2):
        state = ttrain.create_train_state(cfg, nu, ni, device="cpu")
        losses.append(fn(state, fg, torch.Generator().manual_seed(seed))[1])
    assert losses[0] == losses[1] != losses[2] and np.isfinite(losses).all()


# --- entry points -------------------------------------------------------------------


def test_config_json_keeps_lightgcn_shared():
    """A LightGCN config writes none of XSimGCL's fields (the JAX package
    reads it); an XSimGCL config writes those that differ and reads back."""
    assert "cl_eps" not in Config().to_json() and '"model"' in Config().to_json()
    cfg = _cfg(cl_eps=0.1)
    text = cfg.to_json()
    assert '"cl_eps": 0.1' in text and "cl_layer" not in text
    assert Config.from_json(text) == cfg


@pytest.mark.parametrize("trainer", ["compact", "full", "sharded"])
def test_other_trainers_refuse_xsimgcl(tiny_data, trainer):
    """The compact, full-node and sharded trainers raise for XSimGCL."""
    from movie_recommender_system_with_gnns_tpu_torch.training import compact, distributed

    cfg = _cfg(trainer=trainer)
    with pytest.raises(ValueError, match="runs LightGCN only"):
        check_model(cfg, trainer)
    build = {"compact": lambda: compact.make_compact_epoch_fn(cfg),
             "full": lambda: ttrain.make_epoch_fn(cfg),
             "sharded": lambda: distributed.train_model_sharded(
                 cfg, tiny_data.num_users, tiny_data.num_items, tiny_data.edge_index,
                 None, None)}[trainer]
    with pytest.raises(ValueError, match="trainer='fullgraph'"):
        build()


def _cli_args(tmp_path, trainer):
    return ["--device", "cpu", "--dataset", "synthetic", "--synthetic-users", "80",
            "--synthetic-items", "120", "--synthetic-interactions", "3000",
            "--indexes-dir", str(tmp_path / "idx"), "--epochs", "2", "--dim", "16",
            "--layers", "2", "--clusters", "3", "--model", "xsimgcl",
            "--checkpoint", str(tmp_path / "m.npz"), "--histories-dir", str(tmp_path / "h"),
            "train", "--trainer", trainer, "--fullgraph-steps", "2", "--loss", "standard",
            "--split-level", "interaction"]


def test_cli_trains_xsimgcl_on_the_fullgraph_trainer(tmp_path, capsys, monkeypatch):
    """``cli --model xsimgcl train --trainer fullgraph`` trains through
    ``make_fullgraph_epoch_fn``; ``--trainer compact`` refuses it."""
    calls = []
    real = tfg.make_fullgraph_epoch_fn

    def spy(cfg, fg):
        calls.append(cfg.model.model)
        return real(cfg, fg)

    monkeypatch.setattr(tfg, "make_fullgraph_epoch_fn", spy)
    assert tcli.main(_cli_args(tmp_path, "fullgraph")) == 0
    out = capsys.readouterr().out
    assert "Epoch: 001" in out and "Test Loss" in out and calls == ["xsimgcl"]
    assert (tmp_path / "m.npz").exists()
    with pytest.raises(ValueError, match="trainer='fullgraph'"):
        tcli.main(_cli_args(tmp_path, "compact"))
