"""Ops of the training slice against the JAX package on the same numpy inputs:
propagation, both BPR losses and their gradients, the samplers and metrics,
and the fused-BPR module (its plain PyTorch version on the CPU) against both
the JAX f32 route and the JAX Pallas kernel in interpret mode.

Tolerances: values rtol 1e-5 / atol 1e-6 and gradients rtol 1e-4 (f32 sums in
another order); against the Pallas kernel the JAX suite's own bounds
(|Δloss| < 5e-4, gradient rel err < 1e-2), because that kernel rounds the
gathered rows to bf16 and the port does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.data.graph import COOGraph as JCOO
from movie_recommender_system_with_gnns_tpu.data.movielens import make_synthetic_movielens
from movie_recommender_system_with_gnns_tpu.models import lightgcn as jmodel
from movie_recommender_system_with_gnns_tpu.ops import bpr as jbpr
from movie_recommender_system_with_gnns_tpu.ops import metrics as jmetrics
from movie_recommender_system_with_gnns_tpu.ops import spmm as jspmm
from movie_recommender_system_with_gnns_tpu.training import compact as jcompact
from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph as TCOO
from movie_recommender_system_with_gnns_tpu_torch.models import lightgcn as tmodel
from movie_recommender_system_with_gnns_tpu_torch.ops import bpr as tbpr
from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_bpr
from movie_recommender_system_with_gnns_tpu_torch.ops import metrics as tmetrics
from movie_recommender_system_with_gnns_tpu_torch.ops import sampling as tsampling
from movie_recommender_system_with_gnns_tpu_torch.ops import spmm as tspmm
from movie_recommender_system_with_gnns_tpu_torch.training import compact as tcompact

from torch_parity import (both_clusters, both_params, greedy_parts, jax_cluster,
                          rel_err, to_np)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(scope="module")
def data():
    return make_synthetic_movielens(60, 90, 2000, seed=0)


# --------------------------------------------------------------------- spmm


def test_spmm_segment(data):
    n = data.num_users + data.num_items
    emb = np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32)
    gj = JCOO.build(data.edge_index, n)
    out_j = jspmm.spmm_segment(jspmm.DeviceCOO.from_host(gj), jnp.asarray(emb))
    gt = tspmm.DeviceCOO.from_host(TCOO.build(data.edge_index, n), "cpu")
    x = torch.from_numpy(emb).requires_grad_(True)
    out_t = tspmm.spmm_segment(gt, x)
    np.testing.assert_allclose(to_np(out_t), to_np(out_j), **VAL)
    # Â is symmetric here, so d sum(out·c) / d emb = Â·c
    c = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32))
    (g,) = torch.autograd.grad((out_t * c).sum(), x)
    g_j = jax.grad(lambda e: jnp.sum(jspmm.spmm_segment(
        jspmm.DeviceCOO.from_host(gj), e) * jnp.asarray(to_np(c))))(jnp.asarray(emb))
    np.testing.assert_allclose(to_np(g), to_np(g_j), **GRAD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_densify_blocks(dtype):
    rng = np.random.default_rng(2)
    k, width, e = 3, 16, 200
    blk = rng.integers(0, k, e).astype(np.int32)
    dst = rng.integers(0, width, e).astype(np.int32)
    src = rng.integers(0, width, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    a_j = jspmm.densify_blocks(blk, dst, src, w, k, width, dtype=jnp.dtype(dtype))
    a_t = tspmm.densify_blocks(blk, dst, src, w, k, width, dtype=dtype, device="cpu")
    assert a_t.shape == (k, width, width) and str(a_t.dtype) == f"torch.{dtype}"
    # duplicate cells sum in f32 in another order: one ulp of the storage type
    tol = dict(rtol=2 ** -7, atol=0) if dtype == "bfloat16" else VAL
    np.testing.assert_allclose(to_np(a_t.float()), np.asarray(a_j.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("name,bad", [("blk", 3), ("dst", 16), ("src", -1)])
def test_densify_blocks_range_check(name, bad):
    args = dict(blk=np.zeros(4, np.int32), dst=np.zeros(4, np.int32),
                src=np.zeros(4, np.int32))
    args[name] = np.array([0, bad, 0, 0], np.int32)
    with pytest.raises(ValueError, match=f"{name} index out of range"):
        tspmm.densify_blocks(args["blk"], args["dst"], args["src"],
                             np.ones(4, np.float32), 3, 16, device="cpu")
    # tensors are not range-checked unless asked
    with pytest.raises(ValueError, match="out of range"):
        tspmm.densify_blocks(*(torch.from_numpy(args[k]) for k in ("blk", "dst", "src")),
                             torch.ones(4), 3, 16, device="cpu", check=True)


# ---------------------------------------------------------------- propagate


@pytest.mark.parametrize("readout", ["reference", "standard"])
@pytest.mark.parametrize("layers", [1, 3])
def test_propagate(data, readout, layers):
    nu, ni = data.num_users, data.num_items
    pj, pt = both_params(nu, ni, 8, seed=3)
    gj = jspmm.DeviceCOO.from_host(JCOO.build(data.edge_index, nu + ni))
    gt = tspmm.DeviceCOO.from_host(TCOO.build(data.edge_index, nu + ni), "cpu")
    uj, ij = jmodel.propagate(pj, gj, jspmm.spmm_segment, layers, readout)
    ut, it = tmodel.propagate(pt, gt, tspmm.spmm_segment, layers, readout)
    np.testing.assert_allclose(to_np(ut), to_np(uj), **VAL)
    np.testing.assert_allclose(to_np(it), to_np(ij), **VAL)


def test_propagate_compute_dtype_and_bad_readout(data):
    nu, ni = data.num_users, data.num_items
    pj, pt = both_params(nu, ni, 8, seed=3)
    gj = jspmm.DeviceCOO.from_host(JCOO.build(data.edge_index, nu + ni))
    gt = tspmm.DeviceCOO.from_host(TCOO.build(data.edge_index, nu + ni), "cpu")
    uj, _ = jmodel.propagate(pj, gj, jspmm.spmm_segment, 2, "reference", jnp.bfloat16)
    ut, _ = tmodel.propagate(pt, gt, tspmm.spmm_segment, 2, "reference", "bfloat16")
    assert ut.dtype == torch.float32
    # bf16 sums round at other places in the two frameworks: a few bf16 ulps
    np.testing.assert_allclose(to_np(ut), to_np(uj), rtol=2 ** -5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown readout"):
        tmodel.propagate(pt, gt, tspmm.spmm_segment, 2, "other")


# ---------------------------------------------------------------- bpr losses


def _loss_inputs(b, d, kneg, masked, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    nshape = (b, d) if kneg == 1 else (b, kneg, d)
    args = [f(b, d), f(b, d) * 0.1, f(b, d), f(b, d) * 0.1, f(*nshape), f(*nshape) * 0.1]
    mask = (rng.random(b) < 0.7) if masked else None
    return args, mask


@pytest.mark.parametrize("loss", ["reference", "standard"])
@pytest.mark.parametrize("kneg", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_bpr_losses_values_and_grads(loss, kneg, masked):
    args, mask = _loss_inputs(48, 16, kneg, masked, seed=kneg + 10 * masked)
    jfn, tfn = jbpr.select_bpr_loss(loss), tbpr.select_bpr_loss(loss)
    jmask = None if mask is None else jnp.asarray(mask)
    lj, gj = jax.value_and_grad(
        lambda *a: jfn(*a, 5e-3, mask=jmask), argnums=tuple(range(6)))(
            *map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    lt = tfn(*targs, 5e-3, mask=None if mask is None else torch.from_numpy(mask))
    gt = torch.autograd.grad(lt, targs)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **VAL)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(to_np(a), to_np(b), **GRAD)


def test_bpr_loss_helpers():
    assert tbpr.select_bpr_loss("reference") is tbpr.bpr_loss
    assert tbpr.select_bpr_loss("standard") is tbpr.bpr_loss_standard
    with pytest.raises(ValueError, match="unknown loss"):
        tbpr.select_bpr_loss("other")
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    assert torch.equal(tbpr._mean_over_negs(x), x.mean(1))
    assert tbpr._mean_over_negs(x[0]) is not None and tbpr._mean_over_negs(x[0]).shape == (3, 4)
    m = torch.tensor([True, False])
    np.testing.assert_allclose(float(tbpr._masked_mean(x, m)), float(x[0].mean()))
    # an all-false mask divides by max(count, 1), not by zero
    assert float(tbpr._masked_mean(x, torch.tensor([False, False]))) == 0.0
    # a zero final row gives NaN as in the JAX package: no clamp
    z = torch.zeros(1, 4)
    assert torch.isnan(tbpr.bpr_loss(z, z, z + 1, z, z + 1, z))
    assert np.isnan(float(jbpr.bpr_loss(*(jnp.asarray(to_np(t)) for t in
                                         (z, z, z + 1, z, z + 1, z)))))


# ------------------------------------------------------- sampling and metrics


@pytest.mark.parametrize("num", [1, 4])
def test_sample_negative(num):
    gen = torch.Generator().manual_seed(0)
    neg = tsampling.sample_negative(gen, 20_000, 50, num, device="cpu")
    assert neg.shape == ((20_000,) if num == 1 else (20_000, num))
    assert neg.dtype == torch.int32 and int(neg.min()) == 0 and int(neg.max()) == 49
    freq = torch.bincount(neg.reshape(-1).long(), minlength=50).double() / neg.numel()
    # uniform over the catalog: every item within 5 sigma of 1/50
    sigma = (0.02 * 0.98 / neg.numel()) ** 0.5
    assert float((freq - 0.02).abs().max()) < 5 * sigma
    again = tsampling.sample_negative(torch.Generator().manual_seed(0), 20_000, 50, num)
    assert torch.equal(neg, again)


@pytest.mark.parametrize("mode", ["feasible", "popularity"])
def test_unported_negatives_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        tsampling.check_negatives_mode(mode)
    with pytest.raises(ValueError, match="unknown negatives"):
        tsampling.check_negatives_mode("other")
    tsampling.check_negatives_mode("uniform")


def test_sampled_recall_matches_jax_on_injected_samples():
    rng = np.random.default_rng(5)
    b, d, k, ns, ss = 300, 8, 20, 4, 50
    u, p, n = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(3)
    r_j = jmetrics.sampled_recall_at_k(key, *map(jnp.asarray, (u, p, n)), k=k,
                                       num_samples=ns, sample_size=ss)
    # the draws the JAX function makes from this key
    samples = np.stack([np.asarray(jax.random.choice(sk, b, (ss,), replace=False))
                        for sk in jax.random.split(key, ns)])
    r_t = tmetrics.sampled_recall_at_k(
        None, *map(torch.from_numpy, (u, p, n)), k=k, num_samples=ns,
        sample_size=ss, samples=torch.from_numpy(samples))
    np.testing.assert_allclose(float(r_t), float(r_j), rtol=1e-6)
    # own draws: without replacement, and a value in the same range
    gen = torch.Generator().manual_seed(1)
    r_own = tmetrics.sampled_recall_at_k(gen, *map(torch.from_numpy, (u, p, n)),
                                         k=k, num_samples=ns, sample_size=ss)
    assert 0.0 <= float(r_own) <= k / b
    # more users asked for than exist: clipped like the JAX package
    small = tmetrics.sampled_recall_at_k(gen, *map(torch.from_numpy, (u[:5], p[:5], n[:5])),
                                         k=100, num_samples=2, sample_size=100)
    assert 0.0 <= float(small) <= 1.0


def test_recall_ndcg_matches_jax():
    rng = np.random.default_rng(6)
    scores = rng.standard_normal((40, 30)).astype(np.float32)
    rel = rng.random((40, 30)) < 0.1
    rel[:3] = False
    rj, nj = jmetrics.recall_ndcg_at_k(jnp.asarray(scores), jnp.asarray(rel), k=10)
    rt, nt = tmetrics.recall_ndcg_at_k(torch.from_numpy(scores), torch.from_numpy(rel), k=10)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-6)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)


# ---------------------------------------------------- kernel B1's module (CPU)


def _fused_problem(seed, loss="reference", kneg=1, in_cluster=False, pad=0):
    """The JAX suite's fused-BPR problem (96 x 160, d = 16, 3 parts, align 8,
    f32 dense adjacency), cluster 0 or 1, in both packages."""
    data = make_synthetic_movielens(96, 160, 4000, seed=seed)
    parts = greedy_parts(data, 3)
    cj, ct = both_clusters(parts, 96, align=8, dense="float32")
    pj, pt = both_params(96, 160, 16, seed=seed, std=0.01)
    rng = np.random.default_rng(seed + 100)
    b = ct.user_local.shape[1]
    return cj, ct, pj, pt, rng, b


CASES = {
    "cluster0": dict(seed=0, cluster=0),
    "cluster1": dict(seed=0, cluster=1),
    "in_cluster_negatives": dict(seed=3, cluster=0, in_cluster=True),
    "padded_tail": dict(seed=5, cluster=0, pad=64),
    "standard_loss": dict(seed=9, cluster=0, loss="standard"),
    "four_negatives": dict(seed=7, cluster=0, kneg=4),
}


def _case(name):
    c = dict(cluster=0, loss="reference", kneg=1, in_cluster=False, pad=0)
    c.update(CASES[name])
    cj, ct, pj, pt, rng, b = _fused_problem(c["seed"])
    ci = c["cluster"]
    shape = (b,) if c["kneg"] == 1 else (b, c["kneg"])
    if c["in_cluster"]:
        ids = to_np(ct.item_ids[ci])[: int(to_np(ct.item_valid[ci]).sum())]
        neg = ids[rng.integers(0, len(ids), shape)].astype(np.int32)
    else:
        neg = rng.integers(0, 160, shape).astype(np.int32)
    clj, clt = list(jax_cluster(cj, ci)), list(ct.cluster(ci))
    if c["pad"]:
        # garbage-but-masked triplet rows appended to the cluster
        z = np.zeros(c["pad"], np.int32)
        for i, fill in ((5, z), (6, z), (7, z.astype(bool))):
            clj[i] = jnp.concatenate([clj[i], jnp.asarray(fill)])
            clt[i] = torch.cat([clt[i], torch.from_numpy(fill)])
        neg = np.concatenate([neg, np.full(c["pad"], 3, np.int32)])
    mk = lambda mod_cfg, mod_model, mod_train, fused: mod_cfg(
        model=mod_model(num_layers=2, dim=16),
        train=mod_train(loss=c["loss"], fused_bpr=fused))
    from movie_recommender_system_with_gnns_tpu_torch.config import (
        Config as TConfig, ModelConfig as TModel, TrainConfig as TTrain)
    cfgs = dict(j_plain=mk(JConfig, JModel, JTrain, False),
                j_fused=mk(JConfig, JModel, JTrain, True),
                t_plain=mk(TConfig, TModel, TTrain, False),
                t_fused=mk(TConfig, TModel, TTrain, True))
    return dict(cj=cj, ct=ct, pj=pj, pt=pt, clj=tuple(clj), clt=tuple(clt),
                neg=neg, adj_j=cj.adj[ci], adj_t=ct.adj[ci], cfgs=cfgs, c=c)


def _port_loss_and_grads(p, cfg):
    from movie_recommender_system_with_gnns_tpu_torch.training.train import loss_and_grads

    return loss_and_grads(tcompact.compact_cluster_loss, p["pt"], p["clt"],
                          torch.from_numpy(p["neg"]), cfg, p["ct"].u_pad,
                          p["ct"].i_pad, p["adj_t"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_bpr_matches_jax_f32_route(name):
    """(a) the port's fused module against the JAX row-gather route in f32."""
    p = _case(name)
    lj, gj = jax.value_and_grad(jcompact.compact_cluster_loss)(
        p["pj"], p["clj"], jnp.asarray(p["neg"]), p["cfgs"]["j_plain"],
        p["cj"].u_pad, p["cj"].i_pad, p["adj_j"])
    lt, gt = _port_loss_and_grads(p, p["cfgs"]["t_fused"])
    assert abs(float(lt) - float(lj)) < 1e-5
    assert rel_err(gt.user_emb, gj.user_emb) < 1e-4
    assert rel_err(gt.item_emb, gj.item_emb) < 1e-4
    # and the port's two routes agree with each other
    lp, gp = _port_loss_and_grads(p, p["cfgs"]["t_plain"])
    assert abs(float(lt) - float(lp)) < 1e-6
    assert rel_err(gt.item_emb, gp.item_emb) < 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_bpr_matches_jax_pallas_kernel(name):
    """(b) against the JAX Pallas kernel in interpret mode, at the JAX suite's
    own tolerance (that kernel rounds gathered rows to bf16)."""
    p = _case(name)
    lj, gj = jax.value_and_grad(jcompact.compact_cluster_loss)(
        p["pj"], p["clj"], jnp.asarray(p["neg"]), p["cfgs"]["j_fused"],
        p["cj"].u_pad, p["cj"].i_pad, p["adj_j"])
    lt, gt = _port_loss_and_grads(p, p["cfgs"]["t_fused"])
    assert abs(float(lt) - float(lj)) < 5e-4
    assert rel_err(gt.user_emb, gj.user_emb) < 1e-2
    assert rel_err(gt.item_emb, gj.item_emb) < 1e-2


def test_fused_bpr_padding_is_neutral():
    """Masked rows appended to a cluster change neither loss nor gradients."""
    p5 = _case("padded_tail")
    unpadded = dict(p5, clt=tuple(t[: -64] if i >= 5 else t
                                  for i, t in enumerate(p5["clt"])),
                    neg=p5["neg"][:-64])
    l_pad, g_pad = _port_loss_and_grads(p5, p5["cfgs"]["t_fused"])
    l_ref, g_ref = _port_loss_and_grads(unpadded, p5["cfgs"]["t_fused"])
    assert abs(float(l_pad) - float(l_ref)) < 1e-6
    np.testing.assert_allclose(to_np(g_pad.item_emb), to_np(g_ref.item_emb), atol=1e-8)


@pytest.mark.parametrize("loss", ["reference", "standard"])
def test_bpr_tile_outputs_and_autograd_function(loss):
    """The wrapper's plain version returns (loss, gu, gi, gni) as the kernel
    does, and the autograd.Function splits them into the five gradients."""
    rng = np.random.default_rng(11)
    u_pad, i_pad, d, b = 24, 40, 16, 200
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    fu, ur, fi, ir, ni = f(u_pad, d), f(u_pad, d), f(i_pad, d), f(i_pad, d), f(b, d)
    ul = torch.from_numpy(rng.integers(0, u_pad, b).astype(np.int32))
    pl = torch.from_numpy(rng.integers(0, i_pad, b).astype(np.int32))
    loc = torch.from_numpy(rng.integers(0, i_pad, b).astype(np.int32))
    inc = torch.from_numpy(rng.random(b) < 0.5)
    m = torch.from_numpy(rng.random(b) < 0.8)
    kw = dict(scale=1 / 16, bpr_coeff=5e-3, loss=loss)
    i32 = lambda t: t.to(torch.int32)
    out, gu, gi, gni = cuda_bpr.bpr_tile(torch.cat([fu, ur], 1), torch.cat([fi, ir], 1),
                                         ni, ul, pl, loc, i32(inc), i32(m), **kw)
    assert gu.shape == (u_pad, 2 * d) and gi.shape == (i_pad, 2 * d) and gni.shape == (b, d)
    assert torch.all(gni[~m] == 0)
    leaves = [t.clone().requires_grad_(True) for t in (fu, ur, fi, ir, ni)]
    fused = cuda_bpr.fused_bpr_loss(*leaves, ul, pl, loc, inc, m, **kw)
    grads = torch.autograd.grad(3.0 * fused, leaves)
    np.testing.assert_allclose(float(fused.detach()), float(out), rtol=1e-6)
    for g, ref in zip(grads, (gu[:, :d], gu[:, d:], gi[:, :d], gi[:, d:], gni)):
        np.testing.assert_allclose(to_np(g), 3.0 * to_np(ref), rtol=1e-6, atol=1e-9)
    plain = cuda_bpr.fused_bpr_loss_plain(fu, ur, fi, ir, ni, ul, pl, loc, inc, m, **kw)
    np.testing.assert_allclose(float(plain), float(out), rtol=1e-6)


def test_bpr_tile_weights_and_support():
    m = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    w = cuda_bpr._weights(m, 8, 5e-3, "reference")
    np.testing.assert_allclose(to_np(w), [-1 / 30, 5e-3 / 24], rtol=1e-6)
    w = cuda_bpr._weights(torch.zeros(4, dtype=torch.int32), 8, 5e-3, "standard")
    np.testing.assert_allclose(to_np(w), [1.0, 5e-3 / 8], rtol=1e-6)   # max(count, 1)
    # no table-size limit on this card, only the row width
    assert cuda_bpr.fused_bpr_supported(10 ** 6, 10 ** 6, 64)
    assert not cuda_bpr.fused_bpr_supported(128, 128, 513)
    with pytest.raises(ValueError, match="unknown loss"):
        cuda_bpr.bpr_tile(*(torch.zeros(1, 2),) * 2, torch.zeros(1, 1),
                          *(torch.zeros(1, dtype=torch.int32),) * 5,
                          scale=1.0, bpr_coeff=0.0, loss="other")
