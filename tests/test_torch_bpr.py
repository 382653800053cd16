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
from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_scatter import (
    sort_rows as tsort_rows)
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


@pytest.mark.parametrize("mode", ["feasible"])
def test_unported_negatives_raise(mode):
    """Every law of the JAX package is ported: ``feasible`` passes the check
    now; an unknown law still raises."""
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
    # (the weights from the valid count, max(count, 1) included, are held by
    # the two-pass mirror below)
    # no table-size limit on this card, only the row width
    assert cuda_bpr.fused_bpr_supported(10 ** 6, 10 ** 6, 64)
    assert not cuda_bpr.fused_bpr_supported(128, 128, 513)
    with pytest.raises(ValueError, match="unknown loss"):
        cuda_bpr.bpr_tile(*(torch.zeros(1, 2),) * 2, torch.zeros(1, 1),
                          *(torch.zeros(1, dtype=torch.int32),) * 5,
                          scale=1.0, bpr_coeff=0.0, loss="other")


# ------------------------------------- kernel B1's two passes, mirrored (CPU)
#
# ``csrc/bpr_tile.cu`` step by step in PyTorch: pass 1's per-triplet
# coefficients of the row gradients, pass 2's rows summed over the call's
# lists (an entry standing for ``kneg`` triplets) with 8-way round-robin
# partials and the partner rows gathered again, its fixed-order loss, the
# weights from the valid count. The CUDA source cannot run here, so this
# settles its algebra against ``bpr_tile_plain``. Tolerance: 1e-5 of the
# largest entry, since f32 sums are taken in another order; an output that is
# all zeros must be exactly zero.

WARPS, THREADS = 8, 256


def _mirror_keys(ul, pl, loc, inc, m, u_pad, i_pad):
    """The row keys of the role-sorted design (one sort of all roles): role r
    of triplet t at entry r·B + t; the table row (users first, then items) or
    the sentinel u_pad + i_pad."""
    valid, incl = m != 0, inc != 0
    sentinel = torch.full_like(ul, u_pad + i_pad)
    return torch.cat([torch.where(valid, ul, sentinel),
                      torch.where(valid, u_pad + pl, sentinel),
                      torch.where(valid & incl, u_pad + loc, sentinel)])


def _mirror_incidence(keys, rows):
    """(order, start): the entries sorted stably by key, and start[r] = first
    sorted position with key >= r for r in [0, rows]."""
    order = torch.sort(keys, stable=True).indices
    start = torch.searchsorted(keys[order], torch.arange(rows + 1, dtype=keys.dtype))
    return order, start


def _round_robin(*lists):
    """Pass 2's sum of one row: warp w adds entries w, w + 8, ... of each list
    in turn, in list order; then the 8 partials are added in warp order."""
    d = lists[0].shape[1]
    total = None
    for w in range(WARPS):
        part = torch.cat([c[w::WARPS] for c in lists])
        ps = part.cumsum(0)[-1] if part.numel() else torch.zeros(d)
        total = ps if total is None else total + ps
    return total


def _entries(order, beg, end, kneg):
    """The triplets of list positions [beg, end), each entry standing for
    kneg of them."""
    e = order[beg:end].long()
    return (e[:, None] * kneg + torch.arange(kneg)).reshape(-1)


def _mirror_bpr_tile(u_tab, i_tab, ni, ul, pl, loc, inc, m, incidence, *, scale,
                     bpr_coeff, loss):
    b, d = ni.shape
    u_pad, i_pad = u_tab.shape[0], i_tab.shape[0]
    ref = loss == "reference"
    gain, c1, coeff_d = (10.0 if ref else -1.0), (-0.1 if ref else 1.0), bpr_coeff / d
    kneg = incidence.kneg
    valid, incl = m != 0, (inc != 0) & (m != 0)
    cnt = float(max(kneg * int(incidence.user_start[u_pad]), 1))
    w1, w2 = c1 / cnt, coeff_d / cnt
    # pass 1: lt, gni (1/count included) and the coefficients of the rows
    uf, ui = u_tab[ul, :d], u_tab[ul, d:]
    pf, pi = i_tab[pl, :d], i_tab[pl, d:]
    nf = torch.where(incl[:, None], i_tab[loc, :d], ni * scale)
    dot = lambda a, c: (a * c).sum(1, keepdim=True)
    if ref:
        iu, ip, in_ = (dot(x, x).rsqrt() for x in (uf, pf, nf))
    else:
        iu = ip = in_ = torch.ones(b, 1)
    cp, cn = dot(uf, pf) * iu * ip, dot(uf, nf) * iu * in_
    x = gain * (cp - cn)
    sp = torch.nn.functional.softplus(x)
    g = gain * torch.sigmoid(x)
    if ref:
        a_u, a_p, a_n = -g * iu * iu * (cp - cn), g * iu * ip, -g * iu * in_
        b_u, b_p = g * ip * iu, -g * ip * ip * cp
        c_u, c_n = -g * in_ * iu, g * in_ * in_ * cn
    else:
        z = torch.zeros_like(g)
        a_u, a_p, a_n, b_u, b_p, c_u, c_n = z, g, -g, g, z, -g, z
    a_n = torch.where(incl[:, None], a_n, a_n * scale)
    n_src = torch.where(incl[:, None], i_tab[loc, :d], ni)   # what a_n multiplies
    reg = dot(ui, ui) + dot(pi, pi) + dot(ni, ni)
    lt = torch.where(valid[:, None], torch.cat([sp, reg], 1), 0.0)
    gni = (2 * coeff_d * ni + torch.where(incl[:, None], 0.0,
                                          scale * c1 * (c_u * uf + c_n * nf))) / cnt
    gni = torch.where(valid[:, None], gni, 0.0)
    # pass 2, block 0: strided per-thread partials, then a fixed tree
    acc = torch.nn.functional.pad(lt, (0, 0, 0, -b % THREADS)).view(-1, THREADS, 2)
    acc = acc.cumsum(0)[-1]
    h = THREADS // 2
    while h:
        acc = acc[:h] + acc[h:2 * h]
        h //= 2
    out = w1 * acc[0, 0] + w2 * acc[0, 1]
    # table rows: each entry's coefficients times the partner rows gathered
    # again and the row's own final
    gu, gi = torch.zeros(u_pad, 2 * d), torch.zeros(i_pad, 2 * d)
    st = incidence.user_start
    for r in range(u_pad):
        t = _entries(incidence.user_order, int(st[r]), int(st[r + 1]), kneg)
        if t.numel() == 0:
            continue
        own = u_tab[r, :d]
        s = _round_robin(a_u[t] * own + a_p[t] * i_tab[pl[t], :d] + a_n[t] * n_src[t])
        gu[r, :d] = w1 * s
        gu[r, d:] = 2.0 * w2 * t.numel() * u_tab[r, d:]
    st, nr = incidence.pos_start, incidence.neg_range
    for r in range(i_pad):
        tp = _entries(incidence.pos_order, int(st[r]), int(st[r + 1]), kneg)
        tn = incidence.neg_order[int(nr[r]):int(nr[i_pad + r])].long()
        if tp.numel() + tn.numel() == 0:
            continue
        own = i_tab[r, :d]
        pos = b_u[tp] * u_tab[ul[tp], :d] + b_p[tp] * own
        neg = torch.where(valid[tn, None], c_u[tn] * u_tab[ul[tn], :d] + c_n[tn] * own, 0.0)
        gi[r, :d] = w1 * _round_robin(pos, neg)
        if tp.numel():
            gi[r, d:] = 2.0 * w2 * tp.numel() * i_tab[r, d:]
    return out, gu, gi, gni


def _mirror_inputs(case, d, seed):
    """Random ``bpr_tile`` inputs on the CPU with a masked tail of b // 5."""
    rng = np.random.default_rng(seed)
    u_pad, i_pad, b = 40, 56, 1100
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
    ints = lambda hi, n: torch.from_numpy(rng.integers(0, hi, n).astype(np.int32))
    u_tab, i_tab = f(u_pad, 2 * d), f(i_pad, 2 * d)
    ul, pl, loc, inc = ints(u_pad, b), ints(i_pad, b), ints(i_pad, b), ints(2, b)
    m = torch.ones(b, dtype=torch.int32)
    m[b - b // 5:] = 0
    if case == "user_hub":       # user 3 in about 900 valid triplets
        ul[: 900] = 3
    elif case == "item_hub":     # item 5 the positive of 850, negative of more
        pl[: 850] = 5
        loc[::3] = 5
    elif case == "loc_eq_pl":    # in-cluster negatives equal to the positive
        loc[::7], inc[::7] = pl[::7], 1
    elif case == "all_masked":
        m.zero_()
    elif case == "four_negatives":
        ul, pl, m = (t[: b // 4].repeat_interleave(4) for t in (ul, pl, m))
    ni = f(b, d)
    return u_tab, i_tab, ni, ul, pl, loc, inc, m


MIRROR_CASES = ["mixed", "user_hub", "item_hub", "loc_eq_pl", "all_masked",
                "four_negatives"]


@pytest.mark.parametrize("d", [16, 64, 100])
@pytest.mark.parametrize("loss", ["reference", "standard"])
@pytest.mark.parametrize("case", MIRROR_CASES)
def test_bpr_tile_two_pass_mirror(case, loss, d):
    args = _mirror_inputs(case, d, seed=MIRROR_CASES.index(case) + d)
    kw = dict(scale=1 / 16, bpr_coeff=5e-3, loss=loss)
    # four negatives per positive: the trainer's layout, an entry per group
    kneg = 4 if case == "four_negatives" else 1
    incidence = cuda_bpr.bpr_incidence(*args[3:], 40, 56, kneg=kneg)
    got = _mirror_bpr_tile(*args, incidence, **kw)
    want = cuda_bpr.bpr_tile_plain(*args, **kw)
    for name, a, ref in zip(("loss", "gu", "gi", "gni"), got, want):
        err = float((a - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)
    if case == "all_masked":
        assert all(not bool(t.any()) for t in got)
    assert not bool(got[3][args[7] == 0].any())


@pytest.mark.parametrize("case", ["mixed", "item_hub", "loc_eq_pl", "all_masked",
                                  "four_negatives"])
def test_bpr_tile_incidence_lists(case):
    """``bpr_incidence``'s user and positive lists are the role-sorted
    design's (numpy's stable argsort of its role keys), each row's triplets in
    ascending t; its negative lists are the in-cluster runs of the negatives'
    global ids sorted stably; the trainer's layout (an entry per group of four
    triplets) expands to the lists of the expanded arrays."""
    u_tab, i_tab, ni, ul, pl, loc, inc, m = _mirror_inputs(case, 16, seed=1)
    u_pad, i_pad, b = u_tab.shape[0], i_tab.shape[0], ni.shape[0]
    rows = u_pad + i_pad
    got = cuda_bpr.bpr_incidence(ul, pl, loc, inc, m, u_pad, i_pad)
    keys = _mirror_keys(ul, pl, loc, inc, m, u_pad, i_pad).numpy()
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(keys[order], np.arange(rows + 1))
    v = int((m != 0).sum())
    assert int(got.user_start[u_pad]) == v and got.kneg == 1
    for r in range(rows):
        e = order[bounds[r]:bounds[r + 1]]
        if r < u_pad:
            lst = got.user_order[got.user_start[r]:got.user_start[r + 1]].numpy()
            np.testing.assert_array_equal(lst, e)
            continue
        ri = r - u_pad
        pos = got.pos_order[got.pos_start[ri]:got.pos_start[ri + 1]].numpy()
        neg = got.neg_order[got.neg_range[ri]:got.neg_range[i_pad + ri]].numpy()
        np.testing.assert_array_equal(np.concatenate([pos + b, neg + 2 * b]), e)
    if case == "item_hub":
        assert int(got.pos_start[6] - got.pos_start[5]) >= 800
    # the negatives by global id: local row r holds item 3 r + 1; an
    # out-of-cluster negative is some other id
    rng = np.random.default_rng(2)
    item_ids = 3 * np.arange(i_pad) + 1
    gid = np.where(inc.numpy() != 0, item_ids[loc.numpy()], 3 * rng.integers(0, 90, b))
    n_order, n_start = tsort_rows(torch.from_numpy(gid.astype(np.int32)), 3 * i_pad + 1)
    valid = (m != 0).numpy()
    for r in range(i_pad):
        run = n_order[n_start[item_ids[r]]:n_start[item_ids[r] + 1]].numpy()
        lst = got.neg_order[got.neg_range[r]:got.neg_range[i_pad + r]].numpy()
        np.testing.assert_array_equal(run[valid[run]], lst)
        np.testing.assert_array_equal(run, np.flatnonzero(gid == item_ids[r]))
    if case == "four_negatives":
        grouped = cuda_bpr.bpr_incidence(ul, pl, loc, inc, m, u_pad, i_pad, kneg=4)
        assert grouped.kneg == 4
        for o, s, o1, s1 in ((grouped.user_order, grouped.user_start,
                              got.user_order, got.user_start),
                             (grouped.pos_order, grouped.pos_start,
                              got.pos_order, got.pos_start)):
            np.testing.assert_array_equal(4 * s.numpy(), s1.numpy())
            n = int(s[-1])
            expanded = (4 * o[:n, None].long() + torch.arange(4)).reshape(-1)
            np.testing.assert_array_equal(expanded.numpy(), o1[:4 * n].numpy())
        assert torch.equal(grouped.neg_order, got.neg_order)
        assert torch.equal(grouped.neg_range, got.neg_range)
