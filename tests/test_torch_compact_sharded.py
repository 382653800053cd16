"""The port's data-parallel compact trainer (``training/compact_sharded.py``)
against the JAX package's, on 4 gloo ranks (``torch_dist_ranks.spawn``) and
JAX's 4×1 mesh of conftest's virtual CPU devices, from the same tables,
clusters, cluster order and negatives.

The port's ranks run the plain loss and the fused BPR kernel's route (its
plain version on the CPU), the JAX side the plain loss. Two cluster sets:

  * 4 clusters, one superstep, and 8 clusters, two supersteps: against the
    manual reference of ``tests/test_compact_sharded.py`` (one Adam update
    per superstep on the edge-count-weighted mean of JAX's
    ``compact_cluster_loss`` gradients, what both packages' docstrings
    promise), and at one superstep the loss against JAX's plain
    ``make_compact_sharded_epoch_fn`` too.
  * Fault C6 of the JAX package (ROADMAP, faults): on the plain route that
    epoch applies the SUM of the clusters' gradients, not their weighted
    mean (each rank's gradient of the replicated tables is summed over
    ``data`` by ``shard_map``'s autodiff, then its ``psum`` of ``g · w``
    sums ``w · Σg``); on the fused route, whose ``shard_map`` skips the
    varying-manifest check, it applies the mean. Its first moments after
    one superstep are held to ``(1 - b1)`` times the clipped sum and the
    clipped mean respectively. Its own test compares only the loss and the
    tables after one Adam update, which is ``±lr`` whatever the gradient.

Tolerances: the epoch's loss within rtol 1e-5 and the two-superstep
tables within rtol 2e-4 / atol 1e-6 (``tests/test_compact_sharded.py``);
Adam's first moments, ``(1 - b1)`` times the clipped gradients, within the
gradient tolerance of ``tests/test_sharding.py`` (rtol 1e-4, atol 1e-6
scaled by ``1 - b1``). The tables after ONE superstep are not compared:
Adam's first update is ``±lr`` wherever ``|g| ≫ eps``, so a near-zero
gradient entry whose last bits differ moves by up to ``2·lr``.
Moments are held on both routes, tables on the plain route; the fused
route sums the gradients in another order, and its tables are held by the
1×1 check. On a
1×1 mesh the fused epoch is the single-device compact epoch: tables,
moments, loss and step ``torch.equal``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.parallel.mesh import make_mesh
from movie_recommender_system_with_gnns_tpu.training.compact import compact_cluster_loss
from movie_recommender_system_with_gnns_tpu.training.compact_sharded import (
    make_compact_sharded_epoch_fn)
from movie_recommender_system_with_gnns_tpu.training.train import TrainState, make_optimizer

import torch_dist_ranks as ranks
from torch_parity import both_clusters, both_params, greedy_parts, jax_cluster, jax_epoch_draws

LAYERS, DIM = 2, 8
SETS = {"k4": 4, "k8": 8}


#: JAX's compact loss and its gradient, compiled once for the clusters' shape
_loss_and_grad = jax.jit(jax.value_and_grad(compact_cluster_loss), static_argnums=(3, 4, 5))


def _manual(cfg, cj, params, perm, negs):
    """One Adam update per 4 clusters of ``perm`` on the edge-weighted mean
    of their gradients: (tables, optimizer state, edge-weighted mean loss)."""
    opt = make_optimizer(cfg)
    ec, p, ost, wloss = np.asarray(cj.edge_counts), params, opt.init(params), 0.0
    for s in range(len(perm) // 4):
        sel, grads = perm[4 * s:4 * s + 4], None
        for c in sel:
            loss_c, g = _loss_and_grad(p, jax_cluster(cj, c), jnp.asarray(negs[c]), cfg,
                                       cj.u_pad, cj.i_pad)
            g = jax.tree.map(lambda x: x * (ec[c] / ec[sel].sum()), g)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
            wloss += float(loss_c) * ec[c]
        upd, ost = opt.update(grads, ost, p)
        p = optax.apply_updates(p, upd)
    return p, ost, wloss / ec.sum()


def _clipped(grads, max_norm):
    """optax's clip_by_global_norm of a gradient tree, in float64 numpy."""
    leaves = [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(grads)]
    norm = np.sqrt(sum((g * g).sum() for g in leaves))
    return [g * min(1.0, max_norm / norm) for g in leaves]


def _jax_epoch(cfg, cj, params, key):
    """JAX's 4×1 epoch at one superstep, and what its first moments are
    held against: ``(1 - b1)`` times the clipped sum and the clipped
    edge-weighted mean of the four clusters' gradients on its own route."""
    _, negs = jax_epoch_draws(key, 4, cj.user_local.shape[1], params.item_emb.shape[0], 1)
    grads = [_loss_and_grad(params, jax_cluster(cj, c), jnp.asarray(negs[c]), cfg,
                            cj.u_pad, cj.i_pad)[1] for c in range(4)]
    w = np.asarray(cj.edge_counts, np.float64)
    total = jax.tree.map(lambda *g: sum(np.asarray(x, np.float64) for x in g), *grads)
    mean = jax.tree.map(lambda *g: sum(np.asarray(x, np.float64) * c / w.sum()
                                       for x, c in zip(g, w)), *grads)
    opt = make_optimizer(cfg)
    fn = make_compact_sharded_epoch_fn(cfg, make_mesh(4, 1, devices=jax.devices()[:4]))
    p = jax.tree.map(jnp.copy, params)
    st, loss = fn(cj)(TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)), cj, key)
    b1, clip = cfg.train.adam_b1, cfg.train.grad_clip_norm
    return dict(loss=float(loss), mu=_adam_mu(st.opt_state),
                sum=[(1 - b1) * g for g in _clipped(total, clip)],
                mean=[(1 - b1) * g for g in _clipped(mean, clip)])


def _adam_mu(opt_state):
    """Adam's first moments from an optax chain's state."""
    adam = next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    return np.asarray(adam.mu.user_emb), np.asarray(adam.mu.item_emb)


@pytest.fixture(scope="module")
def run(tiny_data, tmp_path_factory):
    nu, ni = tiny_data.num_users, tiny_data.num_items
    cfg = JConfig(model=JModel(num_layers=LAYERS, dim=DIM), train=JTrain(lr=1e-2))
    key = jax.random.PRNGKey(11)
    refs, inputs = {}, dict(nu=nu, sets=np.asarray(list(SETS)), layers=LAYERS, dim=DIM)
    for tag, k in SETS.items():
        parts = greedy_parts(tiny_data, k)
        assert len(parts) == k
        cj, _ = both_clusters(parts, nu)
        pj, pt = both_params(nu, ni, DIM, seed=4, std=0.1)
        # JAX keys each cluster's negatives by the cluster's id; the port's
        # neg[j] belongs to the j-th cluster trained
        perm, negs = jax_epoch_draws(key, k, cj.user_local.shape[1], ni, 1)
        p, ost, loss = _manual(cfg, cj, pj, perm, negs)
        refs[tag] = dict(loss=float(loss), u=np.asarray(p.user_emb), i=np.asarray(p.item_emb),
                         mu=_adam_mu(ost), step=k // 4)
        if tag == "k4":
            for route, fused in (("plain", False), ("fused", True)):
                cfg_r = JConfig(model=cfg.model, train=JTrain(lr=1e-2, fused_bpr=fused))
                refs[tag][f"jax_{route}"] = _jax_epoch(cfg_r, cj, pj, key)
        inputs.update({f"{tag}_parts": k, f"{tag}_perm": perm, f"{tag}_neg": negs[perm],
                       **{f"{tag}_part{j}": q for j, q in enumerate(parts)}})
        inputs.update(u=pt.user_emb.numpy(), i=pt.item_emb.numpy())
    out = ranks.spawn(ranks.compact_supersteps, 4, tmp_path_factory.mktemp("compact"),
                      inputs)
    return refs, out


@pytest.mark.parametrize("route", ["plain", "fused"])
@pytest.mark.parametrize("tag", list(SETS))
def test_compact_superstep_matches_jax(run, tag, route):
    """The epoch's loss and step count (and at one superstep the loss of
    JAX's plain sharded epoch); both routes' first moments against the
    manual reference; the plain route's tables after two supersteps. JAX's
    fused epoch is not a reference at these tolerances: its kernel gathers
    the tables in bf16, the port's kernel in f32."""
    refs, out = run
    ref, key = refs[tag], f"{tag}_{route}"
    np.testing.assert_allclose(float(out[f"{key}_loss"]), ref["loss"], rtol=1e-5)
    if "jax_plain" in ref:
        np.testing.assert_allclose(float(out[f"{key}_loss"]), ref["jax_plain"]["loss"],
                                   rtol=1e-5)
    assert int(out[f"{key}_step"]) == ref["step"]
    for got, want in zip((out[f"{key}_mu_u"], out[f"{key}_mu_i"]), ref["mu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    if route == "plain":
        if ref["step"] > 1:
            np.testing.assert_allclose(out[f"{key}_u"], ref["u"], rtol=2e-4, atol=1e-6)
            np.testing.assert_allclose(out[f"{key}_i"], ref["i"], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("route,applied,not_applied",
                         [("plain", "sum", "mean"), ("fused", "mean", "sum")])
def test_jax_compact_sharded_epoch_gradient_by_route(run, route, applied, not_applied):
    """Fault C6 of the JAX package, kept as evidence: after one superstep on
    its 4×1 mesh, JAX's Adam first moments are ``(1 - b1)`` times the
    clipped SUM of the four clusters' gradients on the plain route, and the
    clipped edge-weighted MEAN its docstring promises on the fused BPR
    route, whose ``shard_map`` is built with ``check_vma=False``. Within
    rtol 1e-4, atol 1e-7 of the one, and farther than that from the other."""
    jref = run[0]["k4"][f"jax_{route}"]
    for got, want in zip(jref["mu"], jref[applied]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert not all(np.allclose(got, want, rtol=1e-4, atol=1e-7)
                   for got, want in zip(jref["mu"], jref[not_applied]))


def test_compact_sharded_refuses_clusters_that_do_not_divide(run):
    """7 clusters over 4 data ranks: JAX's ValueError."""
    assert str(run[1]["divide_error"]) == "num_clusters=7 must divide by data axis 4"


def test_compact_sharded_1x1_is_the_single_device_step(run):
    """At dp = 1 the cluster weight is exactly 1: the fused route's epoch
    equals the single-device compact epoch bit for bit."""
    assert run[1]["solo_equal"].all(), run[1]["solo_equal"]
