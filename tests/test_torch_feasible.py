"""Exact-feasible negatives of the port (``ops/sampling.py``, the compact and
full-graph trainers' draws) against the JAX package on the same numpy
inputs. The random streams differ, so the port's rule is fed the candidate
draws JAX's key produces (``torch_parity.jax_feasible_draws``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, ModelConfig as JModel, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.ops import sampling as jsampling
from movie_recommender_system_with_gnns_tpu.training import compact as jcompact
from movie_recommender_system_with_gnns_tpu.training import fullgraph as jfg
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config as TConfig, ModelConfig as TModel, TrainConfig as TTrain)
from movie_recommender_system_with_gnns_tpu_torch.ops import sampling as tsampling
from movie_recommender_system_with_gnns_tpu_torch.training import compact as tcompact
from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph as tfg
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

from torch_parity import (both_clusters, both_params, greedy_parts, jax_epoch_draws,
                          jax_feasible_draws, jax_fullgraph_draws, to_np)


def _pairs(seed=0, n=400, users=50, items=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, users, n).astype(np.int32),
            rng.integers(0, items, n).astype(np.int32))


@pytest.mark.parametrize("align", [1, 128])
def test_build_member_table_matches_jax(align):
    u, i = _pairs()
    t = tsampling.build_member_table(u, i, align=align)
    np.testing.assert_array_equal(t, jsampling.build_member_table(u, i, align=align))
    assert t.dtype == np.int32 and t.shape[1] % align == 0
    keys = tsampling.member_keys(t, "cpu")
    assert keys.dtype == torch.int64 and bool((keys[1:] >= keys[:-1]).all())


def test_host_tables_match_jax():
    """The Cantor hash, its sorted table, the user → items dict and the
    feasible set difference equal JAX's."""
    u, i = _pairs(1)
    np.testing.assert_array_equal(
        tsampling.build_membership_hash(u, i, 512), jsampling.build_membership_hash(u, i, 512))
    np.testing.assert_array_equal(
        to_np(tsampling.cantor_hash_pair(torch.from_numpy(u), torch.from_numpy(i))),
        np.asarray(jsampling.cantor_hash_pair(jnp.asarray(u), jnp.asarray(i))))
    e = np.stack([u, i + 50])
    assert tsampling.get_user_items(e) == jsampling.get_user_items(e)
    a = np.stack(_pairs(2, n=300))
    np.testing.assert_array_equal(tsampling.is_in_feasible(a, np.stack([u, i])),
                                  jsampling.is_in_feasible(a, np.stack([u, i])))


@pytest.mark.parametrize("kind", ["present", "absent", "sentinel"])
def test_member_probe_matches_jax(kind):
    """The int64-key search gives JAX's booleans: on pairs of the table, on
    pairs beyond it (ids past the last user or item, between its users), and
    on the int32-max sentinel pairs of its padding."""
    u, i = _pairs(3)
    table = jsampling.build_member_table(u, i)
    rng = np.random.default_rng(4)
    big = np.iinfo(np.int32).max
    qu, qi = dict(
        present=(u, i),
        absent=(rng.integers(0, 70, 500), rng.integers(0, 60, 500)),
        sentinel=(np.array([big, big, 0, big, 49]), np.array([big, 0, big, 5, big])),
    )[kind]
    qu, qi = qu.astype(np.int32), qi.astype(np.int32)
    want = np.asarray(jsampling._member_probe(jnp.asarray(table), jnp.asarray(qu),
                                              jnp.asarray(qi)))
    got = tsampling._member_probe(tsampling.member_keys(table, "cpu"), torch.from_numpy(qu),
                                  torch.from_numpy(qi))
    np.testing.assert_array_equal(to_np(got), want)
    assert want.all() if kind == "present" else not want.all()


@pytest.mark.parametrize("num", [1, 3])
def test_sample_negative_feasible_from_jax_draws(num):
    """The rule applied to the candidates JAX's key draws equals JAX's
    ``sample_negative_feasible`` exactly; hub users, whose candidates are
    often members, make the later rounds matter."""
    rng = np.random.default_rng(5)
    ni = 30
    u = np.concatenate([np.repeat([0, 1], 25), rng.integers(2, 40, 200)]).astype(np.int32)
    i = np.concatenate([np.arange(25), np.arange(25), rng.integers(0, ni, 200)]).astype(np.int32)
    table = jsampling.build_member_table(u, i)
    users = np.concatenate([[0, 1] * 50, rng.integers(0, 40, 156)]).astype(np.int32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jsampling.sample_negative_feasible(
        key, jnp.asarray(users), ni, jnp.asarray(table), num=num))
    shape = (users.shape[0],) if num == 1 else (users.shape[0], num)
    draws = jax_feasible_draws(key, shape, ni)
    got = tsampling.feasible_from_draws(torch.from_numpy(users), torch.from_numpy(draws),
                                        tsampling.member_keys(table, "cpu"))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(to_np(got), want)
    # the hubs' first candidates often were members, and were redrawn
    assert (draws[0] != want).any()


def test_feasible_law_residual_members():
    """No more residual members than ``Σ (deg_u / I)^(R+1)`` predicts (5
    sigma), over 200,000 draws from hub users of degree 24 of 30."""
    ni, r = 30, 4
    u = np.repeat(np.arange(4), 24).astype(np.int32)
    i = np.concatenate([np.arange(k, k + 24) % ni for k in range(4)]).astype(np.int32)
    keys = tsampling.member_keys(tsampling.build_member_table(u, i), "cpu")
    users = torch.arange(4, dtype=torch.int32).repeat(50_000)
    neg = tsampling.sample_negative_feasible(torch.Generator().manual_seed(7), users, ni,
                                             keys, num_rounds=r)
    hits = int(tsampling._member_probe(keys, users, neg).sum())
    p = (24 / ni) ** (r + 1)
    expect, sigma = users.numel() * p, (users.numel() * p * (1 - p)) ** 0.5
    assert abs(hits - expect) <= 5 * sigma, (hits, expect, sigma)


def test_feasible_law_uniform_over_non_members():
    """Among the draws that are not train pairs, every non-member item is
    equally likely (chi-square, 5 sigma of its degrees of freedom)."""
    ni = 40
    members = np.arange(0, ni, 3)
    keys = tsampling.member_keys(tsampling.build_member_table(
        np.zeros(len(members), np.int32), members.astype(np.int32)), "cpu")
    users = torch.zeros(200_000, dtype=torch.int32)
    neg = to_np(tsampling.sample_negative_feasible(torch.Generator().manual_seed(8), users,
                                                   ni, keys, num=2)).reshape(-1)
    free = np.setdiff1d(np.arange(ni), members)
    ok = neg[np.isin(neg, free)]
    assert ok.size > 0.99 * neg.size
    counts = np.bincount(ok, minlength=ni)[free]
    expect = ok.size / free.size
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    dof = free.size - 1
    assert chi2 < dof + 5 * (2 * dof) ** 0.5, chi2


def _cfgs(**train):
    model = dict(num_layers=2, dim=8)
    train = dict(dict(lr=1e-2, negatives="feasible"), **train)
    return (JConfig(model=JModel(**model), train=JTrain(**train)),
            TConfig(model=TModel(**model), train=TTrain(**train)))


def test_compact_epoch_feasible_matches_jax(tiny_data):
    """One Adam epoch on member-table clusters: the port's negatives from the
    candidates JAX's epoch key draws, each step's from the global users of
    its triplet slots; parameters and the mean loss within 1e-5 of JAX's
    epoch fn, which draws its feasible negatives itself."""
    cfg_j, cfg_t = _cfgs()
    nu, ni = tiny_data.num_users, tiny_data.num_items
    cj, ct = both_clusters(greedy_parts(tiny_data, 4), nu)
    cj = jcompact.attach_member_table(cj, tiny_data.edge_index, nu)
    ct = tcompact.attach_member_table(ct, tiny_data.edge_index, nu)
    pj, pt = both_params(nu, ni, 8, seed=3, std=0.05)
    key = jax.random.PRNGKey(13)
    k, b = ct.num_clusters, ct.user_local.shape[1]
    perm, draws = jax_epoch_draws(key, k, b, ni, 1, feasible_rounds=4)
    neg = torch.stack([
        tsampling.feasible_from_draws(ct.user_ids[int(c)][ct.user_local[int(c)].long()],
                                      torch.from_numpy(draws[j]), ct.member_table)
        for j, c in enumerate(perm)])
    uniform = np.stack([np.asarray(d[0]) for d in draws])
    assert (to_np(neg) != uniform).any()        # some candidate was redrawn
    opt = jtrain.make_optimizer(cfg_j)
    st_j, loss_j = jcompact.make_compact_epoch_fn(cfg_j)(
        jtrain.TrainState(pj, opt.init(pj), jnp.zeros((), jnp.int32)), cj, key)
    st_t, loss_t = tcompact.make_compact_epoch_fn(cfg_t)(
        ttrain.TrainState(pt, ttrain.make_optimizer(cfg_t).init(pt), 0), ct, None,
        perm=torch.from_numpy(perm.copy()), neg=neg)
    np.testing.assert_allclose(loss_t, float(loss_j), atol=1e-5)
    for a, b_ in zip(st_t.params, st_j.params):
        np.testing.assert_allclose(to_np(a), np.asarray(b_), atol=1e-5, rtol=0)


def test_fullgraph_epoch_feasible_matches_jax(tiny_data):
    """One full-graph epoch (K = 2 feasible negatives): the port's negatives
    from the candidates JAX's epoch key draws for each step's users;
    parameters and the mean loss within 1e-5 of JAX's epoch fn."""
    cfg_j, cfg_t = _cfgs(trainer="fullgraph", num_clusters=4, fullgraph_steps=3,
                         num_negatives=2, hybrid_block_dtype="float32", loss="standard")
    nu, ni = tiny_data.num_users, tiny_data.num_items
    e, n = tiny_data.edge_index, nu + ni
    fj = jfg.build_fullgraph_data(cfg_j, e, nu, n)
    ft = tfg.build_fullgraph_data(cfg_t, e, nu, n, device="cpu")
    pj, pt = both_params(nu, ni, 8, seed=4, std=0.1)
    key = jax.random.PRNGKey(14)
    perm, draws = jax_fullgraph_draws(key, fj.e_real, fj.num_steps, fj.batch, ni, 2,
                                      feasible_rounds=4)
    idx = torch.cat([torch.from_numpy(perm.astype(np.int64)),
                     torch.arange(ft.e_real, ft.num_steps * ft.batch)])
    users = ft.user[idx].view(ft.num_steps, ft.batch)
    neg = torch.stack([tsampling.feasible_from_draws(users[s], torch.from_numpy(draws[s]),
                                                     ft.member_table)
                       for s in range(ft.num_steps)])
    opt = jtrain.make_optimizer(cfg_j)
    st_j, loss_j = jfg.make_fullgraph_epoch_fn(cfg_j, fj)(
        jtrain.TrainState(pj, opt.init(pj), jnp.zeros((), jnp.int32)), fj, key)
    st_t, loss_t = tfg.make_fullgraph_epoch_fn(cfg_t, ft)(
        ttrain.TrainState(pt, ttrain.make_optimizer(cfg_t).init(pt), 0), ft, None,
        perm=torch.from_numpy(perm.copy()), neg=neg)
    np.testing.assert_allclose(loss_t, float(loss_j), atol=1e-5)
    for a, b_ in zip(st_t.params, st_j.params):
        np.testing.assert_allclose(to_np(a), np.asarray(b_), atol=1e-5, rtol=0)


@pytest.mark.parametrize("trainer", ["compact", "fullgraph"])
def test_trainers_draw_feasible_negatives(tiny_data, trainer, monkeypatch):
    """Left to their generator, both trainers' epochs draw their negatives
    through the member table, once a step, and keep no more train pairs than
    ``Σ (deg_u / I)^(R+1)`` predicts for the step's users (5 sigma)."""
    cfg_j, cfg_t = _cfgs(trainer=trainer, num_clusters=4, fullgraph_steps=2,
                         num_negatives=2, hybrid_block_dtype="float32")
    nu, ni = tiny_data.num_users, tiny_data.num_items
    e = tiny_data.edge_index
    seen = []
    real = tsampling.sample_negative_feasible

    fwd = (e[0] < nu) & (e[1] >= nu)
    deg = np.bincount(np.unique(np.stack([e[0][fwd], e[1][fwd]]), axis=1)[0], minlength=nu)

    def spy(gen, user, num_items, member, num_rounds=4, num=1):
        out = real(gen, user, num_items, member, num_rounds, num)
        u = user[:, None].expand(out.shape)
        hits = int(tsampling._member_probe(member, u, out).sum())
        p = (deg[to_np(u)] / num_items) ** (num_rounds + 1)
        seen.append((hits, p.sum(), (p * (1 - p)).sum() ** 0.5))
        return out

    if trainer == "compact":
        data = tcompact.attach_member_table(
            both_clusters(greedy_parts(tiny_data, 4), nu)[1], e, nu)
        fn, mod = tcompact.make_compact_epoch_fn(cfg_t), tcompact
    else:
        data = tfg.build_fullgraph_data(cfg_t, e, nu, nu + ni, device="cpu")
        fn, mod = tfg.make_fullgraph_epoch_fn(cfg_t, data), tfg
    _, pt = both_params(nu, ni, 8, seed=2)
    monkeypatch.setattr(mod, "sample_negative_feasible", spy)
    st, loss = fn(ttrain.TrainState(pt, ttrain.make_optimizer(cfg_t).init(pt), 0), data,
                  torch.Generator().manual_seed(1))
    steps = data.num_clusters if trainer == "compact" else data.num_steps
    assert len(seen) == steps and st.step == steps and np.isfinite(loss)
    for hits, expect, sigma in seen:
        assert hits <= expect + 5 * sigma + 1, seen
