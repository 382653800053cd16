"""Full-state checkpoints (``training/checkpoint.py::save_train_state`` /
``load_train_state`` / ``load_state_meta``): a file written by either
package loads in the other with every array equal, under Adam with a
constant and a cosine schedule and under the three lazy optimizers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.config import (
    Config as JConfig, TrainConfig as JTrain)
from movie_recommender_system_with_gnns_tpu.training import checkpoint as jckpt
from movie_recommender_system_with_gnns_tpu.training import compact as jcompact
from movie_recommender_system_with_gnns_tpu.training import train as jtrain
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
from movie_recommender_system_with_gnns_tpu_torch.training import checkpoint as tckpt
from movie_recommender_system_with_gnns_tpu_torch.training import compact as tcompact
from movie_recommender_system_with_gnns_tpu_torch.training import train as ttrain

from torch_parity import to_np

NU, NI, D, COUNT, STEP = 7, 9, 4, 11, 13
OPTIMIZERS = ["adam", "adam_cosine", "lazy_adam", "hybrid_adam", "lazy_item_adam"]


def _tables(seed):
    """[user, item, mu.user, mu.item, nu.user, nu.item] float32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, D)).astype(np.float32) for n in (NU, NI) * 3]


def _jax_leaves(opt, tabs):
    """The JAX state's leaves in ``tree_flatten`` order, as numpy arrays."""
    c, s = np.int32(COUNT), np.int32(STEP)
    u, i, mu_u, mu_i, nu_u, nu_i = tabs
    if opt == "adam":
        return [u, i, c, mu_u, mu_i, nu_u, nu_i, s]
    if opt == "adam_cosine":
        return [u, i, c, mu_u, mu_i, nu_u, nu_i, c, s]
    return [u, i, mu_u, mu_i, nu_u, nu_i, c, s]


def _jax_state_like(opt):
    sched = dict(lr_schedule="cosine", lr_total_steps=20) if opt == "adam_cosine" else {}
    st = jtrain.create_train_state(JConfig(train=JTrain(**sched)), NU, NI)
    st = jtrain.TrainState(jax.tree_util.tree_map(lambda x: x[:, :D], st.params),
                           None, st.step)
    if opt.startswith("adam"):
        cfg = JConfig(train=JTrain(**sched))
        return st._replace(opt_state=jtrain.make_optimizer(cfg).init(st.params))
    return st._replace(opt_state=jcompact.init_lazy_adam(st.params))


def _port_state(opt, tabs):
    u, i, mu_u, mu_i, nu_u, nu_i = (torch.from_numpy(t.copy()) for t in tabs)
    P = LightGCNParams
    if opt.startswith("adam"):
        ost = ttrain.AdamState(COUNT, P(mu_u, mu_i), P(nu_u, nu_i))
    else:
        ost = tcompact.LazyAdamState(P(mu_u, mu_i), P(nu_u, nu_i), COUNT)
    return ttrain.TrainState(P(u, i), ost, STEP)


def _port_leaves(st):
    ost = st.opt_state
    return [*st.params, *ost.mu, *ost.nu, ost.count, st.step]


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_port_file_loads_in_jax(tmp_path, opt):
    """The port writes; JAX's ``load_train_state`` reads it into its own
    state_like (same optimizer and schedule) with every leaf equal."""
    tabs = _tables(1)
    path = str(tmp_path / "st.npz")
    tckpt.save_train_state(path, _port_state(opt, tabs), meta={"epoch": 3},
                           schedule_count=opt == "adam_cosine")
    loaded = jckpt.load_train_state(path, _jax_state_like(opt))
    got = jax.tree_util.tree_leaves(loaded)
    want = _jax_leaves(opt, tabs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)
    assert jckpt.load_state_meta(path) == {"num_leaves": len(want), "epoch": 3}


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_jax_file_loads_in_port(tmp_path, opt):
    """JAX writes; the port's ``load_train_state`` reads it into a port
    state_like of the same optimizer: tables and moments equal, on the
    state_like's device, new tensors; counts and step Python ints."""
    tabs = _tables(2)
    like = _jax_state_like(opt)
    _, treedef = jax.tree_util.tree_flatten(like)
    jst = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in _jax_leaves(opt, tabs)])
    path = str(tmp_path / "st.npz")
    jckpt.save_train_state(path, jst, meta={"epoch": 5})
    port_like = _port_state(opt, _tables(3))
    st = tckpt.load_train_state(path, port_like)
    assert type(st.opt_state) is type(port_like.opt_state)
    leaves = _port_leaves(st)
    for g, w in zip(leaves[:6], tabs):
        assert g.device == port_like.params.user_emb.device and g.dtype == torch.float32
        np.testing.assert_array_equal(to_np(g), w)
    assert leaves[6:] == [COUNT, STEP] and all(type(x) is int for x in leaves[6:])
    assert not any(g is w for g, w in zip(leaves[:6], _port_leaves(port_like)))
    assert tckpt.load_state_meta(path)["epoch"] == 5


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_port_round_trip_is_exact(tmp_path, opt):
    """The port's own round trip: every leaf equal, a file saved again from
    the loaded state byte-equal per array."""
    path, again = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    st = _port_state(opt, _tables(4))
    cos = opt == "adam_cosine"
    tckpt.save_train_state(path, st, schedule_count=cos)
    back = tckpt.load_train_state(path, _port_state(opt, _tables(5)))
    for a, b in zip(_port_leaves(back), _port_leaves(st)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    tckpt.save_train_state(again, back, schedule_count=cos)
    with np.load(path) as za, np.load(again) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for f in za.files:
            assert za[f].tobytes() == zb[f].tobytes() and za[f].dtype == zb[f].dtype


def test_cosine_counts_that_differ_raise(tmp_path):
    """A 9-leaf Adam file holds the count twice; two counts that disagree
    mean a corrupt file, never a silent pick of one."""
    tabs = _tables(6)
    leaves = _jax_leaves("adam_cosine", tabs)
    leaves[7] = np.int32(COUNT + 1)
    like = _jax_state_like("adam_cosine")
    _, treedef = jax.tree_util.tree_flatten(like)
    path = str(tmp_path / "bad.npz")
    jckpt.save_train_state(path, jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in leaves]))
    with pytest.raises(ValueError, match="schedule's count 12 differs"):
        tckpt.load_train_state(path, _port_state("adam", tabs))


def test_load_refuses_another_structure(tmp_path):
    """A file of another state structure or shape raises instead of loading
    mislabelled arrays."""
    path = str(tmp_path / "lazy.npz")
    tckpt.save_train_state(path, _port_state("lazy_adam", _tables(7)))
    with pytest.raises(ValueError, match="not an integer scalar"):
        tckpt.load_train_state(path, _port_state("adam", _tables(7)))
    tckpt.save_train_state(path, _port_state("adam_cosine", _tables(7)), schedule_count=True)
    with pytest.raises(ValueError, match="holds 9 leaves"):
        tckpt.load_train_state(path, _port_state("lazy_adam", _tables(7)))
    small = _port_state("adam", [t[:3] for t in _tables(8)])
    tckpt.save_train_state(path, small)
    with pytest.raises(ValueError, match=r"expected torch.float32 \(7, 4\)"):
        tckpt.load_train_state(path, _port_state("adam", _tables(8)))


def test_load_state_meta_both_ways(tmp_path):
    """``load_state_meta`` reads the meta of either package's file: the leaf
    count and the caller's keys (the epoch and the run identity recovery
    writes)."""
    meta = {"epoch": 4, "run": {"config_sha256": "ab", "call": "cd"}}
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save_train_state(tpath, _port_state("hybrid_adam", _tables(9)), meta=meta)
    like = _jax_state_like("hybrid_adam")
    jckpt.save_train_state(jpath, like, meta=meta)
    want = {"num_leaves": 8, **meta}
    assert tckpt.load_state_meta(tpath) == jckpt.load_state_meta(tpath) == want
    assert tckpt.load_state_meta(jpath) == want
    assert not (tmp_path / "t.npz.tmp").exists()
