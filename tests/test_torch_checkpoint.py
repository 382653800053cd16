"""Checkpoints and parameters carried between the JAX package and the port."""

import jax
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.models import lightgcn as jlg
from movie_recommender_system_with_gnns_tpu.ops.bpr import normalize_embedding as j_norm
from movie_recommender_system_with_gnns_tpu.training import checkpoint as jck
from movie_recommender_system_with_gnns_tpu_torch.models import lightgcn as tlg
from movie_recommender_system_with_gnns_tpu_torch.ops.bpr import normalize_embedding as t_norm
from movie_recommender_system_with_gnns_tpu_torch.training import checkpoint as tck


def _jax_params(nu=30, ni=45, d=16):
    return jlg.init_params(jax.random.PRNGKey(4), nu, ni, d)


def test_jax_checkpoint_loads_in_port(tmp_path):
    params = _jax_params()
    meta = {"val_recall": 0.125, "config": "{}"}
    jck.save_params(str(tmp_path / "m.npz"), params, meta=meta)
    loaded, got = tck.load_params(str(tmp_path / "m.npz"), device="cpu")
    assert got == meta
    for j, t in zip(params, loaded):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_port_checkpoint_loads_in_jax(tmp_path):
    gen = torch.Generator().manual_seed(2)
    params = tlg.init_params(30, 45, 16, generator=gen, device="cpu")
    tck.save_params(str(tmp_path / "m.npz"), params, meta={"epoch": 3})
    loaded, meta = jck.load_params(str(tmp_path / "m.npz"))
    assert meta == {"epoch": 3}
    for t, j in zip(params, loaded):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    tck.save_params(str(tmp_path / "plain.npz"), params)
    assert jck.load_params(str(tmp_path / "plain.npz"))[1] == {}
    assert tck.load_params(str(tmp_path / "plain.npz"), device="cpu")[1] == {}


def test_params_from_numpy_is_bit_exact():
    params = _jax_params()
    t = tlg.params_from_numpy(np.asarray(params.user_emb), np.asarray(params.item_emb),
                              device="cpu")
    for j, tt in zip(params, t):
        np.testing.assert_array_equal(np.asarray(j).view(np.uint32),
                                      tt.numpy().view(np.uint32))


def test_init_params_seeded():
    a = tlg.init_params(200, 300, 32, generator=torch.Generator().manual_seed(7),
                        device="cpu")
    b = tlg.init_params(200, 300, 32, generator=torch.Generator().manual_seed(7),
                        device="cpu")
    assert a.user_emb.shape == (200, 32) and a.item_emb.shape == (300, 32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert abs(float(a.item_emb.std()) - 0.01) < 1e-3
    assert not torch.equal(a.user_emb[:50], a.item_emb[:50])


def test_get_embeddings_matches_jax():
    params = _jax_params()
    t = tlg.params_from_numpy(np.asarray(params.user_emb), np.asarray(params.item_emb),
                              device="cpu")
    ui, ii = np.array([0, 5, 29]), np.array([44, 1])
    ju, ji = jlg.get_embeddings(params, ui, ii)
    tu, ti = tlg.get_embeddings(t, torch.from_numpy(ui), torch.from_numpy(ii))
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    with pytest.warns(UserWarning, match="Both indices"):
        assert tlg.get_embeddings(t) == (None, None)


def test_normalize_embedding_matches_jax(rng):
    x = rng.standard_normal((64, 24)).astype(np.float32)
    x[3] = 0.0   # a zero row gives NaN in both
    j = np.asarray(j_norm(x))
    t = t_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    assert np.isnan(t[3]).all() and np.isnan(j[3]).all()
    np.testing.assert_allclose(t_norm(torch.from_numpy(x), eps=1e-3).numpy(),
                               np.asarray(j_norm(x, eps=1e-3)), rtol=1e-6)
