"""Step-numbered parameter checkpoints: the port's ``save_params_orbax`` /
``load_params_orbax`` against the JAX package's Orbax backend.

The port writes its own format (``<dir>/<step>/params.npz``; Orbax imports
JAX), so the tests hold it to Orbax's rules for steps, with JAX's Orbax
directory beside the port's, and to the arrays JAX's round trip restores.
"""

import os

import jax
import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.models.lightgcn import LightGCNParams as JParams
from movie_recommender_system_with_gnns_tpu.training import checkpoint as jck
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import params_from_numpy
from movie_recommender_system_with_gnns_tpu_torch.training import checkpoint as tck
from torch_parity import np_tables

ocp = pytest.importorskip("orbax.checkpoint")


def _both(seed=0, nu=20, ni=30, d=16):
    u, i = np_tables(nu, ni, d, seed=seed)
    return (JParams(jax.numpy.asarray(u), jax.numpy.asarray(i)),
            params_from_numpy(u, i, device="cpu"), (u, i))


def _steps(directory):
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def test_round_trip_at_step_5_matches_jax(tmp_path):
    """JAX's round trip (tests/test_training.py's Orbax test): save at step
    5, load the latest; the port's tables equal JAX's restored arrays."""
    jp, tp, (u, i) = _both()
    jck.save_params_orbax(str(tmp_path / "jax"), jp, step=5)
    assert tck.save_params_orbax(str(tmp_path / "port"), tp, step=5) is True
    restored_j = jck.load_params_orbax(str(tmp_path / "jax"))
    restored_t = tck.load_params_orbax(str(tmp_path / "port"), device="cpu")
    for j, t, ref in zip(restored_j, restored_t, (u, i)):
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(t.numpy(), ref)
    assert os.path.exists(tmp_path / "port" / "5" / tck.PARAMS_FILE)


def test_named_step_loads_that_step(tmp_path):
    d = str(tmp_path / "port")
    tables = []
    for step, seed in ((3, 1), (5, 2)):
        _, tp, ref = _both(seed=seed)
        assert tck.save_params_orbax(d, tp, step=step)
        tables.append(ref)
    for step, ref in ((3, tables[0]), (5, tables[1]), (None, tables[1])):
        got = tck.load_params_orbax(d, step=step, device="cpu")
        for t, r in zip(got, ref):
            np.testing.assert_array_equal(t.numpy(), r)
    with pytest.raises(FileNotFoundError):
        tck.load_params_orbax(d, step=4, device="cpu")
    with pytest.raises(FileNotFoundError):      # Orbax's type for a missing step
        with ocp.CheckpointManager(str(tmp_path / "jd")) as m:
            m.save(3, args=ocp.args.StandardSave({"a": jax.numpy.ones(2)}))
            m.wait_until_finished()
            m.restore(4)


def test_save_rules_match_orbax(tmp_path):
    """Saves at 3, 5, 5 and 4: Orbax writes 3 and 5 and ignores a step at
    or below the latest; the port does the same and says so."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    wrote = []
    for step, seed in ((3, 1), (5, 2), (5, 3), (4, 4)):
        jp, tp, _ = _both(seed=seed)
        jck.save_params_orbax(jd, jp, step=step)
        wrote.append(tck.save_params_orbax(td, tp, step=step))
    assert wrote == [True, True, False, False]
    assert _steps(jd) == _steps(td) == [3, 5]
    assert tck.latest_step(td) == 5
    # step 5 holds the first save at 5, in both packages
    ref = _both(seed=2)[2]
    for got in (jck.load_params_orbax(jd), tck.load_params_orbax(td, device="cpu")):
        for t, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(t), r)


def test_empty_or_missing_directory_raises_in_both(tmp_path):
    os.makedirs(tmp_path / "empty_j")
    os.makedirs(tmp_path / "empty_t")
    with pytest.raises(FileNotFoundError):
        jck.load_params_orbax(str(tmp_path / "empty_j"))
    with pytest.raises(FileNotFoundError, match="No steps found"):
        tck.load_params_orbax(str(tmp_path / "empty_t"), device="cpu")
    with pytest.raises(FileNotFoundError, match="No steps found"):
        tck.load_params_orbax(str(tmp_path / "missing"), device="cpu")
    assert tck.latest_step(str(tmp_path / "missing")) is None


def test_stale_temporary_directory_is_ignored(tmp_path):
    d = tmp_path / "port"
    _, tp, ref = _both(seed=1)
    assert tck.save_params_orbax(str(d), tp, step=3)
    # an unfinished save's leftovers: a temporary directory of a later step
    # and one with a digit-only prefix in its name
    for stale in (".9.tmp-abc", "7.tmp-xyz"):
        os.makedirs(d / stale)
        (d / stale / tck.PARAMS_FILE).write_bytes(b"partial")
    assert tck.latest_step(str(d)) == 3
    for t, r in zip(tck.load_params_orbax(str(d), device="cpu"), ref):
        np.testing.assert_array_equal(t.numpy(), r)
    assert tck.save_params_orbax(str(d), tp, step=4)
    assert _steps(d) == [3, 4]
    assert not [n for n in os.listdir(d) if n.startswith(".4.tmp")]


def test_jax_load_params_reads_a_port_step(tmp_path):
    _, tp, (u, i) = _both(seed=3)
    tck.save_params_orbax(str(tmp_path), tp, step=7)
    path = str(tmp_path / "7" / tck.PARAMS_FILE)
    jp, meta = jck.load_params(path)
    assert meta == {"step": 7}
    np.testing.assert_array_equal(np.asarray(jp.user_emb), u)
    np.testing.assert_array_equal(np.asarray(jp.item_emb), i)
    assert tck.load_params(path, device="cpu")[1] == {"step": 7}


def test_jax_orbax_directory_is_not_read(tmp_path):
    jp, _, _ = _both()
    jck.save_params_orbax(str(tmp_path), jp, step=2)
    with pytest.raises(FileNotFoundError, match="params.npz"):
        tck.load_params_orbax(str(tmp_path), device="cpu")


def test_load_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so the default device is valid")
    _, tp, _ = _both()
    tck.save_params_orbax(str(tmp_path), tp, step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.load_params_orbax(str(tmp_path))
