"""Rules of the port: no JAX, nothing of the JAX package, and entry points
that run on the GPU unless asked for the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "movie_recommender_system_with_gnns_tpu_torch"
FORBIDDEN = ("jax", "movie_recommender_system_with_gnns_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


def test_forbidden_match_is_exact():
    assert _forbidden("jax.numpy") and _forbidden("movie_recommender_system_with_gnns_tpu.ops")
    assert not _forbidden("movie_recommender_system_with_gnns_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_entry_points_default_to_cuda(tmp_path):
    """Without a GPU and without device='cpu', entry points raise instead of
    running on the host."""
    from movie_recommender_system_with_gnns_tpu_torch import cli
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import (
        init_params, params_from_numpy)
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        load_params, save_params)
    from movie_recommender_system_with_gnns_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(4, 5, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(np.zeros((4, 8), np.float32), np.zeros((5, 8), np.float32))
    params = init_params(4, 5, 8, device="cpu")
    save_params(str(tmp_path / "m.npz"), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params(str(tmp_path / "m.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--indexes-dir", str(tmp_path / "idx"), "--checkpoint",
                  str(tmp_path / "m.npz"), "recommend", "--user-id", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
