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
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("probe_*.py"))
             + [ROOT / "tools" / "fullgraph_quality.py"]
             # the multi-rank tests' ranks: they start without JAX
             + [ROOT / "tests" / "torch_dist_ranks.py"])
    assert len(files) > 10
    scanned = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"utils/observability.py", "training/recovery.py", "parallel/mesh.py",
            "parallel/sharding.py", "training/distributed.py",
            "training/compact_sharded.py"} <= scanned
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
    from movie_recommender_system_with_gnns_tpu_torch.config import Config
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import triplets_from_edges
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceCOO, densify_blocks
    from movie_recommender_system_with_gnns_tpu_torch.parallel.mesh import make_mesh
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        load_params, save_params)
    from movie_recommender_system_with_gnns_tpu_torch.training.compact import (
        build_compact_clusters)
    from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
        build_cluster_batches, prepare_training_data)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        build_eval_batch, create_train_state)
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
    # the training slice's entry points
    edges = np.array([[0, 1, 2, 3], [2, 3, 0, 1]], np.int32)
    idx = np.zeros(2, np.int32)
    for call in (
            lambda: create_train_state(Config(), 4, 5),
            lambda: build_compact_clusters([edges], 2),
            lambda: build_cluster_batches([edges], 2, 4),
            lambda: build_eval_batch(edges, 4, 2),
            lambda: triplets_from_edges(edges, 2),
            lambda: DeviceCOO.from_host(COOGraph.build(edges, 4)),
            lambda: densify_blocks(idx, idx, idx, np.ones(2, np.float32), 1, 4),
            lambda: prepare_training_data(Config()),
            lambda: cli.main(["--indexes-dir", str(tmp_path / "idx"), "--checkpoint",
                              str(tmp_path / "m.npz"), "train", "--fused-bpr"]),
            # the multi-device slice: a mesh on the card (NCCL) by default
            lambda: make_mesh(1, 1),
            lambda: cli.main(["--indexes-dir", str(tmp_path / "idx"), "--checkpoint",
                              str(tmp_path / "m.npz"), "train", "--mesh", "1x1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert create_train_state(Config(), 4, 5, device="cpu").params.user_emb.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
