"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port. Each entry runs in a fresh process, and
the loaded modules' top-level names are compared whole (the port's name
begins with the JAX package's)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

PORT = "movie_recommender_system_with_gnns_tpu_torch"

_DRIVE = """
import json, sys
sys.path.insert(0, {repo!r})
from benchmark.tests.conftest import run_tiny, tiny_bench
from pathlib import Path
root = tiny_bench(Path({tmp!r}))
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(tmp_path, body: str):
    code = _DRIVE.format(repo=str(harness.REPO), tmp=str(tmp_path), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("body", [
    "run_tiny(root, 'tiny-serve')",
    "run_tiny(root, 'tiny-train')",
    "run_tiny(root, 'tiny-fullnode')",
    "run_tiny(root, 'tiny-serve', mode='control')",
    "import benchmark.calibrate, benchmark.run",
], ids=["serve", "train", "fullnode", "control", "entry-modules"])
def test_no_jax_loaded(tmp_path, body):
    loaded = _loaded(tmp_path, body)
    assert not loaded & set(harness.FORBIDDEN)
    if body.startswith("run_tiny"):
        assert PORT in loaded


def test_reference_loads_nothing_of_the_port(tmp_path):
    body = """
import numpy as np, torch
from benchmark.reference import lightgcn, serve
from benchmark import dataset, work, trace
edges = np.array([[0, 1, 0, 2], [2, 2, 3, 0]], np.int32)
serve.serve_topk(torch.ones(2, 4), torch.eye(3, 4), np.array([0, 1]),
                 serve.seen_csr(edges, 2), 2)
lightgcn.build_adjacency(edges, 4, "cpu")
"""
    loaded = _loaded(tmp_path, body)
    assert PORT not in loaded and not loaded & set(harness.FORBIDDEN)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_x", None)
    assert harness.forbidden_modules() == [] or PORT + "_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", None)
    assert "jaxlib" in harness.forbidden_modules()
