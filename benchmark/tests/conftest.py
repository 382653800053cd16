"""Small cells for the CPU tests: a copy of the benchmark's files in a
temporary directory, with configurations and workloads at ``bench.py``'s
``SCALES["tiny"]`` size added as files, run through the harness on the CPU."""

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]

#: compared numbers' limits at the tiny size: the serve cell's are the d-64
#: cell's own; the training set's are read from this size's sound runs (its
#: gaps run wider than at full size, where 349,184 triplets a step average
#: the rounding out)
TINY_TRAIN_LIMITS = {"moment_gap": 3e-4, "change_gap": 3e-4}


def tiny_bench(root: Path) -> Path:
    """A copy of the benchmark's data files with tiny cells added; returns
    its root."""
    dst = root / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(".cache", "tests", "__pycache__"))
    graph = {"users": 943, "items": 1682, "interactions": 100_000, "communities": 8}
    for name, src, extra in (("tiny-d64", "lightgcn-d64-ml25m", {}),
                             ("tiny-d256", "lightgcn-d256-pop8-ml25m", {"dim": 32})):
        c = json.loads((dst / "configs" / f"{src}.json").read_text())
        c["name"] = name
        c["graph"].update(graph)
        c["model"].update(extra)
        c["train"]["num_clusters"] = 4
        (dst / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, src, config, params, limits in (
            ("tiny-serve", "serve-d64-batch32k", "tiny-d64", {"dispatch_users": 256}, None),
            ("tiny-serve-dot", "serve-d256-batch32k", "tiny-d256", {"dispatch_users": 256},
             None),
            ("tiny-train", "train-d256-fullgraph", "tiny-d256", {}, TINY_TRAIN_LIMITS),
            ("tiny-fullnode", "train-d64-fullnode", "tiny-d64", {}, TINY_TRAIN_LIMITS)):
        w = json.loads((dst / "workloads" / f"{src}.json").read_text())
        w.update(name=name, config=config)
        w["params"].update(params)
        if limits:
            w["limits"] = limits
        (dst / "workloads" / f"{name}.json").write_text(json.dumps(w))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


def run_tiny(root: Path, cell: str, seed: int = 5, mode: str = "program", seconds=0.5,
             trace: bool = False):
    from benchmark import harness

    ctx = harness.make_context(cell, seed, seconds, trace, "cpu", root=root, mode=mode)
    return harness.run_cell(ctx)
