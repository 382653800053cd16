"""The XSimGCL cell (``train-xsimgcl-d64-fullgraph``, traffic
``train_epochs_cl``) run tiny through the harness on the CPU: a sound run is
correct, and the control and each of ``faults_cl.py``'s faults come out not
correct; the per-layer readers read a traced run; the references load
nothing of the port."""

import json

import pytest

from benchmark.faults_cl import FAULTS_CL
from benchmark.tests.conftest import run_tiny, tiny_bench

CELL = "tiny-xsimgcl"
#: compared numbers' limits at the tiny size, from its runs on the CPU (four
#: sound seeds: loss 5.9e-5 to 3.8e-4, moment up to 1.6e-3, change up to
#: 1.8e-3; the control 1.5e-3 / 2.5e-4 / 2.6e-3; float8 operands' loss
#: 1.75e-3). Its steps hold about 800 distinct users and 1,200 items, so its
#: gaps run far wider than the cell's, whose 113,000 and 55,000 average them
TINY_LIMITS = {"loss_gap": 8e-4, "moment_gap": 3e-3, "change_gap": 3e-3}


@pytest.fixture(scope="module")
def tiny_cl(tmp_path_factory):
    dst = tiny_bench(tmp_path_factory.mktemp("bench_cl"))
    c = json.loads((dst / "configs" / "xsimgcl-d64-ml25m.json").read_text())
    c["name"] = "tiny-xsimgcl-cfg"
    c["graph"].update({"users": 943, "items": 1682, "interactions": 100_000, "communities": 8})
    c["model"]["dim"] = 32
    c["train"]["num_clusters"] = 4
    (dst / "configs" / "tiny-xsimgcl-cfg.json").write_text(json.dumps(c))
    w = json.loads((dst / "workloads" / "train-xsimgcl-d64-fullgraph.json").read_text())
    w.update(name=CELL, config="tiny-xsimgcl-cfg", limits=TINY_LIMITS)
    (dst / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    return dst


@pytest.mark.parametrize("seed", [11, 2 ** 33 + 5])
def test_sound_run_is_correct(tiny_cl, seed):
    res = run_tiny(tiny_cl, CELL, seed=seed)
    assert res.correct, res.checks
    assert res.failed == 0 and res.attempted > 0
    rows = res.info["cl_rows"]
    assert len(rows) == 3 and all(0 < u <= 943 and 0 < i <= 1682 for u, i in rows[0])
    assert len(res.info["window_cl_rows"]) == res.info["steps"]


def test_control_is_not_correct(tiny_cl):
    res = run_tiny(tiny_cl, CELL, seed=21, mode="control")
    assert not res.correct, res.checks


@pytest.mark.parametrize("fault", sorted(FAULTS_CL))
def test_fault_is_not_correct(tiny_cl, fault):
    with FAULTS_CL[fault]():
        res = run_tiny(tiny_cl, CELL, seed=31)
    assert not res.correct, (res.checks, res.failed)


def test_traced_run_reads_the_new_metrics(tiny_cl):
    """A traced run on the CPU: the readers that need no card time read a
    number (the host spans and the sync counter, which counts only on the
    card); the device readers find no kernels there."""
    from benchmark import harness

    res = run_tiny(tiny_cl, CELL, seed=5, trace=True)
    readers = harness.metric_readers(tiny_cl)
    assert readers["train.cl_host_ms"].read(res, None) > 0
    assert readers["train.cl_host_syncs"].read(res, None) == 0
    assert readers["train.infonce_roofline"].read(res, None) is None
    assert readers["setup.port_s"].read(res, None) > 0


def test_parent_without_the_model_fails_at_once(tiny_cl, monkeypatch):
    """A port without ``models/xsimgcl.py`` gives no result, at once."""
    import importlib

    from benchmark import harness

    real = importlib.import_module

    def missing(name, *a, **kw):
        if name.endswith(".models.xsimgcl"):
            raise ModuleNotFoundError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(importlib, "import_module", missing)
    with pytest.raises(harness.BenchError, match="no XSimGCL"):
        run_tiny(tiny_cl, CELL)
