"""The port's ``utils/observability.py``: the metrics stream in the JAX
package's layout, the span timer, memory stats and the profiler hook."""

import json

import pytest
import torch

from movie_recommender_system_with_gnns_tpu.utils import observability as jobs
from movie_recommender_system_with_gnns_tpu_torch.utils import observability as tobs


def test_metrics_logger_records_read_by_jax(tmp_path):
    """One ``{"step", "ts", **metrics}`` JSON object a line, appended: JAX's
    ``MetricsLogger.read`` reads the port's file, and a file both packages
    appended to reads back in order."""
    path = str(tmp_path / "sub" / "metrics.jsonl")
    log = tobs.MetricsLogger(path)
    log.log(0, train_loss=0.5, val_recall=0.25)
    log.log(1, train_loss=torch.tensor(0.25).item(), val_recall=0.5)
    jobs.MetricsLogger(path).log(2, train_loss=0.125)
    rows = jobs.MetricsLogger.read(path)
    assert rows == tobs.MetricsLogger.read(path)
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert [r["train_loss"] for r in rows] == [0.5, 0.25, 0.125]
    assert set(rows[0]) == {"step", "ts", "train_loss", "val_recall"}
    assert all(isinstance(r["ts"], float) for r in rows)
    assert log.history("train_loss") == [0.5, 0.25] and log.history("none") == []
    with open(path) as f:
        assert all(json.loads(line) for line in f)


def test_metrics_logger_without_path_keeps_histories():
    log = tobs.MetricsLogger()
    log.log(0, a=1.0)
    log.log(1, a=2.0, b=3.0)
    assert log.history("a") == [1.0, 2.0] and log.history("b") == [3.0]


def test_trace_span_logs_its_seconds(tmp_path, capsys):
    log = tobs.MetricsLogger(str(tmp_path / "m.jsonl"))
    with tobs.trace_span("load", log, step=3, verbose=True):
        sum(range(1000))
    (row,) = tobs.MetricsLogger.read(str(tmp_path / "m.jsonl"))
    assert row["step"] == 3 and row["span/load_s"] >= 0.0
    assert "[trace] load:" in capsys.readouterr().out


def test_device_memory_stats_and_profile_on_the_host(tmp_path):
    """A CPU device has no memory stats; ``profile_to`` records the host when
    asked for the CPU, and for a CUDA device without CUDA it raises instead of
    recording the host alone."""
    assert tobs.device_memory_stats("cpu") == {}
    with tobs.profile_to(str(tmp_path / "prof"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tobs.profile_to(str(tmp_path / "prof2")):
            pass
