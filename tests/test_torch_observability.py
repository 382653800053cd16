"""The port's ``utils/observability.py``: the metrics stream in the JAX
package's layout, the spans and counters (off, under ``tracing()`` and under
a profiler, on the profiler's clock) and the profiler hook."""

import json
import time

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
    """``profile_to`` records the host when asked for the CPU, and for a
    CUDA device without CUDA it raises instead of recording the host alone.
    The port keeps no memory-stats reader: ``torch.cuda.max_memory_allocated``
    is what the benchmark reads."""
    assert not hasattr(tobs, "device_memory_stats")
    with tobs.profile_to(str(tmp_path / "prof"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tobs.profile_to(str(tmp_path / "prof2")):
            pass


@pytest.fixture
def ring():
    """An empty ring and counters, emptied again after the test."""
    tobs.clear()
    yield
    tobs.clear()


def _spans():
    with tobs.trace_span("outer"):
        with tobs.trace_span("inner"):
            sum(range(1000))
            tobs.count("event")
        with tobs.trace_span("held", wait=True):
            tobs.count("event", 2)


def test_off_records_nothing_and_enters_no_range(ring, monkeypatch):
    """With no profiler and no ``tracing()``, a span reads no clock and
    enters no range, and a counter counts nothing."""
    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(tobs, "_range", refuse)
    monkeypatch.setattr(tobs.time, "time_ns", refuse)
    assert not torch.autograd._profiler_enabled()
    _spans()
    assert tobs.span_records() == [] and tobs.counts() == {}
    assert tobs.trace_span("a") is tobs.trace_span("b")


@pytest.mark.parametrize("how", ["tracing", "profiler"])
def test_spans_nest_and_carry_wait(ring, how):
    """Under ``tracing()`` and under a CPU profiler session, the spans are
    recorded when they close, nested in time, with ``wait`` where marked;
    each counter event is a record with its increment, and the totals add
    up."""
    from torch.profiler import ProfilerActivity, profile

    ctx = tobs.tracing() if how == "tracing" else profile(activities=[ProfilerActivity.CPU])
    with ctx:
        _spans()
    recs = tobs.span_records()
    assert [r.name for r in recs] == ["event", "inner", "event", "held", "outer"]
    by = {(r.name, r.n): r for r in recs}
    outer, inner, held = by["outer", 0], by["inner", 0], by["held", 0]
    assert [r.wait for r in (outer, inner, held)] == [False, False, True]
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= held.t0_ns <= held.t1_ns <= outer.t1_ns
    one, two = by["event", 1], by["event", 2]
    assert inner.t0_ns <= one.t0_ns == one.t1_ns <= inner.t1_ns
    assert held.t0_ns <= two.t0_ns <= held.t1_ns
    assert tobs.counts() == {"event": 3}
    _spans()        # off again
    assert len(tobs.span_records()) == len(recs) and tobs.counts() == {"event": 3}


def test_spans_follow_a_scheduled_profiler(ring):
    """Under a profiler with a schedule, spans record in its active steps
    only: while it waits and warms up, tracing is off."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=1, repeat=1)) as prof:
        for step in range(4):
            with tobs.trace_span(f"step.{step}"):
                tobs.count("c")
            prof.step()
    assert [r.name for r in tobs.span_records()] == ["c", "step.2"]
    assert tobs.counts() == {"c": 1}


def test_a_span_left_by_an_exception_is_recorded(ring):
    with pytest.raises(KeyError), tobs.tracing():
        with tobs.trace_span("failed"):
            raise KeyError("x")
    (rec,) = tobs.span_records()
    assert rec.name == "failed" and rec.t0_ns <= rec.t1_ns


def test_counters_count_only_while_on(ring):
    tobs.count("c")
    with tobs.tracing():
        tobs.count("c", 4)
        tobs.count("c", 0)
        with tobs.tracing():
            tobs.count("c")
        tobs.count("c")
    tobs.count("c", 7)
    assert tobs.counts() == {"c": 6}
    assert [r.n for r in tobs.span_records()] == [4, 1, 1]


def test_records_lie_inside_their_trace_events(ring, tmp_path):
    """Each record's [t0, t1] lies inside its own event of the exported
    Chrome trace (the span's profiler range), ``ts`` +
    ``baseTimeNanoseconds`` / 1000 being Unix µs, within 5 µs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with tobs.trace_span(f"s.{i}", wait=i % 2 == 1):
                torch.ones(32, 32) @ torch.ones(32, 32)
            time.sleep(1e-4)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    events = {e["name"]: e for e in doc["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name")).startswith("s.")}
    recs = tobs.span_records()
    assert sorted(r.name for r in recs) == sorted(events)
    for r in recs:
        e = events[r.name]
        start, end = e["ts"] + base_us, e["ts"] + e["dur"] + base_us
        assert start - 5 <= r.t0_ns / 1e3 <= r.t1_ns / 1e3 <= end + 5, (r, e)


#: the kernels' plain versions, which only the CPU runs: they read their
#: row counts on the host, where that waits for nothing
_PLAIN_ONLY = {"sorted_index_add_plain", "lse_plain", "grads_plain"}


def test_xsimgcl_spans_open_inside_the_step_and_add_no_host_sync(ring, monkeypatch):
    """An XSimGCL full-graph epoch on the CPU under ``tracing()``: each step
    holds two ``xsimgcl.perturb`` spans (one a hop), one
    ``xsimgcl.distinct``, two ``xsimgcl.infonce`` (users, items) and two
    ``xsimgcl.infonce_bwd`` (inside the autograd backward), all inside its
    ``fullgraph.step``. Every conversion of a tensor to a host value outside
    the kernels' plain versions is counted: the epoch's closing ``float`` is
    the only one, as in a LightGCN epoch, so on the card the step adds no
    sync to the epoch's one (``host_sync``, which counts only there)."""
    import traceback

    from movie_recommender_system_with_gnns_tpu_torch.config import (
        Config, ModelConfig, TrainConfig)
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens)
    from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph, train

    data = make_synthetic_movielens(num_users=120, num_items=180, num_interactions=12000,
                                    seed=0)
    nu, ni = data.num_users, data.num_items
    conversions = []
    for name in ("item", "__float__", "__int__", "__bool__", "__index__", "tolist", "numpy"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            caller = traceback.extract_stack(limit=3)[-2]
            if caller.name not in _PLAIN_ONLY:
                conversions.append((_name, caller.name))
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    per_epoch = {}
    for model in ("lightgcn", "xsimgcl"):
        cfg = Config(model=ModelConfig(num_layers=2, dim=16, model=model, readout="standard"),
                     train=TrainConfig(trainer="fullgraph", fullgraph_steps=4, num_clusters=4,
                                       hybrid_block_dtype="float32", loss="standard",
                                       cl_dtype="float32"))
        fg = fullgraph.build_fullgraph_data(cfg, data.edge_index, nu, nu + ni, device="cpu")
        fn = fullgraph.make_fullgraph_epoch_fn(cfg, fg)
        state = train.create_train_state(cfg, nu, ni, device="cpu")
        conversions.clear()
        tobs.clear()
        with tobs.tracing():
            fn(state, fg, torch.Generator().manual_seed(0))
        per_epoch[model] = list(conversions)
    monkeypatch.undo()
    assert per_epoch["xsimgcl"] == per_epoch["lightgcn"] == [("__float__", "epoch_fn")]
    recs = tobs.span_records()
    steps = [r for r in recs if r.name == "fullgraph.step"]
    assert len(steps) == fg.num_steps == 4
    want = {"xsimgcl.perturb": 2, "xsimgcl.distinct": 1, "xsimgcl.infonce": 2,
            "xsimgcl.infonce_bwd": 2}
    for step in steps:
        inside = [r.name for r in recs if r.name.startswith("xsimgcl.")
                  and step.t0_ns <= r.t0_ns <= r.t1_ns <= step.t1_ns]
        assert {k: inside.count(k) for k in want} == want
    assert sum(r.name.startswith("xsimgcl.") for r in recs) == 7 * len(steps)
    assert tobs.counts().get("host_sync", 0) == 0     # counted on the card only
