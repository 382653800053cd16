"""The readers of the port's spans and counters (``port_spans.py`` and the
five metrics that use it): their arithmetic on a synthetic trace and
synthetic records, whose base time is unknown to them, the cells that list
them, a port that keeps no records, and a tiny traced run on the CPU."""

import json
import shutil
from collections import namedtuple

import pytest

from benchmark import harness, port_spans, work
from benchmark.tests.conftest import run_tiny, tiny_bench
from benchmark.trace import DeviceOp, Span, Trace

#: the port's record, as ``utils/observability.py::Record`` lays it out
Rec = namedtuple("Rec", "name t0_ns t1_ns wait n", defaults=(False, 0))
#: Unix ns at the trace's zero, which the readers do not know
BASE_NS = 1_790_000_000_123_456_789
PEAKS = work.Peaks(1.0, 1.0)
SERVE = ("serve.ids_ms", "serve.host_syncs", "serve.port_idle_ms")
TRAIN = ("train.host_ms", "train.port_idle_ms")


def _ns(us: float) -> int:
    """Unix ns of a trace time in µs."""
    return BASE_NS + round(us * 1e3)


def _res(info, ops, spans):
    busy = sum(d for _, _, d in ops) * 1e-6
    return harness.Result(end_to_end={}, attempted=0, failed=0, checks={}, correct=True,
                          memory_peak_bytes=0, info=info,
                          trace=Trace([DeviceOp(n, s, d, None) for n, s, d in ops],
                                      [Span(n, s, e) for n, s, e in spans], busy))


def _read(name, res, monkeypatch, records):
    monkeypatch.setattr(port_spans, "port_records", lambda: records)
    return harness.metric_readers()[name].read(res, PEAKS)


def _serving():
    """Two dispatches. The benchmark's spans at 100–400 and 500–800 µs; the
    port's start 3 and 2 µs inside them and end at 350 and 760. Card ops at
    120–200, 260–300, 600–700 and 790–900: idle 200–260, 300–600, 700–790.
    A third, older dispatch lies before the traced stretch."""
    recs = [Rec("serving.ids", _ns(-95), _ns(-90)), Rec("host_sync", _ns(-91), _ns(-91), n=1),
            Rec("serving.batch_recommend", _ns(-100), _ns(-50)),
            Rec("serving.ids", _ns(110), _ns(150)), Rec("host_sync", _ns(130), _ns(130), n=1),
            Rec("host_sync", _ns(149), _ns(149), n=1), Rec("inner.span", _ns(150), _ns(200)),
            Rec("serving.batch_recommend", _ns(103), _ns(350)),
            Rec("serving.ids", _ns(510), _ns(530)), Rec("host_sync", _ns(520), _ns(520), n=1),
            Rec("host_sync", _ns(529), _ns(529), n=1),
            Rec("serving.batch_recommend", _ns(502), _ns(760))]
    ops = [("k", 120, 80), ("k", 260, 40), ("k", 600, 100), ("k", 790, 110)]
    spans = [("bench.dispatch", 100, 400), ("bench.to_host", 400, 420),
             ("bench.dispatch", 500, 800)]
    return recs, _res({"dispatches": 2}, ops, spans)


def test_alignment_with_an_unknown_base():
    recs, res = _serving()
    st = port_spans.stretch(recs, port_spans.DISPATCH, 2)
    assert [o.t0_ns for o in st.outer] == [_ns(103), _ns(502)]
    # the base plus the least lead of a port span over its benchmark span
    assert port_spans.shift_ns(st.outer, res.trace, "bench.dispatch") == BASE_NS + 2000


@pytest.mark.parametrize("name,value", [
    ("serve.ids_ms", (40 + 20) / 2 * 1e-3),
    ("serve.host_syncs", 2.0),
    # idle inside the port's spans, shifted by base + 2 µs: 101–348 and
    # 500–758 against 200–260, 300–600, 700–790
    ("serve.port_idle_ms", ((60 + 48) + (100 + 58)) / 2 * 1e-3),
])
def test_serving_readers(monkeypatch, name, value):
    recs, res = _serving()
    assert _read(name, res, monkeypatch, recs) == pytest.approx(value)


def _training():
    """Two epochs of 4 steps. The benchmark's spans at 0–1000 and
    1000–2000 µs; the port's epoch spans start 5 and 0 µs in and end at 990
    and 1995, each with its closing wait at 600–990 and 1500–1995. Card ops cover
    all but 100–150, 580–620 (idle inside the host part, and 20 µs of the
    wait) and 1200–1300, 1800–1900 (idle in the second's host part, and in
    its wait)."""
    recs = []
    for lo, wait0, hi in ((5, 600, 990), (1000, 1500, 1995)):
        recs += [Rec("train.draws", _ns(lo + 1), _ns(lo + 2)),
                 Rec("host_sync", _ns(hi - 1), _ns(hi - 1), n=1),
                 Rec("train.wait", _ns(wait0), _ns(hi), True),
                 Rec("train.epoch", _ns(lo), _ns(hi))]
    ops = [("k", 0, 100), ("k", 150, 430), ("k", 620, 580), ("k", 1300, 500),
           ("k", 1900, 150)]
    spans = [("bench.epoch", 0, 1000), ("bench.epoch", 1000, 2000)]
    return recs, _res({"epochs": 2, "steps": 8}, ops, spans)


@pytest.mark.parametrize("name,value", [
    # host time less the waits: (600 - 5) + (1500 - 1000) µs over 8 steps
    ("train.host_ms", (595 + 500) / 8 * 1e-3),
    # idle in the host parts only: 100–150 and 580–600; 1200–1300. The
    # wait's 600–620 and 1800–1900 are the card's own gaps
    ("train.port_idle_ms", (50 + 20 + 100) / 2 * 1e-3),
])
def test_training_readers_leave_the_wait_out(monkeypatch, name, value):
    recs, res = _training()
    assert _read(name, res, monkeypatch, recs) == pytest.approx(value)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_none_without_an_outer_span_and_zero_where_nothing_was_measured(monkeypatch, name):
    """None only where the port recorded no outer span; 0.0 where a span or
    counter ran and measured nothing."""
    serve = name.startswith("serve")
    recs, res = _serving() if serve else _training()
    outer = port_spans.DISPATCH[0] if serve else "train.epoch"
    assert _read(name, res, monkeypatch, [r for r in recs if r.name != outer]) is None
    assert _read(name, res, monkeypatch, []) is None
    # only the outer spans, each exactly covered by device ops and by its
    # benchmark span: no inner span, no counter, no idle time, no wait
    bare = [r for r in recs if r.name == outer]
    shift = BASE_NS
    ops = [(o.name, (o.t0_ns - shift) / 1e3, (o.t1_ns - o.t0_ns) / 1e3) for o in bare]
    spans = [("bench.dispatch" if serve else "bench.epoch", *op[1:2], op[1] + op[2])
             for op in ops]
    full = _res(res.info, ops, spans)
    got = _read(name, full, monkeypatch, bare)
    assert got == (pytest.approx(0.0) if name != "train.host_ms" else pytest.approx(
        sum(o.t1_ns - o.t0_ns for o in bare) * 1e-6 / 8))
    assert got is not None


def test_interval_helpers():
    assert port_spans.subtract((0, 10), [(2, 3), (5, 12)]) == [(0, 2), (3, 5)]
    assert port_spans.subtract((0, 10), []) == [(0, 10)]
    assert port_spans.overlap([(0, 5), (6, 9)], [(4, 7), (8, 20)]) == 1 + 1 + 1
    assert port_spans.idle_intervals(Trace([DeviceOp("a", 0, 10, None),
                                            DeviceOp("b", 5, 10, None),
                                            DeviceOp("c", 20, 1, None)], [], 0)) == [(15, 20)]


def test_each_cell_lists_exactly_the_new_metrics():
    """The serve cells list the three serving readers, the training cells
    the two training readers, and no cell lists another's."""
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        names = harness._per_layer_names(w["name"], {}, harness.ROOT)
        want = SERVE if w["traffic"] == "serve_batch" else TRAIN
        assert sorted(set(names) & set(port_spans.METRICS)) == sorted(want), w["name"]
    assert set(harness.metric_readers()) >= set(port_spans.METRICS)


def test_a_port_with_no_records_leaves_the_metrics_out(monkeypatch, capsys):
    """Where the port has no ``span_records`` (one older than them), the
    cells' lists go without the five metrics, with a line on stderr that
    names them, so a traced run's line leaves them out; where it has it,
    nothing is left out."""
    from movie_recommender_system_with_gnns_tpu_torch.utils import observability as obs

    harness.metric_readers()        # the readers load port_spans
    cell = "serve-d64-batch32k"
    kept = harness._per_layer_names(cell, {}, harness.ROOT)
    assert set(SERVE) <= set(kept)
    assert capsys.readouterr().err == ""
    monkeypatch.delattr(obs, "span_records")
    assert port_spans.port_records() is None
    left = harness._per_layer_names(cell, {}, harness.ROOT)
    assert left == [m for m in kept if m not in SERVE] and left
    err = capsys.readouterr().err
    assert "no span_records" in err and all(m in err for m in SERVE)


@pytest.mark.parametrize("cell,names", [("tiny-serve", SERVE), ("tiny-train", TRAIN)])
def test_tiny_traced_run_reads_the_ports_records(tmp_path, cell, names):
    """A tiny cell traced on the CPU: the port's spans are recorded under the
    benchmark's profiler, and the readers find them (no card: no idle time,
    no host sync)."""
    from movie_recommender_system_with_gnns_tpu_torch.utils import observability as obs

    root = tiny_bench(tmp_path)
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    obs.clear()
    try:
        res = run_tiny(root, cell, trace=True, seconds=0.2)
        readers = harness.metric_readers(root)
        got = {n: readers[n].read(res, PEAKS) for n in names}
    finally:
        obs.clear()
    assert res.correct
    if cell == "tiny-serve":
        assert got["serve.ids_ms"] > 0 and got["serve.host_syncs"] == 0.0
        assert got["serve.port_idle_ms"] == 0.0
    else:
        assert got["train.host_ms"] > 0 and got["train.port_idle_ms"] == 0.0
