"""The yardstick: work counters against hand counts, the kernel maps, the
trace reduction, the agreement of ``BENCHMARK.json`` with the files it
names, and that a cell, a configuration and a metric added as files are found
by name."""

import json

import pytest

from benchmark import harness, work
from benchmark.tests.conftest import run_tiny, tiny_bench
from benchmark.trace import reduce_events

REPO = harness.REPO


def test_masked_score_work_by_hand():
    # Q 2, N 256, d 8, bf16: 2·2·256·8 operations; rows (2 + 256)·8·2 bytes,
    # mask 2·256/8, chunk maxima 2 rows × 2 chunks × 2 bytes
    assert work.masked_score_work(2, 256, 8) == (8192.0, 4128 + 64 + 8)
    assert work.masked_score_work(1, 129, 8)[1] == 130 * 16 + 129 / 8 + 2 * 2


def test_row_sums_bytes_by_hand():
    # 3 entries into 5 rows at d 4, f32, twice: 2·(3·(16+4) + 5·16)
    assert work.row_sums_bytes(3, 5, 4, 2) == 2 * (60 + 80)
    assert work.row_sums_bytes(9, 7, 4) == 180 + 112


def test_remainder_hop_bytes_by_hand():
    assert work.remainder_hop_bytes(10, 4, 6, 6, 4) == 10 * 8 + 4 * 4 + 12 * 16


def test_model_flops_by_hand():
    # 3 hops of 2·10·4 plus 2·3·(1+2)·4, three times
    assert work.train_step_model_flops(10, 3, 2, 4, 3) == 3 * (240 + 72)
    assert work.dispatch_model_flops(2, 5, 8) == 160


def test_peaks_refuse_unknown_card():
    assert work.peaks_for("NVIDIA H100 80GB HBM3").bf16_flops == 989e12
    with pytest.raises(KeyError):
        work.peaks_for("NVIDIA H100 PCIe")
    p = work.Peaks(10.0, 2.0)
    assert work.bound_s(30.0, 4.0, p) == 3.0 and work.bound_s(10.0, 8.0, p) == 4.0


@pytest.mark.parametrize("name,names,want", [
    ("void (anonymous namespace)::sorted_index_add_kernel<float, 8, 2>(float const*)",
     ["sorted_index_add_kernel"], True),
    ("void score_chunkmax_bf16_kernel(CUtensorMap_st)", ["score_chunkmax_bf16_kernel"], True),
    ("void my_sorted_index_add_kernel<float>(float*)", ["sorted_index_add_kernel"], False),
    ("Memcpy DtoD (Device -> Device)", ["ell_spmm_kernel"], False),
])
def test_kernel_name_matching(name, names, want):
    assert work.matches(name, names) is want


def test_kernel_maps_name_a_counter():
    for path in sorted(work.KERNELS_DIR.glob("*.json")):
        m = work.kernel_map(path.stem)
        assert m["kernels"] and all(isinstance(k, str) for k in m["kernels"])
        assert callable(getattr(work, m["counter"]))


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.dispatch", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 10, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 12, "dur": 8, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 40, "dur": 5, "args": {}},
    ]
    t = reduce_events(ev)
    assert t.busy_s == pytest.approx(20e-6)
    assert [op.annotation for op in t.ops] == ["bench.dispatch", None, None]
    assert t.time_of(lambda op: op.name.startswith("k")) == (pytest.approx(18e-6), 2)
    assert t.idle_gaps(5) == [["host outside any span", pytest.approx(20e-6)]]
    assert t.top_ops(1) == [["k1", pytest.approx(10e-6)]]


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_names_files_that_agree():
    bench = _bench()
    for c in bench["configs"]:
        cfg = harness.load_named("configs", c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        wl = harness.load_named("workloads", w["name"])
        assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (harness.ROOT / "traffic" / f"{w['traffic']}.py").is_file()
    readers = harness.metric_readers()
    for m in bench["per_layer"]:
        r = readers[m["name"]]
        assert (r.UNIT, r.SOURCE, r.MOVES, r.LAYER) == (m["unit"], m["source"], m["moves"],
                                                        m["layer"])


def test_every_cell_reports_what_its_metrics_move():
    bench = _bench()
    e2e = {m["name"]: m.get("workloads") for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            assert e2e[m["moves"]] is None or cell in e2e[m["moves"]]


def _with_metric(tmp_path, name: str, body: str, cells):
    """A copy of the benchmark with a per-layer reader added as a file and
    named in a copy of ``BENCHMARK.json`` for ``cells``."""
    root = tiny_bench(tmp_path)
    (root / "metrics" / f"{name}.py").write_text(
        'UNIT = "rows"\nLAYER = "benchmark"\nSOURCE = "program_counter"\n'
        f'MOVES = "serve_qps"\n\n\ndef read(res, peaks):\n    return {body}\n')
    bench = _bench()
    bench["per_layer"].append({"name": name, "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "benchmark",
                               "moves": "serve_qps", "workloads": cells})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_files_added_by_name_are_found(tmp_path):
    """A cell, a configuration and a per-layer metric dropped in as files
    run with no code edited, and the metric is read where BENCHMARK.json
    names it."""
    root = _with_metric(tmp_path, "serve.checked_rows", 'res.info.get("checked_rows")',
                        ["tiny-serve"])
    res = run_tiny(root, "tiny-serve")
    assert res.correct and res.info["checked_rows"] > 0
    got = harness.read_per_layer(res, "tiny-serve", work.Peaks(1.0, 1.0), root)
    # the metric that lists the cell, and setup.port_s, whose end-to-end
    # metric every cell reports; no other cell's metrics
    assert sorted(got) == ["serve.checked_rows", "setup.port_s"]
    assert got["serve.checked_rows"] == {"value": res.info["checked_rows"], "unit": "rows"}


def test_a_listed_metric_with_nothing_to_read_gives_no_result(tmp_path):
    root = _with_metric(tmp_path, "serve.nothing", "None", ["tiny-serve"])
    res = run_tiny(root, "tiny-serve")
    with pytest.raises(harness.BenchError, match="serve.nothing"):
        harness.read_per_layer(res, "tiny-serve", work.Peaks(1.0, 1.0), root)
    (tmp_path / "BENCHMARK.json").unlink()
    with pytest.raises(harness.BenchError, match="BENCHMARK.json"):
        harness.read_per_layer(res, "tiny-serve", work.Peaks(1.0, 1.0), root)


def test_optimizer_span_needs_the_epochs_optimizer():
    from benchmark.traffic import train_epochs

    def no_optimizer(state):
        return state

    with pytest.raises(harness.BenchError, match="optimizer"):
        train_epochs._annotate_optimizer(no_optimizer)
