"""The benchmark's harness, shared by every cell.

A run is one process: the cell's workload file names a configuration and a
traffic kind; the traffic module (``benchmark/traffic/<kind>.py``) builds the
inputs from the seed, sets the port up, warms the cell's own shapes, measures
for ``--seconds`` and checks what the timed path produced against the plain
reference (``benchmark/reference/``). This module finds those files by name,
keeps the host-clock spans, reads the per-layer metrics
(``benchmark/metrics/<metric>.py``) from a traced run, and prints the result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: modules whose presence after the window makes a run invalid: the JAX
#: package and JAX itself, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "movie_recommender_system_with_gnns_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, unknown card, bad files)."""


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _process_elapsed_s() -> Optional[float]:
    """Seconds since this process started, from ``/proc`` (both readings on
    the clock since boot); None where ``/proc`` is not there."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_T_IMPORT = time.perf_counter()
_ELAPSED_AT_IMPORT = _process_elapsed_s() or 0.0


def since_process_start() -> float:
    return _ELAPSED_AT_IMPORT + time.perf_counter() - _T_IMPORT


def load_named(kind: str, name: str, root: Path = ROOT) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def load_module(path: Path, prefix: str):
    """A module from a file whose name may hold dots (``serve.host_ms.py``)."""
    mod_name = f"bench_{prefix}_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(root: Path = ROOT) -> Dict[str, Any]:
    """Every per-layer reader under ``metrics/``, by metric name."""
    return {p.name[:-3]: load_module(p, "metric")
            for p in sorted((root / "metrics").glob("*.py"))}


@dataclass
class Span:
    name: str
    start: float
    end: float


class Spans:
    """The benchmark's host-clock spans. Each also enters a
    ``torch.profiler.record_function`` range named ``bench.<name>``, so a
    traced run can tell which span launched each device op."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.items: List[Span] = []

    @contextmanager
    def __call__(self, name: str, sync: bool = False):
        import torch

        if sync:
            self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
            if sync:
                self.sync()
        self.items.append(Span(name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(s.end - s.start for s in self.items if s.name == name)

    def durations(self, name: str) -> List[float]:
        return [s.end - s.start for s in self.items if s.name == name]


@dataclass
class Context:
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    spans: Spans
    root: Path = ROOT
    #: "program" (the port), "control" (the reference in the next lower
    #: precision in the program's place); calibration only
    mode: str = "program"
    #: objects that do not depend on the seed, kept across seeds by the
    #: calibration script (one process, many seeds); empty in a normal run
    cache: Dict[str, Any] = field(default_factory=dict)

    @property
    def params(self) -> dict:
        return self.workload["params"]

    def sync(self) -> None:
        self.spans.sync()

    @staticmethod
    def since_start() -> float:
        return since_process_start()


@dataclass
class Result:
    """What a traffic module hands back."""

    end_to_end: Dict[str, Tuple[float, str]]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]    # name: (value, limit)
    correct: bool
    memory_peak_bytes: int
    info: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None              # benchmark.trace.Trace of the traced stretch
    window_s: float = 0.0          # length of the traced stretch (host clock)


def check_limits(values: Dict[str, float], limits: Dict[str, float]
                 ) -> Tuple[Dict[str, Tuple[float, float]], bool]:
    """Each compared number beside its limit, and whether all are within."""
    checks = {k: (float(values[k]), float(limits[k])) for k in limits}
    ok = all(v <= lim for v, lim in checks.values())
    return checks, ok


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _per_layer_names(cell: str, e2e: Dict[str, Any], root: Path) -> List[str]:
    """The per-layer metrics ``BENCHMARK.json`` (beside the benchmark's
    folder) gives this cell: those that list it, and those without a list
    whose end-to-end metric the cell reports."""
    path = root.parent / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json beside {root}")
    bench = json.loads(path.read_text())
    names = []
    for m in bench.get("per_layer", []):
        cells = m.get("workloads")
        if (cell in cells) if cells is not None else (m["moves"] in e2e):
            names.append(m["name"])
    return names


def read_per_layer(res: Result, cell: str, peaks, root: Path = ROOT) -> Dict[str, dict]:
    """Each per-layer metric that ``BENCHMARK.json`` gives this cell, from
    its reader. A reader that is missing, or finds nothing to read in a cell
    that lists it, makes the run give no result."""
    readers = metric_readers(root)
    out = {}
    for name in _per_layer_names(cell, res.end_to_end, root):
        if name not in readers:
            raise BenchError(f"per-layer metric {name} has no reader under {root / 'metrics'}")
        value = readers[name].read(res, peaks)
        if value is None:
            raise BenchError(f"per-layer metric {name} found nothing to read in {cell}")
        out[name] = {"value": value, "unit": readers[name].UNIT}
    return out


def device_info(res: Result, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(res.memory_peak_bytes)}
    if trace and res.trace is not None:
        info["busy_s"] = res.trace.busy_s
        info["window_s"] = res.window_s
    limit = power_limit_w()
    if limit is not None:
        info["power_limit_w"] = limit
    return info


def power_limit_w() -> Optional[float]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "--id=0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def make_context(cell: str, seed: int, seconds: float, trace: bool, device,
                 root: Path = ROOT, mode: str = "program") -> Context:
    import torch

    workload = load_named("workloads", cell, root)
    config = load_named("configs", workload["config"], root)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    return Context(cell=cell, workload=workload, config=config, seed=seed,
                   seconds=seconds, trace=trace, device=dev, spans=Spans(sync),
                   root=root, mode=mode)


def run_cell(ctx: Context) -> Result:
    traffic = load_module(ctx.root / "traffic" / f"{ctx.workload['traffic']}.py", "traffic")
    return traffic.run(ctx)


def result_line(ctx: Context, res: Result, peaks) -> dict:
    metrics = (read_per_layer(res, ctx.cell, peaks, ctx.root) if ctx.trace
               else {k: {"value": v, "unit": u} for k, (v, u) in res.end_to_end.items()})
    line = {"correct": bool(res.correct), "attempted": int(res.attempted),
            "failed": int(res.failed), "metrics": metrics,
            "device": device_info(res, ctx.trace)}
    if ctx.trace and res.trace is not None:
        line["breakdown"] = {"device_ops": res.trace.top_ops(10),
                             "idle_gaps": res.trace.idle_gaps(10)}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in res.checks.items()}
    return line


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; this benchmark measures the card only",
              file=sys.stderr)
        return 2
    try:
        ctx = make_context(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
        need = int(ctx.workload.get("chips", 1))
        if torch.cuda.device_count() < need:
            print(f"benchmark: the cell needs {need} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        from .work import peaks_for

        peaks = peaks_for(torch.cuda.get_device_name(0))
        res = run_cell(ctx)
        found = forbidden_modules()
        if found:
            print(f"benchmark: modules of JAX or of the JAX package are loaded: {found}",
                  file=sys.stderr)
            return 3
        line = result_line(ctx, res, peaks)
    except (BenchError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(f"correct: {line['correct']}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
