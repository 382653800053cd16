"""Readings for the limits that decide ``correct``: one process runs a cell
on many seeds, keeping the data set and the port's seed-free set-up between
them, and prints the compared numbers of each run as one JSON line.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--mode program|control|fault:<name>] [--seconds S] [--out FILE]

``program`` runs the port as the benchmark does; ``control`` puts the
reference in the next lower precision in its place; ``fault:<name>`` plants
one of ``benchmark/faults.py``'s faults in the port. Needs the card.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(HERE / ".cache" / sub)
sys.path.insert(0, str(HERE.parent))

from benchmark import harness  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402


def readings(cell: str, seeds, mode: str, seconds: float, device: str = "cuda",
             root: Path = harness.ROOT, cache=None):
    """[(seed, {number: value}, correct, failed)] of ``cell`` on each seed."""
    cache = {"keep_program": True} if cache is None else cache
    fault = FAULTS[mode.split(":", 1)[1]] if mode.startswith("fault:") else None
    out = []
    for seed in seeds:
        ctx = harness.make_context(cell, seed, seconds, False, device, root=root,
                                   mode="control" if mode == "control" else "program")
        ctx.cache = cache
        with fault() if fault else contextlib.nullcontext():
            res = harness.run_cell(ctx)
        out.append((seed, {k: v for k, (v, _) in res.checks.items()}, res.correct,
                    res.failed, res.info.get("numbers", {})))
        harness.free_device()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    a = ap.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    t0 = time.time()
    rows = readings(a.workload, seeds, a.mode, a.seconds)
    lines = [json.dumps({"workload": a.workload, "mode": a.mode, "seed": s, "numbers": n,
                         "extra": x, "correct": c, "failed": f})
             for s, n, c, f, x in rows]
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"calibrate: {len(rows)} runs in {time.time() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
