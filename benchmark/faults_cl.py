"""Faults planted in the port's XSimGCL step, to show that ``correct``
catches them in the cell ``train-xsimgcl-d64-fullgraph``: each is a context
manager that swaps one of the port's functions while it is open (as
``faults.py``'s do).

  * ``cl_dropped``: the contrastive term left out (λ = 0);
  * ``noise_dropped``: the hops' noise left out (ε = 0);
  * ``infonce_fp8``: the InfoNCE products computed from float8 e4m3
    operands (each unit row rounded to e4m3; bfloat16 holds every e4m3 value,
    so the card's bfloat16 kernel then multiplies exactly those).

Readings on the card, one process over many seeds (``calibrate.py``'s
``readings``, which keeps the data and the port's seed-free set-up):

    python3 benchmark/faults_cl.py --workload train-xsimgcl-d64-fullgraph \\
        --seeds 7,8,9 --fault infonce_fp8 [--seconds S] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from contextlib import contextmanager
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.faults import _swap  # noqa: E402


def _with_config(change):
    from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph

    real = fullgraph.make_fullgraph_epoch_fn

    def broken(cfg, fg):
        return real(change(cfg), fg)

    return _swap(fullgraph, "make_fullgraph_epoch_fn", broken)


def cl_dropped():
    return _with_config(lambda cfg: cfg.replace(
        train=dataclasses.replace(cfg.train, cl_weight=0.0)))


def noise_dropped():
    return _with_config(lambda cfg: cfg.replace(
        model=dataclasses.replace(cfg.model, cl_eps=0.0)))


@contextmanager
def infonce_fp8():
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_infonce

    def broken(x, dtype):
        return x.to(torch.float8_e4m3fn).to(dtype).contiguous()

    with _swap(cuda_infonce, "round_operands", broken):
        yield


FAULTS_CL = {"cl_dropped": cl_dropped, "noise_dropped": noise_dropped,
             "infonce_fp8": infonce_fp8}


def main() -> int:
    from benchmark import calibrate

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS_CL))
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    a = ap.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    with FAULTS_CL[a.fault]():
        rows = calibrate.readings(a.workload, seeds, "program", a.seconds)
    lines = [json.dumps({"workload": a.workload, "mode": f"fault:{a.fault}", "seed": s,
                         "numbers": n, "extra": x, "correct": c, "failed": f})
             for s, n, c, f, x in rows]
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
