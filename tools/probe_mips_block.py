#!/usr/bin/env python3
"""Where the per-block top-k kernel's time goes, on one NVIDIA GPU.

    python3 tools/probe_mips_block.py [--root DIR] [--design current|ffma]

At the serving shape of ``method="pallas"`` (Q 256 normalized queries, the
59,047-row catalog, d = 64, block 4096, k = 10, an int8 train-seen-like mask
of 0.12 % density, all made from seed 0) and at Q = 1,536 (the chunk
``batch_recommend_users`` takes for a masked f32 batch at this catalog), it
times with CUDA events over 20 launches each, in two alternating rounds:
the wrapper ``cuda_mips.mips_block_topk`` with the mask, without it and at
k = 1; kernels built from variants of the source (:data:`VARIANTS`, the
knobs of the current design and, named ``off_*``, the same kernel with one
kind of work disabled; ``--design ffma`` applies :data:`FFMA_VARIANTS` to
the source of the earlier FFMA design in a checkout given by ``--root``:
its scores written with no top-k), each checked against the package's
result; and ``torch.matmul`` + ``masked_fill_`` + ``torch.topk`` on the same
operands. Then the wrapper's host time per call, piece by piece (the checks,
the output allocations, two apart or one with two views, the device context
and the stream lookup, each way), and the whole call, by the host clock over
200 calls. Prints the card's ``nvidia-smi`` line and one JSON
object per round.

``--root`` times the package of another checkout, for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: variant -> [(exact source line, replacement), ...] on the current source
VARIANTS = {
    # query bands of 16 rows (one m16 tile a warp row)
    "qb16": [("constexpr int kQB = 32;", "constexpr int kQB = 16;")],
    # catalog tiles of 64 columns instead of 128
    "tn64": [("constexpr int kTN = 128;", "constexpr int kTN = 64;")],
    # a unit's tiles never split, or over 4 CTAs of a cluster instead of 2
    # where the units alone leave SMs idle
    "split1": [("constexpr int kSplitMax = 2;", "constexpr int kSplitMax = 1;")],
    "split4": [("constexpr int kSplitMax = 2;", "constexpr int kSplitMax = 4;")],
    # buffers that take 8 entries past k + one tile before a compaction
    "slack8": [("constexpr int kSlack = 16;", "constexpr int kSlack = 8;")],
    # 16 warps a CTA instead of 8
    "t512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    # no threshold before the buffer first fills (every column of the first
    # tiles is appended until a compaction)
    "no_early_thr": [("constexpr bool kEarlyThreshold = true;",
                      "constexpr bool kEarlyThreshold = false;")],
    # attribution, with one kind of work off (their results differ): no
    # products, no epilogue before the CTA's last tile, no copies after the
    # prologue's
    "off_products": [("      if (ks < nks) {", "      if (ks < nks && threadIdx.x > 100000) {")],
    "off_epilogue": [("    if (kc == p.nkc - 1) {\n",
                      "    if (kc == p.nkc - 1 && tile == t0 + ntiles - 1) {\n")],
    "off_copies": [("    if (s + kStages - 1 < steps) issue_stage<VEC4>",
                    "    if (s + kStages - 1 < steps && threadIdx.x > 100000) issue_stage<VEC4>")],
}
#: the same for the earlier FFMA design (one CTA per 8 queries x block, FFMA,
#: the whole score tile in shared memory, k serial warp rounds)
FFMA_VARIANTS = {
    # scores and mask as before, the top-k rounds off (one store a warp)
    "no_select": [(
        "  if (warp >= qt || qi >= nq) return;",
        "  if (warp >= qt || qi >= nq || k > 0) {\n"
        "    if (warp < qt && qi < nq && lane == 0)\n"
        "      os[((int64_t)j * nq + qi) * k] = sc[(size_t)warp * block + (j & 31)];\n"
        "    return;\n  }")],
}
NQ, N, D, BLOCK, K = 256, 59_047, 64, 4096, 10
NQ_BATCH = 1536
MASK_DENSITY = 0.0012


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_us(fn, iters=200):
    """Host microseconds per call of ``fn``, the queue drained at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def build_variants(_build, csrc: Path, variants: dict) -> dict:
    """{variant: ctypes library} built from patched copies of ``csrc``'s
    ``mips_block.cu``, one ``nvcc`` each, all at once."""
    src = (csrc / "mips_block.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for line, repl in edits:
            if text.count(line) != 1:
                raise SystemExit(f"probe out of date: a line of {name} is not in the "
                                 f"source exactly once")
            text = text.replace(line, repl)
        path = _build.BUILD_DIR / f"probe_mips_{name}.cu"
        path.write_text(text)
        procs[name] = (path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} build failed:\n{err}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in (out + err).splitlines() if "registers" in ln or "spill" in ln]}),
            flush=True)
        libs[name] = ctypes.CDLL(str(path.with_suffix(".so")))
    return libs


def inputs(nq: int):
    """(q, c, mask) on the card, from seed 0."""
    g = torch.Generator("cuda").manual_seed(0)
    c = torch.nn.functional.normalize(torch.randn(N, D, device="cuda", generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, D, device="cuda", generator=g), dim=1)
    mask = (torch.rand(nq, N, device="cuda", generator=g) < MASK_DENSITY).to(torch.int8)
    return q.contiguous(), c.contiguous(), mask


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose package is timed (default: this one)")
    ap.add_argument("--design", choices=("current", "ffma"), default="current",
                    help="which variant set applies to that checkout's source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_mips_block: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_mips

    if not Path(cuda_mips.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"probe: the package was not imported from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    libs = build_variants(_build, _build.CSRC,
                          VARIANTS if args.design == "current" else FFMA_VARIANTS)
    orig = cuda_mips._block_library()
    head = {"package": str(Path(cuda_mips.__file__).parent.parent), "design": args.design}
    cases = {}
    shapes = {}
    for nq in (NQ, NQ_BATCH):
        q, c, mask = inputs(nq)
        shapes[nq] = (q, c, mask)
        call = (lambda q=q, c=c, m=mask, k=K:
                cuda_mips.mips_block_topk(q, c, k, block=BLOCK, mask=m))
        ref = call()
        cases[f"q{nq}"] = call
        cases[f"q{nq}_no_mask"] = (lambda q=q, c=c: cuda_mips.mips_block_topk(
            q, c, K, block=BLOCK))
        cases[f"q{nq}_k1"] = lambda q=q, c=c, m=mask: cuda_mips.mips_block_topk(
            q, c, 1, block=BLOCK, mask=m)
        mb = mask.bool()
        cases[f"q{nq}_library"] = (lambda q=q, c=c, mb=mb: torch.topk(
            torch.matmul(q, c.T).masked_fill_(mb, -1e30), K))
        for name, lib in libs.items():
            def variant(lib=lib, call=call):
                _build._LIBS["mips_block"] = lib
                try:
                    return call()
                finally:
                    _build._LIBS["mips_block"] = orig
            out = variant()
            torch.cuda.synchronize()
            if name != "no_select" and not name.startswith("off_"):
                head[f"q{nq}_{name}_equal"] = bool(torch.equal(out[0], ref[0])
                                                   and torch.equal(out[1], ref[1]))
            cases[f"q{nq}_{name}"] = variant
        # bound: each input read once, each output written once; 3 TF32
        # products per f32 multiply-add (see chip_smoke.py phase 7d)
        nb = -(-N // BLOCK)
        byts = (N + nq) * D * 4 + nq * N + nb * nq * K * 8
        flops = 2.0 * nq * N * D
        head[f"q{nq}_bound"] = dict(bytes_ms=byts / 3.35e12 * 1e3,
                                    ffma_ms=flops / 67e12 * 1e3,
                                    tf32x3_ms=3 * flops / 495e12 * 1e3)
    print(json.dumps(head), flush=True)
    for rnd in range(2):
        row = {"round": rnd}
        for name, fn in cases.items():
            row[f"{name}_ms"] = time_ms(fn)
        print(json.dumps(row), flush=True)

    # the wrapper's host time, piece by piece
    q, c, mask = shapes[NQ]
    nb = -(-N // BLOCK)
    dev = q.device
    pieces = {
        "checks_and_call": lambda: cuda_mips.mips_block_topk(q, c, K, block=BLOCK, mask=mask),
        "two_empty": lambda: (torch.empty((nb, NQ, K), dtype=torch.float32, device=dev),
                              torch.empty((nb, NQ, K), dtype=torch.int32, device=dev)),
        "one_empty_two_views": lambda: _one_empty(nb, dev),
        "device_ctx_stream": lambda: _ctx_stream(dev),
        "stream_only": lambda: torch.cuda.current_stream(dev).cuda_stream,
        # absent from a checkout before this wrapper
        "raw_stream": lambda: getattr(cuda_mips, "_raw_stream", lambda _: None)(dev),
        "data_ptrs": lambda: (q.data_ptr(), c.data_ptr(), mask.data_ptr()),
        "tensor_checks": lambda: (q.dtype, q.dim(), q.shape, q.is_contiguous(), q.device,
                                  c.dtype, c.dim(), c.shape, c.is_contiguous(), c.device,
                                  mask.dtype, mask.shape, mask.is_contiguous(),
                                  mask.device),
    }
    row = {"host_us": {name: host_us(fn) for name, fn in pieces.items()}}
    print(json.dumps(row), flush=True)
    return 0


def _one_empty(nb, dev):
    out = torch.empty((2, nb, NQ, K), dtype=torch.int32, device=dev)
    return out[0].view(torch.float32), out[1]


def _ctx_stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


if __name__ == "__main__":
    sys.exit(main())
