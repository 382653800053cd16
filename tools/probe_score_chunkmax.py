#!/usr/bin/env python3
"""Where the fused score-and-chunk-max kernel's time goes, on one NVIDIA GPU.

    python3 tools/probe_score_chunkmax.py

At the serving shape (32,768 queries x 59,392 padded columns, d = 64, bf16)
it times, with CUDA events over 20 launches each, in two alternating rounds:
the kernel with the packed mask and unmasked; two variants built from the
same source with the global score stores disabled and with the tensor-core
products disabled; a plain ``fill_`` of a score matrix of the same size (the
pure write); and ``torch.matmul`` of the same operands. Prints the card's
``nvidia-smi`` line and one JSON object per round.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: (variant, exact source line, replacement): each variant guards one kind of
#: work with a condition that is never true, so the compiler keeps the rest
VARIANTS = {
    "no_store": ("    __stcs(reinterpret_cast<uint4*>(s + (row0 + r) * np_ + col0 + seg),",
                 "    if (tid > 100000) __stcs(reinterpret_cast<uint4*>("
                 "s + (row0 + r) * np_ + col0 + seg),"),
    "no_mma": ("        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);",
               "        for (int ni = 0; ni < 8; ++ni) if (tid > 100000) "
               "mma_bf16(acc[mi][ni], a[mi], b[ni]);"),
}


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_variants(_build) -> dict:
    src = (_build.CSRC / "score_chunkmax.cu").read_text()
    libs, procs = {}, {}
    for name, (line, repl) in VARIANTS.items():
        if line not in src:
            raise SystemExit(f"probe out of date: {name} line not in score_chunkmax.cu")
        path = _build.BUILD_DIR / f"probe_{name}.cu"
        path.write_text(src.replace(line, repl))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} build failed:\n{err}")
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"probe_{name}.so"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.score_chunkmax.argtypes = [p, p, p, i32, i64, i32, p, p, i64, i64, i32, i64, i32, p]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_mips
    from movie_recommender_system_with_gnns_tpu_torch.ops.bpr import normalize_embedding

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    _build.build("score_chunkmax")
    libs = {"kernel": cuda_mips._library(), **build_variants(_build)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    nq, n, np_, d = 32768, 59047, 59392, 64
    q = normalize_embedding(torch.randn(nq, d, device="cuda", generator=gen))
    c = normalize_embedding(torch.randn(n, d, device="cuda", generator=gen))
    q = q.bfloat16().contiguous()
    c = torch.nn.functional.pad(c.bfloat16(), (0, 0, 0, np_ - n)).contiguous()
    mp = torch.randint(0, 256, (nq, np_ // 8), device="cuda", generator=gen,
                       dtype=torch.uint8) & 0x11
    s = torch.empty((nq, np_), dtype=torch.bfloat16, device="cuda")
    cm = torch.empty((nq, np_ // 128), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, packed: bool):
        err = lib.score_chunkmax(q.data_ptr(), c.data_ptr(), mp.data_ptr() if packed else None,
                                 2 if packed else 0, mp.shape[1] if packed else 0, 2048,
                                 s.data_ptr(), cm.data_ptr(), nq, np_, d, n, 1, stream)
        if err:
            raise SystemExit(f"launch failed: cudaError {err}")

    for rnd in range(2):
        row = {"round": rnd}
        for name in ("kernel", "no_store", "no_mma"):
            for packed in (True, False):
                key = f"{name}_{'packed' if packed else 'unmasked'}_ms"
                row[key] = time_ms(lambda: launch(libs[name], packed))
        row["fill_ms"] = time_ms(lambda: s.fill_(1.0))
        row["matmul_ms"] = time_ms(lambda: torch.matmul(q, c.T))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
