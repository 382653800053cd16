#!/usr/bin/env python3
"""Where the fused score-and-chunk-max kernel's time goes, on one NVIDIA GPU.

    python3 tools/probe_score_chunkmax.py [--root DIR]

At the serving shape (32,768 queries x 59,392 padded columns, d = 64, bf16)
it times, with CUDA events over 20 launches each, in two alternating rounds:
the wrapper ``cuda_mips.score_chunkmax`` with the packed mask (n_tile 2048),
the int8 mask and unmasked; the kernel and variants built from its source
with one kind of work disabled or done another way each (:data:`VARIANTS`),
packed and unmasked; a plain ``fill_`` of a score matrix of the same size
(the pure write); and ``torch.matmul`` of the same operands. Prints the
card's ``nvidia-smi`` line and one JSON object per round.

``--root`` times the wrapper of the package in another checkout instead, for
example an earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Its source is not patched, so no variant is built there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: variant -> [(exact source line, replacement), ...]. Most variants guard
#: one kind of work with a condition that is never true (or end a function
#: early), so the compiler keeps the rest; ``mask_l2`` copies the mask from
#: elsewhere, ``runs`` deals the work units in another order.
VARIANTS = {
    "no_store": [
        ("    tma_store(smap, s0, col0, row0, policy);",
         "    if (threadIdx.x > 100000) tma_store(smap, s0, col0, row0, policy);"),
        ("    tma_store(smap, s1, col0 + TILE / 2, row0, policy);",
         "    if (threadIdx.x > 100000) tma_store(smap, s1, col0 + TILE / 2, row0, policy);")],
    "no_wgmma": [(
        "            wgmma_m64n128k16(acc[h], sw128_desc(",
        "            if (threadIdx.x > 100000) wgmma_m64n128k16(acc[h], sw128_desc(")],
    # the excluded lanes are not cleared (the mask bytes are still read)
    "no_unpack": [(
        "        if (MODE != 0 || PAD) v = (v & ~m) | (neg2 & m);",
        "        if ((MODE != 0 || PAD) && threadIdx.x > 100000) v = (v & ~m) | (neg2 & m);")],
    # the per-element epilogue off; the staging tiles are still stored
    "stores_only": [(
        "                                              int g, int tg) {\n#pragma unroll\n",
        "                                              int g, int tg) {\n"
        "  if (threadIdx.x < 100000) return;\n#pragma unroll\n")],
    # the mask bytes are not copied into shared memory
    "no_mask_copy": [(
        "    cp_async16(base + w.off_mask",
        "    if (threadIdx.x > 100000) cp_async16(base + w.off_mask")],
    # packed mask: every unit of a band copies the band's first 256-byte
    # window (L2-resident after its first read) instead of its own
    "mask_l2": [(
        "    const int64_t col = mask_col<MODE>(w, ubb, x) + c * 16;",
        "    const int64_t col = (MODE == 2 ? x * TILE : mask_col<MODE>(w, ubb, x)) + c * 16;")],
    # each block walks a contiguous run of units instead of every
    # gridDim-th unit
    "runs": [(
        "  const int64_t u_begin = blockIdx.x, u_end = w.units, u_step = gridDim.x;",
        "  const int64_t u_begin = w.units * blockIdx.x / gridDim.x,\n"
        "                u_end = w.units * (blockIdx.x + 1) / gridDim.x, u_step = 1;")],
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
    """{variant: ctypes library}: the unchanged source as ``kernel``, then
    every variant, one ``nvcc`` each, all at once."""
    src = (_build.CSRC / "score_chunkmax.cu").read_text()
    patched = {"kernel": src}
    for name, edits in VARIANTS.items():
        text = src
        for line, repl in edits:
            if line not in text:
                raise SystemExit(f"probe out of date: a line of {name} is not in the source")
            text = text.replace(line, repl)
        patched[name] = text
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in patched.items():
        path = _build.BUILD_DIR / f"probe_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} build failed:\n{err}")
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"probe_{name}.so"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.score_chunkmax.argtypes = [p, p, p, i32, i64, i32, p, p, i64, i64, i32, i64,
                                       i32, i32, p]
        lib.score_chunkmax.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose package is timed (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_mips
    from movie_recommender_system_with_gnns_tpu_torch.ops.bpr import normalize_embedding

    if not Path(cuda_mips.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"probe: the package was not imported from {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    libs = build_variants(_build) if root == ROOT else {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    gen = torch.Generator(device="cuda").manual_seed(0)
    nq, n, np_, d, n_tile = 32768, 59047, 59392, 64, 2048
    q = normalize_embedding(torch.randn(nq, d, device="cuda", generator=gen))
    c = normalize_embedding(torch.randn(n, d, device="cuda", generator=gen))
    q = q.bfloat16().contiguous()
    c = torch.nn.functional.pad(c.bfloat16(), (0, 0, 0, np_ - n)).contiguous()
    mp = torch.randint(0, 256, (nq, np_ // 8), device="cuda", generator=gen,
                       dtype=torch.uint8) & 0x11
    m8 = (torch.randint(0, 256, (nq, np_), device="cuda", generator=gen,
                        dtype=torch.uint8) < 32).to(torch.int8)
    s = torch.empty((nq, np_), dtype=torch.bfloat16, device="cuda")
    cm = torch.empty((nq, np_ // 128), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, packed: bool):
        err = lib.score_chunkmax(q.data_ptr(), c.data_ptr(), mp.data_ptr() if packed else None,
                                 2 if packed else 0, mp.shape[1] if packed else 0, n_tile,
                                 s.data_ptr(), cm.data_ptr(), nq, np_, d, n, 1, sms, stream)
        if err:
            raise SystemExit(f"launch failed: cudaError {err}")

    wrapper = {"packed": dict(mask_packed=mp), "int8": dict(mask=m8), "unmasked": {}}
    print(json.dumps({"package": str(Path(cuda_mips.__file__).parent.parent),
                      "variants": list(libs)}), flush=True)
    for rnd in range(2):
        row = {"round": rnd}
        for mode, kw in wrapper.items():
            row[f"wrapper_{mode}_ms"] = time_ms(
                lambda: cuda_mips.score_chunkmax(q, c, n, n_tile=n_tile, **kw))
        for name, lib in libs.items():
            for packed in (True, False):
                key = f"{name}_{'packed' if packed else 'unmasked'}_ms"
                row[key] = time_ms(lambda: launch(lib, packed))
        row["fill_ms"] = time_ms(lambda: s.fill_(1.0))
        row["matmul_ms"] = time_ms(lambda: torch.matmul(q, c.T))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
