// Fused pass 1 of exact two-phase MIPS top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_mips.py::_score_chunkmax_kernel of the
// JAX package. For one (Qp, d) query matrix and one (Np, d) catalog it writes
//   s[r, j]  = q[r] . c[j], set to NEG_INF where j >= n (pad column) or where
//              the exclusion mask marks (r, j), rounded to the score type;
//   cm[r, t] = max over j in [128 t, 128 t + 128) of the ROUNDED s[r, j]
//              (the chunk-containment argument of pass 2 needs the maxima of
//              the values pass 2 will read), NaN kept as torch.amax keeps it.
// Pass 2 (top chunks, gather, final top-k) stays in PyTorch (ops/cuda_mips.py).
//
// Bound at the serving shape (Q = 32,768, N = 59,047 padded to 59,392, d = 64,
// bf16, packed mask), H100 SXM at 3.35 TB/s and 989 TFLOP/s bf16:
//   work        2 Q N d        = 2.49e11 FLOP -> 0.25 ms
//   score write Q N 2 B        = 3.89 GB      -> 1.16 ms
//   packed mask Q N / 8 B      = 0.24 GB      -> 0.07 ms
// so the kernel is bound by the bytes it must write, at about 1.25 ms with
// the chunk maxima (Q N / 64 B) and the operands.
//
// bf16 lane: a persistent, warp-specialised kernel. One block of three
// warpgroups per SM takes every gridDim-th work unit; a unit is one 128-row
// query band times up to 16 column tiles that share mask bytes (packed mask,
// n_tile 2048: the 16 chunks of one mask tile, 32 KB of mask; see
// unit_tiles). Dealt so, the blocks work at any time on neighbouring units of
// a few bands: their stores and mask reads fall on neighbouring columns of
// the same rows, which the card's memory serves faster than 132 separate
// bands (contiguous runs of units, which would keep a band for ~56 units,
// measured 0.07 ms slower at the serving shape). Within a unit consumer 0
// takes the first half of the tiles and consumer 1 the second, in turns.
//   * producer (one thread of warpgroup 2): TMA loads, 128-byte swizzled, of
//     the band (when the block's next unit lies in another band, at the
//     serving shape every unit: 16 KB per 16 tiles; it stays resident up to
//     d = 256, past that its depth slices stream beside the catalog's) and of
//     every catalog tile's 64-deep slices into a ring of two stages per
//     consumer, each signalled on an mbarrier. TMA's zero fill covers d % 64.
//   * consumers (warpgroups 0 and 1) copy each unit's mask bytes once, by
//     cp.async into one of two buffers, a unit ahead (load_mask), and run
//     wgmma m64n128k16 with both operands in shared memory (two 64-row
//     halves, 128 f32 accumulators a thread); while
//     one runs its epilogue the other's products run. The epilogue packs each
//     column pair into one bf16x2 word, clears excluded lanes with a mask
//     built from one 16-bit load of the mask bytes and a sign-spreading byte
//     permute (the pad test only on the tile that crosses n), takes the
//     NaN-keeping bf16x2 max and writes the word into a swizzled staging half
//     (conflict-free); each 128 x 64 half leaves by one TMA store (L2
//     evict-first) that drains while the work goes on. A row's chunk max is a
//     register reduction and two quad shuffles; a consumer's 8 chunk maxima
//     of a unit leave together, 16 bytes a row.
// Against the one-block-per-tile design it replaces (3.24 ms at the serving
// shape; loads alone 1.30 ms, per-element tests 0.7 ms): L2 reads per tile
// fall from 48 KB (query, catalog, a 16 KB mask tile of which one bit plane
// is used) to about 19 KB (catalog, 2 KB of mask, 1 KB of band); the
// per-element work loses the byte loads, the compares, the shared round trip
// of the chunk max and the staged re-read; the products lose mma.sync's
// fragment loads; the chunk maxima stop costing a scattered 2-byte store each.
// This kernel takes about 1.71 ms with the packed mask and 1.52 ms unmasked,
// where torch.matmul of the same operands takes 1.49 ms and a fill_ of the
// score matrix 1.18 ms. Without its stores it takes 0.75 ms unmasked: the
// store path sets the time. Of the mask's 0.19 ms, copying it from an
// L2-resident window saves 0.15 ms, so the mask's DRAM reads cost it, not its
// instructions. With the int8 mask (1.95 GB of mask bytes, units of two
// tiles) it takes 2.70 ms, where the design it replaces took 3.26 ms (NVIDIA
// H100 80GB HBM3 at 700 W, all times by tools/probe_score_chunkmax.py).
//
// f32 lane (off the serving path): one block per 128 x 128 output tile, exact
// f32 FMA (no TF32: it is held against exact f32), mask tile by cp.async.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int TILE = 128;      // queries x columns of one output tile (= chunk)
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------- bf16 lane

constexpr int KS = 64;                          // depth slice: one 128-byte swizzle atom
constexpr int SLICE_BYTES = TILE * KS * 2;      // 128 rows x 64 bf16 = 16 KB
constexpr int STAGES = 4;                       // catalog ring: two stages per consumer
constexpr int BAND_SLICES = 4;                  // resident band up to d = 256
constexpr int UNIT_TILES = 16;                  // tiles of a work unit, at most
constexpr int WG_THREADS = 128;
constexpr int THREADS_WG = 3 * WG_THREADS;      // consumers 0, 1; producer 2
constexpr int MASK_BYTES = TILE * TILE;         // 128 rows x 128 bytes
constexpr int HALF_BYTES = TILE * (TILE / 2) * 2;  // 128 rows x 64 bf16: one store box
constexpr int MAX_HALVES = 4;                   // staging halves per consumer, at most
constexpr int CM_RUN = 8;                       // chunk maxima a consumer stages per unit
constexpr int CM_BYTES = 2 * TILE * CM_RUN * 2; // their buffers, both consumers
// shared memory from a 1024-byte aligned base (the swizzle atom's period):
// [A: the band's nk slices, or 4 streamed A slices][B: catalog ring]
// [2 unit mask buffers of `windows` 16 KB windows][staging halves, a ring per
// consumer][staged chunk maxima], and the mbarriers at OFF_BAR; Work holds
// the offsets the host chose for the call's d and mask
constexpr int OFF_BAR = 224 * 1024;
constexpr int SMEM_WG = OFF_BAR + 128 + 1024;   // + alignment slack
static_assert(STAGES == BAND_SLICES, "streamed A slices use the band's space");
static_assert(SMEM_WG <= 232448, "more shared memory than a block can have");
// mbarriers, 8 bytes each from OFF_BAR
constexpr int BAR_FULL = 0, BAR_EMPTY = 4, BAR_MFULL = 8, BAR_MEMPTY = 10,
              BAR_BFULL = 12, BAR_BEMPTY = 13;

struct Work {
  __nv_bfloat16* cm;
  const uint8_t* mask;   // (Qp, mask_ld) mask bytes
  int64_t mask_ld;
  int64_t units;         // bands x units_per_band
  int units_per_band;
  int ntiles;            // Np / 128
  int nk;                // depth slices of 64
  int resident;          // the band stays in shared memory (nk <= BAND_SLICES)
  int n_tile;            // packed mask's tile width
  int n;                 // valid columns
  int windows;           // mask windows (MODE 1: tiles) per unit, 1 or 2
  int cm_stage;          // a consumer's 8 chunks of a unit lie side by side:
                         // stage their maxima, store 16 bytes a row
  int off_b, off_mask, off_stg, off_cm;   // shared-memory offsets
  int halves;            // staging halves per consumer, 2..MAX_HALVES
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed. The loop is inside
// the asm, so the compiler sees no divergent path around the products; a wait
// that lasts 2^34 cycles (seconds, where a real one lasts microseconds) traps,
// so a broken pipeline fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .s64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.s64 t1, t1, t0;\n"
      "setp.gt.s64 p, t1, 17179869184;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// waits until at most `pending` of this thread's bulk store groups still
// read shared memory
__device__ __forceinline__ void bulk_wait_read(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
  else if (pending == 2)
    asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group.read 3;\n" ::: "memory");
}

// 2-D TMA box global -> shared, completion counted on `bar` in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 2-D TMA box shared -> global in the current bulk group, with an L2 policy
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %3}], [%1], %4;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products (emits no instruction)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart; `addr` may step by 32 bytes inside the atom for k16 steps
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, f32, in registers) (+)= A (64 x 16) . B (128 x 16)^T, both bf16,
// K-major in 128-byte-swizzled shared memory; accumulate = 0 overwrites D.
// Thread t of the warpgroup holds d[4 j + e] at row 16 (t / 32) + t % 32 / 4
// + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Work unit `ub` of a band (MODE 0 no mask, 1 int8, 2 tile-bit-packed) and
// its tile i. A unit's tiles share the mask bytes the producer loads once:
//   MODE 2: `windows` 128-byte windows of one n_tile-column mask tile. In the
//     packed layout (ops/topk.py::pack_mask_tiles) byte b of a mask tile holds
//     columns b + p n_tile / 8 in bit p, so window jw serves the 8 tiles at
//     128 jw + p n_tile / 8, tile p on bit plane p. Tile i of a unit is window
//     i % windows, plane i / windows: with n_tile 2048 and two windows the 16
//     tiles are the mask tile's 16 chunks in order.
//   MODE 1: `windows` consecutive tiles, each with its own 128 x 128 bytes.
//   MODE 0: 16 consecutive tiles.
// Consumer 0 takes the first ceil(nt / 2) tiles of a unit, consumer 1 the rest.
template <int MODE>
__device__ __forceinline__ int unit_tiles(const Work& w, int ub) {
  if (MODE == 2) return 8 * w.windows;
  const int per = MODE == 1 ? w.windows : UNIT_TILES;
  return min(per, w.ntiles - ub * per);
}

template <int MODE>
__device__ __forceinline__ int tile_col(const Work& w, int ub, int i) {
  if (MODE == 2) {
    const int units_per_mask_tile = (w.n_tile >> 10) / w.windows;
    const int mt = ub / units_per_mask_tile;
    const int jw = (ub - mt * units_per_mask_tile) * w.windows + i % w.windows;
    return mt * w.n_tile + jw * TILE + (i / w.windows) * (w.n_tile >> 3);
  }
  return (ub * (MODE == 1 ? w.windows : UNIT_TILES) + i) * TILE;
}

// first byte column of the unit's mask window x (MODE 1: of its tile x)
template <int MODE>
__device__ __forceinline__ int mask_col(const Work& w, int ub, int x) {
  if (MODE == 1) return (ub * w.windows + x) * TILE;
  const int units_per_mask_tile = (w.n_tile >> 10) / w.windows;
  const int mt = ub / units_per_mask_tile;
  return mt * (w.n_tile >> 3) + ((ub - mt * units_per_mask_tile) * w.windows + x) * TILE;
}

// 0xFFFF in each 16-bit lane whose byte 0 (lane 0) or byte 1 (lane 1) of `y`
// has its sign bit set (prmt with the sign-replicating selector nibbles; the
// __byte_perm intrinsic keeps only the low three bits of each)
__device__ __forceinline__ uint32_t sign_lanes(uint32_t y) {
  uint32_t m;
  asm("prmt.b32 %0, %1, 0, 0x9988;\n" : "=r"(m) : "r"(y));
  return m;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" :: "r"(addr), "h"(v) : "memory");
}

template <int OFF>
__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1+%2];\n" : "=h"(v) : "r"(addr), "n"(OFF) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

// 16 bytes global -> shared by cp.async, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// The consumers' share of loading unit uu's mask bytes (vv: its number among
// the block's units) into mask buffer vv % 2, laid out as a 128-byte-swizzled
// TMA box would be: each of the 256 consumer threads (ct) copies every 256th
// 16-byte chunk by cp.async, then arrives on the buffer's full barrier when its
// copies have landed. The buffer's last user, unit vv - 2, must be done.
template <int MODE>
__device__ __forceinline__ void load_mask(const Work& w, uint32_t base, uint32_t bar,
                                          int64_t uu, uint32_t vv, int ct) {
  const int bd = static_cast<int>(uu / w.units_per_band);
  const int ubb = static_cast<int>(uu - static_cast<int64_t>(bd) * w.units_per_band);
  const uint32_t mb = vv & 1;
  mbar_wait(bar + 8 * (BAR_MEMPTY + mb), ((vv >> 1) & 1) ^ 1);
  for (int e = ct; e < w.windows * TILE * 8; e += 2 * WG_THREADS) {
    const int x = e / (TILE * 8), r = e / 8 % TILE, c = e % 8;
    const int64_t col = mask_col<MODE>(w, ubb, x) + c * 16;
    const bool valid = col < w.mask_ld;   // an int8 unit's missing last tile
    cp_async16(base + w.off_mask + (mb * w.windows + x) * MASK_BYTES + r * TILE +
                     ((c ^ (r & 7)) << 4),
                 valid ? w.mask + (static_cast<int64_t>(bd) * TILE + r) * w.mask_ld + col
                       : w.mask,
                 valid);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar + 8 * (BAR_MFULL + mb)) : "memory");
}

// One consumer's epilogue for columns [64 C, 64 C + 64) of its 128 x 128
// tile: rows h 64 + 16 warp + 8 hr + g, column pairs 8 j + 2 tg, j in
// [8 C, 8 C + 8). `mk` (128-byte mask rows) and `stg` (one 128 x 64 store box)
// are shared addresses of 128-byte-swizzled tiles: 16-byte chunk c of row r
// sits at (c ^ r % 8) 16, and r % 8 == g, so the chunk's address is the row's
// base with g in bits 4-6, XOR c << 4. A pair is one bf16x2 word: excluded
// halves become NEG_INF through a lane mask built from the mask bytes (MODE 2:
// bit plane `7 - mshift` moved to each byte's sign bit; MODE 1: byte != 0),
// whose sign bits prmt spreads over the 16-bit lanes. mx[2 h + hr] carries
// each row's running max.
template <int MODE, bool PAD, int C>
__device__ __forceinline__ void epilogue_half(const float (&acc)[2][64], uint32_t mk,
                                              uint32_t stg, __nv_bfloat162 (&mx)[4],
                                              uint32_t neg2, int lim, int mshift, int warp,
                                              int g, int tg) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = h * 64 + warp * 16 + hr * 8 + g;
      const uint32_t srow = stg + r * TILE + (g << 4) + tg * 4;
      uint32_t bits[8];
      if (MODE != 0) {
        const uint32_t mrow = mk + r * TILE + (g << 4) + tg * 2;
#pragma unroll
        for (int jj = 0; jj < 8; jj += 2) {
          const uint32_t a = mrow ^ (((8 * C + jj) >> 1) << 4);
          bits[jj] = lds16<0>(a);
          bits[jj + 1] = lds16<8>(a);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * C + jj;
        const __nv_bfloat162 pb = __floats2bfloat162_rn(acc[h][4 * j + 2 * hr],
                                                        acc[h][4 * j + 2 * hr + 1]);
        uint32_t v = reinterpret_cast<const uint32_t&>(pb);
        uint32_t m = 0;
        if (MODE == 2) m = sign_lanes(bits[jj] << mshift);
        if (MODE == 1) m = sign_lanes(((bits[jj] & 0x7F7Fu) + 0x7F7Fu) | bits[jj]);
        if (PAD) {
          const int c = 8 * j + 2 * tg;
          m |= (c >= lim ? 0x0000FFFFu : 0u) | (c + 1 >= lim ? 0xFFFF0000u : 0u);
        }
        if (MODE != 0 || PAD) v = (v & ~m) | (neg2 & m);
        mx[2 * h + hr] = __hmax2_nan(mx[2 * h + hr], reinterpret_cast<const __nv_bfloat162&>(v));
        sts32(srow ^ ((j & 7) << 4), v);
      }
    }
}

// A consumer's whole epilogue for one tile: the two halves go through its ring
// of `halves` staging halves, each stored by one TMA box as soon as it is
// written; then each row's chunk max, reduced over its quad, goes to the
// consumer's chunk-max staging at `cm_slot` (when non-zero) or to `cm_dst`.
template <int MODE, bool PAD>
__device__ __forceinline__ void epilogue(const float (&acc)[2][64], uint32_t mk,
                                         uint32_t stg, int halves, uint32_t& seq,
                                         const CUtensorMap* smap, uint64_t policy,
                                         int col0, int row0, __nv_bfloat16* cm_dst,
                                         int64_t ncm, uint32_t cm_slot, int lim,
                                         int mshift, int t, int wg) {
  const int warp = t / 32, g = t % 32 / 4, tg = t % 4;
  const uint32_t neg16 = __bfloat16_as_ushort(__float2bfloat16_rn(NEG_INF));
  const uint32_t neg2 = neg16 | (neg16 << 16);
  __nv_bfloat162 mx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[i] = __floats2bfloat162_rn(-INFINITY, -INFINITY);
  // half 0 goes to staging half seq % halves, whose store of `halves` halves
  // ago must have left shared memory; half 1 to the next one
  const uint32_t s0 = stg + (seq % halves) * HALF_BYTES;
  const uint32_t s1 = stg + ((seq + 1) % halves) * HALF_BYTES;
  if (t == 0) bulk_wait_read(halves - 1);
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  epilogue_half<MODE, PAD, 0>(acc, mk, s0, mx, neg2, lim, mshift, warp, g, tg);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (t == 0) bulk_wait_read(halves - 2);
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (t == 0) {
    tma_store(smap, s0, col0, row0, policy);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  epilogue_half<MODE, PAD, 1>(acc, mk, s1, mx, neg2, lim, mshift, warp, g, tg);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (t == 0) {
    tma_store(smap, s1, col0 + TILE / 2, row0, policy);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  seq += 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat16 m = __hmax_nan(mx[i].x, mx[i].y);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const unsigned short o = static_cast<unsigned short>(__shfl_xor_sync(
          0xffffffffu, static_cast<int>(__bfloat16_as_ushort(m)), off));
      m = __hmax_nan(m, __ushort_as_bfloat16(o));
    }
    const int r = (i >> 1) * 64 + warp * 16 + (i & 1) * 8 + g;
    if (tg == 0) {
      if (cm_slot != 0)
        sts16(cm_slot + r * CM_RUN * 2, __bfloat16_as_ushort(m));
      else
        cm_dst[r * ncm] = m;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS_WG, 1)
score_chunkmax_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap cmap,
                           const __grid_constant__ CUtensorMap smap, const Work w) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar = base + OFF_BAR;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar + 8 * (BAR_FULL + s), 1);
      mbar_init(bar + 8 * (BAR_EMPTY + s), 4);   // the owning consumer's 4 warps
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar + 8 * (BAR_MFULL + b), 2 * WG_THREADS);  // every consumer thread
      mbar_init(bar + 8 * (BAR_MEMPTY + b), 2);  // both consumers, every unit
    }
    mbar_init(bar + 8 * BAR_BFULL, 1);
    mbar_init(bar + 8 * BAR_BEMPTY, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's units: blockIdx.x, + gridDim.x, ... (see the head comment)
  const int64_t u_begin = blockIdx.x, u_end = w.units, u_step = gridDim.x;
  // warp-uniform as far as the compiler can see (the products run in
  // branches on it)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / WG_THREADS), 0);

  // Consumer wg owns catalog stages 2 wg and 2 wg + 1, which its own depth
  // slices fill in turn: it waits on every phase of its stages' barriers, so
  // a parity never stands for a phase it has skipped.
  if (wg == 2) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 2 * WG_THREADS) return;
    int cur_band = -1;
    uint32_t nband = 0, slices0 = 0, slices1 = 0;
    for (int64_t u = u_begin; u < u_end; u += u_step) {
      const int band = static_cast<int>(u / w.units_per_band);
      const int ub = static_cast<int>(u - static_cast<int64_t>(band) * w.units_per_band);
      if (w.resident && band != cur_band) {
        mbar_wait(bar + 8 * BAR_BEMPTY, (nband & 1) ^ 1);
        mbar_expect_tx(bar + 8 * BAR_BFULL, w.nk * SLICE_BYTES);
        for (int k = 0; k < w.nk; ++k)
          tma_load(base + k * SLICE_BYTES, &qmap, k * KS, band * TILE, bar + 8 * BAR_BFULL);
        ++nband;
      }
      cur_band = band;
      const int nt = unit_tiles<MODE>(w, ub), h0 = (nt + 1) / 2;
      // the two consumers' tiles in turns: 0, h0, 1, h0 + 1, ...
      for (int x = 0; x < 2 * h0; ++x) {
        const int o = x & 1, i = o ? h0 + (x >> 1) : (x >> 1);
        if (i >= nt) continue;
        const int col0 = tile_col<MODE>(w, ub, i);
        for (int k = 0; k < w.nk; ++k) {
          const uint32_t n = o ? slices1++ : slices0++;
          const int s = 2 * o + (n & 1);
          mbar_wait(bar + 8 * (BAR_EMPTY + s), ((n >> 1) & 1) ^ 1);
          mbar_expect_tx(bar + 8 * (BAR_FULL + s), w.resident ? SLICE_BYTES : 2 * SLICE_BYTES);
          tma_load(base + w.off_b + s * SLICE_BYTES, &cmap, k * KS, col0,
                   bar + 8 * (BAR_FULL + s));
          if (!w.resident)
            tma_load(base + s * SLICE_BYTES, &qmap, k * KS, band * TILE,
                     bar + 8 * (BAR_FULL + s));
        }
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t = threadIdx.x % WG_THREADS, lane = t % 32;
  const uint32_t stg = base + w.off_stg + wg * w.halves * HALF_BYTES;
  const uint32_t cm_stage = base + w.off_cm + wg * TILE * CM_RUN * 2;
  const int64_t ncm = w.ntiles;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  float acc[2][64];
  int cur_band = -1;
  uint32_t nband = 0, nunit = 0, slices = 0, seq = 0;
  if (MODE != 0 && u_begin < u_end) load_mask<MODE>(w, base, bar, u_begin, 0, threadIdx.x);
  for (int64_t u = u_begin; u < u_end; u += u_step) {
    const int band = static_cast<int>(u / w.units_per_band);
    const int ub = static_cast<int>(u - static_cast<int64_t>(band) * w.units_per_band);
    if (w.resident && band != cur_band) {
      if (cur_band >= 0 && t == 0) mbar_arrive(bar + 8 * BAR_BEMPTY);
      mbar_wait(bar + 8 * BAR_BFULL, nband & 1);
      ++nband;
    }
    cur_band = band;
    const uint32_t mb = nunit & 1;
    if (MODE != 0) mbar_wait(bar + 8 * (BAR_MFULL + mb), (nunit >> 1) & 1);
    const int nt = unit_tiles<MODE>(w, ub), h0 = (nt + 1) / 2;
    const int i0 = wg ? h0 : 0, i1 = wg ? nt : h0;
    const bool stage_cm = w.cm_stage && i1 - i0 == CM_RUN;
    __nv_bfloat16* cm_band = w.cm + static_cast<int64_t>(band) * TILE * ncm;
    // the next unit's mask is requested after this consumer's first tile of
    // this one, when the other consumer is surely done with the unit before
    bool next_mask = MODE == 0 || u + u_step >= u_end;
    for (int i = i0; i < i1; ++i) {
      const int col0 = tile_col<MODE>(w, ub, i);
      for (int k = 0; k < w.nk; ++k) {
        const uint32_t n = slices + k;
        const int s = 2 * wg + (n & 1);
        mbar_wait(bar + 8 * (BAR_FULL + s), (n >> 1) & 1);
        const uint32_t a = base + (w.resident ? k : s) * SLICE_BYTES;
        const uint32_t b = base + w.off_b + s * SLICE_BYTES;
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_m64n128k16(acc[h], sw128_desc(a + h * (SLICE_BYTES / 2) + kk * 32),
                             sw128_desc(b + kk * 32), (k | kk) != 0);
        wgmma_commit();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (k > 0) {
          wgmma_wait<1>();   // slice k - 1 is read: give its stage back
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          if (lane == 0) mbar_arrive(bar + 8 * (BAR_EMPTY + 2 * wg + ((n - 1) & 1)));
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      slices += w.nk;
      if (lane == 0) mbar_arrive(bar + 8 * (BAR_EMPTY + 2 * wg + ((slices - 1) & 1)));
      // the tile's mask window and bit plane (MODE 1: its own mask bytes)
      const int x = MODE == 2 ? i % w.windows : i;
      const uint32_t mk = base + w.off_mask + (mb * w.windows + x) * MASK_BYTES;
      const int mshift = MODE == 2 ? 7 - i / w.windows : 0;
      const uint32_t cm_slot = stage_cm ? cm_stage + (i - i0) * 2 : 0;
      const int lim = w.n - col0;
      if (lim < TILE)
        epilogue<MODE, true>(acc, mk, stg, w.halves, seq, &smap, policy, col0, band * TILE,
                             cm_band + col0 / TILE, ncm, cm_slot, lim, mshift, t, wg);
      else
        epilogue<MODE, false>(acc, mk, stg, w.halves, seq, &smap, policy, col0, band * TILE,
                              cm_band + col0 / TILE, ncm, cm_slot, lim, mshift, t, wg);
      if (!next_mask) {
        load_mask<MODE>(w, base, bar, u + u_step, nunit + 1, threadIdx.x);
        next_mask = true;
      }
    }
    if (!next_mask) load_mask<MODE>(w, base, bar, u + u_step, nunit + 1, threadIdx.x);
    if (stage_cm) {
      // the run's 8 chunk maxima of each row leave as one 16-byte store
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      *reinterpret_cast<uint4*>(cm_band + t * ncm + tile_col<MODE>(w, ub, i0) / TILE) =
          lds128(cm_stage + t * CM_RUN * 2);
    }
    if (MODE != 0 && t == 0) mbar_arrive(bar + 8 * (BAR_MEMPTY + mb));
    ++nunit;
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------------------- f32 lane

constexpr int THREADS = 256;   // 8 warps
constexpr int KS_F32 = 32;              // depth slice, f32 lane
constexpr int LDS_F32 = TILE + 4;       // f32 slices are stored transposed [k][row]

struct MaskArgs {
  const uint8_t* ptr;   // (Qp, ld) bytes, or nullptr
  int mode;             // 0 none, 1 one byte per column, 2 tile-bit-packed
  int64_t ld;           // row pitch in bytes, a multiple of 16
  int n_tile;           // packed layout's tile width, a multiple of 1024
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// max that keeps NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Starts the copy of the block's 128 x 128 exclusion flags into shared memory
// (pitch `pitch` bytes) and returns how to read them: flag = (byte >> *shift)
// & *keep. Packed layout (ops/topk.py::pack_mask_tiles): within each
// n_tile-column tile, byte b holds columns b + i * n_tile / 8 in bit i. With
// n_tile a multiple of 1024, the block's 128 columns (col0 a multiple of 128)
// lie in one tile and one bit plane, on 128 consecutive bytes of each row; the
// int8 layout is 128 consecutive bytes too. Completes at cp_async_wait_all().
__device__ __forceinline__ void stage_mask(const MaskArgs& m, int64_t row0,
                                           int64_t col0, uint8_t* mk, int pitch,
                                           int* shift, int* keep) {
  int64_t byte0 = col0;
  *shift = 0;
  *keep = 0xff;
  if (m.mode == 2) {
    const int nb = m.n_tile >> 3;
    const int64_t t = col0 / m.n_tile;
    const int w0 = (int)(col0 - t * m.n_tile);
    byte0 = t * nb + w0 % nb;
    *shift = w0 / nb;
    *keep = 1;
  }
  const uint8_t* src = m.ptr + row0 * m.ld + byte0;
  for (int v = threadIdx.x; v < TILE * (TILE / 16); v += THREADS) {
    const int r = v / (TILE / 16), seg = (v % (TILE / 16)) * 16;
    cp_async16(smem_addr(mk + r * pitch + seg), src + r * m.ld + seg, true);
  }
}

__device__ __forceinline__ float masked(float v, int rl, int cl, int64_t col0,
                                        int64_t n, bool has_mask, const uint8_t* mk,
                                        int pitch, int shift, int keep) {
  if (col0 + cl >= n) return NEG_INF;
  if (has_mask && ((mk[rl * pitch + cl] >> shift) & keep)) return NEG_INF;
  return v;
}

// f32 lane. Thread (tx, ty) = (tid % 16, tid / 16) owns rows ty + 16 i and
// columns tx + 16 j, i, j < 8. The mask tile reuses the query slice's bytes
// after the depth loop (static shared memory stays under 48 KB).
__global__ void __launch_bounds__(THREADS)
score_chunkmax_f32_kernel(const float* __restrict__ q, const float* __restrict__ c,
                          MaskArgs mask, float* __restrict__ s,
                          float* __restrict__ cm, int64_t np_, int d, int64_t n) {
  __shared__ __align__(16) float qs[KS_F32][LDS_F32];
  __shared__ float cs[KS_F32][LDS_F32];
  static_assert(TILE * TILE <= sizeof(qs), "mask tile must fit");
  uint8_t* mk = reinterpret_cast<uint8_t*>(qs);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KS_F32) {
    for (int v = tid; v < TILE * (KS_F32 / 4); v += THREADS) {
      const int r = v / (KS_F32 / 4), kv = (v % (KS_F32 / 4)) * 4;
      float4 qa = make_float4(0.f, 0.f, 0.f, 0.f), ca = qa;
      if (k0 + kv < d) {
        qa = *reinterpret_cast<const float4*>(q + (row0 + r) * d + k0 + kv);
        ca = *reinterpret_cast<const float4*>(c + (col0 + r) * d + k0 + kv);
      }
      qs[kv][r] = qa.x; qs[kv + 1][r] = qa.y; qs[kv + 2][r] = qa.z; qs[kv + 3][r] = qa.w;
      cs[kv][r] = ca.x; cs[kv + 1][r] = ca.y; cs[kv + 2][r] = ca.z; cs[kv + 3][r] = ca.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KS_F32; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = cs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const bool has_mask = mask.mode != 0;
  int shift = 0, keep = 0;
  if (has_mask) {
    stage_mask(mask, row0, col0, mk, TILE, &shift, &keep);
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rl = ty + 16 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = tx + 16 * j;
      const float v = masked(acc[i][j], rl, cl, col0, n, has_mask, mk, TILE, shift, keep);
      s[(row0 + rl) * np_ + col0 + cl] = v;
      mx = nan_max(mx, v);
    }
    // the 16 threads of one ty are lanes with equal bit 4: xor 1..8 stays inside
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (tx == 0) cm[(row0 + rl) * (np_ / TILE) + blockIdx.x] = mx;
  }
}

constexpr int ERR_NO_ENCODE = 100000;   // no driver entry point for TMA maps
constexpr int ERR_ENCODE = 100001;      // + CUresult of cuTensorMapEncodeTiled

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// row-major (outer, inner) tensor, boxes of (box_outer, box_inner), 128-byte
// swizzle, zero fill outside the tensor
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              uint64_t inner, uint64_t outer, uint64_t pitch_bytes, uint32_t box_inner,
              uint32_t box_outer) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

template <int MODE>
int launch_bf16(const CUtensorMap& qm, const CUtensorMap& cmap, const CUtensorMap& sm,
                const Work& w, int grid, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      score_chunkmax_bf16_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_WG);
  if (err != cudaSuccess) return static_cast<int>(err);
  score_chunkmax_bf16_kernel<MODE><<<grid, THREADS_WG, SMEM_WG, st>>>(qm, cmap, sm, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one pass on `stream` and returns 0, a CUDA error, or a code of
// score_chunkmax_error_string. Shapes are checked by the Python wrapper: qp,
// np_ multiples of 128, d a multiple of 8, pointers 16-byte aligned,
// 0 < n <= np_, mask_ld a multiple of 16, n_tile a multiple of 1024 dividing
// np_ for the packed mask; num_sms is the card's SM count (the bf16 lane's
// persistent grid).
extern "C" int score_chunkmax(const void* q, const void* c, const void* mask,
                              int mask_mode, int64_t mask_ld, int n_tile,
                              void* s, void* cm, int64_t qp, int64_t np_, int d,
                              int64_t n, int is_bf16, int num_sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const dim3 grid((unsigned)(np_ / TILE), (unsigned)(qp / TILE));
    const MaskArgs m{static_cast<const uint8_t*>(mask), mask_mode, mask_ld, n_tile};
    score_chunkmax_f32_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(c), m,
        static_cast<float*>(s), static_cast<float*>(cm), np_, d, n);
    return (int)cudaGetLastError();
  }
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, cmap, sm;
  int err = encode_2d(&qm, bf16, q, d, qp, 2ull * d, KS, TILE);
  if (!err) err = encode_2d(&cmap, bf16, c, d, np_, 2ull * d, KS, TILE);
  if (!err) err = encode_2d(&sm, bf16, s, np_, qp, 2ull * np_, TILE / 2, TILE);
  if (err) return err;
  Work w;
  w.cm = static_cast<__nv_bfloat16*>(cm);
  w.mask = static_cast<const uint8_t*>(mask);
  w.mask_ld = mask_ld;
  w.ntiles = static_cast<int>(np_ / TILE);
  w.nk = (d + KS - 1) / KS;
  w.resident = w.nk <= BAND_SLICES;
  w.n_tile = n_tile;
  w.n = static_cast<int>(n);
  w.off_b = (w.resident ? w.nk : STAGES) * SLICE_BYTES;
  w.off_mask = w.off_b + STAGES * SLICE_BYTES;
  // the largest unit (two mask windows, chunk maxima staged) whose buffers
  // leave two staging halves per consumer
  w.halves = 0;
  for (int win = mask_mode != 0 ? 2 : 1; win >= 1 && w.halves < 2; --win) {
    if (mask_mode == 2 && (n_tile >> 10) % win != 0) continue;
    const int off_stg = w.off_mask + (mask_mode != 0 ? 2 * win * MASK_BYTES : 0);
    // a consumer's 8 chunks of a unit lie side by side, and 16-byte aligned
    const bool contiguous = (mask_mode == 0 || (mask_mode == 2 && win == 2 && n_tile == 2048)) &&
                            w.ntiles % CM_RUN == 0;
    for (int stage = contiguous ? 1 : 0; stage >= 0; --stage) {
      int halves = (OFF_BAR - off_stg - (stage ? CM_BYTES : 0)) / (2 * HALF_BYTES);
      if (halves > MAX_HALVES) halves = MAX_HALVES;
      if (halves >= 2) {
        w.windows = win;
        w.cm_stage = stage;
        w.halves = halves;
        w.off_stg = off_stg;
        w.off_cm = off_stg + 2 * halves * HALF_BYTES;
        break;
      }
    }
  }
  w.units_per_band = mask_mode == 2 ? static_cast<int>(np_ / 1024) / w.windows
                     : mask_mode == 1 ? (w.ntiles + w.windows - 1) / w.windows
                                      : (w.ntiles + UNIT_TILES - 1) / UNIT_TILES;
  w.units = (qp / TILE) * w.units_per_band;
  const int grid = static_cast<int>(w.units < num_sms ? w.units : num_sms);
  if (mask_mode == 2) return launch_bf16<2>(qm, cmap, sm, w, grid, st);
  if (mask_mode == 1) return launch_bf16<1>(qm, cmap, sm, w, grid, st);
  return launch_bf16<0>(qm, cmap, sm, w, grid, st);
}

extern "C" const char* score_chunkmax_error_string(int err) {
  static char buf[96];
  if (err == ERR_NO_ENCODE) return "no driver entry point cuTensorMapEncodeTiled";
  if (err >= ERR_ENCODE) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
