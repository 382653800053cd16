// Fused in-batch InfoNCE for sm_90a: the log-sum-exp of every row of a tall
// product, forward and backward, with the logits recomputed and never stored.
//
// Replaces no TPU kernel: the JAX package has no XSimGCL. It was added for
// the port's XSimGCL (models/xsimgcl.py), whose loss holds, twice a step,
//
//   InfoNCE(A, B) = mean_i [ -a_i.b_i / tau + log sum_j exp(a_i.b_j / tau) ]
//
// over the step's n distinct rows (about 113,000 users and 55,000 items on
// the ML-25M-sized graph, d 64), a and b the rows normalised to unit length
// and rounded to bf16 by the wrapper (ops/cuda_infonce.py). The (n, n)
// logits of the users alone would take 52 GB in f32, so no pass stores them.
//
// Three kernels:
//
//   * infonce_fwd_kernel (X = A, Y = B): S = X Y^T and, per row, the sum of
//     exp2((S_ij - 1) log2(e) / tau); writes lse[i] = log sum_j exp(S_ij / tau)
//     (natural units) and nothing else. The rows are unit vectors, so every
//     logit S_ij / tau lies within 1/tau (bf16 rounding moves a norm by
//     2^-8 at most): 1/tau serves as each row's maximum, no running maximum
//     is kept, and for tau >= 0.025 no term of the sum leaves f32's range;
//   * infonce_bwd_kernel<D, false> (X = A, Y = B): out_i = sum_j P_ij b_j with
//     P_ij = exp(S_ij / tau - lse_i), S recomputed, P rounded to bf16 (to
//     nearest) as the A operand of the second product;
//   * infonce_bwd_kernel<D, true> (X = B, Y = A): out_j = sum_i P_ij a_i, the
//     bias lse_i now that of the streamed row.
//
// The wrapper finishes dA = (P B - B_diag) / (tau n) and dB = (P^T A -
// A_diag) / (tau n), and the normalisation's backward.
//
// Design: each kernel is persistent (one block per SM, taking the 128-row
// bands of X in a fixed order: band blockIdx.x, + gridDim.x, ...) and
// warp-specialised, 3 warpgroups a block:
//   * producer (one thread of warpgroup 2, 40 registers): TMA loads,
//     128-byte swizzled, of the band's rows of X into one of two band
//     buffers, and of every 128-row tile of Y into a ring of 6 stages, each
//     signalled on an mbarrier; in infonce_bwd_kernel<D, true> each stage
//     also carries the tile's 128 entries of lse, so each column's bias
//     arrives with its tile. TMA zero-fills d 32 rows to 64 columns, so both
//     widths run one pipeline. Every tile of Y is read once for 128 rows.
//   * consumers (warpgroups 0 and 1, 232 registers), 64 rows of the band
//     each: S = X Y^T by wgmma m64n128k16 (bf16 in, f32 accumulation, both
//     operands in shared memory), then per logit ex2.approx(fmaf(s, scale2,
//     -bias)); in the backward P is rounded to bf16 in registers, where the
//     f32 accumulator layout of S already is the A fragment layout, and is
//     the register A operand of O += P Y, wgmma m64n64k16 with Y read
//     MN-major from the same stage. Within a consumer the next tile's S is
//     issued before the current tile's exponentials: in the forward into a
//     second S accumulator; in the backward beside O += P Y, the next
//     tile's exponentials then taken in place in S while O's products run,
//     and packed into P once they are done. Across the two consumers the
//     warp schedulers run one's exponentials beside the other's products.
// Measured on this card against other designs: named barriers that hand the
// turn to issue products from one consumer to the other (FlashAttention-3's
// ping-pong) made every kernel slower (forward about 5 %, backward 2-8 %);
// three consumers of 64 rows (192-row bands, 160 registers) 3 % faster at
// the users' shape and slower at the items' (whose bands fill the SMs'
// last round worse); 4 Y stages 5 % slower than 6 (a backward stage stays
// held until O += P Y has read it), 8 about 2 % slower.
// Each output row is summed by one thread quad (forward) or by one
// accumulator of the wgmma chain (backward), tile after tile in one order:
// a call gives the same bits every time. No atomics.
//
// n is read from device memory (count, int32): the launch is sized to the
// buffers' rows (cap), every row in [n, cap) is written as zero, and the
// step that chose the rows never waits for the device. Columns at or past
// n are masked in the exponentials; in the backward the rows of the last
// tile of Y past n are set to zero in shared memory before its products,
// since 0 times whatever the buffer holds there must stay 0.
//
// Bounds on this card (H100 SXM, 132 SMs, 1.98 GHz at most, about 1.7 GHz
// at its 700 W limit under this load):
//   * tensor cores: 2 n^2 d operations forward and 4 n^2 d backward (6 n^2 d
//     is the model's count, the metric's; the two backward kernels each
//     recompute S, so they do 8 n^2 d): at 989 TFLOP/s 4.96 ms a users
//     step (n 113,000) and 1.17 ms an items step (n 55,000);
//   * MUFU: n^2 ex2 a pass at 16 a clock an SM, 3 passes: 3.1-3.6 ms a users
//     pass and 0.72-0.85 ms an items pass, about 11.5-13.2 ms a step in all.
// So the exponentials, not the products, bound each pass: the forward is
// all MUFU, and each backward kernel holds as much tensor-core work as MUFU
// work. ptxas: 168 registers a thread at launch (the consumers raise theirs
// to 232, the producer lowers its to 40), 0 bytes spilled, in every kernel.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kConsumers = 2;              // consumer warpgroups, 64 rows of a band each
constexpr int kBand = 64 * kConsumers;     // rows of X a band
constexpr int kTile = 128;                 // rows of Y a tile
constexpr int kWidth = 64;                 // bf16 a shared row: one 128-byte swizzle atom
constexpr int kStages = 6;                 // Y ring
constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kThreads = (kConsumers + 1) * kWG;   // consumers first, then the producer
// registers a thread after setmaxnreg: the block holds all of the SM's 64 K
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
static_assert((kConsumers * kConsumerRegs + kProducerRegs) * kWG <= 65536,
              "more registers than an SM has");
constexpr int kRowBytes = 2 * kWidth;
constexpr int kXBytes = kBand * kRowBytes;     // one band buffer
constexpr int kXRows = 64 * kRowBytes;         // a consumer's rows of it
constexpr int kYBytes = kTile * kRowBytes;     // one stage, 16 KB
constexpr int kLBytes = kTile * 4;             // a tile's slice of lse
// shared memory from a 1024-byte aligned base (the swizzle atom's period):
// [2 band buffers][Y ring][lse slices][mbarriers]
constexpr int kOffY = 2 * kXBytes;
constexpr int kOffL = kOffY + kStages * kYBytes;
constexpr int kOffBar = kOffL + kStages * kLBytes;
constexpr int kFull = 0, kEmpty = kStages, kXFull = 2 * kStages, kXEmpty = 2 * kStages + 2;
constexpr int kSmem = kOffBar + 8 * (2 * kStages + 4) + 1024;   // + alignment slack
// named barrier kAlone + c: consumer c's 128 threads alone
constexpr int kAlone = 1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// returns once the phase of parity `parity` has completed; a wait that lasts
// 2^34 cycles (seconds, where a real one lasts microseconds) traps, so a
// broken pipeline fails the launch instead of hanging the card
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

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// 2-D TMA box global -> shared, completion counted on `bar` in bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, int c0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accesses of registers that asynchronous
// products read or write across their issue and wait (emit no instruction)
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void keep(uint32_t (&p)[kTile / 16][4]) {
#pragma unroll
  for (int k = 0; k < kTile / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(p[k][i]) :: "memory");
}

// K-major operand in 128-byte-swizzled shared memory: rows of 128 bytes,
// 8-row groups 1024 bytes apart; `addr` steps by 32 bytes inside the atom
// for each k16
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// MN-major operand 64 columns wide (one swizzle atom) in the same layout:
// 8 k rows an atom, atoms 1024 bytes apart along k. The stride between
// atoms along MN is never used at this width; it is given the same 1024
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, f32, in registers) (+)= A (64 x 16) . B (128 x 16)^T, both bf16,
// K-major in shared memory; accumulate = 0 overwrites D. Thread t of the
// warpgroup holds d[4 j + e] at row 16 (t / 32) + t % 32 / 4 + 8 (e / 2),
// column 8 j + 2 (t % 4) + e % 2.
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

// D (64 x 64, f32) += A (64 x 16, bf16, in registers: each warp's 16 rows
// as mma.m16n8k16's A fragment) . B (16 x 64, bf16), B MN-major (its 64
// columns contiguous) in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// S = X (a consumer's 64 rows) . Y (a tile's 128 rows)^T, one commit group
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t xa, uint32_t ya) {
#pragma unroll
  for (int kk = 0; kk < kWidth / 16; ++kk)
    wgmma_m64n128k16(s, kmajor_desc(xa + kk * 32), kmajor_desc(ya + kk * 32), kk != 0);
  wgmma_commit();
}

// O += P . Y (the tile's 128 rows), one commit group
__device__ __forceinline__ void issue_o(float (&o)[32], const uint32_t (&p)[kTile / 16][4],
                                       uint32_t ya) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_m64n64k16_rs(o, p[kk], mnmajor_desc(ya + kk * 16 * kRowBytes));
  wgmma_commit();
}

__device__ __forceinline__ void init_barriers(uint32_t bar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * (kFull + s), 1);
      mbar_init(bar + 8 * (kEmpty + s), 4 * kConsumers);    // every consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar + 8 * (kXFull + b), 1);
      mbar_init(bar + 8 * (kXEmpty + b), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer: for each of the block's bands below n, its rows of X into
// band buffer (band's number) % 2, then every tile of Y (and, kLse, its
// slice of lse) into the ring. `it` counts tiles across bands, as the
// consumers do.
template <bool kLse>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const CUtensorMap* ymap,
                                        const CUtensorMap* lmap, uint32_t base, uint32_t bar,
                                        int n, int bands, int tiles) {
  uint32_t it = 0, nb = 0;
  for (int band = blockIdx.x; band < bands && band * kBand < n; band += gridDim.x, ++nb) {
    const uint32_t xb = nb & 1;
    mbar_wait(bar + 8 * (kXEmpty + xb), ((nb >> 1) & 1) ^ 1);
    mbar_expect_tx(bar + 8 * (kXFull + xb), kXBytes);
    tma_load_2d(base + xb * kXBytes, xmap, 0, band * kBand, bar + 8 * (kXFull + xb));
    for (int t = 0; t < tiles; ++t, ++it) {
      const uint32_t s = it % kStages;
      mbar_wait(bar + 8 * (kEmpty + s), ((it / kStages) & 1) ^ 1);
      mbar_expect_tx(bar + 8 * (kFull + s), kYBytes + (kLse ? kLBytes : 0));
      tma_load_2d(base + kOffY + s * kYBytes, ymap, 0, t * kTile, bar + 8 * (kFull + s));
      if (kLse) tma_load_1d(base + kOffL + s * kLBytes, lmap, t * kTile, bar + 8 * (kFull + s));
    }
  }
}

// ------------------------------------------------------------------ forward

// this tile's terms exp2((s - 1) scale2) added to each row's sum, columns at
// or past `lim` (the tile's first column past n) left out when kMask
template <bool kMask>
__device__ __forceinline__ void sum_exps(const float (&s)[64], float (&l)[2], float scale2,
                                         int lim, int tg) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], scale2, -scale2));
      l[e >> 1] += !kMask || 8 * j + 2 * tg + (e & 1) < lim ? p : 0.f;
    }
}

// Tile t of a band, whose S is in `cur` (issued a round before). kNext: the
// next tile's S is issued into `nxt` first. Then
// tile t's stage is given back and its exponentials summed; only the last
// tile (!kNext) may have columns past n. `it` is tile t's number across
// bands. The accumulators are fenced only before an issue and after a wait:
// no instruction touches them while their products run.
template <bool kNext>
__device__ __forceinline__ void fwd_round(float (&cur)[64], float (&nxt)[64], float (&l)[2],
                                          int t, uint32_t it, uint32_t base, uint32_t bar,
                                          uint32_t xa, int n, float scale2, int lane, int tg) {
  if (kNext) {
    const uint32_t sn = (it + 1) % kStages;
    mbar_wait(bar + 8 * (kFull + sn), ((it + 1) / kStages) & 1);
    keep(nxt);
    wgmma_fence();
    issue_s(nxt, xa, base + kOffY + sn * kYBytes);
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  keep(cur);
  if (lane == 0) mbar_arrive(bar + 8 * (kEmpty + it % kStages));
  const int lim = n - t * kTile;
  if (!kNext && lim < kTile)
    sum_exps<true>(cur, l, scale2, lim, tg);
  else
    sum_exps<false>(cur, l, scale2, lim, tg);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
infonce_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ymap, const int* __restrict__ count,
                   float* __restrict__ lse, int cap, float scale2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + kOffBar;
  const int n = max(0, min(*count, cap));
  const int bands = (cap + kBand - 1) / kBand, tiles = (n + kTile - 1) / kTile;
  init_barriers(bar);
  // warp-uniform as far as the compiler can see (the products run in
  // branches on it)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / kWG), 0);
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs) : "memory");
    if (threadIdx.x == kConsumers * kWG)
      produce<false>(&xmap, &ymap, nullptr, base, bar, n, bands, tiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs) : "memory");
  const int t = threadIdx.x % kWG, warp = t / 32, lane = t % 32, g = lane / 4, tg = lane % 4;
  uint32_t it = 0, nb = 0;
  float sa[64], sb[64];
  for (int band = blockIdx.x; band < bands; band += gridDim.x) {
    const int rw = band * kBand + 64 * wg;   // this consumer's first row
    if (band * kBand >= n) {                 // past the count: nothing to sum
      if (t < 64 && rw + t < cap) lse[rw + t] = 0.f;
      continue;
    }
    const uint32_t xb = nb & 1;
    mbar_wait(bar + 8 * (kXFull + xb), (nb >> 1) & 1);
    const uint32_t xa = base + xb * kXBytes + wg * kXRows;
    {
      const uint32_t s0 = it % kStages;
      mbar_wait(bar + 8 * (kFull + s0), (it / kStages) & 1);
      keep(sa);
      wgmma_fence();
      issue_s(sa, xa, base + kOffY + s0 * kYBytes);
    }
    float l[2] = {0.f, 0.f};
    // tiles in pairs, S alternating between sa and sb; the last round issues nothing
    int tt = 0;
    for (; tt + 2 < tiles; tt += 2) {
      fwd_round<true>(sa, sb, l, tt, it++, base, bar, xa, n, scale2, lane, tg);
      fwd_round<true>(sb, sa, l, tt + 1, it++, base, bar, xa, n, scale2, lane, tg);
    }
    if (tt + 2 == tiles) {
      fwd_round<true>(sa, sb, l, tt, it++, base, bar, xa, n, scale2, lane, tg);
      fwd_round<false>(sb, sb, l, tt + 1, it++, base, bar, xa, n, scale2, lane, tg);
    } else {
      fwd_round<false>(sa, sa, l, tt, it++, base, bar, xa, n, scale2, lane, tg);
    }
    if (lane == 0) mbar_arrive(bar + 8 * (kXEmpty + xb));   // the band's X is read
    ++nb;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = l[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int r = rw + 16 * warp + g + 8 * h;
      if (tg == 0 && r < cap) lse[r] = r < n ? (scale2 + log2f(v)) * kLn2 : 0.f;
    }
  }
}

// ----------------------------------------------------------------- backward

// rows [valid, kTile) of a stage of Y set to zero, seen by this consumer's
// products (the other consumer writes the same zeros)
__device__ __forceinline__ void zero_rows(uint32_t y, int valid, int wg, int t) {
  for (int i = valid * (kRowBytes / 16) + t; i < kTile * (kRowBytes / 16); i += kWG)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(y + 16 * i), "r"(0), "r"(0), "r"(0), "r"(0) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(kAlone + wg, kWG);
}

// A tile's P in place of its S: s = exp2(s scale2 - bias), the bias each
// row's (rb, kCol false) or each column's, read from the stage's slice of
// lse at `lsl`; columns at or past `lim` are 0 when kMask.
template <bool kCol, bool kMask>
__device__ __forceinline__ void probs(float (&s)[64], const float (&rb)[2], uint32_t lsl,
                                      float scale2, int lim, int tg) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int c = 8 * j + 2 * tg;
    float cb[2] = {0.f, 0.f};
    if (kCol) {
      const float2 w = lds64(lsl + 4 * c);
      cb[0] = w.x * kLog2e;
      cb[1] = w.y * kLog2e;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float b = kCol ? cb[e & 1] : rb[e >> 1];
      const float q = ex2(fmaf(s[4 * j + e], scale2, -b));
      s[4 * j + e] = !kMask || c + (e & 1) < lim ? q : 0.f;
    }
  }
}

template <bool kCol>
__device__ __forceinline__ void probs_of(float (&s)[64], const float (&rb)[2], uint32_t lsl,
                                         float scale2, int lim, int tg) {
  if (lim < kTile)
    probs<kCol, true>(s, rb, lsl, scale2, lim, tg);
  else
    probs<kCol, false>(s, rb, lsl, scale2, lim, tg);
}

// P rounded to bf16 as the A fragments of O += P Y: p[kk] holds columns
// [16 kk, 16 kk + 16), whose values are s[8 kk .. 8 kk + 7]
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[kTile / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// Tile t of a band, whose P is in `p`: the next tile's S is issued (kNext),
// then O += P Y_t; the next tile's exponentials are taken in place in S
// while O's products run, and packed into `p` once they are done; then
// tile t's stage is given back. The registers of the products are fenced
// only before the issue and after the waits.
template <bool kCol, bool kNext>
__device__ __forceinline__ void bwd_round(float (&s)[64], float (&o)[32],
                                          uint32_t (&p)[kTile / 16][4], const float (&rb)[2],
                                          int t, uint32_t it, uint32_t base, uint32_t bar,
                                          uint32_t xa, int n, float scale2, int wg, int ti,
                                          int lane, int tg) {
  const uint32_t sc = it % kStages, sn = (it + 1) % kStages;
  const uint32_t yc = base + kOffY + sc * kYBytes, yn = base + kOffY + sn * kYBytes;
  const int lim = n - (t + 1) * kTile;   // the next tile's columns below n
  if (kNext) {
    mbar_wait(bar + 8 * (kFull + sn), ((it + 1) / kStages) & 1);
    if (lim < kTile) zero_rows(yn, lim, wg, ti);
  }
  if (kNext) keep(s);
  keep(o);
  keep(p);
  wgmma_fence();
  if (kNext) issue_s(s, xa, yn);
  issue_o(o, p, yc);
  if (kNext) {
    wgmma_wait<1>();
    keep(s);
    probs_of<kCol>(s, rb, base + kOffL + sn * kLBytes, scale2, lim, tg);
  }
  wgmma_wait<0>();
  keep(o);
  keep(p);
  if (kNext) pack_p(s, p);
  if (lane == 0) mbar_arrive(bar + 8 * (kEmpty + sc));
}

template <int D, bool kColBias>
__global__ void __launch_bounds__(kThreads, 1)
infonce_bwd_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ymap,
                   const __grid_constant__ CUtensorMap lmap, const float* __restrict__ lse,
                   const int* __restrict__ count, float* __restrict__ out, int cap,
                   float scale2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + kOffBar;
  const int n = max(0, min(*count, cap));
  const int bands = (cap + kBand - 1) / kBand, tiles = (n + kTile - 1) / kTile;
  init_barriers(bar);
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / kWG), 0);
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs) : "memory");
    if (threadIdx.x == kConsumers * kWG)
      produce<kColBias>(&xmap, &ymap, &lmap, base, bar, n, bands, tiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs) : "memory");
  const int t = threadIdx.x % kWG, warp = t / 32, lane = t % 32, g = lane / 4, tg = lane % 4;
  uint32_t it = 0, nb = 0;
  float s[64], o[32];
  uint32_t p[kTile / 16][4];
  for (int band = blockIdx.x; band < bands; band += gridDim.x) {
    const int rw = band * kBand + 64 * wg;   // this consumer's first row
    if (band * kBand >= n) {                 // past the count: zeros
      for (int i = t; i < 64 * D; i += kWG) {
        const int r = rw + i / D;
        if (r < cap) out[(size_t)r * D + i % D] = 0.f;
      }
      continue;
    }
    float rb[2] = {0.f, 0.f};
    if (!kColBias) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + 16 * warp + g + 8 * h;
        rb[h] = r < n ? lse[r] * kLog2e : 0.f;
      }
    }
    const uint32_t xb = nb & 1;
    mbar_wait(bar + 8 * (kXFull + xb), (nb >> 1) & 1);
    const uint32_t xa = base + xb * kXBytes + wg * kXRows;
    {   // tile 0's S, then its P
      const uint32_t s0 = it % kStages, y0 = base + kOffY + s0 * kYBytes;
      mbar_wait(bar + 8 * (kFull + s0), (it / kStages) & 1);
      if (n < kTile) zero_rows(y0, n, wg, t);
      keep(s);
      wgmma_fence();
      issue_s(s, xa, y0);
      wgmma_wait<0>();
      keep(s);
      probs_of<kColBias>(s, rb, base + kOffL + s0 * kLBytes, scale2, n, tg);
      pack_p(s, p);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // the last round issues no S
    for (int tt = 0; tt + 1 < tiles; ++tt)
      bwd_round<kColBias, true>(s, o, p, rb, tt, it++, base, bar, xa, n, scale2, wg, t, lane,
                                tg);
    bwd_round<kColBias, false>(s, o, p, rb, tiles - 1, it++, base, bar, xa, n, scale2, wg, t,
                               lane, tg);
    if (lane == 0) mbar_arrive(bar + 8 * (kXEmpty + xb));   // the band's X is read
    ++nb;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + 16 * warp + g + 8 * h;
      if (r >= cap) continue;
      const bool live = r < n;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)r * D + 8 * j + 2 * tg) =
            live ? make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]) : make_float2(0.f, 0.f);
    }
  }
}

// ---------------------------------------------------------------------- host

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

// a (cap, d) bf16 matrix in boxes of `rows` rows x 64 columns, 128-byte
// swizzle; columns past d and rows past cap read as zeros
int encode_rows(CUtensorMap* map, const void* ptr, int d, int cap, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(cap)};
  const cuuint64_t strides[1] = {2ull * d};
  const cuuint32_t box[2] = {kWidth, static_cast<cuuint32_t>(rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

// lse (cap f32) in boxes of one tile's 128 entries
int encode_lse(CUtensorMap* map, const void* ptr, int cap) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(cap)};
  const cuuint64_t strides[1] = {4ull * cap};   // rank 1: not read
  const cuuint32_t box[1] = {kTile};
  const cuuint32_t elem_strides[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

// one block per SM of the current device, or per band where there are
// fewer; the device's primary context is made current on the calling thread
// (autograd runs the backward on a thread of its own, where the driver call
// that encodes the tensor maps finds none otherwise)
cudaError_t persistent_grid(int cap, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int bands = (cap + kBand - 1) / kBand;
  *grid = bands < sms ? bands : sms;
  return e;
}

template <int D>
int fwd(const void* x, const void* y, const void* count, void* lse, int cap, float scale2,
        cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = persistent_grid(cap, &grid);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(infonce_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap xm, ym;
  int err = encode_rows(&xm, x, D, cap, kBand);
  if (!err) err = encode_rows(&ym, y, D, cap, kTile);
  if (err) return err;
  infonce_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      xm, ym, static_cast<const int*>(count), static_cast<float*>(lse), cap, scale2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kColBias>
int bwd(const void* x, const void* y, const void* lse, const void* count, void* out, int cap,
        float scale2, cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = persistent_grid(cap, &grid);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(infonce_bwd_kernel<D, kColBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap xm, ym, lm;
  int err = encode_rows(&xm, x, D, cap, kBand);
  if (!err) err = encode_rows(&ym, y, D, cap, kTile);
  if (!err) err = encode_lse(&lm, lse, cap);
  if (err) return err;
  infonce_bwd_kernel<D, kColBias><<<grid, kThreads, kSmem, stream>>>(
      xm, ym, lm, static_cast<const float*>(lse), static_cast<const int*>(count),
      static_cast<float*>(out), cap, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse (cap) f32 of x, y (cap, d) bf16 rows, the first *count of them real:
// lse[i] = log sum_{j < count} exp(x_i.y_j * scale2 / log2(e)) for i < count,
// 0 for count <= i < cap. scale2 = log2(e) / tau. d is 32 or 64; x, y and
// lse 16-byte aligned. Returns the first failed call's code (0 on success,
// else a cudaError_t or a code of infonce_error_string); never synchronizes.
extern "C" int infonce_fwd(const void* x, const void* y, const void* count, void* lse,
                           int cap, int d, float scale2, void* stream) {
  if (cap <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 32: return fwd<32>(x, y, count, lse, cap, scale2, s);
    case 64: return fwd<64>(x, y, count, lse, cap, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out (cap, d) f32: out_r = sum_{c < count} bf16(P_rc) y_c for r < count,
// P_rc = exp(x_r.y_c * scale2 / log2(e) - lse[r]) (col_bias 0) or
// - lse[c] (col_bias 1); rows from count to cap are zero.
extern "C" int infonce_bwd(const void* x, const void* y, const void* lse, const void* count,
                           void* out, int cap, int d, float scale2, int col_bias,
                           void* stream) {
  if (cap <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define INFONCE_BWD(D)                                                          \
  case D:                                                                       \
    return col_bias ? bwd<D, true>(x, y, lse, count, out, cap, scale2, s)       \
                    : bwd<D, false>(x, y, lse, count, out, cap, scale2, s);
  switch (d) {
    INFONCE_BWD(32)
    INFONCE_BWD(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef INFONCE_BWD
}

extern "C" const char* infonce_error_string(int code) {
  static char buf[96];
  if (code == ERR_NO_ENCODE) return "no driver entry point cuTensorMapEncodeTiled";
  if (code >= ERR_ENCODE) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d",
             code - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}
