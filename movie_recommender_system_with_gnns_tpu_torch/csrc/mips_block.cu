// Per-block MIPS scoring with the block's top-k taken in the same kernel, for
// sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// movie_recommender_system_with_gnns_tpu/ops/pallas_mips.py::_mips_block_kernel
// (driven by mips_topk_pallas).
//
// What it computes, for catalog block j (columns j*block .. j*block+block-1)
// and every query r:
//   s[r, c] = <q[r, :], cat[c, :]>            in f32
//   s[r, c] = NEG_INF  where c >= n (past the catalog) or mask[r, c] != 0
//   the k largest s[r, :] of the block, best first, the lowest column winning
//   ties, into os[j, r, :] / oi[j, r, :] (global column ids); a rank whose
//   score is NEG_INF names the block's first column, j*block, exactly as the
//   TPU kernel's k rounds of max-and-retire leave it.
// The (nb, Q, k) candidates are merged by ops/topk.py::merge_topk.
//
// Bound on this card. At the serving shape (Q 256, N 59,047, d 64, k 10, an
// int8 mask) the call reads 30.6 MB once (0.009 ms at 3.35 TB/s) and does
// 1.93 GFLOP of f32 products, 0.029 ms on the FMA pipes at 67 TFLOP/s. Scores
// that must hold f32 accuracy can still go through the tensor cores as three
// TF32 products, which at the 495 TFLOP/s dense TF32 rate take 0.012 ms: that
// is this design's bound, and it is set by operations.
//
// Design.
//  * Work unit: a band of kQB queries x one catalog block, one CTA of 8 warps.
//    Each catalog tile of kTN columns is read once for the whole band, so the
//    catalog crosses the L2 ceil(Q / kQB) times per call. Where the units
//    alone would leave SMs idle, a cluster of kSplitMax CTAs shares a unit:
//    each walks a run of the block's tiles, and at the end each merges a
//    share of the rows from the cluster's lists, read through distributed
//    shared memory.
//  * Scores on tensor cores, f32-exact: x = hi + lo with hi = tf32(x) and
//    lo = tf32(x - hi) (cvt.rna), and s = lo_q.hi_c + hi_q.lo_c + hi_q.hi_c by
//    mma.sync.m16n8k8 tf32 with f32 accumulation (the hi.hi sum and the sum
//    of the two small products kept apart, then added): about 22 bits of each
//    product, the dropped lo.lo term under 2^-22 of it. The band is split
//    once per unit into hi/lo planes in shared memory; a catalog value is
//    split by the one thread that loads it into its B fragment. There is no
//    single-product path.
//  * Tiles by cp.async, kStages chunks staged: a stage is kTN catalog rows x
//    kKC floats (16-byte copies where d % 4 == 0 and the catalog is 16-byte
//    aligned, else 4-byte ones; columns past the catalog and depth past d are
//    zero-filled, so K is padded to the product's depth of 8), and with the
//    first stage of a tile, the tile's mask bytes. Mask rows are N bytes
//    apart, which is no multiple of 16, so each row's bytes are copied as the
//    16-byte-aligned window that covers them (only a window chunk that would
//    cross either end of the mask is copied byte by byte with plain loads),
//    then packed at the row's offset into one bit per column. d is walked in
//    chunks of kKC; the band's hi/lo planes hold a window of up to kKWMax of
//    depth, reloaded per tile only when d is deeper than that, so d is not
//    bounded by shared memory.
//  * Streaming top-k: every query keeps a threshold, the k-th best score so
//    far (-inf until k candidates are held), and a candidate buffer of cap
//    (value, column) pairs. After a tile, each score that beats its
//    threshold strictly goes into its query's buffer (a quad of lanes
//    reserves its slots with one integer shared-memory atomic; no float
//    atomic anywhere). Columns arrive in ascending order, so the strict test
//    keeps the lowest column on ties; a dead column scores NEG_INF and can
//    enter only while the threshold is -inf. When a buffer could not take
//    another tile, or first holds k candidates, or after the last tile, one
//    warp ranks its entries by (value desc, column asc), keeps the best k in
//    order and raises the threshold to the k-th. Ranks follow a total order,
//    so the result does not depend on the order of the appends or of the
//    cluster's lists: two calls give the same bits. The buffers live in
//    shared memory for k <= kKFast where they fit beside the band, else in a
//    global scratch the wrapper allocates (up to k = block), in the same
//    kernel. No score tile is held: a call writes only the nb * Q * k
//    candidates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kQB = 32;                   // queries per band (CTA)
constexpr int kTN = 128;                  // catalog columns per tile
constexpr int kKC = 32;                   // depth of one staged chunk (floats)
constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsM = kQB / 16;         // warps along the band (one m16 tile each)
constexpr int kWarpsN = kWarps / kWarpsM; // warps along the tile
constexpr int kWN = kTN / kWarpsN;        // tile columns per warp
constexpr int kNT = kWN / 8;              // n8 tiles per warp
constexpr int kCS = kKC + 4;              // catalog stage row stride (floats): no bank conflict
constexpr int kMW = kTN + 32;             // mask window bytes per band row
constexpr int kKWMax = 256;               // deepest band window held in shared memory
constexpr int kStages = 2;                // catalog chunks staged at once (and mask tiles)
constexpr int kSplitMax = 2;              // CTAs of a cluster that share one unit's tiles,
                                          // where units alone would not fill the SMs
constexpr int kSlack = 16;                // buffer room past k + one tile
constexpr int kKFast = 128;               // largest k whose buffers may live in shared memory
constexpr int kR = 4;                     // buffer entries a lane ranks at once
constexpr bool kEarlyThreshold = true;    // compact as soon as a buffer holds k
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;          // bytes a block may opt in to on sm_90

static_assert(kQB % 16 == 0 && kWarps % kWarpsM == 0 && kNT >= 1, "warp layout");
static_assert(kQB % kWarps == 0, "compaction rows per warp");
static_assert(kQB % kSplitMax == 0 && kSplitMax <= 8, "merged rows per CTA; a portable cluster");
static_assert(kWN <= 32 && 32 % kWN == 0, "a warp's columns lie in one mask word");

struct Cand {
  float v;
  int c;
};

struct Params {
  const float* q;
  const float* cat;
  const int8_t* mask;
  float* os;
  int* oi;
  Cand* scratch;       // null: buffers in shared memory
  int nq, n, d, k, block;
  int split;           // CTAs of a cluster that share a unit's tiles (divides kQB)
  int dpad;            // d rounded up to 8
  int nkc;             // chunks of kKC per tile
  int kw;              // band window depth (a multiple of kKC)
  int nwin;            // band windows
  int cap;             // candidate buffer entries per query
  int stride;          // cap + room for the k a ranking selects
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

// The tile's mask bytes, copied as 16-byte-aligned windows, as one bit per
// column: bits[r * (kTN / 32) + w] holds columns 32w .. 32w + 31 of row r.
__device__ __forceinline__ void pack_mask(const Params& p, const unsigned char* md,
                                          uint16_t* bits, int q0, int64_t c0) {
  for (int idx = threadIdx.x; idx < kQB * (kTN / 16); idx += kThreads) {
    const int r = idx / (kTN / 16);
    const int piece = idx - r * (kTN / 16);
    const int qi = q0 + r;
    uint32_t out = 0;
    if (qi < p.nq) {
      const int o = (int)((uintptr_t)(p.mask + (int64_t)qi * p.n + c0) & 15) + 16 * piece;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(md + r * kMW + (o & ~3));
      const int sh = (o & 3) * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t x = __funnelshift_r(w[i], w[i + 1], sh);
        // the top bit of each byte: set where the byte is non-zero
        const uint32_t y = ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u) >> 7;
        out |= ((y | (y >> 7) | (y >> 14) | (y >> 21)) & 0xfu) << (4 * i);
      }
    }
    bits[r * (kTN / 16) + piece] = (uint16_t)out;
  }
}

// Issue the copies of this CTA's stage s (its tile t0 + s / nkc, chunk s % nkc)
// into the stage's buffer.
template <bool VEC4>
__device__ __forceinline__ void issue_stage(const Params& p, int s, int t0, int64_t bcol0,
                                            int q0, float* cs, unsigned char* ms) {
  const int tile = t0 + s / p.nkc;
  const int kc = s - (tile - t0) * p.nkc;
  float* dst = cs + (s % kStages) * kTN * kCS;
  const int lc0 = tile * kTN;               // first column of the tile in the block
  const int64_t c0 = bcol0 + lc0;
  const int k0 = kc * kKC;
  if (VEC4) {
    for (int idx = threadIdx.x; idx < kTN * (kKC / 4); idx += kThreads) {
      const int c = idx / (kKC / 4);
      const int kk = k0 + (idx - c * (kKC / 4)) * 4;
      const bool ok = c0 + c < p.n && lc0 + c < p.block && kk < p.d;
      cp_async16(dst + c * kCS + (kk - k0), ok ? p.cat + (c0 + c) * p.d + kk : p.cat,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTN * kKC; idx += kThreads) {
      const int c = idx / kKC;
      const int kk = k0 + (idx - c * kKC);
      const bool ok = c0 + c < p.n && lc0 + c < p.block && kk < p.d;
      cp_async4(dst + c * kCS + (kk - k0), ok ? p.cat + (c0 + c) * p.d + kk : p.cat,
                ok ? 4 : 0);
    }
  }
  if (p.mask != nullptr && kc == 0) {
    unsigned char* md = ms + (tile % kStages) * kQB * kMW;
    const uintptr_t lo = (uintptr_t)p.mask;
    const uintptr_t hi = lo + (uintptr_t)p.nq * (uintptr_t)p.n;
    for (int idx = threadIdx.x; idx < kQB * (kMW / 16); idx += kThreads) {
      const int r = idx / (kMW / 16);
      const int piece = idx - r * (kMW / 16);
      const int qi = q0 + r;
      if (qi >= p.nq) continue;
      const uintptr_t a =
          (((uintptr_t)(p.mask + (int64_t)qi * p.n + c0)) & ~(uintptr_t)15) + 16 * piece;
      unsigned char* to = md + r * kMW + 16 * piece;
      if (a >= lo && a + 16 <= hi) {
        cp_async16(to, (const void*)a, 16);
      } else {
        for (int b = 0; b < 16; ++b)
          to[b] = (a + b >= lo && a + b < hi) ? *(const unsigned char*)(a + b) : 0;
      }
    }
  }
}

// Order of candidates: value desc, then column asc.
__device__ __forceinline__ bool better(float v, int c, float ov, int oc) {
  return v > ov || (v == ov && c < oc);
}

// One warp compacts a query's buffer of cn entries: the best min(k, cn) in
// order at its front, then count and threshold. Each lane takes kR entries
// a round and counts, over one pass of the buffer, the entries better than
// each: that count is the entry's rank, and a kept entry goes to `sel` at its
// rank, then back to the front. Returns the number kept.
__device__ __forceinline__ int compact(const Params& p, Cand* buf, int cn, int* cnt,
                                       float* thr, int lane) {
  Cand* sel = buf + p.cap;
  const int keep = min(p.k, cn);
  for (int b0 = 0; b0 < cn; b0 += 32 * kR) {
    float mv[kR];
    int mc[kR], rank[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int idx = b0 + i * 32 + lane;
      const Cand e = idx < cn ? buf[idx] : Cand{-CUDART_INF_F, 0x7fffffff};
      mv[i] = e.v;
      mc[i] = e.c;
      rank[i] = 0;
    }
#pragma unroll 4
    for (int x = 0; x < cn; ++x) {
      const Cand o = buf[x];
#pragma unroll
      for (int i = 0; i < kR; ++i) rank[i] += better(o.v, o.c, mv[i], mc[i]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
      if (b0 + i * 32 + lane < cn && rank[i] < keep) sel[rank[i]] = Cand{mv[i], mc[i]};
  }
  __syncwarp();
  for (int t = lane; t < keep; t += 32) buf[t] = sel[t];
  __syncwarp();
  if (lane == 0) {
    *cnt = keep;
    *thr = keep >= p.k ? buf[p.k - 1].v : -CUDART_INF_F;
  }
  __syncwarp();
  return keep;
}

// SMEM_BUF: the candidate buffers live in shared memory (else in p.scratch).
template <bool VEC4, bool SMEM_BUF>
__global__ void __launch_bounds__(kThreads, 1) mips_block_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);                      // kStages x kTN x kCS
  unsigned char* ms = smem + kStages * kTN * kCS * sizeof(float);   // kStages x kQB x kMW
  uint16_t* mbits = reinterpret_cast<uint16_t*>(ms + kStages * kQB * kMW);  // kQB x kTN bits
  const int as = p.kw + 4;                                         // band row stride
  uint32_t* ahi = reinterpret_cast<uint32_t*>(mbits + kQB * (kTN / 16));
  uint32_t* alo = ahi + kQB * as;
  int* cnt = reinterpret_cast<int*>(alo + kQB * as);
  float* thr = reinterpret_cast<float*>(cnt + kQB);
  Cand* cand = SMEM_BUF ? reinterpret_cast<Cand*>(thr + kQB)
                        : p.scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * kQB * p.stride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / kWarpsN, wn = warp - wm * kWarpsN;
  // a cluster of p.split CTAs shares a unit: CTA `part` walks its run of the
  // block's tiles, and merges the rows r with r % p.split == part at the end
  const int part = blockIdx.x % p.split;
  const int q0 = blockIdx.x / p.split * kQB;
  const int j = blockIdx.y;
  const int64_t bcol0 = (int64_t)j * p.block;
  const int tiles_all = (p.block + kTN - 1) / kTN;
  const int per_part = (tiles_all + p.split - 1) / p.split;
  const int t0 = min(part * per_part, tiles_all);
  const int ntiles = min(tiles_all - t0, per_part);
  const int steps = ntiles * p.nkc;

  if (tid < kQB) {
    cnt[tid] = 0;
    thr[tid] = -CUDART_INF_F;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) issue_stage<VEC4>(p, st, t0, bcol0, q0, cs, ms);
    cp_async_commit();
  }

  // hi.hi products, and the two small ones apart: two shorter chains
  float acc[kNT][4], acc2[kNT][4];
  for (int s = 0; s < steps; ++s) {
    const int tile = t0 + s / p.nkc;
    const int kc = s - (tile - t0) * p.nkc;
    if (s + kStages - 1 < steps) issue_stage<VEC4>(p, s + kStages - 1, t0, bcol0, q0, cs, ms);
    cp_async_commit();
    cp_async_wait_stage();
    __syncthreads();

    const int kw0 = (kc * kKC / p.kw) * p.kw;
    if (kc * kKC == kw0 && (p.nwin > 1 || s == 0)) {
      // the band's window [kw0, kw0 + kw), split into hi/lo planes
      for (int idx = tid; idx < kQB * p.kw; idx += kThreads) {
        const int r = idx / p.kw;
        const int kk = idx - r * p.kw;
        const int qi = q0 + r;
        const float x = (qi < p.nq && kw0 + kk < p.d) ? p.q[(int64_t)qi * p.d + kw0 + kk] : 0.0f;
        const uint32_t h = tf32(x);
        ahi[r * as + kk] = h;
        alo[r * as + kk] = tf32(x - __uint_as_float(h));
      }
      __syncthreads();
    }
    if (kc == 0) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = acc2[nt][e] = 0.0f;
      if (p.mask != nullptr) {
        // read in this tile's epilogue, after the barrier that follows it
        pack_mask(p, ms + (tile % kStages) * kQB * kMW, mbits, q0, bcol0 + tile * kTN);
        if (p.nkc == 1) __syncthreads();
      }
    }

    // three TF32 products per k-step, f32 accumulation
    const float* cb = cs + (s % kStages) * kTN * kCS;
    const int nks = min(kKC, p.dpad - kc * kKC) / 8;
    const int r0 = wm * 16 + g;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      if (ks < nks) {
        const int ka = kc * kKC - kw0 + ks * 8 + t4;
        const uint32_t ah[4] = {ahi[r0 * as + ka], ahi[(r0 + 8) * as + ka],
                                ahi[r0 * as + ka + 4], ahi[(r0 + 8) * as + ka + 4]};
        const uint32_t al[4] = {alo[r0 * as + ka], alo[(r0 + 8) * as + ka],
                                alo[r0 * as + ka + 4], alo[(r0 + 8) * as + ka + 4]};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float* bp = cb + (wn * kWN + nt * 8 + g) * kCS + ks * 8 + t4;
          const float b0 = bp[0], b1 = bp[4];
          const uint32_t bh0 = tf32(b0), bh1 = tf32(b1);
          const uint32_t bl0 = tf32(b0 - __uint_as_float(bh0));
          const uint32_t bl1 = tf32(b1 - __uint_as_float(bh1));
          mma_tf32(acc2[nt], al, bh0, bh1);
          mma_tf32(acc2[nt], ah, bl0, bl1);
          mma_tf32(acc[nt], ah, bh0, bh1);
        }
      }
    }

    if (kc == p.nkc - 1) {
      // the tile's scores: dead columns to NEG_INF, those above the
      // threshold into their query's buffer
      const int lc0 = tile * kTN;
      const int64_t live_cols = p.n - (bcol0 + lc0);       // columns of the tile before n
      const int lim = live_cols < kTN ? (int)live_cols : kTN;
      const int blim = p.block - lc0;                       // columns of the tile in the block
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const bool row_ok = q0 + r < p.nq;
        const float th = thr[r];
        const uint32_t mw =
            p.mask != nullptr
                ? reinterpret_cast<const uint32_t*>(mbits)[r * (kTN / 32) + wn * kWN / 32] >>
                      ((wn * kWN) & 31)
                : 0u;
        float v[2 * kNT];
        bool ok[2 * kNT];
        int np = 0;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = nt * 8 + 2 * t4 + e;                  // column in the warp's span
            const int tc = wn * kWN + b;                        // column in the tile
            const bool dead = tc >= lim || ((mw >> b) & 1u);
            const float x = dead ? kNegInf : acc[nt][2 * h + e] + acc2[nt][2 * h + e];
            const bool take = row_ok & (tc < blim) & (x > th);
            v[2 * nt + e] = x;
            ok[2 * nt + e] = take;
            np += take;
          }
        }
        // the quad of lanes that holds row r reserves its slots at once
        int incl = np;
        int y = __shfl_up_sync(0xffffffffu, incl, 1, 4);
        if (t4 >= 1) incl += y;
        y = __shfl_up_sync(0xffffffffu, incl, 2, 4);
        if (t4 >= 2) incl += y;
        const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
        int base = 0;
        if (t4 == 0 && total > 0) base = atomicAdd(&cnt[r], total);
        base = __shfl_sync(0xffffffffu, base, 0, 4) + incl - np;
        Cand* buf = cand + (size_t)r * p.stride;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (ok[2 * nt + e]) {
              buf[base++] = Cand{v[2 * nt + e],
                                 (int)(bcol0 + lc0 + wn * kWN + nt * 8 + 2 * t4 + e)};
            }
          }
        }
      }
      __syncthreads();

      const bool last = tile == t0 + ntiles - 1;
      for (int i = 0; i < kQB / kWarps; ++i) {
        const int r = warp + kWarps * i;
        const int qi = q0 + r;
        if (qi >= p.nq) continue;
        const int cn = cnt[r];
        const bool need = last || cn > p.cap - kTN ||
                          (kEarlyThreshold && cn >= p.k && thr[r] == -CUDART_INF_F);
        if (!need) continue;
        Cand* buf = cand + (size_t)r * p.stride;
        compact(p, buf, cn, &cnt[r], &thr[r], lane);
      }
    }
    __syncthreads();
  }

  // merge: row r's lists of the cluster's CTAs (each at most k, at the front
  // of its buffer) gathered behind this CTA's own, then its best k written
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = warp; i < kQB / p.split; i += kWarps) {
    const int r = part + p.split * i;
    const int qi = q0 + r;
    if (qi >= p.nq) continue;
    Cand* buf = cand + (size_t)r * p.stride;
    int total = cnt[r];
    for (int o = 1; o < p.split; ++o) {
      const int other = (part + o) % p.split;
      const Cand* src =
          SMEM_BUF ? cluster.map_shared_rank(buf, other)
                   : buf + (ptrdiff_t)(other - part) * kQB * p.stride;
      const int m = *cluster.map_shared_rank(&cnt[r], other);
      for (int t = lane; t < m; t += 32) buf[total + t] = src[t];
      total += m;
    }
    __syncwarp();
    const int keep = compact(p, buf, total, &cnt[r], &thr[r], lane);
    float* orow = p.os + ((int64_t)j * p.nq + qi) * p.k;
    int* irow = p.oi + ((int64_t)j * p.nq + qi) * p.k;
    for (int t = lane; t < p.k; t += 32) {
      const Cand e = t < keep ? buf[t] : Cand{kNegInf, (int)bcol0};
      orow[t] = e.v;
      irow[t] = e.v == kNegInf ? (int)bcol0 : e.c;
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

struct Plan {
  Params p;
  dim3 grid;
  size_t smem;
  int64_t scratch_bytes;
};

int make_plan(int nq, int n, int d, int k, int block, int sms, Plan* pl) {
  if (d <= 0 || block <= 0 || k <= 0 || k > block) return (int)cudaErrorInvalidValue;
  if ((int64_t)n + block > 2147483647LL) return (int)cudaErrorInvalidValue;
  Params& p = pl->p;
  p = Params{};
  p.nq = nq;
  p.n = n;
  p.d = d;
  p.k = k;
  p.block = block;
  p.dpad = (d + 7) / 8 * 8;
  p.nkc = (p.dpad + kKC - 1) / kKC;
  const int d32 = p.nkc * kKC;
  p.kw = d32 < kKWMax ? d32 : kKWMax;
  p.nwin = (d32 + p.kw - 1) / p.kw;
  const int nb = (n + block - 1) / block;
  if (nb > 65535) return (int)cudaErrorInvalidValue;
  const int bands = (nq + kQB - 1) / kQB;
  // split the units' tiles over clusters only where the units alone leave
  // SMs without work
  p.split = (int64_t)bands * nb < sms ? kSplitMax : 1;
  // a buffer takes one more tile whenever it holds at most kr + kSlack
  // entries, holds the cluster's split lists of a row for the merge, and
  // keeps room behind it for the k a large buffer's ranking selects
  const int kr = (k + 7) / 8 * 8;
  p.cap = kTN + kr + kSlack > p.split * kr ? kTN + kr + kSlack : p.split * kr;
  p.stride = p.cap + kr;
  pl->grid = dim3(bands * p.split, nb);
  const size_t base = (size_t)kStages * kTN * kCS * sizeof(float) +
                      (size_t)kStages * kQB * kMW + (size_t)kQB * (kTN / 8) +
                      (size_t)2 * kQB * (p.kw + 4) * sizeof(uint32_t) + (size_t)2 * kQB * 4;
  const size_t buffers = (size_t)kQB * p.stride * sizeof(Cand);
  const bool fast = k <= kKFast && base + buffers <= (size_t)kMaxSmem;
  pl->smem = base + (fast ? buffers : 0);
  pl->scratch_bytes = fast ? 0 : (int64_t)bands * p.split * nb * (int64_t)buffers;
  if (pl->smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

}  // namespace

// Bytes of global scratch mips_block needs for these sizes on a card of
// `sms` SMs (0 when the candidate buffers fit in shared memory), or -1 for
// sizes it refuses.
extern "C" int64_t mips_block_scratch_bytes(int nq, int n, int d, int k, int block,
                                            int sms) {
  Plan pl;
  if (make_plan(nq, n, d, k, block, sms, &pl) != (int)cudaSuccess) return -1;
  return pl.scratch_bytes;
}

// q (nq, d) and cat (n, d) contiguous f32, mask (nq, n) one byte or null, os
// and oi (ceil(n / block), nq, k) f32 / int32, 1 <= k <= block, sms the
// card's SM count, scratch at least mips_block_scratch_bytes(...) bytes (null
// when that is 0). Launches on `stream`, never synchronizes, returns the
// cudaError_t (0 on success).
extern "C" int mips_block(const void* q, const void* cat, const void* mask, void* os,
                          void* oi, void* scratch, int nq, int n, int d, int k,
                          int block, int sms, void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  Plan pl;
  int e = make_plan(nq, n, d, k, block, sms, &pl);
  if (e != (int)cudaSuccess) return e;
  if (pl.scratch_bytes > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Params& p = pl.p;
  p.q = (const float*)q;
  p.cat = (const float*)cat;
  p.mask = (const int8_t*)mask;
  p.os = (float*)os;
  p.oi = (int*)oi;
  p.scratch = pl.scratch_bytes > 0 ? (Cand*)scratch : nullptr;
  const bool vec4 = d % 4 == 0 && (uintptr_t)cat % 16 == 0;
  const bool smem_buf = pl.scratch_bytes == 0;
  const int variant = 2 * vec4 + smem_buf;
  void (*const kernels[4])(Params) = {
      mips_block_kernel<false, false>, mips_block_kernel<false, true>,
      mips_block_kernel<true, false>, mips_block_kernel<true, true>};
  auto kern = kernels[variant];
  // the shared-memory opt-in, once per kernel and device
  static bool opted[64][4];
  int dev = 0;
  e = (int)cudaGetDevice(&dev);
  if (e != (int)cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev][variant]) {
    e = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxSmem);
    if (e != (int)cudaSuccess) return e;
    opted[dev][variant] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = pl.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kern, p);
  if (e != (int)cudaSuccess) return e;
  return (int)cudaGetLastError();
}

extern "C" const char* mips_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
