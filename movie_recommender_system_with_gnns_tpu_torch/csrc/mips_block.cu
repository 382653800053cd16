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
//   k rounds: take the largest s[r, :], the lowest column winning ties, write
//   it to os[j, r, t] / oi[j, r, t] (global column id), set it to NEG_INF.
// A row with fewer than k live columns therefore repeats the block's first
// column with NEG_INF in its last rounds, exactly as the TPU kernel's loop
// does; the (nb, Q, k) candidates are merged by ops/topk.py::merge_topk.
//
// Design. The TPU kernel holds a whole (Q, block) score tile in VMEM and runs
// k full max-and-mask passes over it on the vector unit. Here one CTA owns a
// catalog block and a tile of up to 8 queries. Its 256 threads each take
// columns (thread, thread + 256, ...): a thread streams its catalog row once
// with 16-byte loads and forms the 8 dot products against the query tile,
// which sits in shared memory and is read as broadcasts; the masked scores go
// to shared memory (8 x block f32, 128 KB at block = 4096, hence the opt-in
// above 48 KB). Then one warp per query extracts the top-k: every lane keeps
// the best (value, lowest column) of the columns it owns (lane, lane + 32,
// ...), a round is a 5-step shuffle reduction over (value desc, column asc),
// and only the lane that owned the winner rescans its 1/32 of the row. The
// score matrix never reaches device memory: a call reads the catalog, the
// queries and the mask, and writes nb * Q * k candidates.
//
// Bound on this card: bytes at the shapes the callers use (Q = 256, N = 59 K,
// d = 64: 15 MB of catalog and 15 MB of mask against 1.9 GFLOP of f32 FMA,
// which the card does in a few tens of microseconds). Each query tile reads
// its catalog block again, but the whole catalog stays in the 50 MB L2.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 8;               // queries per CTA (one warp each in the top-k)
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;     // bytes a block may opt in to on sm_90

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
mips_block_kernel(const float* __restrict__ q, const float* __restrict__ cat,
                  const int8_t* __restrict__ mask, float* __restrict__ os,
                  int* __restrict__ oi, int nq, int n, int d, int k, int block,
                  int qt) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // kQT x d, zero rows past the tile
  float* sc = smem + (size_t)kQT * d;     // qt x block masked scores
  const int q0 = blockIdx.x * qt;
  const int j = blockIdx.y;

  for (int idx = threadIdx.x; idx < kQT * d; idx += kThreads) {
    const int r = idx / d;
    const int qi = q0 + r;
    qs[idx] = (r < qt && qi < nq) ? q[(int64_t)qi * d + (idx - r * d)] : 0.0f;
  }
  __syncthreads();

  for (int cc = threadIdx.x; cc < block; cc += kThreads) {
    const int64_t col = (int64_t)j * block + cc;
    float acc[kQT];
#pragma unroll
    for (int r = 0; r < kQT; ++r) acc[r] = 0.0f;
    if (col < n) {
      const float* row = cat + col * d;
      if (VEC4) {
        for (int x = 0; x < d; x += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row + x));
#pragma unroll
          for (int r = 0; r < kQT; ++r) {
            const float4 u = *reinterpret_cast<const float4*>(qs + r * d + x);
            acc[r] = fmaf(v.x, u.x, acc[r]);
            acc[r] = fmaf(v.y, u.y, acc[r]);
            acc[r] = fmaf(v.z, u.z, acc[r]);
            acc[r] = fmaf(v.w, u.w, acc[r]);
          }
        }
      } else {
        for (int x = 0; x < d; ++x) {
          const float v = __ldg(row + x);
#pragma unroll
          for (int r = 0; r < kQT; ++r) acc[r] = fmaf(v, qs[r * d + x], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kQT; ++r) {
      if (r < qt) {
        const int qi = q0 + r;
        float s = acc[r];
        if (col >= n) {
          s = kNegInf;
        } else if (mask != nullptr && qi < nq && mask[(int64_t)qi * n + col] != 0) {
          s = kNegInf;
        }
        sc[(size_t)r * block + cc] = s;
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = q0 + warp;
  if (warp >= qt || qi >= nq) return;
  float* s = sc + (size_t)warp * block;
  float best_v = -CUDART_INF_F;
  int best_i = block;
  for (int cc = lane; cc < block; cc += 32) {
    const float v = s[cc];
    if (v > best_v) { best_v = v; best_i = cc; }     // strict: lowest column on ties
  }
  float* os_row = os + ((int64_t)j * nq + qi) * k;
  int* oi_row = oi + ((int64_t)j * nq + qi) * k;
  for (int t = 0; t < k; ++t) {
    float v = best_v;
    int i = best_i;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oidx = __shfl_xor_sync(0xffffffffu, i, o);
      if (ov > v || (ov == v && oidx < i)) { v = ov; i = oidx; }
    }
    if (lane == 0) {
      os_row[t] = v;
      oi_row[t] = j * block + i;
    }
    if ((i & 31) == lane) {              // the owner retires the winner and rescans
      s[i] = kNegInf;
      best_v = -CUDART_INF_F;
      best_i = block;
      for (int cc = lane; cc < block; cc += 32) {
        const float x = s[cc];
        if (x > best_v) { best_v = x; best_i = cc; }
      }
    }
  }
}

}  // namespace

// q (nq, d) and cat (n, d) contiguous f32, mask (nq, n) int8 or null, os and
// oi (ceil(n / block), nq, k) f32 / int32, 1 <= k <= block. Launches on
// `stream`, never synchronizes, returns the cudaError_t (0 on success).
extern "C" int mips_block(const void* q, const void* cat, const void* mask,
                          void* os, void* oi, int nq, int n, int d, int k,
                          int block, void* stream) {
  if (nq <= 0 || n <= 0) return (int)cudaSuccess;
  if (d <= 0 || block <= 0 || k <= 0 || k > block) return (int)cudaErrorInvalidValue;
  if ((int64_t)n + block > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int64_t q_bytes = (int64_t)kQT * d * sizeof(float);
  int64_t qt = (kMaxSmem - q_bytes) / ((int64_t)block * sizeof(float));
  if (qt < 1) return (int)cudaErrorInvalidValue;    // block too wide for one CTA
  if (qt > kQT) qt = kQT;
  const int nb = (n + block - 1) / block;
  const int tiles = (nq + (int)qt - 1) / (int)qt;
  if (nb > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)q_bytes + (size_t)qt * block * sizeof(float);
  const bool vec4 = d % 4 == 0 && (uintptr_t)cat % 16 == 0;
  auto kern = vec4 ? mips_block_kernel<true> : mips_block_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(tiles, nb), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)cat, (const int8_t*)mask, (float*)os,
      (int*)oi, nq, n, d, k, block, (int)qt);
  return (int)cudaGetLastError();
}

extern "C" const char* mips_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
