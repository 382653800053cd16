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
// Three kernels, each a block of 4 warps over 128 rows of X that streams
// every row of Y in tiles of 64, double-buffered by cp.async into shared
// memory (rows padded to 16 bytes more than d, so ldmatrix reads them
// without bank conflicts); products by mma.sync m16n8k16 bf16 with f32
// accumulation, 32 rows a warp (two m tiles share each fragment of Y read
// from shared memory, which halves that traffic against 16 rows a warp):
//
//   * infonce_fwd_kernel (X = A, Y = B): S = X Y^T and, per row, the sum of
//     exp2((S_ij - 1) log2(e) / tau); writes lse[i] = log sum_j exp(S_ij / tau)
//     (natural units) and nothing else. The rows are unit vectors, so every
//     logit S_ij / tau lies within 1/tau (bf16 rounding moves a norm by
//     2^-8 at most): 1/tau serves as each row's maximum, no running maximum
//     is kept, and for tau >= 0.025 no term of the sum leaves f32's range;
//   * infonce_bwd_kernel<D, false> (X = A, Y = B): out_i = sum_j P_ij b_j with
//     P_ij = exp(S_ij / tau - lse_i), S recomputed, P rounded to bf16 as the
//     A operand of the second product (its f32 fragments are already laid
//     out as one);
//   * infonce_bwd_kernel<D, true> (X = B, Y = A): out_j = sum_i P_ij a_i, the
//     bias lse_i now that of the streamed row.
//
// The wrapper finishes dA = (P B - B_diag) / (tau n) and dB = (P^T A -
// A_diag) / (tau n), and the normalisation's backward. Each output row is
// written by one warp, with its sum in a fixed order: a call gives the same
// bits every time.
//
// n is read from device memory (count, int32): the launch is sized to the
// buffers' rows (cap) and blocks past n write zeros and exit, so the step
// that chose the rows never waits for the device.
//
// Bound on this card: 2 n^2 d operations forward and 4 n^2 d backward
// (6 n^2 d is the model's count; the two backward kernels each recompute
// S, so they do 8 n^2 d), and n^2 exponentials a pass. At d 64 a logit
// costs 64 tensor-core FMAs and one MUFU exponential: the SM issues about
// 1,000 of the first and 16 of the second a cycle, so the exponentials, the
// max, the sum and the scaling bound each pass more than the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                  // 16-row m tiles a warp: 32 rows
constexpr int kBM = 16 * kMT * kWarps;  // rows of X a block
constexpr int kBN = 64;                 // rows of Y a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int kStride = D + 8;          // bf16 elements a shared row
  static constexpr int kX = kBM * kStride;       // elements of the X tile
  static constexpr int kY = kBN * kStride;       // elements of one Y stage
  static constexpr size_t kBytes = (size_t)(kX + 2 * kY) * 2 + 2 * kBN * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// rows [row0, row0 + ROWS) of a (cap, D) bf16 matrix into shared memory;
// rows at or past `limit` are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          int row0, int limit) {
  constexpr int kChunks = D / 8;   // 16-byte pieces a row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < limit;
    cp_async16(s + r * Layout<D>::kStride + c * 8,
               g + (size_t)(ok ? row : 0) * D + c * 8, ok);
  }
}

// the warp's A fragments of its 32 rows of the X tile, every k step
template <int D>
__device__ __forceinline__ void load_x_frags(uint32_t (&xa)[kMT][D / 16][4],
                                             const __nv_bfloat16* xs, int warp, int lane) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int row = (warp * kMT + mt) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      ldsm_x4(xa[mt][k], xs + row * Layout<D>::kStride + k * 16 + 8 * (lane >> 4));
  }
}

// s = X_warp (32 x D) times the stage's 64 rows, transposed: per m tile, 8
// tiles of 8 columns; each B fragment read from shared memory once for both
template <int D>
__device__ __forceinline__ void logits(float (&s)[kMT][kBN / 8][4],
                                       const uint32_t (&xa)[kMT][D / 16][4],
                                       const __nv_bfloat16* ys, int lane) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      uint32_t b[4];
      ldsm_x4(b, ys + (j * 16 + (lane & 7) + 8 * (lane >> 4)) * Layout<D>::kStride + k * 16 +
                     8 * ((lane >> 3) & 1));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma_bf16(s[mt][2 * j], xa[mt][k], b[0], b[1]);
        mma_bf16(s[mt][2 * j + 1], xa[mt][k], b[2], b[3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
infonce_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                   const int* __restrict__ count, float* __restrict__ lse, int cap,
                   float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ys = xs + Layout<D>::kX;
  const int n = min(*count, cap);
  const int row0 = blockIdx.x * kBM;
  if (row0 >= n) {   // past the count: nothing to sum
    for (int r = threadIdx.x; r < kBM && row0 + r < cap; r += kThreads) lse[row0 + r] = 0.f;
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  load_rows<D, kBM>(xs, x, row0, n);
  load_rows<D, kBN>(ys, y, 0, n);
  cp_async_commit();
  const int tiles = (n + kBN - 1) / kBN;
  uint32_t xa[kMT][D / 16][4];
  float l[kMT][2] = {};
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles)
      load_rows<D, kBN>(ys + ((it + 1) & 1) * Layout<D>::kY, y, (it + 1) * kBN, n);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) load_x_frags<D>(xa, xs, warp, lane);
    float s[kMT][kBN / 8][4];
    logits<D>(s, xa, ys + (it & 1) * Layout<D>::kY, lane);
    const int c0 = it * kBN;
    const bool whole = c0 + kBN <= n;   // no column to mask
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][j][e], scale2, -scale2));
          l[mt][e >> 1] += whole || c0 + j * 8 + 2 * t + (e & 1) < n ? p : 0.f;
        }
    __syncthreads();   // the stage is read before the next load refills it
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = l[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int row = row0 + (warp * kMT + mt) * 16 + (lane >> 2) + 8 * h;
      if (t == 0 && row < cap) lse[row] = (scale2 + log2f(v)) * kLn2;
    }
}

template <int D, bool kColBias>
__global__ void __launch_bounds__(kThreads)
infonce_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ lse, const int* __restrict__ count,
                   float* __restrict__ out, int cap, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ys = xs + Layout<D>::kX;
  float* bias = reinterpret_cast<float*>(ys + 2 * Layout<D>::kY);   // 2 stages of kBN
  const int n = min(*count, cap);
  const int row0 = blockIdx.x * kBM;
  if (row0 >= n) {
    for (int i = threadIdx.x; i < kBM * D; i += kThreads) {
      const int r = row0 + i / D;
      if (r < cap) out[(size_t)r * D + i % D] = 0.f;
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float rbias[kMT][2] = {};
  if (!kColBias) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + (warp * kMT + mt) * 16 + g + 8 * h;
        rbias[mt][h] = r < n ? lse[r] * kLog2e : 0.f;
      }
  }
  load_rows<D, kBM>(xs, x, row0, n);
  load_rows<D, kBN>(ys, y, 0, n);
  cp_async_commit();
  if (kColBias && threadIdx.x < kBN)
    bias[threadIdx.x] = threadIdx.x < n ? lse[threadIdx.x] * kLog2e : 0.f;
  const int tiles = (n + kBN - 1) / kBN;
  uint32_t xa[kMT][D / 16][4];
  float acc[kMT][D / 8][4] = {};
  for (int it = 0; it < tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < tiles) {
      load_rows<D, kBN>(ys + (stage ^ 1) * Layout<D>::kY, y, (it + 1) * kBN, n);
      if (kColBias && threadIdx.x < kBN) {
        const int c = (it + 1) * kBN + threadIdx.x;
        bias[(stage ^ 1) * kBN + threadIdx.x] = c < n ? lse[c] * kLog2e : 0.f;
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) load_x_frags<D>(xa, xs, warp, lane);
    const __nv_bfloat16* yt = ys + stage * Layout<D>::kY;
    float s[kMT][kBN / 8][4];
    logits<D>(s, xa, yt, lane);
    const int c0 = it * kBN;
    const bool whole = c0 + kBN <= n;   // no column to mask
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = j * 8 + 2 * t + (e & 1);
          const float b = kColBias ? bias[stage * kBN + cl] : rbias[mt][e >> 1];
          const float p = ex2(fmaf(s[mt][j][e], scale2, -b));
          s[mt][j][e] = whole || c0 + cl < n ? p : 0.f;
        }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_x4_trans(b, yt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * Layout<D>::kStride +
                             dn * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * dn], pa[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dn + 1], pa[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + (warp * kMT + mt) * 16 + g + 8 * h;
      if (r >= cap) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)r * D + j * 8 + 2 * t) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
    }
}

template <int D>
cudaError_t fwd(const void* x, const void* y, const void* count, void* lse, int cap,
                float scale2, cudaStream_t stream) {
  const size_t bytes = Layout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(infonce_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  infonce_fwd_kernel<D><<<(cap + kBM - 1) / kBM, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const int*>(count), static_cast<float*>(lse), cap, scale2);
  return cudaGetLastError();
}

template <int D, bool kColBias>
cudaError_t bwd(const void* x, const void* y, const void* lse, const void* count, void* out,
                int cap, float scale2, cudaStream_t stream) {
  const size_t bytes = Layout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(infonce_bwd_kernel<D, kColBias>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  infonce_bwd_kernel<D, kColBias><<<(cap + kBM - 1) / kBM, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const float*>(lse), static_cast<const int*>(count), static_cast<float*>(out),
      cap, scale2);
  return cudaGetLastError();
}

}  // namespace

// lse (cap) f32 of x, y (cap, d) bf16 rows, the first *count of them real:
// lse[i] = log sum_{j < count} exp(x_i.y_j * scale2 / log2(e)) for i < count,
// 0 in blocks past count. scale2 = log2(e) / tau. d is 32 or 64 (a warp's
// 32 rows of products with P keep 2 d accumulators a thread in registers).
// Returns the first failed call's cudaError_t (0 on success); never
// synchronizes.
extern "C" int infonce_fwd(const void* x, const void* y, const void* count, void* lse,
                           int cap, int d, float scale2, void* stream) {
  if (cap <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 32: return (int)fwd<32>(x, y, count, lse, cap, scale2, s);
    case 64: return (int)fwd<64>(x, y, count, lse, cap, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out (cap, d) f32: out_r = sum_{c < count} bf16(P_rc) y_c for r < count,
// P_rc = exp(x_r.y_c * scale2 / log2(e) - lse[r]) (col_bias 0) or
// - lse[c] (col_bias 1); rows in blocks past count are zero.
extern "C" int infonce_bwd(const void* x, const void* y, const void* lse, const void* count,
                           void* out, int cap, int d, float scale2, int col_bias,
                           void* stream) {
  if (cap <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define INFONCE_BWD(D)                                                              \
  case D:                                                                           \
    return col_bias ? (int)bwd<D, true>(x, y, lse, count, out, cap, scale2, s)      \
                    : (int)bwd<D, false>(x, y, lse, count, out, cap, scale2, s);
  switch (d) {
    INFONCE_BWD(32)
    INFONCE_BWD(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef INFONCE_BWD
}

extern "C" const char* infonce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
