// Fused BPR triplet loss and all its gradients in one launch, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// movie_recommender_system_with_gnns_tpu/ops/pallas_bpr.py::_bpr_tile_kernel.
//
// What it computes, per valid triplet t (m[t] != 0) of one compact cluster:
//   u_cat = u_tab[ul[t]]   (2d floats: [propagated | initial] user row)
//   p_cat = i_tab[pl[t]]   (2d floats: [propagated | initial] item row)
//   nf    = inc[t] ? i_tab[loc[t]][:d] : ni[t] * scale     (negative's final)
//   reference loss: cos+ / cos- of the L2-normalized finals,
//                   w1 * softplus(10 (cos+ - cos-)),  w1 = -1 / (10 count)
//   standard loss:  raw dots, w1 * softplus(<u,n> - <u,p>), w1 = 1 / count
//   plus w2 * (|ui|^2 + |pi|^2 + |ni|^2),  w2 = coeff / (count d)
// and returns the masked sum (one float) with its gradients gu (u_pad, 2d),
// gi (i_pad, 2d) and gni (B, d). w = [w1, w2] arrives as a device tensor, so
// the step needs no host synchronisation.
//
// Design. The TPU kernel "gathers" with one-hot x table matmuls because
// Mosaic has no row gather, rounds the gathered values to bf16, and carries
// its accumulators across a sequential grid. Here the gathers are real row
// gathers of exact f32 values: one warp owns a triplet, its lanes stride over
// d (element c = lane + 32 j, so every row read is a coalesced 128-byte
// segment and any d up to 512 works), the six dot products are reduced with
// warp shuffles, softplus and its derivative are evaluated once per triplet,
// and the row gradients are formed analytically (through the normalization
// for the reference loss, 2 w2 row for the initial rows, the scale factor
// into gni for an out-of-cluster negative). Blocks run in no order, so the
// table gradients are accumulated with f32 atomicAdd into zero-initialized
// gu and gi (many triplets share a user or an item; the sum order therefore
// changes from run to run). gni is written once per row without atomics, with
// exact zeros for masked triplets, which are skipped outright so no padded
// row can produce a NaN. The loss is reduced per block and added with one
// atomicAdd per block. A zero-norm final row gives NaN, as in the JAX package.
//
// Bound on this card, counted from the data. With V valid triplets of B, a
// call must read m (4 B bytes), the other four indices and the ni row of each
// valid triplet (16 V + 4 d V bytes) and the table rows the valid triplets
// name (8 d bytes per distinct user or positive item, 4 d per item named only
// as an in-cluster negative), and must write gni (4 d B bytes, zeros for
// masked triplets) and both gradient tables in full, their zeros included
// (8 d (u_pad + i_pad) bytes); the arithmetic is about 30 d operations per
// valid triplet. At B = V = 41K, d = 64, u_pad + i_pad = 2.9K that is about
// 25 MB and 80 MFLOP: under 10 microseconds of HBM time on an H100, and far
// less arithmetic time. The tables and their gradients (a few MB) stay in L2,
// so what the kernel really waits for is gather latency and the atomics' L2
// round trips, about 5 d atomic adds per triplet. The design keeps every
// triplet's rows in registers between the forward and the backward half, so
// each row is read once, and spreads triplets over all SMs with a
// grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V = elements of a d-wide row held by one lane (d <= 32 V).
template <int V, bool kReference>
__global__ void __launch_bounds__(kThreads)
bpr_tile_kernel(const float* __restrict__ u_tab, const float* __restrict__ i_tab,
                const float* __restrict__ ni, const int* __restrict__ ul,
                const int* __restrict__ pl, const int* __restrict__ loc,
                const int* __restrict__ inc, const int* __restrict__ m,
                const float* __restrict__ w, float* __restrict__ loss,
                float* __restrict__ gu, float* __restrict__ gi,
                float* __restrict__ gni, int64_t b, int d, float scale) {
  __shared__ float warp_loss[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float w1 = w[0];
  const float w2 = w[1];
  const int64_t row = 2 * (int64_t)d;
  const float gain = kReference ? 10.0f : -1.0f;
  float acc = 0.0f;   // the warp's share of the loss (the same in every lane)

  for (int64_t t = (int64_t)blockIdx.x * kWarps + warp; t < b;
       t += (int64_t)gridDim.x * kWarps) {
    float* gn = gni + t * d;
    if (m[t] == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = lane + 32 * j;
        if (c < d) gn[c] = 0.0f;
      }
      continue;
    }
    const int64_t u_off = (int64_t)ul[t] * row;
    const int64_t p_off = (int64_t)pl[t] * row;
    const int64_t l_off = (int64_t)loc[t] * row;
    const bool in_cluster = inc[t] != 0;
    const float* nrow = ni + t * d;

    float uf[V], ui[V], pf[V], pi[V], nf[V], nn[V];
    float s_uu = 0.f, s_pp = 0.f, s_nn = 0.f, s_up = 0.f, s_un = 0.f, s_reg = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        uf[j] = u_tab[u_off + c];
        ui[j] = u_tab[u_off + d + c];
        pf[j] = i_tab[p_off + c];
        pi[j] = i_tab[p_off + d + c];
        nn[j] = nrow[c];
        nf[j] = in_cluster ? i_tab[l_off + c] : nn[j] * scale;
      } else {
        uf[j] = ui[j] = pf[j] = pi[j] = nf[j] = nn[j] = 0.0f;
      }
      s_uu += uf[j] * uf[j];
      s_pp += pf[j] * pf[j];
      s_nn += nf[j] * nf[j];
      s_up += uf[j] * pf[j];
      s_un += uf[j] * nf[j];
      s_reg += ui[j] * ui[j] + pi[j] * pi[j] + nn[j] * nn[j];
    }
    s_uu = warp_sum(s_uu);
    s_pp = warp_sum(s_pp);
    s_nn = warp_sum(s_nn);
    s_up = warp_sum(s_up);
    s_un = warp_sum(s_un);
    s_reg = warp_sum(s_reg);

    float inv_u = 1.0f, inv_p = 1.0f, inv_n = 1.0f;
    if (kReference) {
      inv_u = 1.0f / sqrtf(s_uu);
      inv_p = 1.0f / sqrtf(s_pp);
      inv_n = 1.0f / sqrtf(s_nn);
    }
    const float cp = s_up * inv_u * inv_p;
    const float cn = s_un * inv_u * inv_n;
    const float x = gain * (cp - cn);
    const float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    const float sig = 1.0f / (1.0f + expf(-x));
    acc += w1 * sp + w2 * s_reg;
    const float g = w1 * gain * sig;    // d loss / d cp  ( = - d loss / d cn )
    const float two_w2 = 2.0f * w2;

    float* gur = gu + u_off;
    float* gpr = gi + p_off;
    float* glr = gi + l_off;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        float g_uf, g_pf, g_nf;
        if (kReference) {
          const float a = uf[j] * inv_u;
          const float bb = pf[j] * inv_p;
          const float cc = nf[j] * inv_n;
          g_uf = g * inv_u * ((bb - cc) - (cp - cn) * a);
          g_pf = g * inv_p * (a - cp * bb);
          g_nf = -g * inv_n * (a - cn * cc);
        } else {
          g_uf = g * (pf[j] - nf[j]);
          g_pf = g * uf[j];
          g_nf = -g * uf[j];
        }
        atomicAdd(gur + c, g_uf);
        atomicAdd(gur + d + c, two_w2 * ui[j]);
        atomicAdd(gpr + c, g_pf);
        atomicAdd(gpr + d + c, two_w2 * pi[j]);
        if (in_cluster) {
          atomicAdd(glr + c, g_nf);
          gn[c] = two_w2 * nn[j];
        } else {
          gn[c] = two_w2 * nn[j] + scale * g_nf;
        }
      }
    }
  }

  if (lane == 0) warp_loss[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += warp_loss[i];
    atomicAdd(loss, total);
  }
}

template <int V>
void launch(bool reference, int blocks, cudaStream_t stream,
            const float* u_tab, const float* i_tab, const float* ni,
            const int* ul, const int* pl, const int* loc, const int* inc,
            const int* m, const float* w, float* loss, float* gu, float* gi,
            float* gni, int64_t b, int d, float scale) {
  if (reference) {
    bpr_tile_kernel<V, true><<<blocks, kThreads, 0, stream>>>(
        u_tab, i_tab, ni, ul, pl, loc, inc, m, w, loss, gu, gi, gni, b, d, scale);
  } else {
    bpr_tile_kernel<V, false><<<blocks, kThreads, 0, stream>>>(
        u_tab, i_tab, ni, ul, pl, loc, inc, m, w, loss, gu, gi, gni, b, d, scale);
  }
}

}  // namespace

// loss (1 float), gu and gi must be zero on entry; gni is written in full.
// reference != 0 selects the reference loss, 0 the standard one. Returns the
// cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int bpr_tile(const void* u_tab, const void* i_tab, const void* ni,
                        const void* ul, const void* pl, const void* loc,
                        const void* inc, const void* m, const void* w,
                        void* loss, void* gu, void* gi, void* gni,
                        int64_t b, int d, float scale, int reference,
                        void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 512) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t need = (b + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sms * 8;      // 8 resident blocks of 256 threads
  const int blocks = (int)(need < cap ? need : cap);
  cudaStream_t s = (cudaStream_t)stream;
#define BPR_LAUNCH(V)                                                        \
  launch<V>(reference != 0, blocks, s, (const float*)u_tab,                  \
            (const float*)i_tab, (const float*)ni, (const int*)ul,           \
            (const int*)pl, (const int*)loc, (const int*)inc, (const int*)m, \
            (const float*)w, (float*)loss, (float*)gu, (float*)gi,           \
            (float*)gni, b, d, scale)
  if (d <= 32) BPR_LAUNCH(1);
  else if (d <= 64) BPR_LAUNCH(2);
  else if (d <= 128) BPR_LAUNCH(4);
  else if (d <= 256) BPR_LAUNCH(8);
  else BPR_LAUNCH(16);
#undef BPR_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* bpr_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
