// Fused BPR triplet loss and all its gradients, deterministic, for sm_90a.
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
// gi (i_pad, 2d) and gni (B, d), count = max(number of valid triplets, 1).
//
// Design. The TPU kernel "gathers" with one-hot x table matmuls, rounds the
// gathered values to bf16 and carries its sums across a sequential grid, so
// every gradient row is summed in grid order. Here blocks run in no order,
// and many triplets share a user or an item, so a row cannot be summed where
// its triplets are computed without atomics, whose order changes from run to
// run. The call is split at that point, and every sum is taken in an order
// fixed by the data:
//   pass 1, a group of 8 to 32 lanes per triplet (grid-stride; a group's
//     lanes stride over d, so any d up to 512 works and each load is a run of
//     consecutive floats; at d <= 64 a warp holds 4 triplets, which shares
//     the per-triplet work of indices, shuffles and softplus among 8 lanes):
//     gathers exact f32 rows, reduces the six dot products with shuffles
//     inside the group, and writes, all without float atomics,
//     lt[t] = (softplus, L2 sum), the unweighted row gradients s_u, s_p, s_n
//     into scratch rows e = role * B + t (role 0 user, 1 positive, 2
//     negative; s_n only for an in-cluster negative), gni[t] but for its
//     1/count factor (exact zeros for a masked triplet, which is skipped
//     outright so no padded row can make a NaN), and a sort key per role:
//     the table row (users first, then items) or the sentinel u_pad + i_pad;
//   a stable radix sort of the 3B (key, e) pairs on the key's low bits only
//     (CUB; index bookkeeping, 2 digit passes up to 65,535 rows): each row's
//     incidences in ascending e, i.e. an item's positive roles before its
//     negative roles, each in ascending t;
//   row starts: a thread per sorted position writes start[r] for the rows
//     that begin there, each exactly once; start[u_pad] is the valid count;
//   pass 2: a block of 8 warps per table row, warp w summing the row's
//     incidences w, w + 8, ... in list order (lanes over d, eight loads in
//     flight up to d = 128), the 8 partials added in warp order in shared
//     memory; the row is w1 * sum | 2 w2 * own initial half * (user or
//     positive incidences), written once, zeros for a row with none. Then blocks scale gni by
//     1/count, and one block sums lt in a fixed order (strided per-thread
//     partials, then a fixed tree).
// Nothing depends on the grid of pass 1, the scheduling of blocks or the
// stream, so two calls on the same inputs give bit-equal outputs. A zero-norm
// final row gives NaN, as in the JAX package.
//
// Bound on this card, counted from the data. With V valid triplets of B, a
// call must read m (4 B bytes), the other four indices and the ni row of each
// valid triplet (16 V + 4 d V bytes) and the table rows the valid triplets
// name (8 d bytes per distinct user or positive item, 4 d per item named only
// as an in-cluster negative), and must write gni (4 d B bytes) and both
// gradient tables in full (8 d (u_pad + i_pad) bytes); the arithmetic is
// about 30 d operations per valid triplet. At the smoke's cluster shape
// (B 38,656, V 33,519, d 64, u_pad + i_pad 2,816) that is about 21.5 MB:
// 6.4 microseconds of HBM time on an H100, far more than the arithmetic
// needs. What the determinism costs is beyond that bound: the scratch rows
// (up to 3 B d floats, 22-30 MB here, within the 50 MB L2) written by pass 1
// and read by pass 2, and the sort's four small launches over 3 B keys. Pass
// 2's longest blocks are the hub rows (a row named by 763 triplets gives each
// warp about 96 loads).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Sum over the G lanes of a lane group (G a power of two up to 32).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1. A group of G lanes takes a triplet, so a warp takes 32 / G at a
// time and the per-triplet work (index loads, shuffles, softplus) is shared
// by fewer lanes; lane s of the group holds elements c = s + G j of a d-wide
// row, j < V (d <= G V), and the group's loads of one j are G consecutive
// floats. Every lane runs the shuffles, so a masked or out-of-range triplet
// is computed on zero rows and only its stores are skipped. c1 = -1/10
// (reference) or 1 (standard), coeff_d = bpr_coeff / d: the weights but for
// their 1/count factor.
template <int G, int V, bool kReference>
__global__ void __launch_bounds__(kThreads)
bpr_pass1_kernel(const float* __restrict__ u_tab, const float* __restrict__ i_tab,
                 const float* __restrict__ ni, const int* __restrict__ ul,
                 const int* __restrict__ pl, const int* __restrict__ loc,
                 const int* __restrict__ inc, const int* __restrict__ m,
                 float* __restrict__ scratch, float2* __restrict__ lt,
                 float* __restrict__ gni, unsigned* __restrict__ keys,
                 int* __restrict__ vals, int64_t b, int d, int u_pad,
                 unsigned sentinel, float scale, float c1, float coeff_d) {
  constexpr int kPer = 32 / G;   // triplets per warp at a time
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int warp = threadIdx.x >> 5;
  const int64_t row = 2 * (int64_t)d;
  const float gain = kReference ? 10.0f : -1.0f;
  const float two_c = 2.0f * coeff_d;

  for (int64_t w0 = ((int64_t)blockIdx.x * kWarps + warp) * kPer; w0 < b;
       w0 += (int64_t)gridDim.x * kWarps * kPer) {
    const int64_t t = w0 + lane / G;
    const bool in_range = t < b;
    const bool valid = in_range && m[t] != 0;
    const bool in_cluster = valid && inc[t] != 0;
    const int u = valid ? ul[t] : 0;
    const int p = valid ? pl[t] : 0;
    const int l = in_cluster ? loc[t] : 0;
    if (in_range && sub < 3) {   // one sort key per role
      unsigned key = sentinel;
      if (sub == 0 && valid) key = (unsigned)u;
      if (sub == 1 && valid) key = (unsigned)(u_pad + p);
      if (sub == 2 && in_cluster) key = (unsigned)(u_pad + l);
      const int64_t e = sub * b + t;
      keys[e] = key;
      vals[e] = (int)e;
    }

    const float* urow = u_tab + u * row;
    const float* prow = i_tab + p * row;
    const float* lrow = i_tab + l * row;
    const float* nrow = ni + t * d;
    float uf[V], ui[V], pf[V], pi[V], nf[V], nn[V];
    float s_uu = 0.f, s_pp = 0.f, s_nn = 0.f, s_up = 0.f, s_un = 0.f, s_reg = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = sub + G * j;
      if (valid && c < d) {
        uf[j] = urow[c];
        ui[j] = urow[d + c];
        pf[j] = prow[c];
        pi[j] = prow[d + c];
        nn[j] = nrow[c];
        nf[j] = in_cluster ? lrow[c] : nn[j] * scale;
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
    s_uu = group_sum<G>(s_uu);
    s_pp = group_sum<G>(s_pp);
    s_nn = group_sum<G>(s_nn);
    s_up = group_sum<G>(s_up);
    s_un = group_sum<G>(s_un);
    s_reg = group_sum<G>(s_reg);
    if (!in_range) continue;
    float* gn = gni + t * d;
    if (!valid) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = sub + G * j;
        if (c < d) gn[c] = 0.0f;
      }
      if (sub == 0) lt[t] = make_float2(0.0f, 0.0f);
      continue;
    }

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
    if (sub == 0) lt[t] = make_float2(sp, s_reg);
    const float g = gain * sig;    // d softplus / d cp  ( = - d / d cn )

    float* su = scratch + t * d;
    float* sp_row = scratch + (b + t) * d;
    float* sn = scratch + (2 * b + t) * d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = sub + G * j;
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
        su[c] = g_uf;
        sp_row[c] = g_pf;
        if (in_cluster) {
          sn[c] = g_nf;
          gn[c] = two_c * nn[j];
        } else {
          gn[c] = two_c * nn[j] + scale * c1 * g_nf;
        }
      }
    }
  }
}

// start[r] = first sorted position whose key is >= r, for r in [0, rows];
// every entry is written by exactly one thread.
__global__ void bpr_row_starts_kernel(const unsigned* __restrict__ keys,
                                      int* __restrict__ start, int64_t n,
                                      int rows) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i <= n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int prev = i == 0 ? -1 : (int)keys[i - 1];
    const int cur = i == n ? rows : (int)keys[i];
    for (int r = prev + 1; r <= cur; ++r) start[r] = (int)i;
  }
}

// Pass 2: block 0 the loss, blocks 1 .. rows the table rows (users, then
// items), the rest scale gni by 1/count.
template <int V, int U>
__global__ void __launch_bounds__(kThreads)
bpr_pass2_kernel(const float* __restrict__ u_tab, const float* __restrict__ i_tab,
                 const float* __restrict__ scratch, const float2* __restrict__ lt,
                 const int* __restrict__ order, const int* __restrict__ start,
                 float* __restrict__ loss, float* __restrict__ gu,
                 float* __restrict__ gi, float* __restrict__ gni, int64_t b,
                 int d, int u_pad, int i_pad, float c1, float coeff_d) {
  __shared__ float part[kWarps][32 * V];
  __shared__ float red[2][kThreads];
  __shared__ int n_own[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = u_pad + i_pad;
  const float cnt = (float)max(start[u_pad], 1);
  const float w1 = c1 / cnt;
  const float w2 = coeff_d / cnt;

  if (blockIdx.x == 0) {
    float s_sp = 0.0f, s_reg = 0.0f;
    int64_t t = threadIdx.x;
    for (; t + 7 * kThreads < b; t += 8 * kThreads) {   // 8 loads in flight
      float2 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = lt[t + k * kThreads];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s_sp += v[k].x;
        s_reg += v[k].y;
      }
    }
    for (; t < b; t += kThreads) {
      const float2 v = lt[t];
      s_sp += v.x;
      s_reg += v.y;
    }
    red[0][threadIdx.x] = s_sp;
    red[1][threadIdx.x] = s_reg;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) {
        red[0][threadIdx.x] += red[0][threadIdx.x + h];
        red[1][threadIdx.x] += red[1][threadIdx.x + h];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) *loss = w1 * red[0][0] + w2 * red[1][0];
    return;
  }

  if ((int)blockIdx.x > rows) {
    const float inv = 1.0f / cnt;
    const int64_t total = b * d;
    for (int64_t i = (int64_t)(blockIdx.x - rows - 1) * kThreads + threadIdx.x;
         i < total; i += (int64_t)(gridDim.x - rows - 1) * kThreads)
      gni[i] *= inv;
    return;
  }

  const int r = blockIdx.x - 1;
  const int beg = start[r], end = start[r + 1];
  const bool user = r < u_pad;
  const float* own = user ? u_tab + (int64_t)r * 2 * d
                          : i_tab + (int64_t)(r - u_pad) * 2 * d;
  float* out = user ? gu + (int64_t)r * 2 * d : gi + (int64_t)(r - u_pad) * 2 * d;
  if (beg == end) {
    for (int c = threadIdx.x; c < 2 * d; c += kThreads) out[c] = 0.0f;
    return;
  }

  const int64_t two_b = 2 * b;   // entries below it are user or positive roles
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  int mine = 0;
  int i = beg + warp;
  for (; i + (U - 1) * kWarps < end; i += U * kWarps) {   // U loads in flight
    int e[U];
#pragma unroll
    for (int k = 0; k < U; ++k) e[k] = order[i + k * kWarps];
    float x[U][V];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const float* src = scratch + (int64_t)e[k] * d;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = lane + 32 * j;
        x[k][j] = c < d ? src[c] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      mine += e[k] < two_b;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += x[k][j];
    }
  }
  for (; i < end; i += kWarps) {
    const int e = order[i];
    mine += e < two_b;
    const float* src = scratch + (int64_t)e * d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c < d) acc[j] += src[c];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[warp][lane + 32 * j] = acc[j];
  if (lane == 0) n_own[warp] = mine;
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n += n_own[w];
  const float two_w2n = 2.0f * w2 * (float)n;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float s = part[0][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][c];
    out[c] = w1 * s;
    out[d + c] = n == 0 ? 0.0f : two_w2n * own[d + c];
  }
}

int sort_bits(int rows) {   // key values 0 .. rows (the sentinel), rows >= 1
  return 32 - __builtin_clz((unsigned)rows);
}

cudaError_t sort_pairs(void* temp, size_t& temp_bytes, unsigned* k0,
                       unsigned* k1, int* v0, int* v1, int n, int rows,
                       cudaStream_t stream, const unsigned** k_out,
                       const int** v_out) {
  cub::DoubleBuffer<unsigned> keys(k0, k1);
  cub::DoubleBuffer<int> vals(v0, v1);
  cudaError_t e = cub::DeviceRadixSort::SortPairs(
      temp, temp_bytes, keys, vals, n, 0, sort_bits(rows), stream);
  if (k_out) *k_out = keys.Current();
  if (v_out) *v_out = vals.Current();
  return e;
}

// G, V1: pass 1's lanes per triplet and elements per lane; V2: pass 2's
// elements per lane (a warp spans d).
template <int G, int V1, int V2>
cudaError_t launch(bool reference, int grid1, int sms, cudaStream_t s,
                   const float* u_tab, const float* i_tab, const float* ni,
                   const int* ul, const int* pl, const int* loc, const int* inc,
                   const int* m, float* loss, float* gu, float* gi, float* gni,
                   float* scratch, float2* lt, unsigned* k0, unsigned* k1,
                   int* v0, int* v1, int* start, void* temp, size_t temp_bytes,
                   int64_t b, int d, int u_pad, int i_pad, float scale,
                   float c1, float coeff_d) {
  constexpr int U = V2 <= 4 ? 8 : 4;   // pass 2's loads in flight per warp
  const int rows = u_pad + i_pad;
  auto pass1 = reference ? bpr_pass1_kernel<G, V1, true>
                         : bpr_pass1_kernel<G, V1, false>;
  int blocks1 = grid1;
  if (blocks1 <= 0) {   // one wave of resident blocks, fewer for a small call
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pass1, kThreads, 0);
    if (e != cudaSuccess) return e;
    const int64_t need = (b + kThreads / G - 1) / (kThreads / G);
    const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    blocks1 = (int)(need < cap ? need : cap);
  }
  pass1<<<blocks1, kThreads, 0, s>>>(u_tab, i_tab, ni, ul, pl, loc, inc, m,
                                     scratch, lt, gni, k0, v0, b, d, u_pad,
                                     (unsigned)rows, scale, c1, coeff_d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned* keys;
  const int* order;
  e = sort_pairs(temp, temp_bytes, k0, k1, v0, v1, (int)(3 * b), rows, s,
                 &keys, &order);
  if (e != cudaSuccess) return e;
  const int64_t n = 3 * b;
  const int64_t cap2 = (int64_t)sms * 8;
  const int64_t need = (n + 1 + kThreads - 1) / kThreads;
  bpr_row_starts_kernel<<<(int)(need < cap2 ? need : cap2), kThreads, 0, s>>>(
      keys, start, n, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t gni_need = (b * d + kThreads - 1) / kThreads;
  const int gni_blocks = (int)(gni_need < cap2 ? gni_need : cap2);
  bpr_pass2_kernel<V2, U><<<1 + rows + gni_blocks, kThreads, 0, s>>>(
      u_tab, i_tab, scratch, lt, order, start, loss, gu, gi, gni, b, d, u_pad,
      i_pad, c1, coeff_d);
  return cudaGetLastError();
}

}  // namespace

// Bytes of CUB scratch space the sort of a call with b triplets and
// u_pad + i_pad = rows table rows needs, into *bytes.
extern "C" int bpr_tile_temp_bytes(int64_t b, int rows, size_t* bytes) {
  *bytes = 0;
  return (int)sort_pairs(nullptr, *bytes, nullptr, nullptr, nullptr, nullptr,
                         (int)(3 * b), rows, 0, nullptr, nullptr);
}

// Every output is written in full: loss (1 float), gu (u_pad, 2d), gi
// (i_pad, 2d), gni (b, d). Scratch, none of it initialized: scratch (3 b d
// floats), lt (2 b floats, 8-byte aligned), ints (4 n + u_pad + i_pad + 1,
// n = 3 b rounded up to a multiple of 32), temp (temp_bytes from
// bpr_tile_temp_bytes). reference != 0 selects the
// reference loss, 0 the standard one; grid1 > 0 sets pass 1's block count
// (its default fills the card). Returns the first cudaError_t of the
// launches (0 on success); never synchronizes.
extern "C" int bpr_tile(const void* u_tab, const void* i_tab, const void* ni,
                        const void* ul, const void* pl, const void* loc,
                        const void* inc, const void* m, void* loss, void* gu,
                        void* gi, void* gni, void* scratch, void* lt,
                        void* ints, void* temp, size_t temp_bytes, int64_t b,
                        int d, int u_pad, int i_pad, float scale,
                        float bpr_coeff, int reference, int grid1,
                        void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 512 || 3 * b + 1 > INT32_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t n = (3 * b + 31) / 32 * 32;   // each array aligned to 128 bytes
  int* k = (int*)ints;
  const float c1 = reference ? -0.1f : 1.0f;
  const float coeff_d = bpr_coeff / (float)d;
  cudaStream_t s = (cudaStream_t)stream;
#define BPR_LAUNCH(G, V1, V2)                                                  \
  e = launch<G, V1, V2>(reference != 0, grid1, sms, s, (const float*)u_tab,    \
                (const float*)i_tab, (const float*)ni, (const int*)ul,         \
                (const int*)pl, (const int*)loc, (const int*)inc,              \
                (const int*)m, (float*)loss, (float*)gu, (float*)gi,           \
                (float*)gni, (float*)scratch, (float2*)lt, (unsigned*)k,       \
                (unsigned*)(k + n), k + 2 * n, k + 3 * n, k + 4 * n, temp,     \
                temp_bytes, b, d, u_pad, i_pad, scale, c1, coeff_d)
  if (d <= 32) BPR_LAUNCH(8, 4, 1);
  else if (d <= 64) BPR_LAUNCH(8, 8, 2);
  else if (d <= 128) BPR_LAUNCH(16, 8, 4);
  else if (d <= 256) BPR_LAUNCH(32, 8, 8);
  else BPR_LAUNCH(32, 16, 16);
#undef BPR_LAUNCH
  return (int)e;
}

extern "C" const char* bpr_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
