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
// Design. The TPU kernel "gathers" with one-hot x table matmuls and carries
// its sums across a sequential grid, so every gradient row is summed in grid
// order. Here blocks run in no order and many triplets share a row, so a row
// is summed where its list of triplets is known, in an order fixed by the
// data, without float atomics. The lists come with the call (its incidence):
//   users:     user_order / user_start, each user row's valid triplets;
//   positives: pos_order / pos_start, each item row's valid positive triplets;
//   negatives: neg_order / neg_range, each item row's in-cluster negatives
//              (lo = neg_range[r], hi = neg_range[i_pad + r]; masked entries
//              are skipped).
// A user or positive entry e stands for the kneg triplets e kneg + k (the
// trainer's layout for kneg negatives per positive), so those lists are built
// once per cluster; every list holds its triplets in ascending t. The
// negatives' lists are runs of one per-step sort of the negatives' global
// ids. The count is kneg * user_start[u_pad]. The call sorts nothing.
//   pass 1, a group of 8 to 32 lanes per triplet (grid-stride; a group's
//     lanes stride over d, any d up to 512, each load a run of consecutive
//     floats): gathers exact f32 rows, reduces the six dot products with
//     shuffles inside the group, and writes lt[t] = (softplus, L2 sum), gni[t]
//     in full (zeros for a masked triplet, which is skipped outright so no
//     padded row can make a NaN), and the few scalars that define the
//     triplet's row gradients, unweighted (w1 = 1):
//       s_u = a_u uf + a_p pf + a_n nf     ru[t] = (a_u, a_p, a_n', nsrc)
//       s_p = b_u uf + b_p pf              rp[t] = (b_u, b_p)
//       s_n = c_u uf + c_n nf              rn[t] = (c_u, c_n)
//     (a_n' = a_n scale and nsrc = -1 for an out-of-cluster negative, whose
//     final is ni[t] scale; nsrc = loc[t] otherwise) and un[t] = ul[t], or -1
//     for a masked triplet;
//   pass 2: block 0 sums lt in a fixed order (strided per-thread partials,
//     then a fixed tree); block 1 + r takes table row r (users, then items)
//     with 8 warps, warp w summing the row's entries w, w + 8, ... in list
//     order (an item's positive entries, then its negative ones), lanes over
//     d, several entries' loads in flight. Per entry it gathers the partner
//     rows again from u_tab, i_tab and ni (a user entry its positive and its
//     negative final, an item entry its user's final) and adds the entry's
//     combination with the row's own final. The 8 partials are added in warp
//     order in shared memory; the row is w1 * sum | 2 w2 * own initial half *
//     (user or positive triplets), written once, zeros for a row with none.
// Nothing depends on the grid of pass 1, the scheduling of blocks or the
// stream, so two calls on the same inputs give bit-equal outputs, and a list
// of entries e with kneg gives the bits of the same list expanded to its
// triplets with kneg 1. A zero-norm final row gives NaN, as in the JAX
// package.
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
// needs. Beyond it the design spends 44 bytes of records per triplet written
// by pass 1 and read by pass 2 (1.7 MB here), the lists (about 12 bytes per
// triplet), and pass 2's gathers of one or two partner rows per entry from
// the cluster's tables (1.4 MB, resident in the 50 MB L2). Pass 2 waits on
// chains of dependent loads (row start, list entry, record, partner rows):
// its blocks of 8 warps per row take 2,817 rows in several waves, and its
// longest blocks are the hub rows (a row named by 763 triplets gives each
// warp about 96 entries). Loading a chunk's indices one entry per lane, with
// or without a 64-register cap, made it slower (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

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
                 const int* __restrict__ user_start, float4* __restrict__ ru,
                 float2* __restrict__ rp, float2* __restrict__ rn,
                 int* __restrict__ un, float2* __restrict__ lt,
                 float* __restrict__ gni, int64_t b, int d, int u_pad, int kneg,
                 float scale, float c1, float coeff_d) {
  constexpr int kPer = 32 / G;   // triplets per warp at a time
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int warp = threadIdx.x >> 5;
  const int64_t row = 2 * (int64_t)d;
  const float gain = kReference ? 10.0f : -1.0f;
  const float two_c = 2.0f * coeff_d;
  const float inv_cnt = 1.0f / (float)max(kneg * user_start[u_pad], 1);

  for (int64_t w0 = ((int64_t)blockIdx.x * kWarps + warp) * kPer; w0 < b;
       w0 += (int64_t)gridDim.x * kWarps * kPer) {
    const int64_t t = w0 + lane / G;
    const bool in_range = t < b;
    const bool valid = in_range && m[t] != 0;
    const bool in_cluster = valid && inc[t] != 0;
    const int u = valid ? ul[t] : 0;
    const int p = valid ? pl[t] : 0;
    const int l = in_cluster ? loc[t] : 0;

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
      if (sub == 1) un[t] = -1;
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
    const float g = gain * sig;    // d softplus / d cp  ( = - d / d cn )
    // the row gradients' coefficients: with a = uf inv_u, bb = pf inv_p,
    // cc = nf inv_n (reference), s_u = g inv_u ((bb - cc) - (cp - cn) a),
    // s_p = g inv_p (a - cp bb), s_n = -g inv_n (a - cn cc); standard:
    // s_u = g (pf - nf), s_p = g uf, s_n = -g uf
    float a_u, a_p, a_n, b_u, b_p, c_u, c_n;
    if (kReference) {
      a_u = -g * inv_u * inv_u * (cp - cn);
      a_p = g * inv_u * inv_p;
      a_n = -g * inv_u * inv_n;
      b_u = g * inv_p * inv_u;
      b_p = -g * inv_p * inv_p * cp;
      c_u = -g * inv_n * inv_u;
      c_n = g * inv_n * inv_n * cn;
    } else {
      a_u = 0.0f;
      a_p = g;
      a_n = -g;
      b_u = g;
      b_p = 0.0f;
      c_u = -g;
      c_n = 0.0f;
    }
    if (sub == 0) lt[t] = make_float2(sp, s_reg);
    if (sub == 1) un[t] = u;
    if (sub == 2)
      ru[t] = make_float4(a_u, a_p, in_cluster ? a_n : a_n * scale,
                          __int_as_float(in_cluster ? l : -1));
    if (sub == 3) rp[t] = make_float2(b_u, b_p);
    if (sub == 4) rn[t] = make_float2(c_u, c_n);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = sub + G * j;
      if (c < d) {
        gn[c] = in_cluster ? inv_cnt * (two_c * nn[j])
                           : inv_cnt * (two_c * nn[j] +
                                        scale * c1 * (c_u * uf[j] + c_n * nf[j]));
      }
    }
  }
}

// Pass 2, a user row: entries v = warp, warp + 8, ... of its n = kneg * len
// triplets, U at a time with their loads in flight, added in list order.
template <int V, int U>
__device__ __forceinline__ void sum_user_entries(
    float (&acc)[V], const float (&own)[V], const int* __restrict__ order,
    int beg, int n, int kneg, int warp, int lane, const float4* __restrict__ ru,
    const int* __restrict__ pl, const float* __restrict__ i_tab,
    const float* __restrict__ ni, int d) {
  const int64_t row = 2 * (int64_t)d;
  int v = warp;
  for (; v + (U - 1) * kWarps < n; v += U * kWarps) {
    int64_t t[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int q = v + k * kWarps;
      t[k] = (int64_t)order[beg + q / kneg] * kneg + q % kneg;
    }
    float4 c[U];
    int p[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      c[k] = ru[t[k]];
      p[k] = pl[t[k]];
    }
    float pf[U][V], nf[U][V];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int ns = __float_as_int(c[k].w);
      const float* prow = i_tab + p[k] * row;
      const float* nrow = ns >= 0 ? i_tab + ns * row : ni + t[k] * d;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = lane + 32 * j;
        pf[k][j] = col < d ? prow[col] : 0.0f;
        nf[k][j] = col < d ? nrow[col] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] += c[k].x * own[j] + c[k].y * pf[k][j] + c[k].z * nf[k][j];
    }
  }
  for (; v < n; v += kWarps) {
    const int64_t t = (int64_t)order[beg + v / kneg] * kneg + v % kneg;
    const float4 c = ru[t];
    const int ns = __float_as_int(c.w);
    const float* prow = i_tab + pl[t] * row;
    const float* nrow = ns >= 0 ? i_tab + ns * row : ni + t * d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = lane + 32 * j;
      if (col < d) acc[j] += c.x * own[j] + c.y * prow[col] + c.z * nrow[col];
    }
  }
}

// Pass 2, an item row's positive (rec = rp, users = ul) or negative (rec =
// rn, users = un, -1 for a masked triplet, skipped) entries.
template <int V, int U>
__device__ __forceinline__ void sum_item_entries(
    float (&acc)[V], const float (&own)[V], const int* __restrict__ order,
    int beg, int n, int kneg, int warp, int lane, const float2* __restrict__ rec,
    const int* __restrict__ users, const float* __restrict__ u_tab, int d) {
  const int64_t row = 2 * (int64_t)d;
  int v = warp;
  for (; v + (U - 1) * kWarps < n; v += U * kWarps) {
    int64_t t[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int q = v + k * kWarps;
      t[k] = (int64_t)order[beg + q / kneg] * kneg + q % kneg;
    }
    float2 c[U];
    int u[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      u[k] = users[t[k]];
      c[k] = rec[t[k]];
    }
    float uf[U][V];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const float* urow = u_tab + max(u[k], 0) * row;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = lane + 32 * j;
        uf[k][j] = col < d && u[k] >= 0 ? urow[col] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (u[k] < 0) continue;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += c[k].x * uf[k][j] + c[k].y * own[j];
    }
  }
  for (; v < n; v += kWarps) {
    const int64_t t = (int64_t)order[beg + v / kneg] * kneg + v % kneg;
    const int u = users[t];
    if (u < 0) continue;
    const float2 c = rec[t];
    const float* urow = u_tab + u * row;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = lane + 32 * j;
      if (col < d) acc[j] += c.x * urow[col] + c.y * own[j];
    }
  }
}

// Pass 2: block 0 the loss, blocks 1 .. rows the table rows (users, then
// items).
template <int V, int U>
__global__ void __launch_bounds__(kThreads)
bpr_pass2_kernel(const float* __restrict__ u_tab, const float* __restrict__ i_tab,
                 const float* __restrict__ ni, const int* __restrict__ ul,
                 const int* __restrict__ pl, const float4* __restrict__ ru,
                 const float2* __restrict__ rp, const float2* __restrict__ rn,
                 const int* __restrict__ un, const float2* __restrict__ lt,
                 const int* __restrict__ user_order, const int* __restrict__ user_start,
                 const int* __restrict__ pos_order, const int* __restrict__ pos_start,
                 const int* __restrict__ neg_order, const int* __restrict__ neg_range,
                 float* __restrict__ loss, float* __restrict__ gu,
                 float* __restrict__ gi, int64_t b, int d, int u_pad, int i_pad,
                 int kneg, float c1, float coeff_d) {
  __shared__ float part[kWarps][32 * V];
  __shared__ float red[2][kThreads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float cnt = (float)max(kneg * user_start[u_pad], 1);
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

  const int r = blockIdx.x - 1;
  const bool user = r < u_pad;
  const int ri = r - u_pad;
  const float* tab = user ? u_tab + (int64_t)r * 2 * d : i_tab + (int64_t)ri * 2 * d;
  float* out = user ? gu + (int64_t)r * 2 * d : gi + (int64_t)ri * 2 * d;
  const int beg = user ? user_start[r] : pos_start[ri];
  const int n = kneg * ((user ? user_start[r + 1] : pos_start[ri + 1]) - beg);
  const int n_lo = user ? 0 : neg_range[ri];
  const int n_neg = user ? 0 : neg_range[i_pad + ri] - n_lo;
  if (n == 0 && n_neg == 0) {
    for (int c = threadIdx.x; c < 2 * d; c += kThreads) out[c] = 0.0f;
    return;
  }

  float own[V], acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int col = lane + 32 * j;
    own[j] = col < d ? tab[col] : 0.0f;
    acc[j] = 0.0f;
  }
  if (user) {
    sum_user_entries<V, U>(acc, own, user_order, beg, n, kneg, warp, lane, ru,
                           pl, i_tab, ni, d);
  } else {
    sum_item_entries<V, U>(acc, own, pos_order, beg, n, kneg, warp, lane, rp, ul,
                           u_tab, d);
    sum_item_entries<V, U>(acc, own, neg_order, n_lo, n_neg, 1, warp, lane, rn,
                           un, u_tab, d);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  const float two_w2n = 2.0f * w2 * (float)n;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float s = part[0][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][c];
    out[c] = w1 * s;
    out[d + c] = n == 0 ? 0.0f : two_w2n * tab[d + c];
  }
}

// G, V1: pass 1's lanes per triplet and elements per lane; V2: pass 2's
// elements per lane (a warp spans d).
template <int G, int V1, int V2>
cudaError_t launch(bool reference, int grid1, int sms, cudaStream_t s,
                   const float* u_tab, const float* i_tab, const float* ni,
                   const int* ul, const int* pl, const int* loc, const int* inc,
                   const int* m, const int* user_order, const int* user_start,
                   const int* pos_order, const int* pos_start,
                   const int* neg_order, const int* neg_range, float* loss,
                   float* gu, float* gi, float* gni, float4* ru, float2* lt,
                   float2* rp, float2* rn, int* un, int64_t b, int d, int u_pad,
                   int i_pad, int kneg, float scale, float c1, float coeff_d) {
  constexpr int U = V2 <= 2 ? 8 : (V2 <= 4 ? 4 : 2);   // pass 2's entries in flight
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
                                     user_start, ru, rp, rn, un, lt, gni, b, d,
                                     u_pad, kneg, scale, c1, coeff_d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bpr_pass2_kernel<V2, U><<<1 + u_pad + i_pad, kThreads, 0, s>>>(
      u_tab, i_tab, ni, ul, pl, ru, rp, rn, un, lt, user_order, user_start,
      pos_order, pos_start, neg_order, neg_range, loss, gu, gi, b, d, u_pad,
      i_pad, kneg, c1, coeff_d);
  return cudaGetLastError();
}

}  // namespace

// Every output is written in full: loss (1 float), gu (u_pad, 2d), gi
// (i_pad, 2d), gni (b, d). The lists (int32): user_order with user_start
// (u_pad + 1), pos_order with pos_start (i_pad + 1), neg_order with
// neg_range (2 i_pad); kneg triplets per user or positive entry, b a multiple
// of kneg. Scratch, none of it initialized: 10 b floats (16-byte aligned) and
// b ints. reference != 0 selects the reference loss, 0 the standard one;
// grid1 > 0 sets pass 1's block count (its default fills the card). Returns
// the first cudaError_t of the two launches (0 on success); never
// synchronizes.
extern "C" int bpr_tile(const void* u_tab, const void* i_tab, const void* ni,
                        const void* ul, const void* pl, const void* loc,
                        const void* inc, const void* m, const void* user_order,
                        const void* user_start, const void* pos_order,
                        const void* pos_start, const void* neg_order,
                        const void* neg_range, void* loss, void* gu, void* gi,
                        void* gni, void* scratch, void* ints, int64_t b, int d,
                        int u_pad, int i_pad, int kneg, float scale,
                        float bpr_coeff, int reference, int grid1, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 512 || kneg <= 0 || b % kneg != 0 || b > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  float* f = (float*)scratch;   // ru (4 b), lt (2 b), rp (2 b), rn (2 b)
  const float c1 = reference ? -0.1f : 1.0f;
  const float coeff_d = bpr_coeff / (float)d;
  cudaStream_t s = (cudaStream_t)stream;
#define BPR_LAUNCH(G, V1, V2)                                                   \
  e = launch<G, V1, V2>(reference != 0, grid1, sms, s, (const float*)u_tab,     \
                (const float*)i_tab, (const float*)ni, (const int*)ul,          \
                (const int*)pl, (const int*)loc, (const int*)inc,               \
                (const int*)m, (const int*)user_order, (const int*)user_start,  \
                (const int*)pos_order, (const int*)pos_start,                   \
                (const int*)neg_order, (const int*)neg_range, (float*)loss,     \
                (float*)gu, (float*)gi, (float*)gni, (float4*)f,                \
                (float2*)(f + 4 * b), (float2*)(f + 6 * b),                     \
                (float2*)(f + 8 * b), (int*)ints, b, d, u_pad, i_pad, kneg,     \
                scale, c1, coeff_d)
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
