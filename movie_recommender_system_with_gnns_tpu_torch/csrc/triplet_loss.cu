// Fused triplet loss of the whole-graph trainers, forward and backward, for
// sm_90a.
//
// Replaces no TPU kernel. The JAX package writes this loss as array code
// (ops/bpr.py::bpr_loss_standard over the rows that training/train.py::
// compute_embeddings gathers) and leaves its fusion to XLA. Eager PyTorch
// runs that code operator by operator: it gathers every triplet's rows into
// copies, writes each (B, K, d) product, square and sum to device memory, and
// autograd writes as many again, plus full-size zero buffers for the slices'
// backward. This pair reads the rows straight from the four tables by index
// and writes only what the row sums after it need.
//
// What it computes, for B triplets (user u_b, positive p_b, negatives n_bk,
// k < K) with a mask, from the final tables UF, IF and the layer-0 tables UE,
// IE (rows of d floats):
//   x_bk = <UF[u_b], IF[n_bk]> - <UF[u_b], IF[p_b]>
//   loss = sum_{b valid} sum_k softplus(x_bk) / (K C)
//        + coeff sum_{b valid} (|UE[u_b]|^2 + |IE[p_b]|^2
//                               + sum_k |IE[n_bk]|^2 / K) / Cd
// with count the valid triplets, C = max(count, 1) and Cd = max(count d, 1):
// ops/bpr.py::bpr_loss_standard. softplus and its derivative are PyTorch's
// (threshold 20), from one precise expf a pair.
//   triplet_fwd_kernel: sig (B, K) = sigma(x_bk), 0 for a masked triplet,
//     and one partial (pair sum, square sum, count) a block;
//   triplet_sum_kernel (one block): the partials added in a fixed order, the
//     loss and (K C, Cd) written to device memory, so nothing waits on the
//     host;
//   triplet_bwd_kernel: with ct the upstream scalar, read from device memory,
//     a_k = ct sig_bk / (K C), a_p = -sum_k a_k, r = 2 coeff ct / Cd (0 for a
//     masked triplet), the gradient of every row occurrence:
//       g_uf[b] = a_p IF[p_b] + sum_k a_k IF[n_bk]     g_ue[b] = r UE[u_b]
//       g_if[b] = a_p UF[u_b]                          g_ie[b] = r IE[p_b]
//       g_if[B + b K + k] = a_k UF[u_b]                g_ie[B + b K + k] = r / K IE[n_bk]
//     the layout of the gathered rows they replace (positives, then the
//     negatives flattened), which ops/cuda_scatter.py::sorted_index_add sums
//     into table rows over the users' and the items' lists.
// No float is summed by atomics and nothing depends on the scheduling of
// blocks: two calls on the same inputs give bit-equal outputs.
//
// Design. A group of G lanes takes a triplet (G = d / 4 up to 32), each lane
// holding d / G consecutive-by-chunk floats of a row as 16-byte loads, so a
// warp takes 32 / G triplets at a time and a group's load of one chunk is G
// consecutive float4. In the forward the K negative rows of a group of up
// to 8 are loaded together, so a lane has up to K + 2 row chunks in flight;
// the backward takes them one at a time. A block of 8 warps takes kRounds
// rounds of triplets. Dots are reduced by xor shuffles
// inside the group (every lane ends with the same bits), so a masked triplet
// is computed on row 0 and only its results are dropped. The gradient
// buffers are written with streaming stores: they exceed L2 and are read
// once, by the row sums.
//
// Bound on this card. Per valid triplet the forward reads 2 (K + 2) rows
// (4 d bytes each), the backward reads them again and writes 2 (K + 2)
// gradient rows; at the flagship's cell (B 349,184, K 8, d 256) that is
// 7.2 GB read by each and 7.2 GB written, about 6.4 ms at 3.35 TB/s. Its
// compulsory part is smaller: each distinct table row read once (the
// popularity negatives repeat hot items, which L2 keeps), the indices, sig,
// and the gradient buffers written once, about 7.7 GB, 2.3 ms. The
// arithmetic (about 6 d (K + 2) flops a triplet) is far below either.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRounds = 4;   // rounds of triplets a warp takes in a block

// Row width D: G lanes a triplet, C float4 chunks a lane, PER triplets a
// warp at a time, BLOCK triplets a block, R float4 a row.
template <int D>
struct Shape {
  static constexpr int G = D / 4 < 32 ? D / 4 : 32;
  static constexpr int C = D / (4 * G);
  static constexpr int PER = 32 / G;
  static constexpr int BLOCK = kWarps * PER * kRounds;
  static constexpr int R = D / 4;
};

// Sum over the G lanes of a lane group; every lane gets the same bits (each
// step adds the same two values in either order).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 scale4(float s, float4 a) {
  return make_float4(s * a.x, s * a.y, s * a.z, s * a.w);
}

__device__ __forceinline__ float4 fma4(float s, float4 a, float4 acc) {
  return make_float4(fmaf(s, a.x, acc.x), fmaf(s, a.y, acc.y), fmaf(s, a.z, acc.z),
                     fmaf(s, a.w, acc.w));
}

// Forward. KG: negatives a group whose loads are issued together (1 or 8;
// K need not be a multiple: the rest of a group reads row 0 and is dropped).
template <int D, int KG>
__global__ void __launch_bounds__(kThreads)
triplet_fwd_kernel(const float4* __restrict__ uf_tab, const float4* __restrict__ if_tab,
                   const float4* __restrict__ ue_tab, const float4* __restrict__ ie_tab,
                   const int64_t* __restrict__ user, const int64_t* __restrict__ pos,
                   const int64_t* __restrict__ neg, const uint8_t* __restrict__ mask,
                   float* __restrict__ sig, float4* __restrict__ part, int64_t b, int k) {
  using S = Shape<D>;
  const int lane = threadIdx.x & 31;
  const int sub = lane % S::G;
  const int warp = threadIdx.x >> 5;
  float pair_acc = 0.f, sq_acc = 0.f;
  int count = 0;

  for (int round = 0; round < kRounds; ++round) {
    const int64_t t = (int64_t)blockIdx.x * S::BLOCK + (round * kWarps + warp) * S::PER +
                      lane / S::G;
    const bool in_range = t < b;
    const bool valid = in_range && mask[t] != 0;
    const int64_t u = valid ? user[t] : 0;
    const int64_t p = valid ? pos[t] : 0;

    float4 uf[S::C];
    float dp = 0.f, q = 0.f;
#pragma unroll
    for (int c = 0; c < S::C; ++c) {
      uf[c] = __ldg(uf_tab + u * S::R + sub + S::G * c);
      const float4 pf = __ldg(if_tab + p * S::R + sub + S::G * c);
      const float4 ue = __ldg(ue_tab + u * S::R + sub + S::G * c);
      const float4 pe = __ldg(ie_tab + p * S::R + sub + S::G * c);
      dp = dot4(uf[c], pf, dp);
      q = dot4(ue, ue, q);
      q = dot4(pe, pe, q);
    }
    const float pos_dot = group_sum<S::G>(dp);

    float pair = 0.f, qn = 0.f;
    for (int k0 = 0; k0 < k; k0 += KG) {
      int64_t n[KG];
#pragma unroll
      for (int j = 0; j < KG; ++j)
        n[j] = (valid && k0 + j < k) ? neg[t * k + k0 + j] : 0;
      float dn[KG];
#pragma unroll
      for (int j = 0; j < KG; ++j) dn[j] = 0.f;
#pragma unroll
      for (int c = 0; c < S::C; ++c) {
#pragma unroll
        for (int j = 0; j < KG; ++j)
          dn[j] = dot4(uf[c], __ldg(if_tab + n[j] * S::R + sub + S::G * c), dn[j]);
      }
#pragma unroll
      for (int c = 0; c < S::C; ++c) {
#pragma unroll
        for (int j = 0; j < KG; ++j) {
          if (k0 + j < k) {
            const float4 ne = __ldg(ie_tab + n[j] * S::R + sub + S::G * c);
            qn = dot4(ne, ne, qn);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const float x = group_sum<S::G>(dn[j]) - pos_dot;
        if (k0 + j < k) {
          const float z = expf(x);
          const bool big = x > 20.f;
          pair += big ? x : log1pf(z);
          if (in_range && sub == j) sig[t * k + k0 + j] = valid ? (big ? 1.f : z / (z + 1.f)) : 0.f;
        }
      }
    }
    const float sq = group_sum<S::G>(q) + group_sum<S::G>(qn) / (float)k;
    if (valid) {
      pair_acc += pair;
      sq_acc += sq;
      count += 1;
    }
  }

  // One value a group (its lanes hold the same bits): add the groups of a
  // warp, then the warps in order.
#pragma unroll
  for (int o = 16; o >= S::G; o >>= 1) {
    pair_acc += __shfl_xor_sync(0xffffffffu, pair_acc, o);
    sq_acc += __shfl_xor_sync(0xffffffffu, sq_acc, o);
    count += __shfl_xor_sync(0xffffffffu, count, o);
  }
  __shared__ float s_pair[kWarps], s_sq[kWarps];
  __shared__ int s_count[kWarps];
  if (lane == 0) {
    s_pair[warp] = pair_acc;
    s_sq[warp] = sq_acc;
    s_count[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ps = 0.f, qs = 0.f;
    int cs = 0;
    for (int w = 0; w < kWarps; ++w) {
      ps += s_pair[w];
      qs += s_sq[w];
      cs += s_count[w];
    }
    part[blockIdx.x] = make_float4(ps, qs, __int_as_float(cs), 0.f);
  }
}

// One block: the partials added in a fixed order (strided per thread, then a
// fixed tree); out = (loss, K C, Cd).
__global__ void __launch_bounds__(kThreads)
triplet_sum_kernel(const float4* __restrict__ part, int64_t parts, int k, int d,
                   float coeff, float* __restrict__ out) {
  __shared__ float s_pair[kThreads], s_sq[kThreads];
  __shared__ long long s_count[kThreads];
  float ps = 0.f, qs = 0.f;
  long long cs = 0;
  for (int64_t i = threadIdx.x; i < parts; i += kThreads) {
    const float4 v = part[i];
    ps += v.x;
    qs += v.y;
    cs += __float_as_int(v.z);
  }
  s_pair[threadIdx.x] = ps;
  s_sq[threadIdx.x] = qs;
  s_count[threadIdx.x] = cs;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s_pair[threadIdx.x] += s_pair[threadIdx.x + s];
      s_sq[threadIdx.x] += s_sq[threadIdx.x + s];
      s_count[threadIdx.x] += s_count[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long long n = s_count[0];
    const float kc = (float)k * (float)(n > 0 ? n : 1);
    const float cd = fmaxf((float)(n * (long long)d), 1.f);
    out[0] = s_pair[0] / kc + coeff * (s_sq[0] / cd);
    out[1] = kc;
    out[2] = cd;
  }
}

// Backward: every gradient row of the B (K + 2) occurrences of each kind
// written once, zeros for a masked triplet (whose rows are not read). The
// negatives are taken one at a time: holding a group's rows as the forward
// does took 158 registers at d 256 (one block an SM) and 1.3 times as long.
template <int D>
__global__ void __launch_bounds__(kThreads)
triplet_bwd_kernel(const float4* __restrict__ uf_tab, const float4* __restrict__ if_tab,
                   const float4* __restrict__ ue_tab, const float4* __restrict__ ie_tab,
                   const int64_t* __restrict__ user, const int64_t* __restrict__ pos,
                   const int64_t* __restrict__ neg, const uint8_t* __restrict__ mask,
                   const float* __restrict__ sig, const float* __restrict__ stats,
                   const float* __restrict__ ct, float4* __restrict__ g_uf,
                   float4* __restrict__ g_ue, float4* __restrict__ g_if,
                   float4* __restrict__ g_ie, int64_t b, int k, float coeff) {
  using S = Shape<D>;
  const int lane = threadIdx.x & 31;
  const int sub = lane % S::G;
  const int warp = threadIdx.x >> 5;
  const float g = *ct;
  const float a_scale = g / stats[0];
  const float r = 2.f * coeff * g / stats[1];
  const float r_neg = r / (float)k;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int round = 0; round < kRounds; ++round) {
    const int64_t t = (int64_t)blockIdx.x * S::BLOCK + (round * kWarps + warp) * S::PER +
                      lane / S::G;
    if (t >= b) continue;
    float4* guf = g_uf + t * S::R + sub;
    float4* gue = g_ue + t * S::R + sub;
    float4* gpf = g_if + t * S::R + sub;
    float4* gpe = g_ie + t * S::R + sub;
    float4* gnf = g_if + (b + t * k) * S::R + sub;
    float4* gne = g_ie + (b + t * k) * S::R + sub;
    if (mask[t] == 0) {
#pragma unroll
      for (int c = 0; c < S::C; ++c) {
        __stcs(guf + S::G * c, zero);
        __stcs(gue + S::G * c, zero);
        __stcs(gpf + S::G * c, zero);
        __stcs(gpe + S::G * c, zero);
      }
      for (int j = 0; j < k; ++j) {
#pragma unroll
        for (int c = 0; c < S::C; ++c) {
          __stcs(gnf + j * S::R + S::G * c, zero);
          __stcs(gne + j * S::R + S::G * c, zero);
        }
      }
      continue;
    }
    const int64_t u = user[t];
    const int64_t p = pos[t];
    float a_p = 0.f;
    for (int j = 0; j < k; ++j) a_p += sig[t * k + j] * a_scale;
    a_p = -a_p;

    float4 uf[S::C], acc[S::C];
#pragma unroll
    for (int c = 0; c < S::C; ++c) {
      uf[c] = __ldg(uf_tab + u * S::R + sub + S::G * c);
      acc[c] = scale4(a_p, __ldg(if_tab + p * S::R + sub + S::G * c));
    }
    for (int j = 0; j < k; ++j) {
      const int64_t n = neg[t * k + j];
      const float a = sig[t * k + j] * a_scale;
      float4 nf[S::C];
#pragma unroll
      for (int c = 0; c < S::C; ++c) nf[c] = __ldg(if_tab + n * S::R + sub + S::G * c);
#pragma unroll
      for (int c = 0; c < S::C; ++c) {
        acc[c] = fma4(a, nf[c], acc[c]);
        __stcs(gnf + j * S::R + S::G * c, scale4(a, uf[c]));
      }
    }
#pragma unroll
    for (int c = 0; c < S::C; ++c) {
      __stcs(guf + S::G * c, acc[c]);
      __stcs(gpf + S::G * c, scale4(a_p, uf[c]));
      __stcs(gue + S::G * c, scale4(r, __ldg(ue_tab + u * S::R + sub + S::G * c)));
      __stcs(gpe + S::G * c, scale4(r, __ldg(ie_tab + p * S::R + sub + S::G * c)));
    }
    for (int j = 0; j < k; ++j) {
      const int64_t n = neg[t * k + j];
      float4 ne[S::C];
#pragma unroll
      for (int c = 0; c < S::C; ++c) ne[c] = __ldg(ie_tab + n * S::R + sub + S::G * c);
#pragma unroll
      for (int c = 0; c < S::C; ++c) __stcs(gne + j * S::R + S::G * c, scale4(r_neg, ne[c]));
    }
  }
}

struct Args {
  const float4 *uf, *itf, *ue, *ite;
  const int64_t *user, *pos, *neg;
  const uint8_t* mask;
  int64_t b;
  int k;
};

template <int D>
int64_t blocks_of(int64_t b) {
  return (b + Shape<D>::BLOCK - 1) / Shape<D>::BLOCK;
}

int64_t blocks_for(int64_t b, int d) {
  switch (d) {
    case 32: return blocks_of<32>(b);
    case 64: return blocks_of<64>(b);
    case 128: return blocks_of<128>(b);
    case 256: return blocks_of<256>(b);
    default: return blocks_of<512>(b);
  }
}

template <int D, int KG>
cudaError_t fwd(const Args& a, float* sig, float4* part, cudaStream_t s) {
  const int64_t blocks = blocks_of<D>(a.b);
  if (blocks > 0)
    triplet_fwd_kernel<D, KG><<<(unsigned)blocks, kThreads, 0, s>>>(
        a.uf, a.itf, a.ue, a.ite, a.user, a.pos, a.neg, a.mask, sig, part, a.b, a.k);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const Args& a, const float* sig, const float* stats, const float* ct,
                float4* g_uf, float4* g_ue, float4* g_if, float4* g_ie, float coeff,
                cudaStream_t s) {
  const int64_t blocks = blocks_of<D>(a.b);
  if (blocks > 0)
    triplet_bwd_kernel<D><<<(unsigned)blocks, kThreads, 0, s>>>(
        a.uf, a.itf, a.ue, a.ite, a.user, a.pos, a.neg, a.mask, sig, stats, ct, g_uf, g_ue,
        g_if, g_ie, a.b, a.k, coeff);
  return cudaGetLastError();
}


bool supported(int d) { return d == 32 || d == 64 || d == 128 || d == 256 || d == 512; }

}  // namespace

// Partials (float4, 16 bytes each) the forward needs for b triplets at width d.
extern "C" int64_t triplet_fwd_parts(int64_t b, int d) {
  return supported(d) && b > 0 ? blocks_for(b, d) : 0;
}

// Forward. Tables (rows, d) f32, contiguous and 16-byte aligned: uf, itf
// (final users, items), ue, ite (layer 0); user, pos (b) and neg (b, k)
// int64 rows; mask (b) bytes; sig (b, k) f32 and part (triplet_fwd_parts
// float4) written in full, out (3 f32) = (loss, K C, Cd). d one of 32, 64,
// 128, 256, 512. Returns the first failed call's cudaError_t (0 on
// success); never synchronizes.
extern "C" int triplet_fwd(const void* uf, const void* itf, const void* ue, const void* ite,
                           const void* user, const void* pos, const void* neg,
                           const void* mask, void* sig, void* part, void* out, int64_t b,
                           int k, int d, float coeff, void* stream) {
  if (b < 0 || k <= 0 || !supported(d)) return (int)cudaErrorInvalidValue;
  const Args a{(const float4*)uf, (const float4*)itf, (const float4*)ue, (const float4*)ite,
               (const int64_t*)user, (const int64_t*)pos, (const int64_t*)neg,
               (const uint8_t*)mask, b, k};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  const bool one = k == 1;
#define FWD(D) (one ? fwd<D, 1>(a, (float*)sig, (float4*)part, s) \
                    : fwd<D, 8>(a, (float*)sig, (float4*)part, s))
  switch (d) {
    case 32: e = FWD(32); break;
    case 64: e = FWD(64); break;
    case 128: e = FWD(128); break;
    case 256: e = FWD(256); break;
    default: e = FWD(512); break;
  }
#undef FWD
  if (e != cudaSuccess) return (int)e;
  triplet_sum_kernel<<<1, kThreads, 0, s>>>((const float4*)part, blocks_for(b, d), k, d,
                                            coeff, (float*)out);
  return (int)cudaGetLastError();
}

// Backward. As triplet_fwd for the tables, indices and mask; sig and stats
// (= out[1:3]) from the forward, ct the upstream scalar (1 f32), all on the
// device. g_uf, g_ue (b, d) and g_if, g_ie (b (1 + k), d) written in full.
extern "C" int triplet_bwd(const void* uf, const void* itf, const void* ue, const void* ite,
                           const void* user, const void* pos, const void* neg,
                           const void* mask, const void* sig, const void* stats,
                           const void* ct, void* g_uf, void* g_ue, void* g_if, void* g_ie,
                           int64_t b, int k, int d, float coeff, void* stream) {
  if (b < 0 || k <= 0 || !supported(d)) return (int)cudaErrorInvalidValue;
  const Args a{(const float4*)uf, (const float4*)itf, (const float4*)ue, (const float4*)ite,
               (const int64_t*)user, (const int64_t*)pos, (const int64_t*)neg,
               (const uint8_t*)mask, b, k};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define BWD(D)                                                                     \
  bwd<D>(a, (const float*)sig, (const float*)stats, (const float*)ct, (float4*)g_uf, \
         (float4*)g_ue, (float4*)g_if, (float4*)g_ie, coeff, s)
  switch (d) {
    case 32: e = BWD(32); break;
    case 64: e = BWD(64); break;
    case 128: e = BWD(128); break;
    case 256: e = BWD(256); break;
    default: e = BWD(512); break;
  }
#undef BWD
  return (int)e;
}

extern "C" const char* triplet_loss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
