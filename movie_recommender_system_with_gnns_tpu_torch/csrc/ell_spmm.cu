// LightGCN propagation out = A_hat · E over one degree bucket of an ELL
// adjacency, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// movie_recommender_system_with_gnns_tpu/ops/pallas_spmm.py::_onehot_spmm_kernel
// (called through _ell_block_call and spmm_ell_pallas).
//
// What it computes, for every row r of the bucket (rows x width slots):
//   out[node_ids[r], :] = sum_s  w[r, s] * emb[nbr[r, s], :]
// over the slots whose neighbour id is not the padding id num_nodes. A row's
// neighbours come first and its padding after them (EllGraph.build writes
// them so, and DeviceELL.from_host checks it), so a row is read only up to
// its first padding id. Products and sums are exact f32 whatever the table
// type (f32 or bf16); the result is rounded once to the table type. Rows
// whose node id is num_nodes pad the bucket and are skipped. Writing straight
// to out[node_ids[r]] restores node order, so no inverse-permutation pass
// follows.
//
// Design. The TPU kernel turns the sparse product into dense matrix-unit work
// (a one-hot densification of every 128-column chunk, an unroll bound on the
// width, a node cap) because Mosaic has no row gather. None of that is
// carried over: a GPU gathers rows directly. A "group" of G lanes (G = the
// power of two that covers one table row in 16-byte or 8-byte vector loads,
// at most a warp) owns one ELL slot at a time: it reads the slot's neighbour
// id and weight (a broadcast load), gathers the neighbour's row with
// coalesced vector loads and accumulates w * row in registers. A block of 256
// threads holds 256 / G groups; the launch gives each row `gpr` of them (one
// per kSlotsPerGroup slots of the bucket's width: 1 for the narrow buckets,
// so a block covers many rows; all of them for the wide buckets, so that a
// row of tens of thousands of slots is shared by the whole block instead of
// serialising on one warp). Four slots are in flight
// per group to hide gather latency. The groups' partial rows meet in shared
// memory and are summed in a fixed order, so the result is deterministic.
// On a power-law graph the widest bucket holds a handful of rows of up to a
// hundred thousand slots: one block per row would leave most of the card
// idle, so the caller may split every row of a bucket into `split` slot
// segments, one block each (blockIdx.y); their partial rows go to an f32
// scratch buffer and a second small kernel sums them, again in a fixed order.
// d need not be a multiple of 4: such tables take the scalar-load variant.
//
// Bound on this card: bytes. A hop must read every true edge's slot (8 bytes:
// id and weight) and the one padding id that ends a row, read the table once
// and write it once; the arithmetic is 2 d operations per true edge. The
// padding behind a row's first padding id (more than half of the slots on a
// power-law graph) is not needed and not read. With every gather charged
// instead (d * 4 bytes per edge) the traffic is over ten times larger, but
// the table of the full graph (57 MB at d = 64) nearly fits the 50 MB L2, so
// most gathers are L2 hits. What the kernel waits for is gather latency; rows are independent,
// so occupancy and the four loads in flight hide it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // slots in flight per group
// Slots of a row per group of lanes: a row of `width` slots is shared by
// width / kSlotsPerGroup groups, at most the block's.
constexpr int kSlotsPerGroup = 128;

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
};

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// G lanes per group (power of two <= 32), NV vectors of VEC elements per lane:
// d <= G * NV * VEC. gpr groups share one row (power of two <= kThreads / G).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const T* __restrict__ emb, const int* __restrict__ nbr,
                const float* __restrict__ w, const int* __restrict__ node_ids,
                T* __restrict__ out, float* __restrict__ scratch, int64_t rows,
                int width, int d, int num_nodes, int G, int gpr, int seg_len) {
  extern __shared__ float part[];            // (kThreads / G) x d partial rows
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int rows_per_block = (kThreads / G) / gpr;
  const int g_in = group % gpr;
  const int64_t row = (int64_t)blockIdx.x * rows_per_block + group / gpr;
  const int dv = d / VEC;
  const int split = gridDim.y;               // slot segments per row
  const int s_begin = blockIdx.y * seg_len;
  const int s_end = min(width, s_begin + seg_len);

  float acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[v][i] = 0.0f;

  if (row < rows) {
    const int* nb = nbr + row * width;
    const float* wr = w + row * width;
    for (int s0 = s_begin + g_in; s0 < s_end; s0 += kUnroll * gpr) {
      int id[kUnroll];
      float wt[kUnroll];
      float x[kUnroll][NV][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * gpr;
        id[u] = s < s_end ? __ldg(nb + s) : num_nodes;
        wt[u] = s < s_end ? __ldg(wr + s) : 0.0f;
      }
      if (id[0] == num_nodes) break;   // padding trails: nothing live follows
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = id[u] != num_nodes;       // padding slots are skipped
        const T* e = emb + (int64_t)(live ? id[u] : 0) * d;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = lane + v * G;
          if (live && c < dv) {
            Vec<T, VEC>::load(e + c * VEC, x[u][v]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) x[u][v][i] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[v][i] = fmaf(wt[u], x[u][v][i], acc[v][i]);
    }
  }

  float* mine = part + (int64_t)group * d;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + v * G;
    if (c < dv) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) mine[c * VEC + i] = acc[v][i];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rows_per_block * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int64_t row2 = (int64_t)blockIdx.x * rows_per_block + r;
    if (row2 >= rows) break;
    const int node = node_ids[row2];
    if (node >= num_nodes || node < 0) continue;      // a row that pads the bucket
    const float* p = part + (int64_t)r * gpr * d + c;
    float sum = 0.0f;
    for (int g = 0; g < gpr; ++g) sum += p[(int64_t)g * d];
    if (split == 1) {
      store_one(out + (int64_t)node * d + c, sum);
    } else {
      scratch[(row2 * split + blockIdx.y) * d + c] = sum;
    }
  }
}

// Second pass of a split bucket: out[node_ids[r]] = sum over the row's segments.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_reduce_kernel(const float* __restrict__ scratch, const int* __restrict__ node_ids,
                  T* __restrict__ out, int64_t rows, int d, int num_nodes, int split) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= rows * d) return;
  const int64_t r = idx / d;
  const int c = (int)(idx - r * d);
  const int node = node_ids[r];
  if (node >= num_nodes || node < 0) return;
  const float* p = scratch + r * split * d + c;
  float sum = 0.0f;
  for (int sgm = 0; sgm < split; ++sgm) sum += p[(int64_t)sgm * d];
  store_one(out + (int64_t)node * d + c, sum);
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename T, int VEC>
cudaError_t launch(const void* emb, const void* nbr, const void* w,
                   const void* node_ids, void* out, void* scratch, int64_t rows,
                   int width, int d, int num_nodes, int split, cudaStream_t stream) {
  const int dv = d / VEC;
  const int G = dv >= 32 ? 32 : pow2_at_least(dv);
  const int nv = pow2_at_least((dv + G - 1) / G);
  const int groups = kThreads / G;
  // one group per kSlotsPerGroup slots of a row, at most the whole block
  int gpr = 1;
  while (gpr * 2 <= groups && gpr * 2 * kSlotsPerGroup <= width) gpr *= 2;
  const int rows_per_block = groups / gpr;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL || split < 1 || split > 65535) return cudaErrorInvalidValue;
  if (split > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  const int seg_len = (width + split - 1) / split;
  const dim3 grid((unsigned)blocks, (unsigned)split);
  const size_t smem = (size_t)groups * d * sizeof(float);
#define ELL_LAUNCH(NV)                                                          \
  ell_spmm_kernel<T, VEC, NV><<<grid, kThreads, smem, stream>>>(                \
      (const T*)emb, (const int*)nbr, (const float*)w, (const int*)node_ids,    \
      (T*)out, (float*)scratch, rows, width, d, num_nodes, G, gpr, seg_len)
  switch (nv) {
    case 1: ELL_LAUNCH(1); break;
    case 2: ELL_LAUNCH(2); break;
    case 4: ELL_LAUNCH(4); break;
    case 8:       // only the scalar-load variant needs more than 4 per lane
      if constexpr (VEC == 1) { ELL_LAUNCH(8); break; }
      return cudaErrorInvalidValue;
    case 16:
      if constexpr (VEC == 1) { ELL_LAUNCH(16); break; }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef ELL_LAUNCH
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  const int64_t cells = rows * d;
  ell_reduce_kernel<T><<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      (const float*)scratch, (const int*)node_ids, (T*)out, rows, d, num_nodes, split);
  return cudaGetLastError();
}

}  // namespace

// One bucket: emb (num_nodes, d) and out (num_nodes, d) of the same type (f32,
// or bf16 when bf16 != 0), nbr (rows, width) int32, w (rows, width) f32,
// node_ids (rows,) int32. split >= 1 slot segments per row; with split > 1,
// scratch holds rows * split * d floats. Writes out[node_ids[r]] for every
// row that does not pad the bucket; never synchronizes. Returns the
// cudaError_t of the launch.
extern "C" int ell_spmm(const void* emb, const void* nbr, const void* w,
                        const void* node_ids, void* out, void* scratch,
                        int64_t rows, int width, int d, int num_nodes,
                        int split, int bf16, void* stream) {
  if (rows <= 0 || width <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 512) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t vec_bytes = bf16 ? 8 : 16;
  const bool vec4 = d % 4 == 0 && (uintptr_t)emb % vec_bytes == 0;
  cudaError_t e;
  if (bf16) {
    e = vec4 ? launch<__nv_bfloat16, 4>(emb, nbr, w, node_ids, out, scratch, rows, width, d, num_nodes, split, s)
             : launch<__nv_bfloat16, 1>(emb, nbr, w, node_ids, out, scratch, rows, width, d, num_nodes, split, s);
  } else {
    e = vec4 ? launch<float, 4>(emb, nbr, w, node_ids, out, scratch, rows, width, d, num_nodes, split, s)
             : launch<float, 1>(emb, nbr, w, node_ids, out, scratch, rows, width, d, num_nodes, split, s);
  }
  return (int)e;
}

extern "C" const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
