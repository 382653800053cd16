// LightGCN propagation out = A_hat · E over every degree bucket of an ELL
// adjacency in one persistent launch, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// movie_recommender_system_with_gnns_tpu/ops/pallas_spmm.py::_onehot_spmm_kernel
// (called through _ell_block_call and spmm_ell_pallas).
//
// What it computes, for every row r of every bucket (rows x width slots):
//   out[node_ids[r], :] = sum_s  w[r, s] * emb[nbr[r, s], :]
// over the slots whose neighbour id is not the padding id num_src, the row
// count of the table emb (num_src x d), which may differ from the row count
// of out (num_nodes x d): a shard of the sharded hybrid remainder sums its
// local rows from the all-gathered table. A row's neighbours come first and
// its padding after them (EllGraph.build writes them so, and
// DeviceELL.from_host checks it), so a row is read only up to its first
// padding id. Products and sums are exact f32 whatever the table type (f32
// or bf16); the result is rounded once to the table type. Rows whose node id
// is num_nodes pad a bucket and are never scheduled (the host drops them from
// the work list), so the kernel itself never reads num_nodes. Writing
// straight to out[node_ids[r]] restores node order, so no inverse-permutation
// pass follows.
//
// Design. The TPU kernel turns the sparse product into dense matrix-unit work
// (a one-hot densification of every 128-column chunk) because Mosaic has no
// row gather; a GPU gathers rows directly, so none of that is carried over.
//
//  * One launch per hop over a work list (ops/cuda_spmm.py::ell_schedule,
//    built once per graph on the host). An item is either a run of whole rows
//    of one bucket or one slot segment of a row too wide for one item; items
//    hold about the same number of live slots. The buckets stay as
//    EllGraph.build lays them out: the launch carries each bucket's pointers
//    and width as kernel parameters.
//  * The grid is persistent (the SM count times the blocks an SM holds). Each
//    warp takes the next item from a counter (an integer atomicAdd) until the
//    list is spent; the warp that draws the last ticket resets the counter,
//    so it is zero before every call without a memset.
//  * A warp walks its rows 32 slots at a time: one coalesced load gives each
//    lane one slot's id and weight (with an evict-first hint, so the slots,
//    read once, do not push table rows out of the L2), and the next chunk's
//    load starts before the current chunk's gathers. A "group" of G lanes
//    (G = the power of two that covers one table row in 16-byte or 8-byte
//    vector loads, at most a warp) takes every (32 / G)-th slot of the chunk;
//    the ids reach it by __shfl_sync, and it starts K row gathers before it
//    uses any of them. The groups' partial rows are summed by a fixed
//    __shfl_xor_sync tree, so a row's sum has one order in every run.
//  * A segment writes its partial row to an f32 scratch row. The warp that
//    finishes a row's last segment (an integer atomicAdd on the row's counter,
//    after a __threadfence) sums the row's partials in segment order, writes
//    out[node], and resets the counter. Integer atomics decide who sums, never
//    in what order: the result is bit-equal from run to run. No float atomic.
//  * The list sweeps one side of a bipartite graph before the other (rows that
//    read higher ids, then rows that read lower ids: users, then items), so
//    the L2 holds one side's table at a time.
//  * d need not be a multiple of 4: such tables (or tables not aligned for
//    vector loads) take the scalar-load instantiation of the same kernel.
//
// Bound on this card: bytes. A hop must read every true edge's slot (8 bytes:
// id and weight) and the one padding id that ends a row, read the table once
// and write the result once; the arithmetic is 2 d operations per true edge.
// The padding behind a row's first padding id is not read. Each gather reads a
// whole table row (d * 4 bytes per edge), over ten times those bytes, but the
// table of the full graph (57 MB at d = 64) nearly fits the 50 MB L2, so most
// gathers are L2 hits: the L2's rate and the gathers in flight set the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Warps share nothing, so a block is two of them: an SM then holds as many
// warps as its registers allow.
constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuckets = 32;
constexpr unsigned kFull = 0xffffffffu;
// Registers per lane for one batch of gathered rows: a group keeps
// K = kGatherRegs / (NV * VEC) gathers in flight (4 at d = 64). Fewer
// registers leave room for more warps, which hide the L2's latency better
// than more gathers per warp do (PERF.md: the tuning of B4).
constexpr int kGatherRegs = 16;
// Slot ids and weights are read once: load them evict-first, so that they
// do not push table rows out of the L2.
constexpr bool kSlotHint = true;

struct Buckets {
  const int* nbr[kMaxBuckets];
  const float* w[kMaxBuckets];
  const int* node_ids[kMaxBuckets];
  int width[kMaxBuckets];
};

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&a),
                                              *reinterpret_cast<const unsigned*>(&b));
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16(v[0]);
  }
};

// Partial rows in the f32 scratch: written by one warp, read by another
// through the L2 (ld.global.cg: never a stale L1 line).
template <int VEC>
struct Partial;

template <>
struct Partial<4> {
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

template <>
struct Partial<1> {
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldcg(p); }
};

template <typename U>
__device__ __forceinline__ U load_slot(const U* p) {
  if constexpr (kSlotHint) return __ldcs(p);
  else return __ldg(p);
}

// What one warp needs to walk rows: the table, its layout and the lane roles.
template <typename T, int VEC, int NV>
struct Walker {
  static constexpr int K = (kGatherRegs / (NV * VEC)) < 2 ? 2
                         : (kGatherRegs / (NV * VEC)) > 16 ? 16
                         : kGatherRegs / (NV * VEC);
  const T* emb;
  int d, dv, num_src, G, ng, g, gl, lane;

  // The slot ids and weights of slots [c, c + 32) of one row (cut at `end`),
  // one slot per lane; slots past `end` read as padding.
  __device__ __forceinline__ void load_chunk(const int* nb, const float* wr, int c, int end,
                                             int& id, float& wt) const {
    const int s = c + lane;
    if (s < end) {
      id = load_slot(nb + s);
      wt = load_slot(wr + s);
    } else {
      id = num_src;
      wt = 0.0f;
    }
  }

  // acc += w * emb[id] over the live slots of one chunk (bit u of `live`):
  // group g takes slots g, g + ng, g + 2 ng, ... in that order, K at a time.
  __device__ __forceinline__ void gather(int id, float wt, unsigned live,
                                         float (&acc)[NV][VEC]) const {
    const int top = live ? 32 - __clz(live) : 0;      // one past the last live slot
    for (int u0 = 0; u0 < top; u0 += ng * K) {
      float sw[K];
      float x[K][NV][VEC];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int u = u0 + k * ng + g;
        const int sid = __shfl_sync(kFull, id, u & 31);
        const float swt = __shfl_sync(kFull, wt, u & 31);
        const bool ok = u < 32 && ((live >> (u & 31)) & 1u);
        sw[k] = ok ? swt : 0.0f;
        const T* e = emb + (int64_t)(ok ? sid : 0) * d;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = gl + v * G;
          if (ok && c < dv) {
            Vec<T, VEC>::load(e + c * VEC, x[k][v]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) x[k][v][i] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[v][i] = fmaf(sw[k], x[k][v][i], acc[v][i]);
    }
  }

  // Sum the groups' partial rows into every lane, by a fixed tree.
  __device__ __forceinline__ void combine(float (&acc)[NV][VEC]) const {
    for (int off = 16; off >= G; off >>= 1)
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[v][i] += __shfl_xor_sync(kFull, acc[v][i], off);
  }

  // Slots [s0, s1) of rows r0 .. r1 - 1 (stride `width`), each row up to its
  // first padding id; calls done(node, acc) with each row's sum in every lane
  // and its node id (ids[r], loaded with the row's first chunk; -1 without ids).
  template <typename Done>
  __device__ __forceinline__ void walk(const int* nbr, const float* w, int width,
                                       const int* ids, int r0, int r1, int s0, int s1,
                                       Done done) const {
    int r = r0;
    int c = s0;
    int id;
    float wt;
    load_chunk(nbr + (int64_t)r * width, w + (int64_t)r * width, c, s1, id, wt);
    int node = ids ? __ldg(ids + r) : -1;
    float acc[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[v][i] = 0.0f;
    while (true) {
      const unsigned live = __ballot_sync(kFull, id != num_src);
      const bool row_done = live != kFull || c + 32 >= s1;
      const int nr = row_done ? r + 1 : r;
      const int nc = row_done ? s0 : c + 32;
      int nid = num_src;
      float nwt = 0.0f;
      int nnode = node;
      if (nr < r1) {
        load_chunk(nbr + (int64_t)nr * width, w + (int64_t)nr * width, nc, s1, nid, nwt);
        if (row_done && ids) nnode = __ldg(ids + nr);
      }
      gather(id, wt, live, acc);
      if (row_done) {
        combine(acc);
        done(node, acc);
        if (nr >= r1) break;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[v][i] = 0.0f;
      }
      r = nr;
      c = nc;
      id = nid;
      wt = nwt;
      node = nnode;
    }
  }
};

// items: (bucket, row0, row1, 0) for a run of whole rows; (-1 - split row,
// segment, slot0, slot1) for one segment of a split row. split_rows:
// (bucket, row, first scratch row, segments). counters[0] deals the items,
// counters[1 + i] counts split row i's finished segments; all are zero
// between calls. The launch bound names one block an SM: with the block size
// alone, ptxas caps the d = 64 instantiation at 64 registers and spills.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, 1)
ell_spmm_kernel(const T* __restrict__ emb, T* __restrict__ out, const Buckets bk,
                const int4* __restrict__ items, int n_items,
                const int4* __restrict__ split_rows, unsigned* __restrict__ counters,
                float* __restrict__ scratch, int d, int num_src, int G) {
  Walker<T, VEC, NV> wk;
  wk.emb = emb;
  wk.d = d;
  wk.dv = d / VEC;
  wk.num_src = num_src;
  wk.G = G;
  wk.ng = 32 / G;
  wk.lane = threadIdx.x & 31;
  wk.g = wk.lane / G;
  wk.gl = wk.lane % G;
  const int lane = wk.lane;
  // every warp draws tickets until one is past the list: n_items + warps draws
  const unsigned last_ticket = (unsigned)n_items + gridDim.x * kWarps - 1u;

  // row sums of group 0's lanes to out[node] (rounded once to T)
  auto store_row = [&](int node, const float (&acc)[NV][VEC]) {
    if (wk.g != 0) return;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = wk.gl + v * G;
      if (c < wk.dv) Vec<T, VEC>::store(out + (int64_t)node * d + c * VEC, acc[v]);
    }
  };

  // Draw a ticket (lane 0) and hand it to the warp; the draw of the last
  // ticket resets the counter for the next call.
  auto draw = [&]() {
    unsigned t = 0;
    if (lane == 0) {
      t = atomicAdd(counters, 1u);
      if (t == last_ticket) counters[0] = 0u;
    }
    return __shfl_sync(kFull, t, 0);
  };
  const unsigned n = (unsigned)n_items;
  unsigned ticket = draw();
  unsigned next = ticket < n ? draw() : ticket;
  int4 it = ticket < n ? items[ticket] : make_int4(0, 0, 0, 0);
  while (ticket < n) {
    // the ticket after the next is drawn while this item is walked; a warp
    // stops drawing after a ticket past the list, so every warp draws
    // exactly one such ticket
    unsigned after = next;
    if (lane == 0 && next < n) after = atomicAdd(counters, 1u);
    if (it.x >= 0) {
      const int b = it.x;
      wk.walk(bk.nbr[b], bk.w[b], bk.width[b], bk.node_ids[b], it.y, it.z, 0, bk.width[b],
              [&](int node, const float (&acc)[NV][VEC]) { store_row(node, acc); });
    } else {
      const int sr = -1 - it.x;
      const int4 row = split_rows[sr];
      const int seg = it.y;
      float* part = scratch + (int64_t)(row.z + seg) * d;
      wk.walk(bk.nbr[row.x] + (int64_t)row.y * bk.width[row.x],
              bk.w[row.x] + (int64_t)row.y * bk.width[row.x], 0, nullptr, 0, 1, it.z, it.w,
              [&](int, const float (&acc)[NV][VEC]) {
                if (wk.g != 0) return;
#pragma unroll
                for (int v = 0; v < NV; ++v) {
                  const int c = wk.gl + v * G;
                  if (c < wk.dv) Partial<VEC>::store(part + c * VEC, acc[v]);
                }
              });
      __threadfence();     // this segment's partial is visible before it is counted
      __syncwarp();
      unsigned done = 0;
      if (lane == 0) done = atomicAdd(counters + 1 + sr, 1u);
      done = __shfl_sync(kFull, done, 0);
      if (done == (unsigned)row.w - 1u) {
        // the row's last segment: sum every segment's partial in order
        __threadfence();
        float sum[NV][VEC];
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[v][i] = 0.0f;
        const float* first = scratch + (int64_t)row.z * d;
        if (wk.g == 0) {
          constexpr int kBatch = Walker<T, VEC, NV>::K;
          for (int q0 = 0; q0 < row.w; q0 += kBatch) {
            float p[kBatch][NV][VEC];
#pragma unroll
            for (int q = 0; q < kBatch; ++q)
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                const int c = wk.gl + v * G;
                if (q0 + q < row.w && c < wk.dv) {
                  Partial<VEC>::load(first + (int64_t)(q0 + q) * d + c * VEC, p[q][v]);
                } else {
#pragma unroll
                  for (int i = 0; i < VEC; ++i) p[q][v][i] = 0.0f;
                }
              }
#pragma unroll
            for (int q = 0; q < kBatch; ++q)
              if (q0 + q < row.w)
#pragma unroll
                for (int v = 0; v < NV; ++v)
#pragma unroll
                  for (int i = 0; i < VEC; ++i) sum[v][i] += p[q][v][i];
          }
        }
        store_row(bk.node_ids[row.x][row.y], sum);
        if (lane == 0) counters[1 + sr] = 0u;    // ready for the next call
      }
    }
    if (lane == 0 && next < n && after == last_ticket) counters[0] = 0u;
    ticket = next;
    next = __shfl_sync(kFull, after, 0);
    if (ticket < n) it = items[ticket];
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename T, int VEC, int NV>
cudaError_t launch_nv(const void* emb, void* out, const Buckets& bk, const void* items,
                      int n_items, const void* split_rows, void* counters, void* scratch,
                      int d, int num_src, int G, int num_sms, cudaStream_t stream) {
  static int per_sm = 0;      // blocks an SM holds, from the occupancy calculator
  if (per_sm == 0) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ell_spmm_kernel<T, VEC, NV>, kThreads, 0);
    if (e != cudaSuccess) return e;
    per_sm = n > 0 ? n : 1;
  }
  const int64_t want = ((int64_t)n_items + kWarps - 1) / kWarps;
  const int64_t full = (int64_t)num_sms * per_sm;
  const int blocks = (int)(want < full ? want : full);
  ell_spmm_kernel<T, VEC, NV><<<blocks, kThreads, 0, stream>>>(
      (const T*)emb, (T*)out, bk, (const int4*)items, n_items, (const int4*)split_rows,
      (unsigned*)counters, (float*)scratch, d, num_src, G);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch(const void* emb, void* out, const Buckets& bk, const void* items,
                   int n_items, const void* split_rows, void* counters, void* scratch,
                   int d, int num_src, int num_sms, cudaStream_t stream) {
  const int dv = d / VEC;
  const int G = dv >= 32 ? 32 : pow2_at_least(dv);
  const int nv = pow2_at_least((dv + G - 1) / G);
#define ELL_LAUNCH(NV)                                                                  \
  return launch_nv<T, VEC, NV>(emb, out, bk, items, n_items, split_rows, counters,     \
                               scratch, d, num_src, G, num_sms, stream)
  switch (nv) {
    case 1: ELL_LAUNCH(1);
    case 2: ELL_LAUNCH(2);
    case 4: ELL_LAUNCH(4);
    case 8:       // only the scalar-load variant needs more than 4 per lane
      if constexpr (VEC == 1) { ELL_LAUNCH(8); }
      return cudaErrorInvalidValue;
    case 16:
      if constexpr (VEC == 1) { ELL_LAUNCH(16); }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef ELL_LAUNCH
}

}  // namespace

// One hop over every bucket: emb (num_src, d) and out (num_nodes, d) of one
// type (f32, or bf16 when bf16 != 0); num_src is the slots' padding id.
// Bucket b (of nbuckets <= 32) is
// nbr[b] (rows, widths[b]) int32, w[b] (rows, widths[b]) f32 and node_ids[b]
// (rows,) int32. items (n_items, 4) and split_rows (n_split, 4) int32 as the
// kernel documents them; counters (1 + n_split,) uint32, zero before the call
// and zero after it; scratch holds one f32 row of d per segment of a split
// row. Writes out[node_ids[r]] for every scheduled row; never
// synchronizes. Returns the cudaError_t of the launch.
extern "C" int ell_spmm(const void* emb, void* out, int d, int num_nodes, int num_src,
                        int bf16,
                        const void* const* nbr, const void* const* w,
                        const void* const* node_ids, const int* widths, int nbuckets,
                        const void* items, int n_items, const void* split_rows,
                        void* counters, void* scratch, int num_sms, void* stream) {
  if (n_items <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 512 || nbuckets <= 0 || nbuckets > kMaxBuckets || num_sms <= 0 ||
      num_nodes <= 0 || num_src <= 0)
    return (int)cudaErrorInvalidValue;
  Buckets bk = {};
  for (int b = 0; b < nbuckets; ++b) {
    bk.nbr[b] = (const int*)nbr[b];
    bk.w[b] = (const float*)w[b];
    bk.node_ids[b] = (const int*)node_ids[b];
    bk.width[b] = widths[b];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t vec_bytes = bf16 ? 8 : 16;
  const bool vec4 = d % 4 == 0 && (uintptr_t)emb % vec_bytes == 0 &&
                    (uintptr_t)out % vec_bytes == 0;
  cudaError_t e;
  if (bf16) {
    e = vec4 ? launch<__nv_bfloat16, 4>(emb, out, bk, items, n_items, split_rows, counters,
                                        scratch, d, num_src, num_sms, s)
             : launch<__nv_bfloat16, 1>(emb, out, bk, items, n_items, split_rows, counters,
                                        scratch, d, num_src, num_sms, s);
  } else {
    e = vec4 ? launch<float, 4>(emb, out, bk, items, n_items, split_rows, counters, scratch,
                                d, num_src, num_sms, s)
             : launch<float, 1>(emb, out, bk, items, n_items, split_rows, counters, scratch,
                                d, num_src, num_sms, s);
  }
  return (int)e;
}

extern "C" const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
