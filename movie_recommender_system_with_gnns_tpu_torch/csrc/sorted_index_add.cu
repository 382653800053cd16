// Deterministic row scatter-add for sm_90a: the sum that index_add_ takes,
// in an order fixed by the data.
//
// Stands for the XLA scatter-add that the JAX package's compact step runs
// where it gathers rows (movie_recommender_system_with_gnns_tpu/training/
// compact.py: the backward of the negatives' row gather and the segment
// path's message sum). No Pallas kernel computes it there; on this card
// PyTorch's index_add_ sums with float atomics, whose order changes from run
// to run, so two steps on the same inputs differ in their last bits.
//
// What it computes: out[r] = the sum, in list order, of x[order[j]] for j in
// [starts[r], starts[r + 1]), for every row r < rows; a row with no entries
// is zero. Each row is written once. With ``order`` a stable argsort of an
// index array ``idx`` and ``starts`` its row starts, this is
// zeros(rows, d).index_add_(0, idx, x) summed in ascending entry order, the
// order of PyTorch's sequential CPU kernel. A bf16 row is summed in f32 and
// rounded to bf16 once, as index_add_ does on the CPU.
//
// Each column of a row is its own chain of adds, and both lanes below add
// every column's entries one after another in list order, starting from
// +0.0f: the bits are those of the sequential sum whichever lane sums a row.
// Only who sums it differs.
//
// Short lane (rows of at most T entries): one warp per row, its lanes over d
// (each load a run of consecutive elements); a warp walks its row's list in
// order with U rows in flight. A row costs a load latency per U entries.
// T = kLongRounds * U, so a short row costs at most kLongRounds latencies:
// 128 entries at d <= 64, 64 at d <= 128, 32 above.
//
// Long lane (rows of more than T entries): the short lane only lists such a
// row (row, first entry, end) in a work list on the device, by an integer
// atomic, and writes nothing for it. A second launch of a fixed grid (as
// many blocks as fit on each SM, at most 4) splits each listed row into
// groups of kGroup = 32 columns and deals the (row, group) items out over its
// blocks, item i to block i mod grid, so one long row's groups run on as many
// SMs. In a block, warp 0 adds: lane c owns column c of the group and adds
// the row's entries in list order. Warps 1-6 feed it: a stage is up to
// kStageRows entries of one item; they copy a stage's indices kStages - 1
// rounds ahead of its rows, and its rows' group slices kStages - 1 rounds
// ahead of the adds, with cp.async into rings in dynamic shared memory. A
// block walks its items back to back through the rings, so a load latency
// is paid once per block and not once per U entries. The order of the work
// list and the placement of items change no result.
//
// Bound on this card: read x once (n d itemsize bytes), the order (4 n) and
// the starts (4 (rows + 1)), write out once (rows d itemsize); n d adds. At
// the compact step's negatives (38,656 entries over 59,047 rows, d 64, f32)
// that is about 25.2 MB: 7.5 microseconds of HBM time. The rows are
// gathered, not streamed, so the short lane pays a latency per U entries.
// The long lane's floor is each column's dependent add chain, about 4
// cycles an entry (a 20 k-entry run: about 45 microseconds), where the bytes
// do not bound it first; each round also pays a barrier and a few dependent
// shared-memory reads, which a stage of 192 entries spreads thin.
//
// ``g_long_tally`` counts the rows and entries the long lane has summed since
// the library loaded; ``sorted_index_add_long_stats`` reads it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

constexpr int kLongRounds = 16;       // T = kLongRounds * U
constexpr int kGroup = 32;            // columns of a long item: one lane each
constexpr int kLongThreads = 224;     // warp 0 adds, warps 1-6 copy
constexpr int kCopiers = kLongThreads - 32;
constexpr int kStageRows = 192;       // entries a stage
constexpr int kStages = 3;            // stages of rows in the ring
constexpr int kSlots = 2 * kStages - 1;  // stages of indices and their items
constexpr int kSmemPerSm = 232448;    // shared memory of an SM that blocks may use
constexpr int kDevices = 64;

// Shared memory of a long-lane block: the ring of rows, then the indices,
// then the stages' items.
template <typename T>
constexpr int long_smem() {
  return kStages * kStageRows * kGroup * (int)sizeof(T) + kSlots * kStageRows * 4 + kSlots * 16;
}

// Long-lane blocks an SM holds: at most 4, fewer where the ring is large.
template <typename T>
constexpr int long_ctas_per_sm() {
  return kSmemPerSm / long_smem<T>() < 4 ? kSmemPerSm / long_smem<T>() : 4;
}

__device__ unsigned long long g_long_tally[2];   // rows, entries

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};

constexpr int lanes_elems(int d) {   // V: elements a lane holds in the short lane
  return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : d <= 256 ? 8 : 16;
}

constexpr int rows_in_flight(int V) {   // U
  return V <= 2 ? 8 : (V <= 4 ? 4 : 2);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One piece of W bytes from global memory to a shared address, both
// W-aligned. cp.async takes 4, 8 or 16 bytes: a 2-byte piece (bf16 rows of an
// odd width) is copied by the thread itself.
template <int W>
__device__ __forceinline__ void copy_piece(uint32_t dst, const void* src) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src)
                 : "memory");
  else if constexpr (W == 8 || W == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" :: "r"(dst), "l"(src),
                 "n"(W) : "memory");
  else
    asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(dst),
                 "h"(*(const unsigned short*)src) : "memory");
}

template <typename T, int V, int U>
__device__ __forceinline__ void short_lane(const T* __restrict__ x,
                                           const int* __restrict__ order,
                                           const int* __restrict__ starts,
                                           T* __restrict__ out, int rows, int d,
                                           int* count, int4* list, int cap) {
  constexpr int kLong = kLongRounds * U;
  const int lane = threadIdx.x & 31;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows;
       r += (int64_t)gridDim.x * kWarps) {
    const int beg = starts[r], end = starts[r + 1];
    if (end - beg > kLong && cap > 0) {   // the long lane sums it
      if (lane == 0) {
        const int slot = atomicAdd(count, 1);
        if (slot < cap) list[slot] = make_int4((int)r, beg, end, 0);
      }
      continue;
    }
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    int i = beg;
    for (; i + U <= end; i += U) {   // U rows in flight, added in list order
      int e[U];
#pragma unroll
      for (int k = 0; k < U; ++k) e[k] = order[i + k];
      float v[U][V];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const T* src = x + (int64_t)e[k] * d;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = lane + 32 * j;
          v[k][j] = c < d ? Num<T>::get(src[c]) : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += v[k][j];
      }
    }
    for (; i < end; ++i) {
      const T* src = x + (int64_t)order[i] * d;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = lane + 32 * j;
        if (c < d) acc[j] += Num<T>::get(src[c]);
      }
    }
    T* dst = out + r * d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c < d) dst[c] = Num<T>::put(acc[j]);
    }
  }
}

// Rounds of a block: in round j the copiers list stage j's item and copy its
// indices, and copy the rows of stage j - (kStages - 1); warp 0 adds stage
// j - (2 kStages - 2). Each round waits for the copies of the round
// kStages - 1 before it, so a stage's indices are in before its rows are
// asked for, and its rows before they are added. A copier's pieces of a
// stage are independent and unrolled: their index reads, then their copies.
template <typename T, int W>
__device__ __forceinline__ void long_lane(const T* __restrict__ x,
                                          const int* __restrict__ order,
                                          T* __restrict__ out, int d,
                                          const int* count, const int4* list,
                                          int cap) {
  constexpr int kSlice = kGroup * (int)sizeof(T);   // bytes of a group's slice
  constexpr int kPieces = kSlice / W;               // W-byte pieces of a slice
  constexpr int kEach = (kStageRows * kPieces + kCopiers - 1) / kCopiers;
  constexpr int kBatch = kEach < 8 ? kEach : 8;
  static_assert(kStageRows % 4 == 0, "the indices' ring ends on 16 bytes");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                  // [kStages][rows' slices]
  int* ids = (int*)(smem + kStages * kStageRows * kSlice);    // [kSlots][kStageRows]
  int4* stage_of = (int4*)(ids + kSlots * kStageRows);        // row, first column,
                                                               // entries, the item's last
  const int groups = (d + kGroup - 1) / kGroup;
  const int items = min(*count, cap) * groups;
  int item = blockIdx.x;
  if (item >= items) return;
  const int stride = gridDim.x;
  int4 cur = list[item / groups];   // row, first entry, end
  int col0 = item % groups * kGroup;
  int4 next = make_int4(0, 0, 0, 0);
  if (item + stride < items) next = list[(item + stride) / groups];
  int pos = cur.y;
  const int lane = threadIdx.x & 31;
  const int p = threadIdx.x - 32;   // copier id, negative in warp 0
  const uint32_t ring0 = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t ids0 = (uint32_t)__cvta_generic_to_shared(ids);
  float acc = 0.0f;
  for (int j = 0;; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int k = j - (2 * kStages - 2);
    if (k >= 0 && stage_of[k % kSlots].z == 0) break;
    if (p >= 0) {
      int4 st = make_int4(0, 0, 0, 0);
      if (item < items) {
        const int n = min(kStageRows, cur.z - pos);
        st = make_int4(cur.x, col0, n, pos + n == cur.z);
        for (int e = p; e < n; e += kCopiers)
          copy_piece<4>(ids0 + 4 * ((j % kSlots) * kStageRows + e), order + pos + e);
        if (p == 0 && col0 == 0 && pos == cur.y) {
          atomicAdd(&g_long_tally[0], 1ull);
          atomicAdd(&g_long_tally[1], (unsigned long long)(cur.z - cur.y));
        }
        pos += n;
        if (pos == cur.z) {
          item += stride;
          cur = next;
          pos = cur.y;
          col0 = item % groups * kGroup;
          if (item + stride < items) next = list[(item + stride) / groups];
        }
      }
      if (p == 0) stage_of[j % kSlots] = st;
      const int s = j - (kStages - 1);
      if (s >= 0 && stage_of[s % kSlots].z > 0) {
        const int4 ss = stage_of[s % kSlots];
        const int bytes = min(kGroup, d - ss.y) * (int)sizeof(T);
        const uint32_t dst = ring0 + (s % kStages) * (kStageRows * kSlice);
        const T* src = x + ss.y;
#pragma unroll 1
        for (int i0 = 0; i0 < kEach; i0 += kBatch) {   // kBatch pieces at a time
          int row[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int q = p + (i0 + i) * kCopiers;
            row[i] = q < ss.z * kPieces ? ids[s % kSlots * kStageRows + q / kPieces] : -1;
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int q = p + (i0 + i) * kCopiers, off = (q % kPieces) * W;
            if (row[i] >= 0 && off < bytes)
              copy_piece<W>(dst + (q / kPieces) * kSlice + off,
                            (const char*)(src + (int64_t)row[i] * d) + off);
          }
        }
      }
    }
    cp_async_commit();
    if (p < 0 && k >= 0) {
      const int4 sk = stage_of[k % kSlots];
      const T* v = (const T*)(ring + k % kStages * (kStageRows * kSlice)) + lane;
      if (sk.z == kStageRows) {
#pragma unroll
        for (int e0 = 0; e0 < kStageRows; e0 += 16) {
          float t[16];
#pragma unroll
          for (int q = 0; q < 16; ++q) t[q] = Num<T>::get(v[(e0 + q) * kGroup]);
#pragma unroll
          for (int q = 0; q < 16; ++q) acc += t[q];
        }
      } else {
#pragma unroll 8
        for (int e = 0; e < sk.z; ++e) acc += Num<T>::get(v[e * kGroup]);
      }
      if (sk.w) {
        const int c = sk.y + lane;
        if (c < d) out[(int64_t)sk.x * d + c] = Num<T>::put(acc);
        acc = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
}

// One template for both lanes, so that every launch is a
// sorted_index_add_kernel: the short lane <false, T, V, U>, the long lane
// <true, T, W, 0> with W its copy piece in bytes.
template <bool LONG, typename T, int V, int U>
__global__ void __launch_bounds__(LONG ? kLongThreads : kThreads)
sorted_index_add_kernel(const T* __restrict__ x, const int* __restrict__ order,
                        const int* __restrict__ starts, T* __restrict__ out,
                        int rows, int d, int* count, int4* list, int cap) {
  if constexpr (LONG)
    long_lane<T, V>(x, order, out, d, count, list, cap);
  else
    short_lane<T, V, U>(x, order, starts, out, rows, d, count, list, cap);
}

template <typename T, int W>
cudaError_t launch_long(const void* x, const void* order, void* out, int rows, int d,
                        int* count, int4* list, int cap, int grid, int dev, cudaStream_t s) {
  static bool sized[kDevices] = {};   // the shared memory limit, set once a device
  if (dev >= kDevices || !sized[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(sorted_index_add_kernel<true, T, W, 0>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               long_smem<T>());
    if (e != cudaSuccess) return e;
    if (dev < kDevices) sized[dev] = true;
  }
  sorted_index_add_kernel<true, T, W, 0><<<grid, kLongThreads, long_smem<T>(), s>>>(
      (const T*)x, (const int*)order, nullptr, (T*)out, rows, d, count, list, cap);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* order, const void* starts,
                   void* out, void* scratch, int rows, int d, int cap, int sms,
                   int dev, cudaStream_t s) {
  constexpr int U = rows_in_flight(V);
  int* count = (int*)scratch;
  int4* list = (int4*)scratch + 1;
  if (cap > 0) {
    const cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), s);
    if (e != cudaSuccess) return e;
  }
  const int64_t need = ((int64_t)rows + kWarps - 1) / kWarps;
  const int64_t most = (int64_t)sms * 16;
  sorted_index_add_kernel<false, T, V, U><<<(int)(need < most ? need : most), kThreads, 0, s>>>(
      (const T*)x, (const int*)order, (const int*)starts, (T*)out, rows, d, count, list,
      cap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || cap == 0) return e;
  const int64_t items = (int64_t)cap * ((d + kGroup - 1) / kGroup);
  const int64_t blocks = (int64_t)sms * long_ctas_per_sm<T>();
  const int grid = (int)(items < blocks ? items : blocks);
  // the widest piece that every group slice of x starts on
  const uintptr_t a = (uintptr_t)x | (uintptr_t)(d * (int)sizeof(T));
  if (a % 16 == 0)
    return launch_long<T, 16>(x, order, out, rows, d, count, list, cap, grid, dev, s);
  if (a % 8 == 0)
    return launch_long<T, 8>(x, order, out, rows, d, count, list, cap, grid, dev, s);
  if constexpr (sizeof(T) == 2)
    if (a % 4 != 0)
      return launch_long<T, 2>(x, order, out, rows, d, count, list, cap, grid, dev, s);
  return launch_long<T, 4>(x, order, out, rows, d, count, list, cap, grid, dev, s);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* order, const void* starts,
                     void* out, void* scratch, int rows, int d, int cap, int sms,
                     int dev, cudaStream_t s) {
  switch (lanes_elems(d)) {
    case 1: return launch<T, 1>(x, order, starts, out, scratch, rows, d, cap, sms, dev, s);
    case 2: return launch<T, 2>(x, order, starts, out, scratch, rows, d, cap, sms, dev, s);
    case 4: return launch<T, 4>(x, order, starts, out, scratch, rows, d, cap, sms, dev, s);
    case 8: return launch<T, 8>(x, order, starts, out, scratch, rows, d, cap, sms, dev, s);
    default: return launch<T, 16>(x, order, starts, out, scratch, rows, d, cap, sms, dev, s);
  }
}

}  // namespace

// T: a row of more entries than this, at width d, is summed by the long lane.
extern "C" int sorted_index_add_long_run(int d) {
  return kLongRounds * rows_in_flight(lanes_elems(d));
}

// out (rows, d) is written in full from x (n, d) by order (n) and starts
// (rows + 1), all int32; bf16 != 0 selects bfloat16 rows, 0 float32.
// scratch holds 16 (cap + 1) bytes, 16-byte aligned, with cap at least the
// number of rows of more than sorted_index_add_long_run(d) entries (n / (T +
// 1) bounds it); with cap 0 no row is long and scratch may be null. Returns
// the first failed call's cudaError_t (0 on success); never synchronizes.
extern "C" int sorted_index_add(const void* x, const void* order,
                                const void* starts, void* out, void* scratch,
                                int rows, int d, int cap, int bf16, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 512 || cap < 0 || (cap > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = bf16 ? dispatch<__nv_bfloat16>(x, order, starts, out, scratch, rows, d, cap, sms, dev, s)
           : dispatch<float>(x, order, starts, out, scratch, rows, d, cap, sms, dev, s);
  return (int)e;
}

// out[0], out[1]: the rows and entries the long lane has summed on the
// current device since the library loaded. Waits for the device.
extern "C" int sorted_index_add_long_stats(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_long_tally, sizeof(g_long_tally));
}

extern "C" const char* sorted_index_add_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
