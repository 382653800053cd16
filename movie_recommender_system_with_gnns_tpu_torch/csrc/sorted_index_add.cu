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
// Design: one warp per row, its lanes over d (each load a run of consecutive
// elements); a warp walks its row's list in order with U rows in flight and
// adds them in list order. Rows are independent, so nothing depends on the
// grid or the scheduling of blocks.
//
// Bound on this card: read x once (n d itemsize bytes), the order (4 n) and
// the starts (4 (rows + 1)), write out once (rows d itemsize); n d adds. At
// the compact step's negatives (38,656 entries over 59,047 rows, d 64, f32)
// that is about 25.2 MB: 7.5 microseconds of HBM time, far more than the adds
// need. The rows are gathered, not streamed, so a row costs a load latency
// per U entries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

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

template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
sorted_index_add_kernel(const T* __restrict__ x, const int* __restrict__ order,
                        const int* __restrict__ starts, T* __restrict__ out,
                        int rows, int d) {
  const int lane = threadIdx.x & 31;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows;
       r += (int64_t)gridDim.x * kWarps) {
    const int beg = starts[r], end = starts[r + 1];
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

template <typename T, int V>
cudaError_t launch(const void* x, const void* order, const void* starts,
                   void* out, int rows, int d, int sms, cudaStream_t s) {
  constexpr int U = V <= 2 ? 8 : (V <= 4 ? 4 : 2);
  const int64_t need = ((int64_t)rows + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sms * 16;
  sorted_index_add_kernel<T, V, U><<<(int)(need < cap ? need : cap), kThreads, 0, s>>>(
      (const T*)x, (const int*)order, (const int*)starts, (T*)out, rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* order, const void* starts,
                     void* out, int rows, int d, int sms, cudaStream_t s) {
  if (d <= 32) return launch<T, 1>(x, order, starts, out, rows, d, sms, s);
  if (d <= 64) return launch<T, 2>(x, order, starts, out, rows, d, sms, s);
  if (d <= 128) return launch<T, 4>(x, order, starts, out, rows, d, sms, s);
  if (d <= 256) return launch<T, 8>(x, order, starts, out, rows, d, sms, s);
  return launch<T, 16>(x, order, starts, out, rows, d, sms, s);
}

}  // namespace

// out (rows, d) is written in full from x (n, d) by order (n) and starts
// (rows + 1), all int32; bf16 != 0 selects bfloat16 rows, 0 float32. Returns
// the launch's cudaError_t (0 on success); never synchronizes.
extern "C" int sorted_index_add(const void* x, const void* order,
                                const void* starts, void* out, int rows, int d,
                                int bf16, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 512) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = bf16 ? dispatch<__nv_bfloat16>(x, order, starts, out, rows, d, sms, s)
           : dispatch<float>(x, order, starts, out, rows, d, sms, s);
  return (int)e;
}

extern "C" const char* sorted_index_add_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
