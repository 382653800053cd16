// Fused pass 1 of exact two-phase MIPS top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_mips.py::_score_chunkmax_kernel of the
// JAX package. For one (Qp, d) query matrix and one (Np, d) catalog it writes
//   s[r, j]  = q[r] . c[j], set to NEG_INF where j >= n (pad column) or where
//              the exclusion mask marks (r, j), rounded to the score type;
//   cm[r, t] = max over j in [128 t, 128 t + 128) of the ROUNDED s[r, j]
//              (the chunk-containment argument of pass 2 needs the maxima of
//              the values pass 2 will read).
// Pass 2 (top chunks, gather, final top-k) stays in PyTorch (ops/cuda_mips.py).
//
// Design. One thread block per 128 x 128 output tile: the tile width equals
// the 128-column chunk, so each chunk max is a row reduction inside the block
// and no reduction crosses blocks. The block's 128 x 128 exclusion flags (int8,
// or one bit plane of the tile-bit-packed mask) and the operand depth slices
// (64 bf16 / 32 f32 values; at d = 64 the bf16 lane holds the whole depth in
// one slice) arrive in shared memory by cp.async, in the bf16 lane all in
// flight together.
// bf16 products run on the tensor cores with mma.sync.m16n8k16 and f32
// accumulation; the f32 lane uses f32 FMA (no TF32, it is held against exact
// f32). The epilogue masks pad columns and excluded entries, rounds, reduces
// the rounded values to the chunk max, and (bf16) stages the rounded tile in
// shared memory so it leaves as whole 256-byte row segments, with streaming
// stores that keep the catalog and the mask, not the scores, in L2. The grid
// walks columns fastest, so the query tile, the catalog (7.6 MB at ML-25M
// width) and the packed-mask bytes that 8 neighbouring column blocks share
// are read from L2.
//
// Bound at the serving shape (Q = 32,768, N = 59,047 padded to 59,392, d = 64,
// bf16, packed mask), H100 SXM at 3.35 TB/s and 989 TFLOP/s bf16:
//   work        2 Q N d        = 2.49e11 FLOP -> 0.25 ms
//   score write Q N 2 B        = 3.89 GB      -> 1.16 ms
//   packed mask Q N / 8 B      = 0.24 GB      -> 0.07 ms
// so the kernel is bound by the bytes it must write, at about 1.24 ms; the
// chunk maxima (Q N / 64 B) and operands add under 1 %.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;      // queries x columns of one block's output tile
constexpr int THREADS = 256;   // 8 warps
constexpr float NEG_INF = -1e30f;

constexpr int KS_BF16 = 64;             // depth slice, bf16 lane
constexpr int LDS_BF16 = KS_BF16 + 8;   // row pitch 144 B: conflict-free fragment loads
constexpr int STG_BF16 = TILE + 8;      // output staging pitch (elements): 272 B
constexpr int MK_PITCH = TILE + 16;     // mask tile pitch (bytes)
constexpr int KS_F32 = 32;              // depth slice, f32 lane
constexpr int LDS_F32 = TILE + 4;       // f32 slices are stored transposed [k][row]

// bf16 lane dynamic shared memory: operand slices (reused as output staging),
// then the mask tile
constexpr int OPS_BYTES_BF16 = 2 * TILE * LDS_BF16 * 2;
constexpr int SMEM_BF16 = OPS_BYTES_BF16 + TILE * MK_PITCH;
static_assert(TILE * STG_BF16 * 2 <= OPS_BYTES_BF16, "output staging must fit");

struct MaskArgs {
  const uint8_t* ptr;   // (Qp, ld) bytes, or nullptr
  int mode;             // 0 none, 1 one byte per column, 2 tile-bit-packed
  int64_t ld;           // row pitch in bytes, a multiple of 16
  int n_tile;           // packed layout's tile width, a multiple of 1024
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  // 16 bytes global -> shared, zero-filled when !valid
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// max that keeps NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Starts the copy of the block's 128 x 128 exclusion flags into shared memory
// (pitch `pitch` bytes) and returns how to read them: flag = (byte >> *shift)
// & *keep. Packed layout (ops/topk.py::pack_mask_tiles): within each
// n_tile-column tile, byte b holds columns b + i * n_tile / 8 in bit i. With
// n_tile a multiple of 1024, the block's 128 columns (col0 a multiple of 128)
// lie in one tile and one bit plane, on 128 consecutive bytes of each row; the
// int8 layout is 128 consecutive bytes too. Completes at cp_async_wait_all().
__device__ __forceinline__ void stage_mask(const MaskArgs& m, int64_t row0,
                                           int64_t col0, uint8_t* mk, int pitch,
                                           int* shift, int* keep) {
  int64_t byte0 = col0;
  *shift = 0;
  *keep = 0xff;
  if (m.mode == 2) {
    const int nb = m.n_tile >> 3;
    const int64_t t = col0 / m.n_tile;
    const int w0 = (int)(col0 - t * m.n_tile);
    byte0 = t * nb + w0 % nb;
    *shift = w0 / nb;
    *keep = 1;
  }
  const uint8_t* src = m.ptr + row0 * m.ld + byte0;
  for (int v = threadIdx.x; v < TILE * (TILE / 16); v += THREADS) {
    const int r = v / (TILE / 16), seg = (v % (TILE / 16)) * 16;
    cp_async16(mk + r * pitch + seg, src + r * m.ld + seg, true);
  }
}

__device__ __forceinline__ float masked(float v, int rl, int cl, int64_t col0,
                                        int64_t n, bool has_mask, const uint8_t* mk,
                                        int pitch, int shift, int keep) {
  if (col0 + cl >= n) return NEG_INF;
  if (has_mask && ((mk[rl * pitch + cl] >> shift) & keep)) return NEG_INF;
  return v;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16x16 bf16, row-major) * B (16x8 bf16, column-major), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 lane. Warp w owns rows [32 (w % 4), +32) and columns [64 (w / 4), +64)
// of the tile: 2 x 8 mma tiles of 16 x 8, 64 f32 accumulators per thread.
__global__ void __launch_bounds__(THREADS, 2)
score_chunkmax_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ c, MaskArgs mask,
                           __nv_bfloat16* __restrict__ s,
                           __nv_bfloat16* __restrict__ cm, int64_t np_, int d,
                           int64_t n) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[2][TILE];
  __nv_bfloat16 (*qs)[LDS_BF16] = reinterpret_cast<__nv_bfloat16 (*)[LDS_BF16]>(smem);
  __nv_bfloat16 (*cs)[LDS_BF16] = qs + TILE;
  uint8_t* mk = smem + OPS_BYTES_BF16;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const int g = lane >> 2, tg = lane & 3;   // mma fragment row group, thread in group
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;

  const bool has_mask = mask.mode != 0;
  int shift = 0, keep = 0;
  if (has_mask) stage_mask(mask, row0, col0, mk, MK_PITCH, &shift, &keep);

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KS_BF16) {
    // 128 rows x 64 values per operand = 1024 16-byte vectors; zero past d
    for (int v = tid; v < TILE * (KS_BF16 / 8); v += THREADS) {
      const int r = v / (KS_BF16 / 8), kv = (v % (KS_BF16 / 8)) * 8;
      const bool in = k0 + kv < d;
      cp_async16(&qs[r][kv], in ? q + (row0 + r) * d + k0 + kv : q, in);
      cp_async16(&cs[r][kv], in ? c + (col0 + r) * d + k0 + kv : c, in);
    }
    cp_async_wait_all();   // the first slice also waits for the mask tile
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS_BF16; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wr * 32 + mi * 16 + g;
        a[mi][0] = ld32(&qs[r][kk + tg * 2]);
        a[mi][1] = ld32(&qs[r + 8][kk + tg * 2]);
        a[mi][2] = ld32(&qs[r][kk + tg * 2 + 8]);
        a[mi][3] = ld32(&qs[r + 8][kk + tg * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int cc = wc * 64 + ni * 8 + g;
        b[ni][0] = ld32(&cs[cc][kk + tg * 2]);
        b[ni][1] = ld32(&cs[cc][kk + tg * 2 + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();   // operand slices free: next slice, or output staging
  }

  // accumulator e of an m16n8 tile: row g + 8 (e / 2), column 2 tg + e % 2
  __nv_bfloat16 (*stg)[STG_BF16] = reinterpret_cast<__nv_bfloat16 (*)[STG_BF16]>(smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wr * 32 + mi * 16 + h * 8 + g;
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int cl = wc * 64 + ni * 8 + tg * 2;
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            masked(acc[mi][ni][2 * h], rl, cl, col0, n, has_mask, mk, MK_PITCH, shift, keep),
            masked(acc[mi][ni][2 * h + 1], rl, cl + 1, col0, n, has_mask, mk, MK_PITCH,
                   shift, keep));
        *reinterpret_cast<__nv_bfloat162*>(&stg[rl][cl]) = p;
        mx = nan_max(mx, __low2float(p));
        mx = nan_max(mx, __high2float(p));
      }
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (tg == 0) red[wc][rl] = mx;
    }
  __syncthreads();
  for (int v = tid; v < TILE * (TILE / 8); v += THREADS) {
    const int r = v / (TILE / 8), seg = (v % (TILE / 8)) * 8;
    __stcs(reinterpret_cast<uint4*>(s + (row0 + r) * np_ + col0 + seg),
           *reinterpret_cast<const uint4*>(&stg[r][seg]));
  }
  if (tid < TILE) {
    cm[(row0 + tid) * (np_ / TILE) + blockIdx.x] =
        __float2bfloat16_rn(nan_max(red[0][tid], red[1][tid]));
  }
}

// f32 lane. Thread (tx, ty) = (tid % 16, tid / 16) owns rows ty + 16 i and
// columns tx + 16 j, i, j < 8. The mask tile reuses the query slice's bytes
// after the depth loop (static shared memory stays under 48 KB).
__global__ void __launch_bounds__(THREADS)
score_chunkmax_f32_kernel(const float* __restrict__ q, const float* __restrict__ c,
                          MaskArgs mask, float* __restrict__ s,
                          float* __restrict__ cm, int64_t np_, int d, int64_t n) {
  __shared__ __align__(16) float qs[KS_F32][LDS_F32];
  __shared__ float cs[KS_F32][LDS_F32];
  static_assert(TILE * TILE <= sizeof(qs), "mask tile must fit");
  uint8_t* mk = reinterpret_cast<uint8_t*>(qs);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KS_F32) {
    for (int v = tid; v < TILE * (KS_F32 / 4); v += THREADS) {
      const int r = v / (KS_F32 / 4), kv = (v % (KS_F32 / 4)) * 4;
      float4 qa = make_float4(0.f, 0.f, 0.f, 0.f), ca = qa;
      if (k0 + kv < d) {
        qa = *reinterpret_cast<const float4*>(q + (row0 + r) * d + k0 + kv);
        ca = *reinterpret_cast<const float4*>(c + (col0 + r) * d + k0 + kv);
      }
      qs[kv][r] = qa.x; qs[kv + 1][r] = qa.y; qs[kv + 2][r] = qa.z; qs[kv + 3][r] = qa.w;
      cs[kv][r] = ca.x; cs[kv + 1][r] = ca.y; cs[kv + 2][r] = ca.z; cs[kv + 3][r] = ca.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KS_F32; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = cs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const bool has_mask = mask.mode != 0;
  int shift = 0, keep = 0;
  if (has_mask) {
    stage_mask(mask, row0, col0, mk, TILE, &shift, &keep);
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rl = ty + 16 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = tx + 16 * j;
      const float v = masked(acc[i][j], rl, cl, col0, n, has_mask, mk, TILE, shift, keep);
      s[(row0 + rl) * np_ + col0 + cl] = v;
      mx = nan_max(mx, v);
    }
    // the 16 threads of one ty are lanes with equal bit 4: xor 1..8 stays inside
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (tx == 0) cm[(row0 + rl) * (np_ / TILE) + blockIdx.x] = mx;
  }
}

}  // namespace

// Launches one pass on `stream` and returns the CUDA error (0 = launched).
// Shapes are checked by the Python wrapper: qp, np_ multiples of 128,
// d a multiple of 8, pointers 16-byte aligned, 0 < n <= np_, mask_ld a
// multiple of 16, n_tile a multiple of 1024 for the packed mask.
extern "C" int score_chunkmax(const void* q, const void* c, const void* mask,
                              int mask_mode, int64_t mask_ld, int n_tile,
                              void* s, void* cm, int64_t qp, int64_t np_, int d,
                              int64_t n, int is_bf16, void* stream) {
  const dim3 grid((unsigned)(np_ / TILE), (unsigned)(qp / TILE));
  const MaskArgs m{static_cast<const uint8_t*>(mask), mask_mode, mask_ld, n_tile};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_chunkmax_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    score_chunkmax_bf16_kernel<<<grid, THREADS, SMEM_BF16, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(c),
        m, static_cast<__nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(cm), np_, d, n);
  } else {
    score_chunkmax_f32_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(c), m,
        static_cast<float*>(s), static_cast<float*>(cm), np_, d, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* score_chunkmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
