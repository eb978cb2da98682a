// Shared pieces of the flash-attention kernels: tile geometry, shared-memory
// tile loads, warp-level tensor-core products (mma.sync, bf16 in, f32
// accumulate) for the bf16 kernels, and a plain-FMA warp product for the f32
// kernels.
//
// Geometry. A thread block has kWarps warps; each warp owns a strip of 16 rows
// of the block's kBlockM-row tile (query rows in the forward and dQ kernels,
// key rows in the dK/dV kernel) and walks the other sequence axis in tiles of
// BN rows that the whole block loads into shared memory. Inside a warp the
// only synchronisation is __syncwarp(); the block synchronises only around
// the shared tile loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace rtt {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;     // mask fill, as in the reference kernel
constexpr float kMaskedLse = 1e30f;   // lse of a row with no unmasked key
constexpr float kLog2e = 1.4426950408889634f;  // the bf16 kernels run exp2
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // rows a block owns

// Element type tags used by the C entry points.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Row padding of a shared tile: 16 bytes, which keeps 16-byte loads aligned
// and puts the 8 rows an ldmatrix reads on distinct banks.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ constexpr int align128(long long bytes) {
  return static_cast<int>((bytes + 127) / 128 * 128);
}

// Element strides of a [b, s, h, d] tensor whose last dim is contiguous.
struct Strides {
  int64_t b, s, h;
};

struct Dims {
  int b, h, hk, sq, sk, causal;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copies rows [row0, row0 + R) of one head of a strided [s, d] view into a
// shared tile with leading dimension ld, 16 bytes per thread per step. Rows at
// or past `nrows` (the ragged edge) are filled with zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int64_t row_stride,
                                          int row0, int nrows, int R) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows) val = *reinterpret_cast<const uint4*>(src + row * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Per-row f32 values (lse, delta) of rows [row0, row0 + R); past the edge the
// row gets `fill`.
__device__ __forceinline__ void load_row_stats(float* dst, const float* src, int row0, int nrows,
                                               int R, float fill) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int row = row0 + i;
    dst[i] = row < nrows ? src[row] : fill;
  }
}

// ---------------------------------------------------------------- f32 path
// One warp: C[16, N] (f32, shared, ldc) = or += A[16, K] . B[K, N] with plain
// FMA. A is row-major (lda). B is row-major (element (k, n) at b[k * ldb + n])
// or column-major (element (k, n) at b[n * ldb + k]).
template <bool BRowMajor, int N, int K>
__device__ __forceinline__ void warp_gemm_fma(float* c, int ldc, const float* a, int lda,
                                              const float* b, int ldb, bool accumulate) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * N; idx += 32) {
    const int i = idx / N;
    const int n = idx % N;
    float acc = accumulate ? c[i * ldc + n] : 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float bv = BRowMajor ? b[k * ldb + n] : b[n * ldb + k];
      acc = fmaf(a[i * lda + k], bv, acc);
    }
    c[i * ldc + n] = acc;
  }
}

// --------------------------------------------------------------- bf16 path
// Tensor-core products with mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// Fragment layouts are the PTX ISA's: with g = lane / 4 and t = lane % 4, an
// f32 accumulator tile acc[4] holds rows (g, g, g + 8, g + 8) and columns
// (2t, 2t + 1, 2t, 2t + 1) of a 16x8 tile; an A fragment a[4] holds the same
// rows of a 16x16 tile at columns 2t.. (a[0], a[1]) and 2t + 8.. (a[2], a[3]).
// So the accumulators of two neighbouring 16x8 tiles repack in registers into
// the A fragment of the next product (pack_a), which keeps P and dS out of
// shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[N8][4] (16 x 8*N8, f32) -> A fragments a[N8/2][4] (bf16) of a 16 x 8*N8
// left operand.
template <int N8>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N8 / 2][4], const float (&acc)[N8][4]) {
#pragma unroll
  for (int k = 0; k < N8 / 2; ++k) {
    a[k][0] = pack_bf16(acc[2 * k][0], acc[2 * k][1]);
    a[k][1] = pack_bf16(acc[2 * k][2], acc[2 * k][3]);
    a[k][2] = pack_bf16(acc[2 * k + 1][0], acc[2 * k + 1][1]);
    a[k][3] = pack_bf16(acc[2 * k + 1][2], acc[2 * k + 1][3]);
  }
}

// One warp: acc[N8][4] += A . B^T, A = 16 x 16*K16 rows of shared `a` (lda),
// B^T read from the rows of shared `b` (ldb): row n of b is column n of the
// product (as K for S = Q K^T).
template <int N8, int K16>
__device__ __forceinline__ void warp_mma_nt(float (&acc)[N8][4], const bf16* a, int lda,
                                            const bf16* b, int ldb) {
  static_assert(N8 % 2 == 0, "pairs of 8-column tiles");
  const int lane = threadIdx.x & 31;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + a_row * lda + kk * 16 + a_col);
#pragma unroll
    for (int n = 0; n < N8; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (n * 8 + b_row) * ldb + kk * 16 + b_col);
      mma_bf16(acc[n], af, bf[0], bf[1]);
      mma_bf16(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// One warp: acc[N8][4] += A . B, A in registers (fragments a[K16][4]), B
// = 16*K16 x 8*N8 rows of shared `b` (ldb), read transposed by ldmatrix
// (as V for O = P V).
template <int N8, int K16>
__device__ __forceinline__ void warp_mma_nn(float (&acc)[N8][4], const uint32_t (&a)[K16][4],
                                            const bf16* b, int ldb) {
  static_assert(N8 % 2 == 0, "pairs of 8-column tiles");
  const int lane = threadIdx.x & 31;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
#pragma unroll
    for (int n = 0; n < N8; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * 16 + b_row) * ldb + n * 8 + b_col);
      mma_bf16(acc[n], a[kk], bf[0], bf[1]);
      mma_bf16(acc[n + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// Asynchronous twin of load_rows for the bf16 kernels (cp.async, 16 bytes a
// thread a step, zero fill past the edge): the copy lands while the block
// computes on the other stage; cp_async_wait and __syncthreads publish it.
template <int D>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* src,
                                                int64_t row_stride, int row0, int nrows, int R) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    const int row = row0 + r;
    const bool valid = row < nrows;
    const bf16* g = valid ? src + row * row_stride + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst + r * ld + c)),
                 "l"(g), "r"(valid ? 16 : 0));
  }
}

// Per-row f32 values of rows [row0, row0 + R), asynchronously; past the edge
// the value is 0 (those rows are masked).
__device__ __forceinline__ void load_row_stats_async(float* dst, const float* src, int row0,
                                                     int nrows, int R) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool valid = row0 + i < nrows;
    const float* g = valid ? src + row0 + i : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + i)),
                 "l"(g), "r"(valid ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N8>
__device__ __forceinline__ void zero(float (&acc)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// Sum / max over the 4 lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Stores a warp's 16 x 8*N8 f32 accumulator strip, times a per-row factor,
// as bf16 rows [row0, row0 + 16) of a strided [s, d] view; rows at or past
// nrows are skipped.
template <int N8>
__device__ __forceinline__ void store_strip(bf16* dst, int64_t row_stride, int row0, int nrows,
                                            const float (&acc)[N8][4], float scale0,
                                            float scale1) {
  const int lane = threadIdx.x & 31;
  const int r0 = row0 + (lane >> 2);
  const int r1 = r0 + 8;
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    if (r0 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * row_stride + n * 8 + c) =
          __floats2bfloat162_rn(acc[n][0] * scale0, acc[n][1] * scale0);
    if (r1 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(dst + r1 * row_stride + n * 8 + c) =
          __floats2bfloat162_rn(acc[n][2] * scale1, acc[n][3] * scale1);
  }
}

// Launch helper: raises the dynamic shared-memory cap of `kernel` to `bytes`
// where it is above the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Dispatches a templated launcher over (element type, head dim). Returns
// cudaErrorInvalidValue for a pair with no instance.
#define RTT_DISPATCH(DTYPE, HEAD_DIM, LAUNCH, ...)                                   \
  [&]() -> cudaError_t {                                                            \
    if ((DTYPE) == rtt::kBFloat16) {                                               \
      switch (HEAD_DIM) {                                                           \
        case 16: return LAUNCH<rtt::bf16, 16>(__VA_ARGS__);                        \
        case 32: return LAUNCH<rtt::bf16, 32>(__VA_ARGS__);                        \
        case 64: return LAUNCH<rtt::bf16, 64>(__VA_ARGS__);                        \
        case 128: return LAUNCH<rtt::bf16, 128>(__VA_ARGS__);                      \
      }                                                                             \
    } else if ((DTYPE) == rtt::kFloat32) {                                         \
      switch (HEAD_DIM) {                                                           \
        case 16: return LAUNCH<float, 16>(__VA_ARGS__);                              \
        case 32: return LAUNCH<float, 32>(__VA_ARGS__);                              \
        case 64: return LAUNCH<float, 64>(__VA_ARGS__);                              \
        case 128: return LAUNCH<float, 128>(__VA_ARGS__);                            \
      }                                                                             \
    }                                                                               \
    return cudaErrorInvalidValue;                                                   \
  }()

}  // namespace rtt
