// Hopper pieces of the warp-specialised flash kernels (flash_attention_fwd_sm90.cu,
// flash_attention_bwd_dq_sm90.cu, flash_attention_bwd_sm90.cu): TMA tile
// loads through 4-D tensor maps,
// mbarrier pipelines, warpgroup tensor-core products (wgmma) with operands
// in 128-byte-swizzled shared memory, and register reallocation between the
// producer and consumer warpgroups.
//
// Shared tiles. Every operand tile is stored as [rows][64] bf16 regions: one
// region per 64 columns of the head dim (one at d = 64, two at d = 128), each
// row 128 bytes, in TMA's 128-byte swizzle (the 16-byte chunk c of row r sits
// at chunk c ^ (r % 8)). A region starts on a 1024-byte boundary, the size of
// one swizzle pattern of 8 rows, which wgmma's descriptors assume.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the entry point is fetched at run time

#include "flash_common.cuh"

namespace rtt {
namespace sm90 {

constexpr int kRegionCols = 64;                 // bf16 columns of one 128-byte row
constexpr int kRowBytes = kRegionCols * 2;
constexpr int kConsumers = 2;                   // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 is the producer
constexpr int kProducerRegs = 40;               // 128 * 40 + 256 * 232 = 384 * 168
constexpr int kConsumerRegs = 232;

__host__ __device__ constexpr int region_bytes(int rows) { return rows * kRowBytes; }
__host__ __device__ constexpr int tile_bytes(int rows, int d) { return rows * d * 2; }

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------------------- TMA
// Loads box (c0 = head-dim column, c1 = sequence row, c2 = head, c3 = batch)
// of a 4-D map into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// Rows [row, row + R) of head (h, b) with every head-dim column: one box per
// 64-column region, regions R * 128 bytes apart.
template <int D, int R>
__device__ __forceinline__ void tma_load_rows(unsigned char* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int h, int b) {
#pragma unroll
  for (int r = 0; r < D / kRegionCols; ++r)
    tma_load_4d(dst + r * region_bytes(R), map, bar, r * kRegionCols, row, h, b);
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands (the
// reduction dim contiguous, as Q and K in Q K^T): sbo = 1024, the stride of
// 8-row groups; lbo unused. MN-major operands (read through the transpose
// bit, as V in P V): sbo = 1024, the stride of 8-row groups along the
// reduction dim, lbo = the stride between 64-column regions.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// K-major descriptor of the 16-column slice kk of a [rows][D] tile, starting
// at row `row0` (a multiple of 8).
template <int Rows>
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int row0, int kk) {
  return smem_desc(tile + (kk / 4) * region_bytes(Rows) + row0 * kRowBytes + (kk % 4) * 32, 16,
                   1024);
}

// MN-major descriptor of rows [16 kk, 16 kk + 16) of a [Rows][D] tile whose
// rows are the reduction dim and whose D columns are the product's columns.
template <int Rows>
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, int kk) {
  return smem_desc(tile + kk * 16 * kRowBytes, region_bytes(Rows), 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties accumulator registers to the surrounding asm, so the compiler keeps
// its own reads and writes of them out of the span of an async product.
template <int N8>
__device__ __forceinline__ void fence_regs(float (&acc)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[n][e])::"memory");
}

// The same for register A operands, which an async product reads until its
// wait_group: they stay live, and unchanged, up to this point.
template <int K16>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K16][4]) {
#pragma unroll
  for (int k = 0; k < K16; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

// 2^x by the special-function unit (ex2.approx, flush to zero): 2^-22
// relative error, and exactly 0 for the masked scores' large negative x.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers over the two consumer warpgroups (ids 1 and 2; 0 is
// __syncthreads): sync waits until the other warpgroup has arrived.
__device__ __forceinline__ void consumer_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void consumer_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}

template <int Regs>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

template <int Regs>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

// m64nNk16, bf16 in, f32 accumulate (d += or = A B). _ss: A and B from shared
// memory, both K-major; _rs: A from registers (the mma.sync A fragment of
// each warp's 16 rows), B from shared memory, MN-major when TransB is 1.
template <int TransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TransB));
}

template <int N, int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wgmma_ss_n64<TransB>(d, da, db, scale_d);
  else wgmma_ss_n128<TransB>(d, da, db, scale_d);
}

template <int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wgmma_rs_n64<TransB>(d, a, db, 1);
  else wgmma_rs_n128<TransB>(d, a, db, 1);
}

// --------------------------------------------------------- host: tensor maps
// A 4-D map over a strided bf16 [b, s, h, d] tensor, dims innermost first
// (d, s, h, b), boxes of 64 columns x `rows` rows of one head. Rows past s
// read as zeros. Returns cudaErrorInvalidValue when cuTensorMapEncodeTiled
// refuses it.
cudaError_t make_map(CUtensorMap* map, const void* base, int d, int s, int h, int b,
                     const Strides& st, int rows);

// Warp-specialised bf16 kernels for d in {64, 128}; launched by the C entry
// points of flash_attention_fwd.cu and flash_attention_bwd.cu.
cudaError_t launch_fwd(int d, const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                       const Strides& qs, const Strides& ks, const Strides& vs,
                       const Strides& os, const Dims& dm, cudaStream_t stream);
cudaError_t launch_dq(int d, const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* delta, bf16* dq, const Strides* st,
                      const Dims& dm, cudaStream_t stream);
cudaError_t launch_dkv(int d, const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* delta, bf16* dk, bf16* dv,
                       const Strides* st, const Dims& dm, cudaStream_t stream);

}  // namespace sm90
}  // namespace rtt
