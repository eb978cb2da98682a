// Flash-attention dQ for Hopper (sm_90a), bf16 at head dims 64 and 128:
// warp-specialised, TMA loads into a ring of shared-memory stages, wgmma on
// two consumer warpgroups.
//
// Replaces: ray_tpu/ops/pallas/flash_attention.py, _flash_bwd_dq_kernel
// (launched by _flash_backward). Same function as the mma.sync kernel of
// flash_attention_bwd.cu, which still serves bf16 at d in {16, 32}: from the
// saved lse and delta = rowsum(dO * O),
//   p = exp(s scale - lse), dp = dO V^T, ds = p (dp - delta) scale, dQ += ds K,
// with ds rounded to bf16 before ds K, as the reference rounds it to k's
// dtype, and dQ accumulated in f32. The scale of ds is folded into the
// exponent (p scale = exp2(s scale log2 e - lse log2 e + log2 scale)), one
// multiply fewer per score, so the kernel needs scale > 0, as the forward's
// wgmma kernel does. Masking is the forward's: top-left causal plus the
// ragged edges of both sequences; query head i reads kv head i // (h / hk).
//
// What bounds it on the H100: 6 d flops per (query, key) pair against 4 d
// bytes of K and V per key, read once per block of 128 queries; the
// tensor cores bound it at the training shapes, and only wgmma reaches their
// full rate.
//
// Design.
// - Block: 3 warpgroups. Warpgroup 0 is the producer (setmaxnreg to 40
//   registers; one thread issues every load); warpgroups 1 and 2 are the
//   consumers (232 registers), each owning 64 query rows of the block's 128,
//   of one (batch, query head). Grid (query tiles of 128, b * h); under
//   causal masking the heaviest (last) query tiles start first.
// - Loads: Q and dO arrive once by TMA on one barrier. K and V tiles of BN
//   keys (128 at d = 64, 64 at d = 128) stream through kStages stages, each
//   with a full mbarrier (TMA bytes) and an empty mbarrier (256 consumer
//   arrivals), through 4-D tensor maps with the tensors' own strides (fused
//   qkv views are read in place; rows past sk arrive as zeros). lse (times log2 e) and delta are constant for a
//   query row: each consumer thread reads its two rows' once, into registers.
// - Products: S = Q K^T and dP = dO V^T by wgmma with both operands K-major
//   in shared memory, committed as two groups, so the exp of S runs while dP
//   is still on the tensor cores. ds is computed on the accumulator
//   registers, rounded to bf16 and repacked as the register A operand of
//   dQ += dS K, whose B operand is the same K tile read MN-major through the
//   transpose bit: one copy of K serves both products.
// - Overlap: the dQ product of tile j stays in flight under tile j + 1's S
//   and dP: its accumulator and dS operand (32 + 32 registers at d = 64,
//   64 + 16 at d = 128) fit beside S and dP (128 or 64); tile j's stage goes
//   back to the producer once that product is done, as K is its B operand.
// - Tiles: BN = 128 at d = 64 puts S and dP on m64n128 products, whose
//   operands take 96 bytes of shared memory a clock against 128 at n64 (the
//   card's whole shared-memory rate): 10% faster than BN = 64 at b8 s2048
//   h16 causal (H100 SXM, 700 W). At d = 128 the registers allow BN = 64
//   only.
// - Traps. (1) Under causal masking the block's last key tile lies wholly
//   (BN = 64) or half (BN = 128) above the first warpgroup's diagonal: that
//   warpgroup runs it with p = 0 where masked instead of skipping it, so
//   every wgmma wait stays on a path that all warps of a warpgroup take
//   (ptxas serialises the products otherwise).
//   (2) K rows past sk arrive as zeros, so s = 0 there and exp2(-lse) is not
//   0: a masked p is chosen by a select, never by a multiply. (3) Rows past
//   sq are computed on zero-filled Q and dO rows and never stored.
// - Stages: 4 (160 KB of shared memory at d = 64, 192 KB at d = 128): the
//   stage of tile j stays busy until its dS K is done, under tile j + 1's
//   products. One block per SM, as the register file is full.
#include "flash_sm90.cuh"

namespace rtt {
namespace sm90 {

template <int D>
struct DqCfg {
  static constexpr int BM = 64 * kConsumers;  // query rows per block
  static constexpr int BN = D == 64 ? 128 : 64;  // keys per streamed tile
  static constexpr int kStages = 4;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + tile_bytes(BM, D);
  static constexpr int kKV = kDo + tile_bytes(BM, D);
  static constexpr int kStage = 2 * tile_bytes(BN, D);  // K tile, then V tile
  static constexpr int kBars = kKV + kStages * kStage;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, Strides dqs, Dims dm) {
  using C = DqCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + C::kQ;
  unsigned char* sDo = smem + C::kDo;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + S;

  // causal: the last query tiles have the most keys; start them first
  const int q0 = (dm.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BM;
  const int bi = blockIdx.y / dm.h;
  const int hi = blockIdx.y % dm.h;
  const int kvh = hi / (dm.h / dm.hk);
  const int k_end = dm.causal ? min(dm.sk, q0 + BM) : dm.sk;
  const int n_tiles = (k_end + BN - 1) / BN;  // 0 when sk == 0: dQ stays 0
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * tile_bytes(BM, D));
      tma_load_rows<D, BM>(sQ, &qmap, q_full, q0, hi, bi);
      tma_load_rows<D, BM>(sDo, &domap, q_full, q0, hi, bi);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        mbar_wait(&kv_empty[s], ((j / S) & 1) ^ 1);
        unsigned char* sK = smem + C::kKV + s * C::kStage;
        mbar_expect_tx(&kv_full[s], C::kStage);
        tma_load_rows<D, BN>(sK, &kmap, &kv_full[s], j * BN, kvh, bi);
        tma_load_rows<D, BN>(sK + tile_bytes(BN, D), &vmap, &kv_full[s], j * BN, kvh, bi);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<kConsumerRegs>();
    constexpr int N8 = BN / 8;
    constexpr int D8 = D / 8;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int r0 = (wg - 1) * 64;          // the warpgroup's first row in the block
    const int wrow = q0 + r0 + warp * 16;  // the warp's first query row
    // this lane's two rows of the warp's strip, and its column pair in a tile
    const int row[2] = {wrow + lane / 4, wrow + lane / 4 + 8};
    const int col = (lane % 4) * 2;
    const float scale2 = dm.scale * kLog2e;
    const int64_t row_base = (static_cast<int64_t>(bi) * dm.h + hi) * dm.sq;
    // p scale = exp2(s scale2 - lse log2 e + log2 scale): the scale of ds
    // rides in the exponent (exact at d = 64, where it is 2^-3)
    float row_lse[2], row_delta[2];  // rows past sq: never stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_lse[i] = (row[i] < dm.sq ? lse[row_base + row[i]] : kMaskedLse) * kLog2e -
                   log2f(dm.scale);
      row_delta[i] = row[i] < dm.sq ? delta[row_base + row[i]] : 0.0f;
    }

    float acc[D8][4];
    zero(acc);
    uint32_t dsa[BN / 16][4] = {};  // dS of the previous tile: the A operand of its dS K
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % S;
      const int k0 = j * BN;
      const unsigned char* sK = smem + C::kKV + s * C::kStage;
      const unsigned char* sV = sK + tile_bytes(BN, D);
      mbar_wait(&kv_full[s], (j / S) & 1);

      float sc[N8][4], dp[N8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, 0>(sc, kmajor_desc<BM>(sQ, r0, kk), kmajor_desc<BN>(sK, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, 0>(dp, kmajor_desc<BM>(sDo, r0, kk), kmajor_desc<BN>(sV, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();  // S and the previous tile's dS K are in; dP may still run
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(dsa);
      if (j > 0) mbar_arrive(&kv_empty[(j - 1) % S]);

      // only a tile that crosses the diagonal or the ragged edge needs
      // masking (the block's last tile lies partly or wholly above the first
      // warpgroup's diagonal: p is 0 there)
      const bool edge = k0 + BN > dm.sk || (dm.causal && k0 + BN - 1 > wrow);
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(sc[n][e], scale2, -row_lse[e / 2]));
          if (edge) {
            const int kpos = k0 + n * 8 + col + (e & 1);
            if (kpos >= dm.sk || (dm.causal && row[e / 2] < kpos)) p = 0.0f;
          }
          sc[n][e] = p;  // p scale
        }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = sc[n][e] * (dp[n][e] - row_delta[e / 2]);  // ds
      pack_a<N8>(dsa, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D, 1>(acc, dsa[kk], mnmajor_desc<BN>(sK, kk));
      wgmma_commit();
    }
    wgmma_wait<0>();  // nothing may be in flight at exit
    fence_regs(acc);
    store_strip<D8>(dq + bi * dqs.b + hi * dqs.h, dqs.s, wrow, dm.sq, acc, 1.0f, 1.0f);
  }
}

template <int D>
cudaError_t launch_dq_d(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                        const float* lse, const float* delta, bf16* dq, const Strides* st,
                        const Dims& dm, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap qmap{}, kmap{}, vmap{}, domap{};
  cudaError_t err = make_map(&qmap, q, D, dm.sq, dm.h, dm.b, st[0], C::BM);
  if (err == cudaSuccess) err = make_map(&domap, dout, D, dm.sq, dm.h, dm.b, st[3], C::BM);
  if (err == cudaSuccess && dm.sk > 0) err = make_map(&kmap, k, D, dm.sk, dm.hk, dm.b, st[1], C::BN);
  if (err == cudaSuccess && dm.sk > 0) err = make_map(&vmap, v, D, dm.sk, dm.hk, dm.b, st[2], C::BN);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kAlloc);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sq + C::BM - 1) / C::BM, dm.b * dm.h);
  kernel<<<grid, kThreads, C::kAlloc, stream>>>(qmap, kmap, vmap, domap, lse, delta, dq, st[4],
                                                dm);
  return cudaGetLastError();
}

cudaError_t launch_dq(int d, const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* delta, bf16* dq, const Strides* st,
                      const Dims& dm, cudaStream_t stream) {
  // the kernel folds log2(scale) into the exponent, which needs scale > 0
  if (!(dm.scale > 0.0f)) return cudaErrorInvalidValue;
  if (d == 64) return launch_dq_d<64>(q, k, v, dout, lse, delta, dq, st, dm, stream);
  if (d == 128) return launch_dq_d<128>(q, k, v, dout, lse, delta, dq, st, dm, stream);
  return cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace rtt

// Dynamic shared memory of one block of the kernel at head dim d (0 if none).
extern "C" int rtt_flash_bwd_dq_sm90_smem(int head_dim) {
  if (head_dim == 64) return rtt::sm90::DqCfg<64>::kAlloc;
  if (head_dim == 128) return rtt::sm90::DqCfg<128>::kAlloc;
  return 0;
}
