// Flash-attention dK/dV for Hopper (sm_90a), bf16 at head dims 64 and 128:
// warp-specialised, TMA loads into a ring of shared-memory stages, wgmma on
// two consumer warpgroups.
//
// Replaces: ray_tpu/ops/pallas/flash_attention.py, _flash_bwd_dkv_kernel
// (launched by _flash_backward). Same function as the mma.sync kernel of
// flash_attention_bwd.cu, which still serves bf16 at d in {16, 32}: from the
// saved lse and delta = rowsum(dO * O),
//   p = exp(s - lse), dp = dO V^T, ds = p (dp - delta) scale,
//   dV += p^T dO, dK += ds^T Q, summed over the query heads of a kv head,
// with p rounded to bf16 before p^T dO and ds before ds^T Q, as the
// reference rounds them. Masking is the forward's: top-left causal plus the
// ragged edges of both sequences.
//
// What bounds it on the H100: 8 d flops per (query, key) pair against 4 d
// bytes of Q and dO per query tile; the tensor cores bound it at the
// training shapes, and only wgmma reaches their full rate.
//
// Design.
// - Block: 3 warpgroups. Warpgroup 0 is the producer (setmaxnreg to 40
//   registers; its first warp loads, its other warps leave); warpgroups 1
//   and 2 are the consumers (232 registers), each owning 64 key rows of the
//   block's 128, of one (batch, kv head). K and V are loaded once by TMA.
// - The block walks every query tile of every query head of its kv head (the
//   GQA sum stays inside the block: no atomics, no per-head f32 scratch).
//   Q and dO tiles of BQ queries stream through kStages stages by TMA, with
//   that tile's lse (times log2 e) and delta, which the producer warp's 32
//   lanes copy into the stage and arrive on its full barrier for. Under
//   causal masking the query tiles that end before the block's first key are
//   skipped. (The second warpgroup still runs the first tile of each head,
//   which lies wholly above its diagonal, with p = 0: a warpgroup that skips
//   a tile puts its wgmma waits on a divergent path, which ptxas serialises.)
// - Products: S^T = K Q^T and dP^T = V dO^T by wgmma with A = K or V and B =
//   Q or dO, all K-major in shared memory, committed as two groups so the
//   softmax of S^T starts while dP^T runs. p^T and ds^T are computed on the
//   accumulator registers, rounded to bf16 and repacked as register A
//   operands of dV += P^T dO and dK += dS^T Q, whose B operands are the same
//   Q and dO tiles read MN-major through the transpose bit: one copy of each
//   tile serves all four products. At d = 64 the dV and dK products of a
//   tile run on while the next tile's S^T and dP^T are issued, and its stage
//   goes back to the producer when they are done.
// - Traps. (1) lse and delta past the ragged edge of sq are not rows of a
//   tensor map: the producer writes 0 there, and a masked p is chosen by a
//   select, never by a multiply, so no stale value can reach p (dp - delta).
//   (2) Registers at d = 128: the dK and dV accumulators take 64 registers
//   each; with S^T and dP^T (32 each at BQ = 64) and the packed operands the
//   consumer stays inside its 232 only if p and ds are computed before dV
//   and dK are issued and those finish inside the tile (the build's ptxas
//   report shows no spill).
// - Stages: 3 at d = 64 (80 KB of shared memory), 2 at d = 128 (128 KB).
#include "flash_sm90.cuh"

namespace rtt {
namespace sm90 {

template <int D>
struct DkvCfg {
  static constexpr int BM = 64 * kConsumers;  // key rows per block
  static constexpr int BQ = 64;               // queries per streamed tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + tile_bytes(BM, D);
  static constexpr int kQ = kV + tile_bytes(BM, D);
  static constexpr int kStage = 2 * tile_bytes(BQ, D);  // Q tile, then dO tile
  static constexpr int kStats = kQ + kStages * kStage;  // per stage: lse[BQ], delta[BQ]
  static constexpr int kBars = kStats + kStages * 2 * BQ * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, Strides dks,
                               Strides dvs, Dims dm) {
  using C = DkvCfg<D>;
  constexpr int BM = C::BM, BQ = C::BQ, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem + C::kK;
  unsigned char* sV = smem + C::kV;
  float* stats = reinterpret_cast<float*>(smem + C::kStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int k0 = blockIdx.x * BM;
  const int bi = blockIdx.y / dm.hk;
  const int kvh = blockIdx.y % dm.hk;
  const int n_rep = dm.h / dm.hk;
  // causal: query tiles that end before this block's first key see none of it
  const int q_begin = dm.causal ? k0 / BQ * BQ : 0;
  const int q_tiles = dm.sq > q_begin ? (dm.sq - q_begin + BQ - 1) / BQ : 0;
  const int n_steps = n_rep * q_tiles;  // (query head of the group, query tile)
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    regs_dealloc<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * tile_bytes(BM, D));
        tma_load_rows<D, BM>(sK, &kmap, kv_full, k0, kvh, bi);
        tma_load_rows<D, BM>(sV, &vmap, kv_full, k0, kvh, bi);
      }
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % S;
        const int hi = kvh * n_rep + t / q_tiles;
        const int q0 = q_begin + (t % q_tiles) * BQ;
        mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        const int64_t row_base = (static_cast<int64_t>(bi) * dm.h + hi) * dm.sq;
        float* st = stats + s * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const bool valid = q0 + i < dm.sq;  // past the edge: 0, never read unmasked
          st[i] = valid ? lse[row_base + q0 + i] * kLog2e : 0.0f;
          st[BQ + i] = valid ? delta[row_base + q0 + i] : 0.0f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], C::kStage);
          unsigned char* sQ = smem + C::kQ + s * C::kStage;
          tma_load_rows<D, BQ>(sQ, &qmap, &full[s], q0, hi, bi);
          tma_load_rows<D, BQ>(sQ + tile_bytes(BQ, D), &domap, &full[s], q0, hi, bi);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<kConsumerRegs>();
    constexpr int Q8 = BQ / 8;
    constexpr int D8 = D / 8;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int r0 = (wg - 1) * 64;          // the warpgroup's first key row in the block
    const int kw = k0 + r0;                // the warpgroup's first key
    const int kwarp = kw + warp * 16;      // the warp's first key
    // this lane's two key rows and its column pair within a query tile
    const int krow[2] = {kwarp + lane / 4, kwarp + lane / 4 + 8};
    const int col = (lane % 4) * 2;
    const float scale2 = dm.scale * kLog2e;  // p = exp2(s scale2 - lse log2 e)

    // at d = 64 the dV and dK products of a tile stay in flight under the
    // next tile's S^T; at d = 128 their accumulators leave no registers for it
    constexpr bool kCarry = D == 64;
    float dk_acc[D8][4], dv_acc[D8][4];
    zero(dk_acc);
    zero(dv_acc);
    uint32_t pa[Q8 / 2][4], dsa[Q8 / 2][4];  // p^T and ds^T: A operands of dV, dK
    auto fence_products = [&]() {  // dV and dK are done: their operands are free
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
    };
    mbar_wait(kv_full, 0);
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % S;
      const int q0 = q_begin + (t % q_tiles) * BQ;
      const unsigned char* sQ = smem + C::kQ + s * C::kStage;
      const unsigned char* sDo = sQ + tile_bytes(BQ, D);
      const float* sLse = stats + s * 2 * BQ;
      const float* sDelta = sLse + BQ;
      mbar_wait(&full[s], (t / S) & 1);

      float st[Q8][4], dpt[Q8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(st, kmajor_desc<BM>(sK, r0, kk), kmajor_desc<BQ>(sQ, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(dpt, kmajor_desc<BM>(sV, r0, kk), kmajor_desc<BQ>(sDo, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();  // S^T and the previous tile's dV, dK are in; dP^T may still run
      fence_regs(st);
      if constexpr (kCarry) {
        fence_products();
        if (t > 0) mbar_arrive(&empty[(t - 1) % S]);
      }

      // masking: ragged edges, and causal pairs (the first query tile of each
      // head may be masked whole for the second warpgroup: p is 0 there)
      const bool edge = q0 + BQ > dm.sq || kwarp + 16 > dm.sk || (dm.causal && q0 < kwarp + 15);
#pragma unroll
      for (int n = 0; n < Q8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + col + (e & 1);
          float p = fast_exp2(fmaf(st[n][e], scale2, -sLse[c]));
          if (edge) {
            const int qpos = q0 + c;
            const int kpos = krow[e / 2];
            if (kpos >= dm.sk || qpos >= dm.sq || (dm.causal && qpos < kpos)) p = 0.0f;
          }
          st[n][e] = p;  // p^T
        }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < Q8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + col + (e & 1);
          dpt[n][e] = st[n][e] * (dpt[n][e] - sDelta[c]) * dm.scale;  // ds^T
        }
      pack_a<Q8>(pa, st);
      pack_a<Q8>(dsa, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dv_acc, pa[kk], mnmajor_desc<BQ>(sDo, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dk_acc, dsa[kk], mnmajor_desc<BQ>(sQ, kk));
      wgmma_commit();
      if constexpr (!kCarry) {
        wgmma_wait<0>();
        fence_products();
        mbar_arrive(&empty[s]);
      }
    }
    if constexpr (kCarry) {
      wgmma_wait<0>();
      fence_products();
      if (n_steps > 0) mbar_arrive(&empty[(n_steps - 1) % S]);
    }
    store_strip<D8>(dk + bi * dks.b + kvh * dks.h, dks.s, kwarp, dm.sk, dk_acc, 1.0f, 1.0f);
    store_strip<D8>(dv + bi * dvs.b + kvh * dvs.h, dvs.s, kwarp, dm.sk, dv_acc, 1.0f, 1.0f);
  }
}

template <int D>
cudaError_t launch_dkv_d(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                         const float* lse, const float* delta, bf16* dk, bf16* dv,
                         const Strides* st, const Dims& dm, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap qmap{}, kmap{}, vmap{}, domap{};
  cudaError_t err = make_map(&kmap, k, D, dm.sk, dm.hk, dm.b, st[1], C::BM);
  if (err == cudaSuccess) err = make_map(&vmap, v, D, dm.sk, dm.hk, dm.b, st[2], C::BM);
  if (err == cudaSuccess && dm.sq > 0) err = make_map(&qmap, q, D, dm.sq, dm.h, dm.b, st[0], C::BQ);
  if (err == cudaSuccess && dm.sq > 0)
    err = make_map(&domap, dout, D, dm.sq, dm.h, dm.b, st[3], C::BQ);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kAlloc);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sk + C::BM - 1) / C::BM, dm.b * dm.hk);
  kernel<<<grid, kThreads, C::kAlloc, stream>>>(qmap, kmap, vmap, domap, lse, delta, dk, dv,
                                                st[4], st[5], dm);
  return cudaGetLastError();
}

cudaError_t launch_dkv(int d, const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* delta, bf16* dk, bf16* dv,
                       const Strides* st, const Dims& dm, cudaStream_t stream) {
  if (d == 64) return launch_dkv_d<64>(q, k, v, dout, lse, delta, dk, dv, st, dm, stream);
  if (d == 128) return launch_dkv_d<128>(q, k, v, dout, lse, delta, dk, dv, st, dm, stream);
  return cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace rtt

// Dynamic shared memory of one block of the kernel at head dim d (0 if none).
extern "C" int rtt_flash_bwd_dkv_sm90_smem(int head_dim) {
  if (head_dim == 64) return rtt::sm90::DkvCfg<64>::kAlloc;
  if (head_dim == 128) return rtt::sm90::DkvCfg<128>::kAlloc;
  return 0;
}
