// Flash-attention forward for Hopper (sm_90a), bf16 at head dims 64 and 128:
// warp-specialised, TMA loads into a ring of shared-memory stages, wgmma on
// two consumer warpgroups.
//
// Replaces: ray_tpu/ops/pallas/flash_attention.py, _flash_fwd_kernel
// (launched by _flash_forward). Same function as the mma.sync kernel of
// flash_attention_fwd.cu, which still serves bf16 at d in {16, 32}:
// blockwise online softmax, causal block skipping, the in-block mask
// q_pos >= k_pos (top-left), GQA through kv head = h // (h / hk), outputs
// `out` (bf16) and lse = m + log(l); a row with no unmasked key gets out = 0,
// lse = 1e30. P is rounded to bf16 before P V, as the reference rounds it to
// v's dtype.
//
// What bounds it on the H100: 4 d flops per (query, key) pair against 2 d
// bytes of K and V per key tile; at the training shapes (s = 2048, d = 64)
// that is far above the 295 flops/byte ridge, so the tensor cores bound it,
// and only wgmma reaches their full rate.
//
// Design.
// - Block: 3 warpgroups. Warpgroup 0 is the producer: setmaxnreg drops it to
//   40 registers and one thread issues every load. Warpgroups 1 and 2 are the
//   consumers (raised to 232 registers); each owns 64 query rows, so a block
//   owns 128. Grid (query tiles of 128, b * h); under causal masking the
//   heaviest (last) query tiles start first.
// - Loads: TMA through 4-D tensor maps over (d, s, h, b) with the tensors' own
//   strides, 128-byte swizzle, one 64-column box per region. The Q tile is
//   loaded once; K and V tiles of BN keys stream through kStages stages with
//   a full mbarrier (TMA bytes) and an empty mbarrier (256 consumer arrivals)
//   each. Rows past sk arrive as zeros and are masked.
// - Products: S = Q K^T by wgmma m64nBNk16 with both operands K-major in
//   shared memory; the online softmax runs on the accumulator registers
//   (exp2, the scale folded into one FFMA, masking only on tiles that cross
//   the diagonal or the ragged edge, a masked p selected to exactly 0); P is
//   rounded to bf16 and repacked in registers as the A operand of O += P V,
//   whose B operand is the V tile read MN-major through the transpose bit.
// - Overlap: a warpgroup issues P V of key tile j - 1 right behind Q K^T of
//   tile j, so the tensor cores work through tile j - 1 while the warpgroup
//   runs tile j's softmax; the stage of tile j - 1 goes back to the producer
//   once that P V is done. The two consumer warpgroups take turns to issue
//   their products (ping-pong on two named barriers), so one's softmax also
//   overlaps the other's products (3% faster than free-running warpgroups on
//   the card at both head dims).
// - Tiles: BN = 128 at both head dims (S takes 64 accumulator registers, O 32
//   or 64). Stages: 3 (112 KB of shared memory at d = 64, 225 KB at
//   d = 128): the stage of tile j - 1 stays busy until its P V is done, under
//   tile j's softmax, and at d = 128 a third stage took the kernel from 0.20
//   to 0.17 ms at b8 s2048 h8 (H100 SXM, 700 W). One block per SM either
//   way, as the register file is full.
// - Bound in practice at d = 64: each score takes one ex2 on the
//   special-function unit (16 a clock per SM), which for a 64 x 128 tile
//   lasts as long as the tile's two products on the tensor cores; so the
//   softmax of one warpgroup only just fits under the other's products.
#include "flash_sm90.cuh"

namespace rtt {
namespace sm90 {

template <int D>
struct FwdCfg {
  static constexpr int BM = 64 * kConsumers;  // query rows per block
  static constexpr int BN = 128;              // keys per streamed tile
  static constexpr int kStages = 3;
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + tile_bytes(BM, D);
  static constexpr int kStage = 2 * tile_bytes(BN, D);  // K tile, then V tile
  static constexpr int kBars = kKV + kStages * kStage;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                           float* __restrict__ lse, Strides os, Dims dm) {
  using C = FwdCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + C::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + S;

  // causal: the last query tiles have the most keys; start them first
  const int q0 = (dm.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BM;
  const int bi = blockIdx.y / dm.h;
  const int hi = blockIdx.y % dm.h;
  const int kvh = hi / (dm.h / dm.hk);
  const int k_end = dm.causal ? min(dm.sk, q0 + BM) : dm.sk;
  const int n_tiles = (k_end + BN - 1) / BN;
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
      mbar_expect_tx(q_full, tile_bytes(BM, D));
      tma_load_rows<D, BM>(sQ, &qmap, q_full, q0, hi, bi);
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
    const float scale2 = dm.scale * kLog2e;  // p = exp2(s scale2 - m scale2)

    float acc[D8][4];
    zero(acc);
    // running max of the raw scores, and this lane's share of the row sums
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    uint32_t pa[N8 / 2][4];  // P of the previous key tile: the A operand of its P V

    // S = Q K^T for the key tile in stage s (one commit group)
    auto issue_qk = [&](float (&sc)[N8][4], int s) {
      const unsigned char* sK = smem + C::kKV + s * C::kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, 0>(sc, kmajor_desc<BM>(sQ, r0, kk), kmajor_desc<BN>(sK, 0, kk), kk);
      wgmma_commit();
    };
    // O += P V for the key tile whose V sits in stage s (one commit group)
    auto issue_pv = [&](int s) {
      const unsigned char* sV = smem + C::kKV + s * C::kStage + tile_bytes(BN, D);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D, 1>(acc, pa[kk], mnmajor_desc<BN>(sV, kk));
      wgmma_commit();
    };
    // Online softmax of the scores of key tile j, in place (sc becomes p);
    // updates m and l and returns the factor that rescales O.
    auto softmax = [&](float (&sc)[N8][4], int j, float (&alpha)[2]) {
      const int k0 = j * BN;
      // only a tile that crosses the diagonal or the ragged edge needs masking
      const bool edge = k0 + BN > dm.sk || (dm.causal && k0 + BN - 1 > wrow);
      if (edge) {
#pragma unroll
        for (int n = 0; n < N8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + n * 8 + col + (e & 1);
            if (kpos >= dm.sk || (dm.causal && row[e / 2] < kpos)) sc[n][e] = kNegInf;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[n][e]);
      float ms[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = quad_max(mx[i]);
        alpha[i] = fast_exp2((m[i] - m_new) * scale2);
        m[i] = m_new;
        ms[i] = m_new * scale2;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is exactly kNegInf; its p is 0 even in a row with
          // no unmasked key so far (where m is still kNegInf)
          float p = fast_exp2(fmaf(sc[n][e], scale2, -ms[e / 2]));
          if (edge && sc[n][e] == kNegInf) p = 0.0f;
          sc[n][e] = p;
          l[e / 2] += p;
        }
    };

    // Ping-pong: the two warpgroups take turns to issue their products
    // (barrier `wg` is this warpgroup's turn), so one's products run while
    // the other is in its softmax. n_tiles + 1 turns each; warpgroup 2 opens
    // the first turn of warpgroup 1 and gives up its own last one.
    const int n_turns = n_tiles > 0 ? n_tiles + 1 : 0;
    int turn = 0;
    auto take_turn = [&]() { consumer_sync(wg); };
    auto pass_turn = [&]() {
      if (++turn < n_turns || wg == 1) consumer_arrive(3 - wg);
    };
    if (wg == 2 && n_turns > 0) consumer_arrive(1);

    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      float sc[N8][4], alpha[2];
      mbar_wait(&kv_full[0], 0);
      take_turn();
      issue_qk(sc, 0);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, 0, alpha);  // O is still 0: no rescale
      pack_a<N8>(pa, sc);
    }
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % S;
      mbar_wait(&kv_full[s], (j / S) & 1);
      float sc[N8][4], alpha[2];
      take_turn();
      issue_qk(sc, s);
      issue_pv((j - 1) % S);  // the previous tile's P V runs under this softmax
      pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(sc, j, alpha);
      wgmma_wait<0>();  // the previous P V is done: its stage goes back
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&kv_empty[(j - 1) % S]);
#pragma unroll
      for (int n = 0; n < D8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      pack_a<N8>(pa, sc);
    }
    if (n_tiles > 0) {
      take_turn();
      issue_pv((n_tiles - 1) % S);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&kv_empty[(n_tiles - 1) % S]);
    }

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = quad_sum(l[i]);
      inv[i] = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
    }
    store_strip<D8>(o + bi * os.b + hi * os.h, os.s, wrow, dm.sq, acc, inv[0], inv[1]);
    if (lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row[i] < dm.sq)
          lse[(static_cast<int64_t>(bi) * dm.h + hi) * dm.sq + row[i]] =
              l[i] > 0.0f ? m[i] * dm.scale + logf(l[i]) : kMaskedLse;
    }
  }
}

template <int D>
cudaError_t launch_fwd_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                         const Strides& qs, const Strides& ks, const Strides& vs,
                         const Strides& os, const Dims& dm, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap qmap{}, kmap{}, vmap{};
  cudaError_t err = make_map(&qmap, q, D, dm.sq, dm.h, dm.b, qs, C::BM);
  if (err == cudaSuccess && dm.sk > 0) err = make_map(&kmap, k, D, dm.sk, dm.hk, dm.b, ks, C::BN);
  if (err == cudaSuccess && dm.sk > 0) err = make_map(&vmap, v, D, dm.sk, dm.hk, dm.b, vs, C::BN);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kAlloc);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sq + C::BM - 1) / C::BM, dm.b * dm.h);
  kernel<<<grid, kThreads, C::kAlloc, stream>>>(qmap, kmap, vmap, o, lse, os, dm);
  return cudaGetLastError();
}

cudaError_t launch_fwd(int d, const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                       const Strides& qs, const Strides& ks, const Strides& vs,
                       const Strides& os, const Dims& dm, cudaStream_t stream) {
  // the softmax takes the row max of the raw scores, which needs scale > 0
  if (!(dm.scale > 0.0f)) return cudaErrorInvalidValue;
  if (d == 64) return launch_fwd_d<64>(q, k, v, o, lse, qs, ks, vs, os, dm, stream);
  if (d == 128) return launch_fwd_d<128>(q, k, v, o, lse, qs, ks, vs, os, dm, stream);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found at run time, so the library
// needs no link against libcuda.
static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

cudaError_t make_map(CUtensorMap* map, const void* base, int d, int s, int h, int b,
                     const Strides& st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kRegionCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace rtt

// Dynamic shared memory of one block of the kernel at head dim d (0 if none).
extern "C" int rtt_flash_fwd_sm90_smem(int head_dim) {
  if (head_dim == 64) return rtt::sm90::FwdCfg<64>::kAlloc;
  if (head_dim == 128) return rtt::sm90::FwdCfg<128>::kAlloc;
  return 0;
}
