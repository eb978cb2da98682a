// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: ray_tpu/ops/pallas/flash_attention.py, _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (launched by _flash_backward). Same math, from the
// saved lse and delta = rowsum(dO * O):
//   p = exp(s - lse), dp = dO V^T, ds = p (dp - delta) scale,
//   dQ += ds K, dV += p^T dO, dK += ds^T Q, all accumulated in f32.
// p is rounded to dO's type before p^T dO and ds to the input type before the
// ds products, where the reference rounds them too. Masking is the forward's:
// top-left causal (q_pos >= k_pos) plus the ragged edges of both sequences.
//
// What bounds it on the H100: 6 d (dQ) and 8 d (dK/dV) flops per (query, key)
// pair against one read of q, k, v, dO: tensor-core bound at the training
// shapes, like the forward.
//
// Design. dQ: grid (query tiles of 64, b * h); each warp owns 16 query rows
// and walks the key tiles with a loop inside the block, as the forward does.
// dK/dV: grid (key tiles of 64, b * hk); each warp owns 16 key rows, and the
// block walks every query tile of every query head of its kv-head group (the
// GQA sum happens inside the block: no per-query-head f32 scratch, no
// atomics). It computes S^T and dP^T directly (key rows x query columns), so
// both products it accumulates take their left operand from registers.
// bf16 kernels: scores, p, ds and the dQ / dK / dV accumulators live in
// registers, every product runs on mma.sync (bf16 in, f32 accumulate) fed by
// ldmatrix, and p and ds go from accumulator to A fragment by repacking in
// registers; the streamed tiles (K, V for dQ; Q, dO, lse, delta for dK/dV)
// pass through two shared-memory stages with cp.async, so the next tile's
// copy overlaps the current tile's products. f32 kernels: the same loops with
// plain FMA on shared-memory strips, to hold the algorithm at f32 tolerances.
//
// Which kernel serves which call: bf16 at d in {64, 128} goes to the
// warp-specialised wgmma kernels, dQ to flash_attention_bwd_dq_sm90.cu and
// dK/dV to flash_attention_bwd_sm90.cu; bf16 at d in {16, 32} to the
// mma.sync kernels below; f32 to the FMA kernels below.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace rtt {

// ------------------------------------------------------- f32 kernels: dQ
template <int D, int BN>
struct DqSmem {
  static constexpr int kLdT = D + pad<float>();
  static constexpr int kLdS = BN + 4;  // scores, then ds in place
  static constexpr int kLdO = D + 4;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + align128(1LL * kBlockM * kLdT * 4);
  static constexpr int kK = kDo + align128(1LL * kBlockM * kLdT * 4);
  static constexpr int kV = kK + align128(1LL * BN * kLdT * 4);
  static constexpr int kS = kV + align128(1LL * BN * kLdT * 4);
  static constexpr int kDp = kS + align128(1LL * kBlockM * kLdS * 4);
  static constexpr int kDq = kDp + align128(1LL * kBlockM * kLdS * 4);
  static constexpr int kLse = kDq + align128(1LL * kBlockM * kLdO * 4);
  static constexpr int kDelta = kLse + align128(kBlockM * 4);
  static constexpr int kBytes = kDelta + align128(kBlockM * 4);
};

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, Dims dm) {
  using L = DqSmem<D, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sDo = reinterpret_cast<float*>(smem + L::kDo);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDp = reinterpret_cast<float*>(smem + L::kDp);
  float* sDq = reinterpret_cast<float*>(smem + L::kDq);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int q0 = blockIdx.x * kBlockM;
  const int bi = blockIdx.y / dm.h;
  const int hi = blockIdx.y % dm.h;
  const int kvh = hi / (dm.h / dm.hk);
  const int64_t row_base = (static_cast<int64_t>(bi) * dm.h + hi) * dm.sq;

  const float* kb = k + bi * ks.b + kvh * ks.h;
  const float* vb = v + bi * vs.b + kvh * vs.h;
  load_rows<float, D>(sQ, L::kLdT, q + bi * qs.b + hi * qs.h, qs.s, q0, dm.sq, kBlockM);
  load_rows<float, D>(sDo, L::kLdT, dout + bi * dos.b + hi * dos.h, dos.s, q0, dm.sq, kBlockM);
  load_row_stats(sLse, lse + row_base, q0, dm.sq, kBlockM, kMaskedLse);
  load_row_stats(sDelta, delta + row_base, q0, dm.sq, kBlockM, 0.0f);
  for (int i = threadIdx.x; i < kBlockM * L::kLdO; i += kThreads) sDq[i] = 0.0f;

  const int k_end = dm.causal ? min(dm.sk, q0 + kBlockM) : dm.sk;
  const int n_tiles = (k_end + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_rows<float, D>(sK, L::kLdT, kb, ks.s, k0, dm.sk, BN);
    load_rows<float, D>(sV, L::kLdT, vb, vs.s, k0, dm.sk, BN);
    __syncthreads();

    // S = Q K^T, dP = dO V^T for this warp's 16 query rows
    warp_gemm_fma<false, BN, D>(sS + r0 * L::kLdS, L::kLdS, sQ + r0 * L::kLdT, L::kLdT, sK,
                                L::kLdT, false);
    warp_gemm_fma<false, BN, D>(sDp + r0 * L::kLdS, L::kLdS, sDo + r0 * L::kLdT, L::kLdT, sV,
                                L::kLdT, false);
    __syncwarp();

    for (int idx = lane; idx < 16 * BN; idx += 32) {
      const int row = r0 + idx / BN;
      const int c = idx % BN;
      const int qpos = q0 + row;
      const int kpos = k0 + c;
      const bool ok = qpos < dm.sq && kpos < dm.sk && (!dm.causal || qpos >= kpos);
      const float p = ok ? expf(sS[row * L::kLdS + c] * dm.scale - sLse[row]) : 0.0f;
      const float ds = p * (sDp[row * L::kLdS + c] - sDelta[row]) * dm.scale;
      sS[row * L::kLdS + c] = ds;
    }
    __syncwarp();

    // dQ += dS K
    warp_gemm_fma<true, D, BN>(sDq + r0 * L::kLdO, L::kLdO, sS + r0 * L::kLdS, L::kLdS, sK,
                               L::kLdT, true);
    __syncwarp();
  }

  float* dqb = dq + bi * dqs.b + hi * dqs.h;
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int row = r0 + idx / D;
    const int c = idx % D;
    const int qpos = q0 + row;
    if (qpos < dm.sq) dqb[qpos * dqs.s + c] = sDq[row * L::kLdO + c];
  }
}

// ---------------------------------------------------- f32 kernels: dK/dV
template <int D, int BN>
struct DkvSmem {
  static constexpr int kLdT = D + pad<float>();
  static constexpr int kLdS = BN + 4;  // S^T, dP^T, then p^T, ds^T in place
  static constexpr int kLdO = D + 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + align128(1LL * kBlockM * kLdT * 4);
  static constexpr int kQ = kV + align128(1LL * kBlockM * kLdT * 4);
  static constexpr int kDo = kQ + align128(1LL * BN * kLdT * 4);
  static constexpr int kSt = kDo + align128(1LL * BN * kLdT * 4);
  static constexpr int kDpt = kSt + align128(1LL * kBlockM * kLdS * 4);
  static constexpr int kDk = kDpt + align128(1LL * kBlockM * kLdS * 4);
  static constexpr int kDv = kDk + align128(1LL * kBlockM * kLdO * 4);
  static constexpr int kLse = kDv + align128(1LL * kBlockM * kLdO * 4);
  static constexpr int kDelta = kLse + align128(BN * 4);
  static constexpr int kBytes = kDelta + align128(BN * 4);
};

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dks, Strides dvs, Dims dm) {
  using L = DkvSmem<D, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sDo = reinterpret_cast<float*>(smem + L::kDo);
  float* sSt = reinterpret_cast<float*>(smem + L::kSt);
  float* sDpt = reinterpret_cast<float*>(smem + L::kDpt);
  float* sDk = reinterpret_cast<float*>(smem + L::kDk);
  float* sDv = reinterpret_cast<float*>(smem + L::kDv);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int k0 = blockIdx.x * kBlockM;
  const int bi = blockIdx.y / dm.hk;
  const int kvh = blockIdx.y % dm.hk;
  const int n_rep = dm.h / dm.hk;

  load_rows<float, D>(sK, L::kLdT, k + bi * ks.b + kvh * ks.h, ks.s, k0, dm.sk, kBlockM);
  load_rows<float, D>(sV, L::kLdT, v + bi * vs.b + kvh * vs.h, vs.s, k0, dm.sk, kBlockM);
  for (int i = threadIdx.x; i < kBlockM * L::kLdO; i += kThreads) {
    sDk[i] = 0.0f;
    sDv[i] = 0.0f;
  }

  // causal: query tiles that end before this block's first key see none of it
  const int first_tile = dm.causal ? k0 / BN : 0;
  const int n_tiles = (dm.sq + BN - 1) / BN;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int hi = kvh * n_rep + rep;
    const float* qb = q + bi * qs.b + hi * qs.h;
    const float* dob = dout + bi * dos.b + hi * dos.h;
    const int64_t row_base = (static_cast<int64_t>(bi) * dm.h + hi) * dm.sq;
    for (int t = first_tile; t < n_tiles; ++t) {
      const int q0 = t * BN;
      __syncthreads();
      load_rows<float, D>(sQ, L::kLdT, qb, qs.s, q0, dm.sq, BN);
      load_rows<float, D>(sDo, L::kLdT, dob, dos.s, q0, dm.sq, BN);
      load_row_stats(sLse, lse + row_base, q0, dm.sq, BN, kMaskedLse);
      load_row_stats(sDelta, delta + row_base, q0, dm.sq, BN, 0.0f);
      __syncthreads();

      // S^T = K Q^T, dP^T = V dO^T for this warp's 16 key rows
      warp_gemm_fma<false, BN, D>(sSt + r0 * L::kLdS, L::kLdS, sK + r0 * L::kLdT, L::kLdT,
                                  sQ, L::kLdT, false);
      warp_gemm_fma<false, BN, D>(sDpt + r0 * L::kLdS, L::kLdS, sV + r0 * L::kLdT, L::kLdT,
                                  sDo, L::kLdT, false);
      __syncwarp();

      for (int idx = lane; idx < 16 * BN; idx += 32) {
        const int row = r0 + idx / BN;
        const int c = idx % BN;
        const int kpos = k0 + row;
        const int qpos = q0 + c;
        const bool ok = kpos < dm.sk && qpos < dm.sq && (!dm.causal || qpos >= kpos);
        const float p = ok ? expf(sSt[row * L::kLdS + c] * dm.scale - sLse[c]) : 0.0f;
        const float ds = p * (sDpt[row * L::kLdS + c] - sDelta[c]) * dm.scale;
        sSt[row * L::kLdS + c] = p;
        sDpt[row * L::kLdS + c] = ds;
      }
      __syncwarp();

      // dV += P^T dO, dK += dS^T Q
      warp_gemm_fma<true, D, BN>(sDv + r0 * L::kLdO, L::kLdO, sSt + r0 * L::kLdS, L::kLdS,
                                 sDo, L::kLdT, true);
      warp_gemm_fma<true, D, BN>(sDk + r0 * L::kLdO, L::kLdO, sDpt + r0 * L::kLdS, L::kLdS,
                                 sQ, L::kLdT, true);
      __syncwarp();
    }
  }

  float* dkb = dk + bi * dks.b + kvh * dks.h;
  float* dvb = dv + bi * dvs.b + kvh * dvs.h;
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int row = r0 + idx / D;
    const int c = idx % D;
    const int kpos = k0 + row;
    if (kpos < dm.sk) {
      dkb[kpos * dks.s + c] = sDk[row * L::kLdO + c];
      dvb[kpos * dvs.s + c] = sDv[row * L::kLdO + c];
    }
  }
}

// ----------------------------------------------------------- bf16 kernels
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dq, Strides qs, Strides ks, Strides vs,
                            Strides dos, Strides dqs, Dims dm) {
  constexpr int BN = 64;
  constexpr int LD = D + pad<bf16>();
  constexpr int N8 = BN / 8;
  constexpr int D8 = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDo = sQ + kBlockM * LD;
  bf16* sKV = sDo + kBlockM * LD;  // two stages of (K tile, V tile)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // causal: the last query tiles have the most keys; start them first
  const int q0 = (dm.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBlockM;
  const int bi = blockIdx.y / dm.h;
  const int hi = blockIdx.y % dm.h;
  const int kvh = hi / (dm.h / dm.hk);
  const int64_t row_base = (static_cast<int64_t>(bi) * dm.h + hi) * dm.sq;
  const bf16* kb = k + bi * ks.b + kvh * ks.h;
  const bf16* vb = v + bi * vs.b + kvh * vs.h;
  const int row[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  const int col = (lane % 4) * 2;
  const float scale2 = dm.scale * kLog2e;  // p = exp2(s scale log2 e - lse log2 e)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lse[i] = (row[i] < dm.sq ? lse[row_base + row[i]] : kMaskedLse) * kLog2e;
    row_delta[i] = row[i] < dm.sq ? delta[row_base + row[i]] : 0.0f;
  }

  const int k_end = dm.causal ? min(dm.sk, q0 + kBlockM) : dm.sk;
  const int n_tiles = (k_end + BN - 1) / BN;
  auto load_kv = [&](int j) {
    bf16* st = sKV + (j & 1) * 2 * BN * LD;
    load_rows_async<D>(st, LD, kb, ks.s, j * BN, dm.sk, BN);
    load_rows_async<D>(st + BN * LD, LD, vb, vs.s, j * BN, dm.sk, BN);
  };
  load_rows_async<D>(sQ, LD, q + bi * qs.b + hi * qs.h, qs.s, q0, dm.sq, kBlockM);
  load_rows_async<D>(sDo, LD, dout + bi * dos.b + hi * dos.h, dos.s, q0, dm.sq, kBlockM);
  load_kv(0);
  cp_async_commit();

  float acc[D8][4];
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    if (j + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sKV + (j & 1) * 2 * BN * LD;
    const bf16* sV = sK + BN * LD;

    float s[N8][4], dp[N8][4];
    zero(s);
    zero(dp);
    warp_mma_nt<N8, D / 16>(s, sQ + warp * 16 * LD, LD, sK, LD);
    warp_mma_nt<N8, D / 16>(dp, sDo + warp * 16 * LD, LD, sV, LD);
    // only a tile that crosses the diagonal or a ragged edge needs masking
    const bool edge = k0 + BN > dm.sk || q0 + warp * 16 + 16 > dm.sq ||
                      (dm.causal && k0 + BN - 1 > q0 + warp * 16);
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        float p = exp2f(s[n][e] * scale2 - row_lse[i]);
        if (edge) {
          const int kpos = k0 + n * 8 + col + (e & 1);
          if (row[i] >= dm.sq || kpos >= dm.sk || (dm.causal && row[i] < kpos)) p = 0.0f;
        }
        s[n][e] = p * (dp[n][e] - row_delta[i]) * dm.scale;  // ds
      }
    uint32_t dsa[N8 / 2][4];
    pack_a<N8>(dsa, s);
    warp_mma_nn<D8, N8 / 2>(acc, dsa, sK, LD);
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();  // nothing may be in flight at exit (sk == 0)
  store_strip<D8>(dq + bi * dqs.b + hi * dqs.h, dqs.s, q0 + warp * 16, dm.sq, acc, 1.0f, 1.0f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, Strides qs,
                             Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                             Dims dm) {
  constexpr int BN = 64;  // query-tile height
  constexpr int LD = D + pad<bf16>();
  constexpr int N8 = BN / 8;
  constexpr int D8 = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBlockM * LD;
  bf16* sQDo = sV + kBlockM * LD;  // two stages of (Q tile, dO tile)
  float* sStats = reinterpret_cast<float*>(sQDo + 4 * BN * LD);  // 2 x (lse, delta)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kBlockM;
  const int bi = blockIdx.y / dm.hk;
  const int kvh = blockIdx.y % dm.hk;
  const int n_rep = dm.h / dm.hk;
  // this lane's two key rows and its column pair within a query tile
  const int krow[2] = {k0 + warp * 16 + lane / 4, k0 + warp * 16 + lane / 4 + 8};
  const int col = (lane % 4) * 2;
  const float scale2 = dm.scale * kLog2e;  // p = exp2(s scale log2 e - lse log2 e)

  // causal: query tiles that end before this block's first key see none of it
  const int q_begin = dm.causal ? k0 / BN * BN : 0;
  const int q_tiles = dm.sq > q_begin ? (dm.sq - q_begin + BN - 1) / BN : 0;
  const int n_steps = n_rep * q_tiles;  // (query head of the group, query tile)
  auto load_q = [&](int t) {
    const int hi = kvh * n_rep + t / q_tiles;
    const int q0 = q_begin + (t % q_tiles) * BN;
    const int64_t row_base = (static_cast<int64_t>(bi) * dm.h + hi) * dm.sq;
    bf16* st = sQDo + (t & 1) * 2 * BN * LD;
    float* stats = sStats + (t & 1) * 2 * BN;
    load_rows_async<D>(st, LD, q + bi * qs.b + hi * qs.h, qs.s, q0, dm.sq, BN);
    load_rows_async<D>(st + BN * LD, LD, dout + bi * dos.b + hi * dos.h, dos.s, q0, dm.sq, BN);
    load_row_stats_async(stats, lse + row_base, q0, dm.sq, BN);
    load_row_stats_async(stats + BN, delta + row_base, q0, dm.sq, BN);
  };
  load_rows_async<D>(sK, LD, k + bi * ks.b + kvh * ks.h, ks.s, k0, dm.sk, kBlockM);
  load_rows_async<D>(sV, LD, v + bi * vs.b + kvh * vs.h, vs.s, k0, dm.sk, kBlockM);
  if (n_steps > 0) load_q(0);
  cp_async_commit();

  float dk_acc[D8][4], dv_acc[D8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int t = 0; t < n_steps; ++t) {
    const int q0 = q_begin + (t % q_tiles) * BN;
    if (t + 1 < n_steps) {  // prefetch the next tile into the other stage
      load_q(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {
      const bf16* sQ = sQDo + (t & 1) * 2 * BN * LD;
      const bf16* sDo = sQ + BN * LD;
      const float* sLse = sStats + (t & 1) * 2 * BN;
      const float* sDelta = sLse + BN;

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows
      float st[N8][4], dpt[N8][4];
      zero(st);
      zero(dpt);
      warp_mma_nt<N8, D / 16>(st, sK + warp * 16 * LD, LD, sQ, LD);
      warp_mma_nt<N8, D / 16>(dpt, sV + warp * 16 * LD, LD, sDo, LD);
      const int kw = k0 + warp * 16;
      const bool edge = q0 + BN > dm.sq || kw + 16 > dm.sk || (dm.causal && q0 < kw + 15);
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + col + (e & 1);
          float p = exp2f(st[n][e] * scale2 - sLse[c] * kLog2e);
          if (edge) {
            const int qpos = q0 + c;
            const int kpos = krow[e / 2];
            if (kpos >= dm.sk || qpos >= dm.sq || (dm.causal && qpos < kpos)) p = 0.0f;
          }
          dpt[n][e] = p * (dpt[n][e] - sDelta[c]) * dm.scale;  // ds^T
          st[n][e] = p;                                           // p^T
        }
      uint32_t pa[N8 / 2][4], dsa[N8 / 2][4];
      pack_a<N8>(pa, st);
      pack_a<N8>(dsa, dpt);
      warp_mma_nn<D8, N8 / 2>(dv_acc, pa, sDo, LD);
      warp_mma_nn<D8, N8 / 2>(dk_acc, dsa, sQ, LD);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();  // nothing may be in flight at exit
  store_strip<D8>(dk + bi * dks.b + kvh * dks.h, dks.s, k0 + warp * 16, dm.sk, dk_acc, 1.0f,
                  1.0f);
  store_strip<D8>(dv + bi * dvs.b + kvh * dvs.h, dvs.s, k0 + warp * 16, dm.sk, dv_acc, 1.0f,
                  1.0f);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const Strides* st,
                      Dims dm, cudaStream_t stream) {
  dim3 grid((dm.sq + kBlockM - 1) / kBlockM, dm.b * dm.h);
  if constexpr (std::is_same<T, bf16>::value && (D == 64 || D == 128)) {
    return sm90::launch_dq(D, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
                           delta, static_cast<bf16*>(dq), st, dm, stream);
  } else if constexpr (std::is_same<T, bf16>::value) {
    constexpr int bytes = (2 * kBlockM + 4 * 64) * (D + pad<bf16>()) * 2;
    auto kernel = flash_bwd_dq_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), st[0], st[1], st[2],
        st[3], st[4], dm);
  } else {
    constexpr int bytes = DqSmem<D, 32>::kBytes;
    auto kernel = flash_bwd_dq_kernel<D, 32>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dq), st[0], st[1], st[2], st[3], st[4], dm);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const Strides* st, Dims dm, cudaStream_t stream) {
  dim3 grid((dm.sk + kBlockM - 1) / kBlockM, dm.b * dm.hk);
  if constexpr (std::is_same<T, bf16>::value && (D == 64 || D == 128)) {
    return sm90::launch_dkv(D, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
                            delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, dm,
                            stream);
  } else if constexpr (std::is_same<T, bf16>::value) {
    constexpr int BN = 64;
    constexpr int bytes = (2 * kBlockM + 4 * BN) * (D + pad<bf16>()) * 2 + 4 * BN * 4;
    auto kernel = flash_bwd_dkv_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), st[0], st[1], st[2], st[3], st[4], st[5], dm);
  } else {
    constexpr int bytes = DkvSmem<D, 32>::kBytes;
    auto kernel = flash_bwd_dkv_kernel<D, 32>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), st[0], st[1], st[2], st[3], st[4],
        st[5], dm);
  }
  return cudaGetLastError();
}

inline Dims read_dims(const int* dims, float scale) {
  return Dims{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], scale};
}

}  // namespace rtt

// strides: 5 x (b, s, h) element strides of q, k, v, dout, dq.
// dims: b, h, hk, sq, sk, causal. lse and delta are contiguous [b, h, sq] f32.
extern "C" int rtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, const int64_t* strides,
                                const int* dims, float scale, void* stream) {
  rtt::Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = rtt::Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const rtt::Dims dm = rtt::read_dims(dims, scale);
  if (dm.sq == 0 || dm.b * dm.h == 0) return 0;
  return static_cast<int>(RTT_DISPATCH(dtype, head_dim, rtt::launch_dq, q, k, v, dout,
                                       static_cast<const float*>(lse),
                                       static_cast<const float*>(delta), dq, st, dm,
                                       static_cast<cudaStream_t>(stream)));
}

// strides: 6 x (b, s, h) element strides of q, k, v, dout, dk, dv.
extern "C" int rtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, const int64_t* strides,
                                 const int* dims, float scale, void* stream) {
  rtt::Strides st[6];
  for (int i = 0; i < 6; ++i) st[i] = rtt::Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const rtt::Dims dm = rtt::read_dims(dims, scale);
  if (dm.sk == 0 || dm.b * dm.hk == 0) return 0;
  return static_cast<int>(RTT_DISPATCH(dtype, head_dim, rtt::launch_dkv, q, k, v, dout,
                                       static_cast<const float*>(lse),
                                       static_cast<const float*>(delta), dk, dv, st, dm,
                                       static_cast<cudaStream_t>(stream)));
}
