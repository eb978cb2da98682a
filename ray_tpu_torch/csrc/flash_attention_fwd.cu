// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/pallas/flash_attention.py, _flash_fwd_kernel
// (launched by _flash_forward). Same function: blockwise online-softmax
// attention with causal block skipping and the in-block mask q_pos >= k_pos
// (top-left alignment), GQA through kv head = h // (h / hk), outputs `out`
// and lse = m + log(l); a row with no unmasked key gets out = 0, lse = 1e30.
//
// What bounds it on the H100: at the training shapes (s = 2048, d = 64) the
// work is 4 * d flops per (query, key) pair against 2 * d * 2 bytes per row,
// far above the 295 flops/byte ridge, so the tensor cores bound it; the
// [s, s] score matrix never reaches device memory.
//
// Design. The TPU grid's sequential k axis becomes a loop inside one thread
// block; the grid is (query tiles of 64 rows, b * h), 4 warps a block, each
// warp owning 16 query rows. K and V tiles of 64 keys are loaded once per step
// for all four warps with 16-byte loads straight from the [b, s, h, d] layout
// (no transpose). bf16 kernel: the warp's scores, the online-softmax state
// (running max m and sum l) and its output accumulator all live in registers;
// S = Q K^T and O += P V run on mma.sync (bf16 in, f32 accumulate, operands
// fed by ldmatrix), and P is repacked from the score accumulators into the
// A fragments of P V without touching shared memory. P is rounded to bf16
// before P V, as the reference rounds it to v's dtype. f32 kernel: the same
// loop with plain FMA on shared-memory strips, so the card can hold the
// algorithm at f32 tolerances.
//
// K and V tiles stream through two shared-memory stages with cp.async: the
// next tile's copy is in flight while the warps compute on the current one.
//
// Which kernel serves which call: bf16 at d in {64, 128} goes to the
// warp-specialised wgmma kernel of flash_attention_fwd_sm90.cu; bf16 at d in
// {16, 32} to the mma.sync kernel below; f32 to the FMA kernel below.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace rtt {

// ------------------------------------------------------------ f32 kernel
template <int D, int BN>
struct FwdSmem {
  static constexpr int kLdT = D + pad<float>();  // q, k, v tiles
  static constexpr int kLdS = BN + 4;             // scores, then p in place
  static constexpr int kLdO = D + 4;              // output accumulator
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + align128(1LL * kBlockM * kLdT * 4);
  static constexpr int kV = kK + align128(1LL * BN * kLdT * 4);
  static constexpr int kS = kV + align128(1LL * BN * kLdT * 4);
  static constexpr int kO = kS + align128(1LL * kBlockM * kLdS * 4);
  static constexpr int kM = kO + align128(1LL * kBlockM * kLdO * 4);
  static constexpr int kL = kM + align128(kBlockM * 4);
  static constexpr int kA = kL + align128(kBlockM * 4);
  static constexpr int kBytes = kA + align128(kBlockM * 4);
};

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, Strides os, Dims dm) {
  using L = FwdSmem<D, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  float* sM = reinterpret_cast<float*>(smem + L::kM);
  float* sL = reinterpret_cast<float*>(smem + L::kL);
  float* sA = reinterpret_cast<float*>(smem + L::kA);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int q0 = blockIdx.x * kBlockM;
  const int bi = blockIdx.y / dm.h;
  const int hi = blockIdx.y % dm.h;
  const int kvh = hi / (dm.h / dm.hk);

  const float* qb = q + bi * qs.b + hi * qs.h;
  const float* kb = k + bi * ks.b + kvh * ks.h;
  const float* vb = v + bi * vs.b + kvh * vs.h;

  load_rows<float, D>(sQ, L::kLdT, qb, qs.s, q0, dm.sq, kBlockM);
  for (int i = threadIdx.x; i < kBlockM * L::kLdO; i += kThreads) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }

  // causal: skip key tiles that start past the block's last query row
  const int k_end = dm.causal ? min(dm.sk, q0 + kBlockM) : dm.sk;
  const int n_tiles = (k_end + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_rows<float, D>(sK, L::kLdT, kb, ks.s, k0, dm.sk, BN);
    load_rows<float, D>(sV, L::kLdT, vb, vs.s, k0, dm.sk, BN);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    warp_gemm_fma<false, BN, D>(sS + r0 * L::kLdS, L::kLdS, sQ + r0 * L::kLdT, L::kLdT, sK,
                                L::kLdT, false);
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int row = r0 + rr;
      const int qpos = q0 + row;
      float s[BN / 32];
      bool ok[BN / 32];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const int c = lane + 32 * t;
        const int kpos = k0 + c;
        ok[t] = kpos < dm.sk && (!dm.causal || qpos >= kpos);
        s[t] = ok[t] ? sS[row * L::kLdS + c] * dm.scale : kNegInf;
        mx = fmaxf(mx, s[t]);
      }
      mx = warp_max(mx);
      const float m_prev = sM[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const float p = ok[t] ? expf(s[t] - m_new) : 0.0f;
        sum += p;
        sS[row * L::kLdS + lane + 32 * t] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[row] = alpha;
        sL[row] = alpha * sL[row] + sum;
        sM[row] = m_new;
      }
    }
    __syncwarp();

    for (int idx = lane; idx < 16 * D; idx += 32) {
      const int row = r0 + idx / D;
      sO[row * L::kLdO + idx % D] *= sA[row];
    }
    __syncwarp();

    // O += P V
    warp_gemm_fma<true, D, BN>(sO + r0 * L::kLdO, L::kLdO, sS + r0 * L::kLdS, L::kLdS, sV,
                               L::kLdT, true);
    __syncwarp();
  }

  float* ob = o + bi * os.b + hi * os.h;
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int row = r0 + idx / D;
    const int c = idx % D;
    const int qpos = q0 + row;
    if (qpos < dm.sq) {
      const float l = sL[row];
      const float val = l == 0.0f ? 0.0f : sO[row * L::kLdO + c] / l;
      ob[qpos * os.s + c] = val;
    }
  }
  if (lane < 16) {
    const int row = r0 + lane;
    const int qpos = q0 + row;
    if (qpos < dm.sq) {
      const float l = sL[row];
      lse[(static_cast<int64_t>(bi) * dm.h + hi) * dm.sq + qpos] =
          l > 0.0f ? sM[row] + logf(l) : kMaskedLse;
    }
  }
}

// ----------------------------------------------------------- bf16 kernel
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
                         Dims dm) {
  constexpr int BN = 64;
  constexpr int LD = D + pad<bf16>();
  constexpr int N8 = BN / 8;
  constexpr int D8 = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + kBlockM * LD;  // two stages of (K tile, V tile)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // causal: the last query tiles have the most keys; start them first
  const int q0 = (dm.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBlockM;
  const int bi = blockIdx.y / dm.h;
  const int hi = blockIdx.y % dm.h;
  const int kvh = hi / (dm.h / dm.hk);
  const bf16* kb = k + bi * ks.b + kvh * ks.h;
  const bf16* vb = v + bi * vs.b + kvh * vs.h;
  // this lane's two rows of the warp's strip, and its column pair in a tile
  const int row[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  const int col = (lane % 4) * 2;

  const int k_end = dm.causal ? min(dm.sk, q0 + kBlockM) : dm.sk;
  const int n_tiles = (k_end + BN - 1) / BN;
  auto load_kv = [&](int j) {
    bf16* st = sKV + (j & 1) * 2 * BN * LD;
    load_rows_async<D>(st, LD, kb, ks.s, j * BN, dm.sk, BN);
    load_rows_async<D>(st + BN * LD, LD, vb, vs.s, j * BN, dm.sk, BN);
  };
  load_rows_async<D>(sQ, LD, q + bi * qs.b + hi * qs.h, qs.s, q0, dm.sq, kBlockM);
  load_kv(0);
  cp_async_commit();

  float acc[D8][4];
  zero(acc);
  // running max (of scores times log2 e, so p = exp2(s - m)) and this lane's
  // share of the row sums
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  const float scale2 = dm.scale * kLog2e;
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

    float s[N8][4];
    zero(s);
    warp_mma_nt<N8, D / 16>(s, sQ + warp * 16 * LD, LD, sK, LD);

    // only a tile that crosses the diagonal or the ragged edge needs masking
    const bool edge = k0 + BN > dm.sk || (dm.causal && k0 + BN - 1 > q0 + warp * 16);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale2;
        if (edge) {
          const int kpos = k0 + n * 8 + col + (e & 1);
          if (kpos >= dm.sk || (dm.causal && row[e / 2] < kpos)) s[n][e] = kNegInf;
        }
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is exactly kNegInf; its p is 0 even in a row with
        // no unmasked key so far (where m is still kNegInf)
        const float p = s[n][e] == kNegInf ? 0.0f : exp2f(s[n][e] - m[e / 2]);
        s[n][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int n = 0; n < D8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    uint32_t pa[N8 / 2][4];
    pack_a<N8>(pa, s);
    warp_mma_nn<D8, N8 / 2>(acc, pa, sV, LD);
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();  // nothing may be in flight at exit (sk == 0)

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
  }
  store_strip<D8>(o + bi * os.b + hi * os.h, os.s, q0 + warp * 16, dm.sq, acc, inv[0], inv[1]);
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < dm.sq)
        lse[(static_cast<int64_t>(bi) * dm.h + hi) * dm.sq + row[i]] =
            l[i] > 0.0f ? m[i] * kLn2 + logf(l[i]) : kMaskedLse;
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       Strides qs, Strides ks, Strides vs, Strides os, Dims dm,
                       cudaStream_t stream) {
  dim3 grid((dm.sq + kBlockM - 1) / kBlockM, dm.b * dm.h);
  if constexpr (std::is_same<T, bf16>::value && (D == 64 || D == 128)) {
    return sm90::launch_fwd(D, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, qs, ks, vs,
                            os, dm, stream);
  } else if constexpr (std::is_same<T, bf16>::value) {
    constexpr int bytes = (kBlockM + 4 * 64) * (D + pad<bf16>()) * 2;
    auto kernel = flash_fwd_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const bf16*>(q),
                                              static_cast<const bf16*>(k),
                                              static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                              lse, qs, ks, vs, os, dm);
  } else {
    constexpr int bytes = FwdSmem<D, 32>::kBytes;
    auto kernel = flash_fwd_kernel<D, 32>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const float*>(q),
                                              static_cast<const float*>(k),
                                              static_cast<const float*>(v),
                                              static_cast<float*>(o), lse, qs, ks, vs, os, dm);
  }
  return cudaGetLastError();
}

}  // namespace rtt

// strides: 4 x (b, s, h) element strides of q, k, v, o.
// dims: b, h, hk, sq, sk, causal.
extern "C" int rtt_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, void* o, void* lse, const int64_t* strides,
                             const int* dims, float scale, void* stream) {
  using rtt::Strides;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const rtt::Dims dm{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], scale};
  if (dm.sq == 0 || dm.b * dm.h == 0) return 0;
  return static_cast<int>(RTT_DISPATCH(dtype, head_dim, rtt::launch_fwd, q, k, v, o,
                                       static_cast<float*>(lse), qs, ks, vs, os, dm,
                                       static_cast<cudaStream_t>(stream)));
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
