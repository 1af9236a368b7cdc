// flash_attention_bwd: the backward of causal GQA attention, for Hopper
// (sm_90a), deterministic (no atomics).
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel, its
// `_flash_bwd` (src/repro/kernels/flash_attention/ops.py:56) recomputes the
// VJP of its plain `ref.attention`.  This file computes the same dq, dk, dv
// from the forward's inputs, its output O, the upstream gradient dO and the
// rows' log-sum-exp L (written by csrc/flash_attention.cu's kernels):
//   P = exp(scale·Q·Kᵀ - L),  Δ_i = Σ_d dO_id·O_id,
//   dS = P ∘ (dO·Vᵀ - Δ),  dq = scale·dS·K,  dk = scale·dSᵀ·Q,  dv = Pᵀ·dO
// over the keys j <= i + Tk - Tq (causal, sequence ends aligned) or all
// keys, with query head h reading KV head h / group in place.  Causal rows
// must see a key (Tq <= Tk; the wrapper refuses the rest).  Inputs float32
// or bfloat16 at head width 16, 32, 64 or 128, [B, H, T, D]; float32
// accumulation; outputs in the input's type.
//
// Bound: operations.  Five products of 2·D·(visible pairs) operations each
// at least (S again, dP, dS·K, dSᵀ·Q, Pᵀ·dO; 10·D operations a visible
// (query, key) pair), against ~(4·Tq + 4·Tk)·D elements moved per head, so
// nothing of size [Tq, Tk] goes to device memory.  Two passes, launched
// one after the other on the caller's stream, each writing every output
// element once, so two runs give the same bits: the dq pass (which also
// writes Δ), then the dk/dv pass.  The entry point picks the kernels from
// the input type and head width (the wrapper's `route_bwd` states the
// rule):
//
// `flash_bwd_dq_sm90`, `flash_bwd_dkdv_sm90` (bfloat16, D 64 or 128) run
// every product on the tensor cores: seven products, S and dP recomputed
// in each pass (7·D multiply-adds, 14·D operations a visible pair), 1.4x
// the bound's work, for no atomics and no [Tq, Tk] buffer.  Each block is
// two warpgroups of 64 rows.  Tiles are bf16, loaded by TMA (3-D tensor
// maps [B·H, T, D], 128-byte swizzle, two 64-column boxes for a 128-wide
// head, a box past T zero-filled) into a ring of three stages, each with a
// full mbarrier; the last of the eight warps done with a stage (a counter
// in shared memory) refills it, so neither warpgroup waits for the other.
// There is no producer warpgroup: at D 128 the dk/dv pass holds 128
// accumulator registers a thread for dK and dV and 64 for Sᵀ and dPᵀ, and
// under 384 threads (setmaxnreg) ptxas serializes every wgmma and spills;
// two warpgroups alone may use up to 255 registers a thread.  Within a
// warpgroup the products of a tile go in separate commit groups, so the
// exponentials run while dP is computed and dS is formed while the first
// product that needs P runs.
//   dq pass: one block per (128 query rows, query head, batch item),
// heaviest (last causal) tiles first.  The Q and dO tiles are loaded once;
// K and V stream in tiles of 64 keys up to the block's causal horizon.
// Each warpgroup first computes Δ for its rows from O and dO (a quarter of
// D a thread, then over the quad: a fixed order) and writes it for the
// dk/dv pass; per key tile, S = Q·Kᵀ and dP = dO·Vᵀ by wgmma with both
// operands in shared memory (K-major), P and dS in registers on the
// float32 accumulators, then dQ += dS·K with dS as the bf16 register
// operand and K read transposed (MN-major).  Q and dO stay in shared
// memory: kept as register operands across the key loop, one form of that
// loop got the dS fragments in the dO fragments' registers from ptxas
// (nvcc 12.9), so every key tile after the first read dS as dO.
//   dk/dv pass: one block per (128 keys, KV head, batch item), key tile 0
// (the most causal work) first.  K and V are loaded once; Q and dO stream
// in tiles of 64 rows, for each query head of the group in ascending order
// from the causal horizon to the end, with their rows of L and Δ copied by
// cp.async (a row of either is 4·Tq bytes from the next, which TMA needs a
// multiple of 16) and counted on the same barrier.  Each warpgroup keeps dK
// and dV for its 64 keys in float32 registers: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
// with both operands in shared memory, then dV += Pᵀ·dO and dK += dSᵀ·Q
// with Pᵀ and dSᵀ as register operands.
//   Both: the mask is applied only on tiles that cross the causal horizon
// or a ragged end, by index (a zero-filled key has S = 0, not P = 0), and
// a tile wholly above the horizon is skipped.  The outputs leave through
// shared memory (the block's own Q or K/V tiles) by TMA stores, which clip
// the rows past T.  P and dS enter the tensor cores as one bf16 term each
// (relative error 2^-9 per term, inside the bf16 tolerance of the outputs).
//
// `flash_bwd_dq`, `flash_bwd_dkdv` (float32 at any D, bfloat16 at D 16 or
// 32) run on the float32 pipes (CUDA cores): TF32 would break the float32
// tolerance.  `flash_bwd_dq`: one block of 256 threads per (64 query rows,
// query head, batch item), heaviest first; it stages its Q and dO rows
// once, writes Δ for them (a warp per row, a fixed shuffle tree), and
// sweeps key tiles of 32 keys up to its causal horizon: each thread
// computes a 4x2 micro-tile of S and dP, turns it into dS, which goes
// through shared memory to the dS·K product.  `flash_bwd_dkdv`: one block
// per (64 keys, KV head, batch item), key tile 0 first, folding the group's
// query heads in ascending order over query tiles of 32 rows: 4x2
// micro-tiles of Sᵀ and dPᵀ, then P and dS through shared memory to the
// Pᵀ·dO and dSᵀ·Q products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int A_BQ = 64;      // dq pass: query rows per block
constexpr int A_BK = 32;      //          keys per staged tile
constexpr int B_BK = 64;      // dk/dv pass: keys per block
constexpr int B_BQ = 32;      //             query rows per staged tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * A_BQ * (D + 1) + 2 * A_BK * (D + 1) + A_BK * (A_BQ + 1) +
         2 * A_BQ;
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * B_BK * (D + 1) + 2 * B_BQ * (D + 1) + 2 * B_BK * (B_BQ + 1) +
         2 * B_BQ;
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             T* __restrict__ dq, float* __restrict__ delta, int Hq, int Hkv,
             int Tq, int Tk, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [A_BQ][D + 1]
  float* Gs = Qs + A_BQ * (D + 1);         // dO [A_BQ][D + 1]
  float* Ks = Gs + A_BQ * (D + 1);         // [A_BK][D + 1]
  float* Vs = Ks + A_BK * (D + 1);         // [A_BK][D + 1]
  float* Ss = Vs + A_BK * (D + 1);         // dS [A_BK][A_BQ + 1] key-major
  float* Ls = Ss + A_BK * (A_BQ + 1);      // [A_BQ]
  float* Ds = Ls + A_BQ;                   // Δ [A_BQ]
  constexpr int DC = D / 16;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * A_BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Tk - Tq;
  const long long rbase = ((long long)b * Hq + h) * Tq;
  const long long qbase = rbase * D;
  const long long kbase = ((long long)b * Hkv + hk) * Tk * D;

  for (int e = tid; e < A_BQ * D; e += NT) {
    const int r = e / D, d = e % D, qi = q0 + r;
    const bool in = qi < Tq;
    Qs[r * (D + 1) + d] = in ? to_f32(q[qbase + (long long)qi * D + d]) : 0.f;
    Gs[r * (D + 1) + d] =
        in ? to_f32(dout[qbase + (long long)qi * D + d]) : 0.f;
  }
  __syncthreads();
  // Δ_i = Σ_d dO·O: a warp per row, lanes over d, a fixed shuffle tree
  for (int r = warp; r < A_BQ; r += NT / 32) {
    const int qi = q0 + r;
    float part = 0.f;
    if (qi < Tq)
      for (int d = lane; d < D; d += 32)
        part += Gs[r * (D + 1) + d] * to_f32(o[qbase + (long long)qi * D + d]);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, w);
    if (lane == 0) {
      Ds[r] = part;
      Ls[r] = qi < Tq ? lse[rbase + qi] : 0.f;
      if (qi < Tq) delta[rbase + qi] = part;
    }
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // key tiles up to the causal horizon of the block's last row
  const int k_end = causal ? min(Tk, min(q0 + A_BQ, Tq) + off) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += A_BK) {
    __syncthreads();   // previous tile's Ks/Vs/Ss reads are done
    for (int e = tid; e < A_BK * D; e += NT) {
      const int r = e / D, d = e % D, kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < Tk) {
        kv = to_f32(k[kbase + (long long)kj * D + d]);
        vv = to_f32(v[kbase + (long long)kj * D + d]);
      }
      Ks[r * (D + 1) + d] = kv;
      Vs[r * (D + 1) + d] = vv;
    }
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
        g[i] = Gs[(ty * 4 + i) * (D + 1) + d];
      }
      const float k0v = Ks[tx * (D + 1) + d];
      const float k1v = Ks[(tx + 16) * (D + 1) + d];
      const float v0v = Vs[tx * (D + 1) + d];
      const float v1v = Vs[(tx + 16) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] += a[i] * k0v;
        s[i][1] += a[i] * k1v;
        dp[i][0] += g[i] * v0v;
        dp[i][1] += g[i] * v1v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live =
            qi < Tq && kj < Tk && (!causal || kj <= qi + off);
        const float p = live ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ss[(tx + 16 * j) * (A_BQ + 1) + r] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < A_BK; ++j) {
      float ds[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[j * (A_BQ + 1) + ty * 4 + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += ds[i] * kv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Tq) continue;
    T* row = dq + qbase + (long long)qi * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(row + tx + 16 * c, acc[i][c] * scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int Hq, int Hkv, int Tq, int Tk,
               int causal, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                        // [B_BK][D + 1]
  float* Vs = Ks + B_BK * (D + 1);         // [B_BK][D + 1]
  float* Qs = Vs + B_BK * (D + 1);         // [B_BQ][D + 1]
  float* Gs = Qs + B_BQ * (D + 1);         // dO [B_BQ][D + 1]
  float* Ps = Gs + B_BQ * (D + 1);         // P  [B_BK][B_BQ + 1] key-major
  float* Ss = Ps + B_BK * (B_BQ + 1);      // dS [B_BK][B_BQ + 1] key-major
  float* Ls = Ss + B_BK * (B_BQ + 1);      // [B_BQ]
  float* Ds = Ls + B_BQ;                   // Δ [B_BQ]
  constexpr int DC = D / 16;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * B_BK;        // key tile 0 (most work) first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int off = Tk - Tq;
  const long long kbase = ((long long)b * Hkv + hk) * Tk * D;

  for (int e = tid; e < B_BK * D; e += NT) {
    const int r = e / D, d = e % D, kj = k0 + r;
    float kv = 0.f, vv = 0.f;
    if (kj < Tk) {
      kv = to_f32(k[kbase + (long long)kj * D + d]);
      vv = to_f32(v[kbase + (long long)kj * D + d]);
    }
    Ks[r * (D + 1) + d] = kv;
    Vs[r * (D + 1) + d] = vv;
  }

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // the first query row that sees key k0, rounded down to its tile
  const int q_begin = causal ? max(0, k0 - off) / B_BQ * B_BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long rbase = ((long long)b * Hq + h) * Tq;
    const long long qbase = rbase * D;
    for (int qt = q_begin; qt < Tq; qt += B_BQ) {
      __syncthreads();   // previous tile's Qs/Gs/Ps/Ss reads are done
      for (int e = tid; e < B_BQ * D; e += NT) {
        const int r = e / D, d = e % D, qi = qt + r;
        const bool in = qi < Tq;
        Qs[r * (D + 1) + d] =
            in ? to_f32(q[qbase + (long long)qi * D + d]) : 0.f;
        Gs[r * (D + 1) + d] =
            in ? to_f32(dout[qbase + (long long)qi * D + d]) : 0.f;
      }
      if (tid < B_BQ) {
        const int qi = qt + tid;
        Ls[tid] = qi < Tq ? lse[rbase + qi] : 0.f;
        Ds[tid] = qi < Tq ? delta[rbase + qi] : 0.f;
      }
      __syncthreads();

      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = Ks[(ty * 4 + i) * (D + 1) + d];
          vv[i] = Vs[(ty * 4 + i) * (D + 1) + d];
        }
        const float q0v = Qs[tx * (D + 1) + d];
        const float q1v = Qs[(tx + 16) * (D + 1) + d];
        const float g0v = Gs[tx * (D + 1) + d];
        const float g1v = Gs[(tx + 16) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][0] += kk[i] * q0v;
          s[i][1] += kk[i] * q1v;
          dp[i][0] += vv[i] * g0v;
          dp[i][1] += vv[i] * g1v;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty * 4 + i, kj = k0 + kr;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j, qi = qt + c;
          const bool live =
              qi < Tq && kj < Tk && (!causal || kj <= qi + off);
          const float p = live ? expf(s[i][j] * scale - Ls[c]) : 0.f;
          Ps[kr * (B_BQ + 1) + c] = p;
          Ss[kr * (B_BQ + 1) + c] = p * (dp[i][j] - Ds[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int jq = 0; jq < B_BQ; ++jq) {
        float pv[4], sv[4], gq[DC], qq[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty * 4 + i) * (B_BQ + 1) + jq];
          sv[i] = Ss[(ty * 4 + i) * (B_BQ + 1) + jq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gq[c] = Gs[jq * (D + 1) + tx + 16 * c];
          qq[c] = Qs[jq * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dva[i][c] += pv[i] * gq[c];
            dka[i][c] += sv[i] * qq[c];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= Tk) continue;
    T* krow = dk + kbase + (long long)kj * D;
    T* vrow = dv + kbase + (long long)kj * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(krow + tx + 16 * c, dka[i][c] * scale);
      store(vrow + tx + 16 * c, dva[i][c]);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, int B, int Hq, int Hkv, int Tq, int Tk, int causal,
           float scale, cudaStream_t stream) {
  const int a_bytes = dq_smem_floats<D>() * (int)sizeof(float);
  const int b_bytes = dkdv_smem_floats<D>() * (int)sizeof(float);
  auto ka = flash_bwd_dq<D, T>;
  auto kb = flash_bwd_dkdv<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, a_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, b_bytes);
  if (err != cudaSuccess) return (int)err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  ka<<<dim3((Tq + A_BQ - 1) / A_BQ, Hq, B), NT, a_bytes, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, lse, static_cast<T*>(dq),
      delta, Hq, Hkv, Tq, Tk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<dim3((Tk + B_BK - 1) / B_BK, Hkv, B), NT, b_bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

// float32 at every head width, bfloat16 at 16 or 32 (wider bfloat16 heads
// take the tensor-core kernels)
template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, void* dq,
             void* dk, void* dv, float* delta, int B, int Hq, int Hkv, int Tq,
             int Tk, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                  B, Hq, Hkv, Tq, Tk, causal, scale, s);
    case 32: return launch<32, T>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                  B, Hq, Hkv, Tq, Tk, causal, scale, s);
  }
  if constexpr (std::is_same_v<T, float>) {
    switch (D) {
      case 64: return launch<64, T>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                    B, Hq, Hkv, Tq, Tk, causal, scale, s);
      case 128: return launch<128, T>(q, k, v, o, dout, lse, dq, dk, dv,
                                      delta, B, Hq, Hkv, Tq, Tk, causal,
                                      scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace tc {

using namespace sm90;

constexpr int NT = 256;        // two warpgroups, which also issue the loads
constexpr int BM = 128;        // rows a block owns (query rows or keys),
                               // 64 a consumer warpgroup
constexpr int BN = 64;         // rows of a streamed tile (keys or queries)
constexpr int STAGES = 3;      // streamed tiles in flight
constexpr int ROW = 128;       // bytes of one swizzled row: 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;

// d (64 x BN, float32) = A·Bᵀ over D: A is 64 rows at `a` of a tile whose
// 64-column boxes are `a_rows` high, B the BN rows of a streamed tile at
// `b`; both K-major (row-major [rows, D]) with the 128-byte swizzle.
template <int D>
__device__ __forceinline__ void mma_abt(float* d, uint32_t a, int a_rows,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a + (kk / 4) * a_rows * ROW + step, 16, 1024),
                 sw128_desc(b + (kk / 4) * BN * ROW + step, 16, 1024),
                 kk > 0);
  }
}

// d (64 x D, float32) += A·B over BN: A the bf16 register fragments of a
// 64 x BN accumulator (`a`, packed as `pack` does), B the BN rows x D of a
// streamed tile at `b`, read MN-major (transposed) with the 128-byte
// swizzle.
template <int D>
__device__ __forceinline__ void mma_ab(float* d, const uint32_t* a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * ROW, BN * ROW, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(d, &a[4 * kk], db);
    else
      wgmma_rs_n64(d, &a[4 * kk], db);
  }
}

// 4 bytes from global to shared memory, asynchronously (zeros when !in)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  return bits(__floats2bfloat162_rn(a, b));
}

// the accumulator `acc` (64 x D: acc[4j + e] is row r (e < 2) or r + 8,
// column 8j + col + (e & 1)) times `mul` as bf16 into rows r, r + 8 of a
// tile whose 64-column boxes are `rows` high, in the TMA's swizzle
template <int D>
__device__ __forceinline__ void stage_out(uint32_t tile, int rows, int r,
                                          int col, const float* acc,
                                          float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t at = tile + (j / 8) * rows * ROW + r * ROW +
                        (((j % 8) ^ (r % 8)) * 16) + col * 2;
    const uint32_t x0 = pack(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    const uint32_t x1 = pack(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at), "r"(x0)
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at + 8 * ROW), "r"(x1)
                 : "memory");
  }
}

// Σ_d a·b over the quarter `qd` of D of row `row` (0 past the end)
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b,
                                         long long row, bool in, int qd) {
  float s = 0.0f;
  if (!in) return s;
  const uint4* pa = reinterpret_cast<const uint4*>(a + row * D + qd * (D / 4));
  const uint4* pb = reinterpret_cast<const uint4*>(b + row * D + qd * (D / 4));
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const uint4 x = pa[i], y = pb[i];
    const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(xh[e]);
      const float2 fy = __bfloat1622float2(yh[e]);
      s += fx.x * fy.x;
      s += fx.y * fy.y;
    }
  }
  return s;
}

// dq for BM query rows x D of head h, batch b (grid: Hq, query tiles, B),
// and Δ for those rows.
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_dq,
                  const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  int Hq, int group, int Tq, int Tk, int causal, float scale,
                  float scale_log2) {
  constexpr int HALVES = D / 64;           // 64-column boxes per row
  constexpr int M_BYTES = BM * D * 2;      // the Q or the dO tile
  constexpr int N_BYTES = BN * D * 2;      // one K or V tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sq = (base + 1023u) & ~1023u;
  const uint32_t sdo = sq + M_BYTES;
  const uint32_t ring = sdo + M_BYTES;
  const uint32_t bars = ring + STAGES * 2 * N_BYTES;
  const uint32_t m_full = bars;
  auto full = [&](int s) { return bars + 8u + 8u * s; };
  auto k_tile = [&](int s) { return ring + s * 2u * N_BYTES; };
  // per stage, the consumer warps done with it
  int* const done = reinterpret_cast<int*>(
      smem_raw + (bars + 8u * (1 + STAGES) - base));

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest first
  const int off = Tk - Tq;
  const int bh = b * Hq + h;
  const int bkv = b * (Hq / group) + h / group;
  // key tiles up to the causal horizon of the block's last row
  const int k_end = causal ? min(Tk, min(q0 + BM, Tq) + off) : Tk;
  const int n_tiles = (k_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(m_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V tile t into stage t % STAGES (one thread)
  auto load = [&](int t) {
    const int s = t % STAGES;
    mbar_expect_tx(full(s), 2 * N_BYTES);
    const uint32_t sk = k_tile(s), sv = sk + N_BYTES;
    for (int hf = 0; hf < HALVES; ++hf) {
      tma_load(sk + hf * BN * ROW, &tm_k, hf * 64, t * BN, bkv, full(s));
      tma_load(sv + hf * BN * ROW, &tm_v, hf * 64, t * BN, bkv, full(s));
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(m_full, 2 * M_BYTES);
    for (int hf = 0; hf < HALVES; ++hf) {
      tma_load(sq + hf * BM * ROW, &tm_q, hf * 64, q0, bh, m_full);
      tma_load(sdo + hf * BM * ROW, &tm_do, hf * 64, q0, bh, m_full);
    }
    for (int t = 0; t < min(STAGES, n_tiles); ++t) load(t);
  }

  const int c = threadIdx.x / 128;         // this warpgroup's 64 rows
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rr = 64 * c + 16 * warp + lane / 4;   // tile rows rr, rr + 8
  const int qi0 = q0 + rr, qi1 = qi0 + 8;
  const int first = q0 + 64 * c;           // the smallest causal horizon
  const int col = 2 * (lane % 4);          // first of this thread's columns
  const long long rb = (long long)bh * Tq;

  // Δ of rows qi0, qi1: a quarter of D a thread, then over the quad
  float dl0 = row_dot<D>(o, dout, rb + qi0, qi0 < Tq, lane % 4);
  float dl1 = row_dot<D>(o, dout, rb + qi1, qi1 < Tq, lane % 4);
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, w);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, w);
  }
  if (lane % 4 == 0) {
    if (qi0 < Tq) delta[rb + qi0] = dl0;
    if (qi1 < Tq) delta[rb + qi1] = dl1;
  }
  // L in the log2 domain (rows past Tq: 0, and masked)
  const float lg0 = qi0 < Tq ? lse[rb + qi0] * LOG2E : 0.0f;
  const float lg1 = qi1 < Tq ? lse[rb + qi1] * LOG2E : 0.0f;

  mbar_wait(m_full, 0);
  const uint32_t qa = sq + 64 * c * ROW, ga = sdo + 64 * c * ROW;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, k0 = t * BN;
    const uint32_t sk = k_tile(s), sv = sk + N_BYTES;
    mbar_wait(full(s), (t / STAGES) & 1);
    // a tile wholly above this warpgroup's horizon adds nothing
    if (!causal || k0 <= first + 63 + off) {
      float sc[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.0f;
      wgmma_fence();
      mma_abt<D>(sc, qa, BM, sk);          // S = Q·Kᵀ
      wgmma_commit();
      mma_abt<D>(dp, ga, BM, sv);          // dP = dO·Vᵀ
      wgmma_commit();
      wgmma_wait<1>();
      pin<BN / 2>(sc);

      // P while dP runs; sc[i] is row qi0 ((i & 2) == 0) or qi1, key
      // k0 + 8·(i / 4) + col + (i & 1)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sc[i] = ex2(sc[i] * scale_log2 - ((i & 2) ? lg1 : lg0));
      if (k0 + BN > Tk || first + 64 > Tq ||
          (causal && k0 + BN - 1 > first + off)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int kj = k0 + 8 * (i / 4) + col + (i & 1);
          const int qi = (i & 2) ? qi1 : qi0;
          if (qi >= Tq || kj >= Tk || (causal && kj > qi + off)) sc[i] = 0.0f;
        }
      }
      pin<BN / 2>(sc);                     // P before the wait for dP
      wgmma_wait<0>();
      pin<BN / 2>(dp);
      uint32_t ds[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        ds[2 * j] = pack(sc[4 * j] * (dp[4 * j] - dl0),
                         sc[4 * j + 1] * (dp[4 * j + 1] - dl0));
        ds[2 * j + 1] = pack(sc[4 * j + 2] * (dp[4 * j + 2] - dl1),
                             sc[4 * j + 3] * (dp[4 * j + 3] - dl1));
      }

      pin<D / 2>(acc);
      wgmma_fence();
      mma_ab<D>(acc, ds, sk);              // dQ += dS·K
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(acc);
    }
    // the last of the 8 warps done with the stage refills it
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const bool last = atomicAdd(&done[s], 1) % 8 == 7;
      __threadfence_block();
      if (last && t + STAGES < n_tiles) load(t + STAGES);
    }
  }

  // epilogue: scale·dQ as bf16 into this warpgroup's rows of the Q tile,
  // one TMA store a box
  stage_out<D>(sq, BM, rr, col, acc, scale);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
  if (tid == 0 && first < Tq) {
    for (int hf = 0; hf < HALVES; ++hf)
      tma_store(&tm_dq, qa + hf * BM * ROW, hf * 64, first, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// dk, dv for BM keys x D of KV head hk, batch b (grid: Hkv, key tiles, B),
// over the query heads hk·group .. hk·group + group - 1 in ascending order.
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_dk,
                    const __grid_constant__ CUtensorMap tm_dv,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int Hq, int group,
                    int Tq, int Tk, int causal, float scale,
                    float scale_log2) {
  constexpr int HALVES = D / 64;
  constexpr int M_BYTES = BM * D * 2;      // the K or the V tile
  constexpr int N_BYTES = BN * D * 2;      // one Q or dO tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sk = (base + 1023u) & ~1023u;
  const uint32_t sv = sk + M_BYTES;
  const uint32_t ring = sv + M_BYTES;
  const uint32_t rows = ring + STAGES * 2 * N_BYTES;   // L, Δ per stage
  const uint32_t bars = rows + STAGES * 2 * BN * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u + 8u * s; };
  auto q_tile = [&](int s) { return ring + s * 2u * N_BYTES; };
  // L and Δ of stage s's rows, and per stage the consumer warps done with
  // it, as generic pointers
  float* const lrows = reinterpret_cast<float*>(smem_raw + (rows - base));
  int* const done = reinterpret_cast<int*>(
      smem_raw + (bars + 8u * (1 + STAGES) - base));

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * BM;          // key tile 0 (most work) first
  const int off = Tk - Tq;
  const int bkv = b * (Hq / group) + hk;
  // query tiles from the first row that sees key k0 (rounded down to a
  // tile) to the end, for each query head of the group
  const int q_begin = causal ? max(0, k0 - off) / BN * BN : 0;
  const int n_q = (Tq - q_begin + BN - 1) / BN;
  const int n_iter = group * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1 + 32);          // the TMA and a warp's lanes
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int c = threadIdx.x / 128;         // this warpgroup's 64 keys
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  // tile t into stage t % STAGES, by one warp: Q and dO by TMA from lane
  // 0, the rows of L and Δ (zeros past Tq) by cp.async from each lane, all
  // completing on the stage's full barrier
  auto load = [&](int t) {
    const int s = t % STAGES;
    const int bh = b * Hq + hk * group + t / n_q;
    const int qt = q_begin + (t % n_q) * BN;
    if (lane == 0) {
      mbar_expect_tx(full(s), 2 * N_BYTES);
      const uint32_t sq = q_tile(s), sdo = sq + N_BYTES;
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load(sq + hf * BN * ROW, &tm_q, hf * 64, qt, bh, full(s));
        tma_load(sdo + hf * BN * ROW, &tm_do, hf * 64, qt, bh, full(s));
      }
    }
    const uint32_t ls = rows + s * 2 * BN * 4;
    const long long rb = (long long)bh * Tq;
    for (int r = lane; r < BN; r += 32) {
      const bool in = qt + r < Tq;
      const long long at = rb + (in ? qt + r : 0);
      cp_async4(ls + r * 4, lse + at, in);
      cp_async4(ls + (BN + r) * 4, delta + at, in);
    }
    cp_async_arrive(full(s));
  };
  if (threadIdx.x < 32) {                  // warp 0 starts the ring
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * M_BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load(sk + hf * BM * ROW, &tm_k, hf * 64, k0, bkv, kv_full);
        tma_load(sv + hf * BM * ROW, &tm_v, hf * 64, k0, bkv, kv_full);
      }
    }
    for (int t = 0; t < min(STAGES, n_iter); ++t) load(t);
  }

  const int rr = 64 * c + 16 * warp + lane / 4;   // tile rows rr, rr + 8
  const int kj0 = k0 + rr, kj1 = kj0 + 8;
  const int kfirst = k0 + 64 * c;
  const int col = 2 * (lane % 4);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  const uint32_t ka = sk + 64 * c * ROW, va = sv + 64 * c * ROW;
  mbar_wait(kv_full, 0);

  for (int t = 0; t < n_iter; ++t) {
    const int s = t % STAGES;
    const int qt = q_begin + (t % n_q) * BN;
    const uint32_t sq = q_tile(s), sdo = sq + N_BYTES;
    mbar_wait(full(s), (t / STAGES) & 1);
    // a tile wholly before this warpgroup's first key adds nothing
    if (!causal || kfirst <= qt + BN - 1 + off) {
      float st[BN / 2], dpt[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) st[i] = dpt[i] = 0.0f;
      wgmma_fence();
      mma_abt<D>(st, ka, BM, sq);          // Sᵀ = K·Qᵀ
      wgmma_commit();
      mma_abt<D>(dpt, va, BM, sdo);        // dPᵀ = V·dOᵀ
      wgmma_commit();
      wgmma_wait<1>();
      pin<BN / 2>(st);

      // Pᵀ while dPᵀ runs; st[4j + e] is key kj0 (e < 2) or kj1, query
      // qt + 8j + col + (e & 1)
      const float* ls = lrows + s * 2 * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * j + col);
        const float l0 = lq.x * LOG2E, l1 = lq.y * LOG2E;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] =
              ex2(st[4 * j + e] * scale_log2 - ((e & 1) ? l1 : l0));
      }
      if (qt + BN > Tq || kfirst + 64 > Tk ||
          (causal && kfirst + 63 > qt + off)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int qi = qt + 8 * (i / 4) + col + (i & 1);
          const int kj = (i & 2) ? kj1 : kj0;
          if (qi >= Tq || kj >= Tk || (causal && kj > qi + off)) st[i] = 0.0f;
        }
      }
      uint32_t pt[BN / 4], dst[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) pt[j] = pack(st[2 * j], st[2 * j + 1]);
      // dV += Pᵀ·dO runs while dSᵀ is formed
      pin<D / 2>(dv);
      wgmma_fence();
      mma_ab<D>(dv, pt, sdo);
      wgmma_commit();
      wgmma_wait<1>();
      pin<BN / 2>(dpt);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(ls + BN + 8 * j + col);
        dst[2 * j] = pack(st[4 * j] * (dpt[4 * j] - dl.x),
                          st[4 * j + 1] * (dpt[4 * j + 1] - dl.y));
        dst[2 * j + 1] = pack(st[4 * j + 2] * (dpt[4 * j + 2] - dl.x),
                              st[4 * j + 3] * (dpt[4 * j + 3] - dl.y));
      }
      pin<D / 2>(dk);
      wgmma_fence();
      mma_ab<D>(dk, dst, sq);              // dK += dSᵀ·Q
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(dv);
      pin<D / 2>(dk);
    }
    // the last of the 8 consumer warps done with the stage refills it, so
    // neither warpgroup waits for the other
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&done[s], 1) % 8 == 7;
      __threadfence_block();
    }
    if (__shfl_sync(0xffffffffu, last, 0) && t + STAGES < n_iter)
      load(t + STAGES);
  }

  // epilogue: scale·dK and dV as bf16 into this warpgroup's rows of the
  // K and V tiles, one TMA store a box
  stage_out<D>(sk, BM, rr, col, dk, scale);
  stage_out<D>(sv, BM, rr, col, dv, 1.0f);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
  if (tid == 0 && kfirst < Tk) {
    for (int hf = 0; hf < HALVES; ++hf) {
      tma_store(&tm_dk, ka + hf * BM * ROW, hf * 64, kfirst, bkv);
      tma_store(&tm_dv, va + hf * BM * ROW, hf * 64, kfirst, bkv);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// [BH, T, D] bfloat16, boxes of 64 columns x `rows` rows, 128-byte swizzle;
// a box past T is zero-filled on load and clipped on store
bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int T, int D,
                int rows) {
  return tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, D, T,
                       BH, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, int B, int Hq, int Hkv, int Tq, int Tk, int causal,
           float scale, cudaStream_t stream) {
  CUtensorMap aq, ado, ak, av, adq, bq, bdo, bk, bv, bdk, bdv;
  if (!tensor_map(&aq, q, B * Hq, Tq, D, BM) ||
      !tensor_map(&ado, dout, B * Hq, Tq, D, BM) ||
      !tensor_map(&ak, k, B * Hkv, Tk, D, BN) ||
      !tensor_map(&av, v, B * Hkv, Tk, D, BN) ||
      !tensor_map(&adq, dq, B * Hq, Tq, D, 64) ||
      !tensor_map(&bq, q, B * Hq, Tq, D, BN) ||
      !tensor_map(&bdo, dout, B * Hq, Tq, D, BN) ||
      !tensor_map(&bk, k, B * Hkv, Tk, D, BM) ||
      !tensor_map(&bv, v, B * Hkv, Tk, D, BM) ||
      !tensor_map(&bdk, dk, B * Hkv, Tk, D, 64) ||
      !tensor_map(&bdv, dv, B * Hkv, Tk, D, 64))
    return (int)cudaErrorInvalidValue;
  const int bars = 8 * (1 + STAGES) + 4 * STAGES;   // and the counters
  const int a_bytes = 1024 + 2 * BM * D * 2 + STAGES * 2 * BN * D * 2 + bars;
  const int b_bytes = 1024 + 2 * BM * D * 2 + STAGES * 2 * BN * D * 2 +
                      STAGES * 2 * BN * 4 + bars;
  auto ka = flash_bwd_dq_sm90<D>;
  auto kb = flash_bwd_dkdv_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, a_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, b_bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = (float)(scale * 1.4426950408889634);
  const int group = Hq / Hkv;
  ka<<<dim3(Hq, (Tq + BM - 1) / BM, B), NT, a_bytes, stream>>>(
      aq, ado, ak, av, adq, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, Hq, group, Tq, Tk,
      causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<dim3(Hkv, (Tk + BM - 1) / BM, B), NT, b_bytes, stream>>>(
      bq, bdo, bk, bv, bdk, bdv, lse, delta, Hq, group, Tq, Tk, causal,
      scale, scale_log2);
  return (int)cudaGetLastError();
}

int launch_d(int D, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, void* dq,
             void* dk, void* dv, float* delta, int B, int Hq, int Hkv, int Tq,
             int Tk, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B,
                               Hq, Hkv, Tq, Tk, causal, scale, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B,
                                 Hq, Hkv, Tq, Tk, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// q, o, dout, dq [B, Hq, Tq, D]; k, v, dk, dv [B, Hkv, Tk, D] (contiguous,
// dtype 0 float32 or 1 bfloat16; 16-byte aligned for the tensor-core
// kernels); lse and delta float32 [B, Hq, Tq] (lse read, delta written).
// bfloat16 at D 64 or 128 launches `flash_bwd_dq_sm90`, then
// `flash_bwd_dkdv_sm90`; everything else `flash_bwd_dq`, then
// `flash_bwd_dkdv`.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int Hq, int Hkv, int Tq, int Tk, int D, int causal,
    float scale, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0 || Tk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, dout, l, dq, dk, dv, dl, B, Hq,
                           Hkv, Tq, Tk, causal, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D == 64 || D == 128)
    return tc::launch_d(D, q, k, v, o, dout, l, dq, dk, dv, dl, B, Hq, Hkv,
                        Tq, Tk, causal, scale, s);
  return launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dq, dk, dv, dl, B,
                                 Hq, Hkv, Tq, Tk, causal, scale, s);
}
