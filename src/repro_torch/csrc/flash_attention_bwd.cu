// flash_attention_bwd: the backward of causal GQA attention, for Hopper
// (sm_90a), deterministic (no atomics).
//
// The reference has no backward Pallas kernel: `_flash_bwd`
// (src/repro/kernels/flash_attention/ops.py) recomputes the VJP of
// its plain `ref.attention`.  This file computes the same dq, dk, dv from
// the forward's inputs, its output O, the upstream gradient dO and the rows'
// log-sum-exp L (written by csrc/flash_attention.cu's kernels):
//   P = exp(scale·Q·Kᵀ - L),  Δ_i = Σ_d dO_id·O_id,
//   dS = P ∘ (dO·Vᵀ - Δ),  dq = scale·dS·K,  dk = scale·dSᵀ·Q,  dv = Pᵀ·dO
// over the keys j <= i + Tk - Tq (causal, sequence ends aligned) or all
// keys, with query head h reading KV head h / group.  Causal rows must see
// a key (Tq <= Tk; the wrapper refuses the rest).  Inputs float32 or
// bfloat16 at head width 16, 32, 64 or 128; float32 math and accumulation;
// outputs in the input's type.
//
// Two kernels, launched one after the other on the caller's stream, each
// writing every output element once, so two runs give the same bits:
//
// `flash_bwd_dq`: one block of 256 threads per (64 query rows, query head,
// batch item), heaviest (last causal) tiles first.  It stages its Q and dO
// rows once, writes Δ for them (a warp per row, a fixed shuffle tree), and
// sweeps the key tiles of 32 keys up to its causal horizon: each thread
// computes a 4x2 micro-tile of S = Q·Kᵀ and dP = dO·Vᵀ together (rows
// ty*4..ty*4+3, keys tx and tx+16), turns it into dS, which goes through
// shared memory to the dS·K product, where each thread owns 4 rows and
// D/16 columns of dq.
//
// `flash_bwd_dkdv`: one block per (64 keys, KV head, batch item), key
// tile 0 (the most causal work) first.  It stages its K and V rows once
// and folds the group's query heads in ascending order, and for each the
// query tiles of 32 rows from its causal horizon to the end: each thread
// computes a 4x2 micro-tile of Sᵀ and dPᵀ (keys ty*4.., queries tx and
// tx+16), P and dS go through shared memory to the Pᵀ·dO and dSᵀ·Q
// products, where each thread owns 4 keys and D/16 columns of dk and dv.
//
// Bound: operations (14·D multiply-adds per visible (query, key) pair,
// against ~(4·Tq + 4·Tk)·D elements moved per head).  This version runs on
// the float32 pipes (CUDA cores); the tensor-core (wgmma) form is a later
// redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
    case 64: return launch<64, T>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                  B, Hq, Hkv, Tq, Tk, causal, scale, s);
    case 128: return launch<128, T>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                    B, Hq, Hkv, Tq, Tk, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq [B, Hq, Tq, D]; k, v, dk, dv [B, Hkv, Tk, D] (contiguous,
// dtype 0 float32 or 1 bfloat16); lse and delta float32 [B, Hq, Tq] (lse
// read, delta written).  Launches `flash_bwd_dq`, then `flash_bwd_dkdv`.
// Returns a cudaError_t (0 on success).
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
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dq, dk, dv, dl, B,
                                   Hq, Hkv, Tq, Tk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
