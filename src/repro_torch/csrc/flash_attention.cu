// flash_attention: causal GQA attention forward with an online softmax,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`):
//   out[b, h, i] = softmax_j(scale · q[b, h, i] · k[b, h / group, j]) v[...]
// over the keys j <= i + Tk - Tq (causal, sequence ends aligned), with
// float32 math for float32 or bfloat16 inputs and the output in the
// input's type.
//
// Bound: operations at prefill lengths (4·Tq·Tk·D multiply-adds per head,
// half of it under the causal mask, against 2·(Tq + 2·Tk)·D bytes), so
// the [Tq, Tk] logits never go to device memory.  This first version runs
// on the float32 pipes (CUDA cores), not the tensor cores: wgmma, TMA and
// pipelining are left for a later version.
//
// Design: one block of 256 threads per (query tile of 64 rows, query
// head, batch item).  The block stages its 64 queries in shared memory
// once, then sweeps the key tiles of 32 keys: it stages K and V (as
// float32), each thread computes a 4x2 micro-tile of scores (rows
// ty*4..ty*4+3, keys tx and tx+16), masks them, and folds them into the
// running max and denominator of its rows (the 16 threads of a row
// reduce the max with warp shuffles; the denominator stays a per-thread
// partial until the end).  The probabilities go through shared memory to
// the P·V product, where each thread owns 4 rows and D/16 output columns.
// The KV head is h / group, read in place (no replication).  Key tiles
// wholly above the causal horizon are skipped: they add exactly 0 once a
// row has a finite maximum.  Ragged Tq and Tk are masked here, not padded.
//
// Rows with no visible key (causal, i + Tk - Tq < 0) are computed as the
// reference's Pallas kernel does through its 128-key blocks: every real
// key has weight 1 (score 0 here) and the sum of V is divided by
// `masked_den` (Tk rounded up to a multiple of 128) instead of the
// weight sum.  A block that holds such rows sweeps every key tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per staged tile
constexpr int NT = 256;       // threads per block: 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BK * (BQ + 1);
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
          int Tq, int Tk, int causal, int masked_den, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);           // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);           // [BK][D]
  float* Ps = Vs + BK * D;                 // [BK][BQ + 1] (key-major)
  constexpr int DC = D / 16;               // output columns per thread

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Tk - Tq;
  const long long qbase = ((long long)b * Hq + h) * Tq * D;
  const long long kbase = ((long long)b * Hkv + hk) * Tk * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    Qs[r * (D + 1) + d] = qi < Tq ? to_f32(q[qbase + (long long)qi * D + d])
                                  : 0.0f;
  }

  // per-row state: rows ty*4 + i
  bool dead[4];
  float m[4], l[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    // rows past Tq are never stored; they run as dead rows (finite)
    dead[i] = qi >= Tq || (causal && qi + off < 0);
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.0f;
  }

  // key tiles: all of them, or up to the causal horizon of the last row
  int k_end = Tk;
  const bool any_dead = causal && q0 + off < 0;
  if (causal && !any_dead) {
    const int last = min(q0 + BQ - 1, Tq - 1) + off + 1;
    k_end = min(Tk, last);
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // previous tile's Ks/Vs/Ps reads are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D;
      const int kj = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (kj < Tk) {
        kv = to_f32(k[kbase + (long long)kj * D + d]);
        vv = to_f32(v[kbase + (long long)kj * D + d]);
      }
      Ks[r * (D + 1) + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
      const float b0 = Ks[tx * (D + 1) + d];
      const float b1 = Ks[(tx + 16) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] += a[i] * b0;
        s[i][1] += a[i] * b1;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x;
        if (kj >= Tk) {
          x = -INFINITY;
        } else if (dead[i]) {
          x = 0.0f;                       // weight 1 for every real key
        } else if (causal && kj > qi + off) {
          x = -INFINITY;
        } else {
          x = s[i][j] * scale;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float m_new = fmaxf(m[i], mt);
      // every row sees a real key in its first tile, so m_new is finite
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(tx + 16 * j) * (BQ + 1) + ty * 4 + i] = p;
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[j * (BQ + 1) + ty * 4 + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) o[i][c] += p[i] * vv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int w = 8; w >= 1; w >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, w);
    const int qi = q0 + ty * 4 + i;
    if (qi >= Tq) continue;
    const float den = dead[i] ? (float)masked_den : (lt == 0.0f ? 1.0f : lt);
    T* orow = out + qbase + (long long)qi * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, o[i][c] / den);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Tq, int Tk, int causal, int masked_den,
           float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_fwd<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Tq, Tk,
      causal, masked_den, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Hq, int Hkv, int Tq, int Tk, int causal,
             int masked_den, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, out, B, Hq, Hkv, Tq, Tk, causal,
                                  masked_den, scale, s);
    case 32: return launch<32, T>(q, k, v, out, B, Hq, Hkv, Tq, Tk, causal,
                                  masked_den, scale, s);
    case 64: return launch<64, T>(q, k, v, out, B, Hq, Hkv, Tq, Tk, causal,
                                  masked_den, scale, s);
    case 128: return launch<128, T>(q, k, v, out, B, Hq, Hkv, Tq, Tk,
                                    causal, masked_den, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Hq, int Hkv, int Tq, int Tk, int D,
                                      int causal, int masked_den, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, B, Hq, Hkv, Tq, Tk, causal,
                           masked_den, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, Hq, Hkv, Tq, Tk,
                                   causal, masked_den, scale, s);
  return (int)cudaErrorInvalidValue;
}
