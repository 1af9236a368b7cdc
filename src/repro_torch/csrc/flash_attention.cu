// flash_attention: causal GQA attention forward with an online softmax,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`):
//   out[b, h, i] = softmax_j(scale · q[b, h, i] · k[b, h / group, j]) v[...]
// over the keys j <= i + Tk - Tq (causal, sequence ends aligned), with
// float32 softmax statistics for float32 or bfloat16 inputs and the output
// in the input's type.
//
// Bound: operations at prefill lengths (4·Tq·Tk·D multiply-adds per head,
// half of it under the causal mask, against 2·(Tq + 2·Tk)·D bytes), so
// the [Tq, Tk] logits never go to device memory.  Two kernels; the entry
// point picks one from the input type and head width (the wrapper's
// `route` states the same rule):
//
// `flash_fwd_sm90` (bfloat16, D 64 or 128) runs both products on the
// tensor cores.  One block of three warpgroups per (128 query rows, query
// head, batch item); blocks are launched heaviest first (the last causal
// query tiles first) so the tail wave is short.  Warpgroup 0 is the
// producer: one thread loads the Q tile once and the K/V tiles of 128 keys
// by TMA into a ring of two stages, each with a full/empty mbarrier pair,
// and the warpgroup gives its registers up (setmaxnreg).  Warpgroups 1 and
// 2 each own 64 query rows: S = Q·Kᵀ by wgmma with both operands in shared
// memory (128-byte swizzle, two 64-column boxes for a 128-wide head), the
// online softmax in registers on the float32 accumulator (row max and sum
// over the four threads of a row, exp2 of pre-scaled logits, the mask
// applied only on tiles that cross the causal horizon or the ragged end),
// then O += P·V by wgmma with P as the register operand and V read
// transposed from shared memory.  The tensor maps are 3-D ([B·H, T, D]),
// so a tile that runs past T is zero-filled instead of reading the next
// head; those keys are masked.  The output goes out through shared memory
// by a TMA store, which clips the rows past Tq.
//
// Precision: P is split into two bfloat16 terms, hi = bf16(P) and
// lo = bf16(P - hi), and both go through the tensor cores into the same
// float32 accumulator (1.5x the tensor work of one bf16 P; P's own
// relative error drops from 2^-8 to 2^-16).  One bf16 P moves an output
// on the first causal rows, where a few keys carry large weights, by more
// than one bfloat16 rounding of the output.  The row sums are the float32
// sums of P.
//
// `flash_fwd` (float32 at any supported D, bfloat16 at D 16 or 32) runs on
// the float32 pipes (CUDA cores): TF32 would break the float32 tolerance.
// One block of 256 threads per (query tile of 64 rows, query head, batch
// item).  The block stages its 64 queries in shared memory once, then
// sweeps the key tiles of 32 keys: it stages K and V (as float32), each
// thread computes a 4x2 micro-tile of scores (rows ty*4..ty*4+3, keys tx
// and tx+16), masks them, and folds them into the running max and
// denominator of its rows (the 16 threads of a row reduce the max with
// warp shuffles; the denominator stays a per-thread partial until the
// end).  The probabilities go through shared memory to the P·V product,
// where each thread owns 4 rows and D/16 output columns.
//
// Both kernels read the KV head h / group in place (no replication), mask
// ragged Tq and Tk themselves (no padding) and skip key tiles wholly above
// the causal horizon: they add exactly 0 once a row has a finite maximum.
// Rows with no visible key (causal, i + Tk - Tq < 0) are computed as the
// reference's Pallas kernel does through its 128-key blocks: every real
// key has weight 1 (score 0 here) and the sum of V is divided by
// `masked_den` (Tk rounded up to a multiple of 128) instead of the weight
// sum.  A block that holds such rows sweeps every key tile.
//
// Given a non-null `lse` ([B, Hq, Tq] float32), both kernels also write
// each row's log-sum-exp of its scaled logits, in natural-log units (the
// backward kernels of csrc/flash_attention_bwd.cu rebuild P from it);
// `flash_fwd_sm90` converts its log2-domain maximum.  Serving passes null.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, int Hq, int Hkv, int Tq, int Tk,
          int causal, int masked_den, float scale) {
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
    if (lse != nullptr && tx == 0)
      lse[((long long)b * Hq + h) * Tq + qi] = m[i] + logf(lt);
    T* orow = out + qbase + (long long)qi * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, o[i][c] / den);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int Tq, int Tk, int causal,
           int masked_den, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_fwd<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Tq, Tk,
      causal, masked_den, scale);
  return (int)cudaGetLastError();
}

// float32 at every head width
int launch_f32(int D, const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Hq, int Hkv, int Tq, int Tk, int causal,
               int masked_den, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, float>(q, k, v, out, lse, B, Hq, Hkv, Tq,
                                      Tk, causal, masked_den, scale, s);
    case 32: return launch<32, float>(q, k, v, out, lse, B, Hq, Hkv, Tq,
                                      Tk, causal, masked_den, scale, s);
    case 64: return launch<64, float>(q, k, v, out, lse, B, Hq, Hkv, Tq,
                                      Tk, causal, masked_den, scale, s);
    case 128: return launch<128, float>(q, k, v, out, lse, B, Hq, Hkv, Tq,
                                        Tk, causal, masked_den, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bfloat16 at 16 or 32 (wider bfloat16 heads take `flash_fwd_sm90`)
int launch_bf16_narrow(int D, const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int Hq, int Hkv, int Tq,
                       int Tk, int causal, int masked_den, float scale,
                       cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, __nv_bfloat16>(q, k, v, out, lse, B, Hq, Hkv,
                                              Tq, Tk, causal, masked_den,
                                              scale, s);
    case 32: return launch<32, __nv_bfloat16>(q, k, v, out, lse, B, Hq, Hkv,
                                              Tq, Tk, causal, masked_den,
                                              scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

namespace sm90 {

constexpr int BQ = 128;        // query rows per block: 2 warpgroups x 64
constexpr int BK = 128;        // keys per K/V tile
constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int NT = 384;        // producer warpgroup + 2 consumer warpgroups
constexpr int ROW = 128;       // bytes of one swizzled row: 64 bf16 columns

// BQ query rows x D of head h, batch b (grid: Hq, query tiles, B).
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o,
               float* __restrict__ lse, int Hq, int group, int Tq, int Tk,
               int causal, int masked_den, float scale_log2) {
  constexpr int HALVES = D / 64;           // 64-column boxes per row
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int KV_BYTES = BK * D * 2;     // one of K or V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = sq + Q_BYTES + STAGES * 2 * KV_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u + 8u * s; };
  auto empty = [&](int s) { return bars + 8u + 8u * (STAGES + s); };
  auto k_tile = [&](int s) { return sq + Q_BYTES + s * 2u * KV_BYTES; };

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int off = Tk - Tq;
  const int bh = b * Hq + h;
  const int bkv = b * (Hq / group) + h / group;
  // key tiles: all of them, or up to the causal horizon of the last row
  int k_end = Tk;
  if (causal && q0 + off >= 0) k_end = min(Tk, min(q0 + BQ, Tq) + off);
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);              // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int hf = 0; hf < HALVES; ++hf)
        tma_load(sq + hf * BQ * ROW, &tm_q, hf * 64, q0, bh, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * KV_BYTES);
        const uint32_t sk = k_tile(s), sv = sk + KV_BYTES;
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_load(sk + hf * BK * ROW, &tm_k, hf * 64, t * BK, bkv,
                   full(s));
          tma_load(sv + hf * BK * ROW, &tm_v, hf * 64, t * BK, bkv,
                   full(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;                  // this warpgroup's 64 rows
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int rr = 64 * c + 16 * warp + lane / 4;   // tile rows rr, rr + 8
    const int qi0 = q0 + rr, qi1 = qi0 + 8;
    const bool dead0 = causal && qi0 + off < 0;
    const bool dead1 = causal && qi1 + off < 0;
    const int first = q0 + 64 * c;         // the smallest causal horizon
    const int col = 2 * (lane % 4);        // first of this thread's columns
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    const uint32_t qa = sq + 64 * c * ROW;
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, k0 = t * BK;
      const uint32_t sk = k_tile(s), sv = sk + KV_BYTES;
      mbar_wait(full(s), (t / STAGES) & 1);

      // S = Q·Kᵀ: D/16 steps of k16, a 64-column box every 4 steps
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        wgmma_ss_n128(
            sc, sw128_desc(qa + (kk / 4) * BQ * ROW + step, 16, 1024),
            sw128_desc(sk + (kk / 4) * BK * ROW + step, 16, 1024), kk > 0);
      }
      wgmma_commit_wait();
      pin<BK / 2>(sc);

      // logits in the log2 domain; sc[4j + e] is row rr (e < 2) or
      // rr + 8, key k0 + 8j + col + (e & 1)
      const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > first + off);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + col + (e & 1);
            const bool dead = e < 2 ? dead0 : dead1;
            const int qi = e < 2 ? qi0 : qi1;
            float x = sc[4 * j + e] * scale_log2;
            if (kj >= Tk) x = -INFINITY;
            else if (dead) x = 0.0f;        // weight 1 for every real key
            else if (causal && kj > qi + off) x = -INFINITY;
            sc[4 * j + e] = x;
          }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      // every row sees a real key in tile 0, so the max is finite from
      // there on; the guard keeps a row past Tq free of NaN
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float u0 = n0 == -INFINITY ? 0.0f : n0;
      const float u1 = n1 == -INFINITY ? 0.0f : n1;
      const float a0 = ex2(m0 - u0), a1 = ex2(m1 - u1);
      m0 = n0;
      m1 = n1;

      // P as the register operand: ph[4kk..4kk+3] is k16 step kk's A
      uint32_t ph[BK / 4], pl[BK / 4];
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = ex2(sc[4 * j] - u0), p1 = ex2(sc[4 * j + 1] - u0);
        const float p2 = ex2(sc[4 * j + 2] - u1);
        const float p3 = ex2(sc[4 * j + 3] - u1);
        s0 += p0 + p1;
        s1 += p2 + p3;
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(p2, p3);
        ph[2 * j] = bits(h01);
        ph[2 * j + 1] = bits(h23);
        pl[2 * j] = bits(__floats2bfloat162_rn(p0 - __low2float(h01),
                                               p1 - __high2float(h01)));
        pl[2 * j + 1] = bits(__floats2bfloat162_rn(p2 - __low2float(h23),
                                                   p3 - __high2float(h23)));
      }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }

      // O += P·V: BK/16 steps; V [keys, D] is the MN-major B operand,
      // 8 keys apart by 1024 bytes, the second 64 columns BK rows on
      pin<D / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(sv + kk * 16 * ROW, BK * ROW, 1024);
        if constexpr (D == 128) {
          wgmma_rs_n128(o, &ph[4 * kk], dv);
          wgmma_rs_n128(o, &pl[4 * kk], dv);
        } else {
          wgmma_rs_n64(o, &ph[4 * kk], dv);
          wgmma_rs_n64(o, &pl[4 * kk], dv);
        }
      }
      wgmma_commit_wait();
      pin<D / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // epilogue: row sums over the quad, divide, bf16 into this
    // warpgroup's rows of the Q tile (same swizzle), one TMA store a box
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    const float r0 = 1.0f / (dead0 ? (float)masked_den : l0);
    const float r1 = 1.0f / (dead1 ? (float)masked_den : l1);
    if (lse != nullptr && lane % 4 == 0) {
      // 2^m · l in natural-log units
      constexpr float LN2 = 0.69314718055994531f;
      float* row = lse + (long long)bh * Tq;
      if (qi0 < Tq) row[qi0] = m0 * LN2 + logf(l0);
      if (qi1 < Tq) row[qi1] = m1 * LN2 + logf(l1);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t at = sq + (j / 8) * BQ * ROW + rr * ROW +
                          (((j % 8) ^ (rr % 8)) * 16) + col * 2;
      const uint32_t x0 = bits(__floats2bfloat162_rn(o[4 * j] * r0,
                                                     o[4 * j + 1] * r0));
      const uint32_t x1 = bits(__floats2bfloat162_rn(o[4 * j + 2] * r1,
                                                     o[4 * j + 3] * r1));
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at), "r"(x0)
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at + 8 * ROW),
                   "r"(x1) : "memory");
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
    if (tid == 0 && first < Tq) {
      for (int hf = 0; hf < HALVES; ++hf)
        tma_store(&tm_o, qa + hf * BQ * ROW, hf * 64, first, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
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
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int Tq, int Tk, int causal,
           int masked_den, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(&mq, q, B * Hq, Tq, D, BQ) ||
      !tensor_map(&mk, k, B * Hkv, Tk, D, BK) ||
      !tensor_map(&mv, v, B * Hkv, Tk, D, BK) ||
      !tensor_map(&mo, out, B * Hq, Tq, D, 64))
    return (int)cudaErrorInvalidValue;
  const int bytes = 1024 + BQ * D * 2 + STAGES * 2 * BK * D * 2 +
                    8 * (1 + 2 * STAGES);
  auto kern = flash_fwd_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, (Tq + BQ - 1) / BQ, B);
  kern<<<grid, NT, bytes, stream>>>(
      mq, mk, mv, mo, lse, Hq, Hq / Hkv, Tq, Tk, causal, masked_den,
      (float)(scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Hq, int Hkv, int Tq, int Tk, int causal,
             int masked_den, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64>(q, k, v, out, lse, B, Hq, Hkv, Tq, Tk,
                               causal, masked_den, scale, s);
    case 128: return launch<128>(q, k, v, out, lse, B, Hq, Hkv, Tq, Tk,
                                 causal, masked_den, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90

// dtype: 0 float32, 1 bfloat16.  bfloat16 at D 64 or 128 runs
// `flash_fwd_sm90`, everything else `flash_fwd`.  `lse` is null or a
// float32 [B, Hq, Tq] buffer for the rows' log-sum-exp.  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Hq, int Hkv, int Tq, int Tk, int D,
                                      int causal, int masked_den, float scale,
                                      void* lse, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_f32(D, q, k, v, out, l, B, Hq, Hkv, Tq, Tk, causal,
                      masked_den, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D == 64 || D == 128)
    return sm90::launch_d(D, q, k, v, out, l, B, Hq, Hkv, Tq, Tk, causal,
                          masked_den, scale, s);
  return launch_bf16_narrow(D, q, k, v, out, l, B, Hq, Hkv, Tq, Tk, causal,
                            masked_den, scale, s);
}
