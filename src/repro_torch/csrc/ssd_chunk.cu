// ssd_chunk: the intra-chunk part of the Mamba-2 SSD (state-space
// duality) layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_chunk_pallas`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_chunk_kernel`).  Per
// (batch·head m, chunk k), all float32, with B and C from the group
// g = m / group:
//   cum      = cumsum(log a)                                  [L]
//   S        = exp(cum_i - cum_j) ⊙ [j <= i] ⊙ (C Bᵀ)          [L, L]
//   y        = S (Δ ⊙ X)                                      [L, P]
//   state    = ((exp(cum_L - cum) ⊙ Δ) ⊙ B)ᵀ X                 [N, P]
//   in_decay = exp(cum),  total = exp(cum_L)
// The carried-state term and the recurrence over chunks stay outside (in
// PyTorch, as the reference keeps them outside its kernel).
//
// Bound: bytes.  Each element read once and written once is
// 4·(M·K·L·(2P + 3) + M·K·(N·P + 1) + 2·G·K·L·N) bytes (647 MB at
// mamba2-130m's prefill, M = 24, K = 256, L = 128, P = 64, N = 128,
// G = 1: 0.193 ms at 3.35 TB/s).  Its least work, C·Bᵀ once per chunk
// and group and the causal half of it, is 19.9 GFLOP there: 0.040 ms at
// the TF32 tensor-core peak, 0.121 ms in three TF32 passes, 0.297 ms on
// the float32 pipes.  Two kernels; the entry point picks one from
// (L, N, P) by the rule the wrapper's `route` states:
//
// `ssd_chunk_sm90` (L 64 or 128, N 64 or 128, P 64 or 128):
// - Tensor cores: its three products run by wgmma in TF32, three passes
//   each (3xTF32, `tf32x3.cuh`).  Every operand is split explicitly into
//   two TF32 values, hi = x rounded to TF32 and lo = (x - hi) rounded to
//   TF32 (the tensor core would truncate a raw float32), and d += hi·hi +
//   lo·hi + hi·lo in float32 accumulators leaves about 2^-21 of each
//   product where one pass leaves 2^-11, which the float32 tolerance
//   needs.  The B operands sit in shared memory (K-major, 128-byte
//   swizzle) and are read by the tensor cores through descriptors, so no
//   thread loads an operand per multiply-add.
// - Grid: one block of two warpgroups per (chunk k, B/C group g, slice of
//   the group's heads); the wrapper picks the slice from the shape so
//   that the grid fills the card (`ops.heads_per_block`).
// - C·Bᵀ once per chunk and group: the block loads its B by TMA (boxes of
//   32 floats) once, splits it in place into B hi and B lo, and computes
//   S0 = C·Bᵀ once for all its heads (only a head's gate and Δ differ,
//   since log a = Δ·A_h).  Warpgroup c owns rows 64c..64c+63 and only the
//   columns j < 64c + 64 that the causal mask keeps, and holds its S0 in
//   registers through the head loop.  C comes from device memory straight
//   into registers as the A operand (its layout is free there).
// - Per head: one warp scans log a (E = L/32 terms in order on each lane,
//   then a warp scan of the lane sums) and writes cum, Δ and w·Δ
//   (w = exp(cum_L - cum)) to shared memory, in_decay and total to device
//   memory.  The head's columns pass 64 at a time (one pass at P = 64,
//   two at jamba-1.5-large's 128: y's and the state's columns are
//   independent over p, and cum, Δ, w·Δ and S0 do not depend on p, so a
//   second pass reuses them and the buffers keep their P-64 size).  A
//   pass's X arrives by TMA into a staging buffer while the previous pass
//   computes; all threads then write it transposed, split, as Xᵀ [p][l]
//   (PTX lets a TF32 operand be K-major only, and both products with X
//   contract over l).  y = P·X with P_ij = S0_ij ·
//   exp(cum_i - cum_j) · Δ_j, built in registers from S0's accumulator as
//   the A operand; the mask sets the exponent of j > i to -1e30 before
//   the exp, as the reference does, so that no lane branches.  state =
//   (w⊙Δ⊙B)ᵀ·X, its A operand read from B hi + lo in shared memory.
// - Fragment order: a thread's m64 accumulator holds columns 2t, 2t+1 of
//   each group of 8 (t = lane % 4), while the TF32 A fragment wants
//   columns t and t+4.  The order of a contraction is free, so Xᵀ keeps
//   each group of 8 l's permuted (position t holds l = 2t, position t + 4
//   holds l = 2t + 1): P's accumulator registers are the A fragment as
//   they stand, and the state's A operand is built in the same order.
// - Shared memory at L = N = 128, P = 64 or 128: B hi and lo 128 KB
//   (kept for the block), Xᵀ hi and lo 64 KB (rebuilt per pass), the X
//   staging buffer 32 KB (one TMA load in flight), cum, Δ, w·Δ 1.5 KB:
//   227 KB with the alignment slack, one block of 8 warps per SM.  A
//   head of two passes costs a block twice a one-pass head's time, which
//   `ops.heads_per_block` counts.  Outputs go
//   out from the accumulators as float2 stores (32 bytes a row a quad).
// - What limits it: the tensor work is a small part of its time.  With
//   two warps per scheduler, the issue of the instructions that build the
//   A fragments (gate, splits) and Xᵀ, between barriers per head, sets
//   the pace; hence the branch-free mask, the hardware ex2 for the gate
//   (its error is below the 3xTF32 products'), and TF32 rounding in two
//   integer instructions.
//
// `ssd_chunk_kernel` (every other shape: ragged or short chunks, other
// state and head widths) runs on the float32 pipes.  One block of 256
// threads per (chunk, batch·head) stages B and C of its chunk in shared
// memory (read from their group with no per-head copy), scans log a in
// order on one thread, and runs three small products from shared memory
// (`ssd_tile.cuh`: each thread holds a 4x4 register micro-tile, rows
// ty + 16a, columns tx + 16b, so a warp's reads are conflict-free).  The
// scores are kept in registers until C is no longer read, then overwrite
// C's buffer; B is scaled in place by exp(cum_L - cum)·Δ for the state.
// X and Δ⊙X are staged 64 columns of the head width at a time, and each
// slice gives its columns of y and of the state: 200,192 bytes at
// L = N = 128 for any P from 64 up (staged whole, P = 128 would need
// 265,728).  The mask is applied before exp
// (j > i gives 0), and tiles wholly above the diagonal are skipped.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ssd_tile.cuh"
#include "tf32x3.cuh"

namespace {

using ssd_tile::mm;
using ssd_tile::zero;

constexpr int NT = 256;     // 16 x 16 threads
constexpr int MAX_L = 128;  // the scores of a chunk fit 2 x 2 passes
constexpr int P_SLICE = 64; // X and Δ⊙X are staged 64 columns at a time

__host__ __device__ inline int ld_c(int L, int N) {
  return (N > L ? N : L) + 1;
}

__host__ __device__ inline int ld_x(int P) {
  return (P < P_SLICE ? P : P_SLICE) + 1;
}

__host__ __device__ inline long long smem_floats(int L, int N, int P) {
  return (long long)L * (N + 1) + (long long)L * ld_c(L, N) +
         2LL * L * ld_x(P) + 3LL * L;
}

__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ la, const float* __restrict__ bm,
                 const float* __restrict__ cm_, float* __restrict__ y,
                 float* __restrict__ st, float* __restrict__ dec,
                 float* __restrict__ tot, int K, int L, int P, int N,
                 int group) {
  extern __shared__ float smem[];
  const int ldb = N + 1, ldc = ld_c(L, N), ldx = ld_x(P);
  float* Bs = smem;                    // [L][N + 1], later w·Δ·B
  float* Cs = Bs + L * ldb;            // [L][ldc], later the scores S
  float* Xs = Cs + L * ldc;            // [L][ldx] a slice of X
  float* DXs = Xs + L * ldx;           // [L][ldx] the slice of Δ ⊙ X
  float* dts = DXs + L * ldx;          // [L]
  float* cum = dts + L;                // [L]
  float* wl = cum + L;                 // [L] exp(cum_L - cum)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int k = blockIdx.x, m = blockIdx.y;
  const long long cmk = (long long)m * K + k;            // this chunk
  const long long cgk = (long long)(m / group) * K + k;  // its B/C group

  for (int l = tid; l < L; l += NT) {
    dts[l] = dt[cmk * L + l];
    cum[l] = la[cmk * L + l];
  }
  for (int e = tid; e < L * N; e += NT) {
    const int l = e / N, n = e % N;
    Bs[l * ldb + n] = bm[cgk * L * N + e];
    Cs[l * ldc + n] = cm_[cgk * L * N + e];
  }
  __syncthreads();
  if (tid == 0) {                       // cumsum in order
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      acc += cum[l];
      cum[l] = acc;
    }
  }
  __syncthreads();
  const float cum_last = cum[L - 1];
  for (int l = tid; l < L; l += NT) {
    wl[l] = expf(cum_last - cum[l]);
    dec[cmk * L + l] = expf(cum[l]);
  }
  if (tid == 0) tot[cmk] = expf(cum_last);

  // scores C·Bᵀ in registers (the lower-triangular 64x64 tiles)
  float sc[2][2][4][4];
#pragma unroll
  for (int pi = 0; pi < 2; ++pi)
#pragma unroll
    for (int pj = 0; pj < 2; ++pj) {
      zero(sc[pi][pj]);
      if (pj <= pi && pi * 64 < L)
        mm(Cs, ldc, 1, Bs, 1, ldb, pi * 64, pj * 64, L, L, 0, N,
           sc[pi][pj], ty, tx);
    }
  __syncthreads();   // C and B are read; S overwrites C, B is rescaled

#pragma unroll
  for (int pi = 0; pi < 2; ++pi)
#pragma unroll
    for (int pj = 0; pj < 2; ++pj)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = pi * 64 + ty + 16 * a, j = pj * 64 + tx + 16 * b;
          if (i < L && j < L) {
            // mask before exp: the gate of j > i is exp(-1e30) = 0
            const float g = j <= i ? expf(cum[i] - cum[j]) : 0.0f;
            Cs[i * ldc + j] = j <= i ? sc[pi][pj][a][b] * g : 0.0f;
          }
        }
  for (int e = tid; e < L * N; e += NT) {
    const int l = e / N, n = e % N;
    Bs[l * ldb + n] = wl[l] * dts[l] * Bs[l * ldb + n];
  }

  // the head width in slices of P_SLICE columns: y = S (Δ ⊙ X) and
  // state = (w·Δ·B)ᵀ X of each slice from its X and Δ ⊙ X
  for (int p0 = 0; p0 < P; p0 += P_SLICE) {
    const int pw = min(P_SLICE, P - p0);
    __syncthreads();   // S and w·Δ·B are written; the last slice is read
    for (int e = tid; e < L * pw; e += NT) {
      const int l = e / pw, q = e % pw;
      const float xv = x[cmk * L * P + (long long)l * P + p0 + q];
      Xs[l * ldx + q] = xv;
      DXs[l * ldx + q] = dts[l] * xv;
    }
    __syncthreads();
    // y: row i reads columns j <= i only
    for (int i0 = 0; i0 < L; i0 += 64) {
      float acc[4][4];
      zero(acc);
      mm(Cs, ldc, 1, DXs, ldx, 1, i0, 0, L, pw, 0, min(L, i0 + 64), acc,
         ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + ty + 16 * a, p = tx + 16 * b;
          if (i < L && p < pw)
            y[cmk * L * P + (long long)i * P + p0 + p] = acc[a][b];
        }
    }
    for (int i0 = 0; i0 < N; i0 += 64) {
      float acc[4][4];
      zero(acc);
      mm(Bs, 1, ldb, Xs, ldx, 1, i0, 0, N, pw, 0, L, acc, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = i0 + ty + 16 * a, p = tx + 16 * b;
          if (n < N && p < pw)
            st[cmk * N * P + (long long)n * P + p0 + p] = acc[a][b];
        }
    }
  }
}

}  // namespace


namespace tc {

using namespace tf32x3;
using ssd_tile::load_terms;
using ssd_tile::warp_cumsum;

constexpr int NT = 256;       // two warpgroups
constexpr int PH = 64;        // X's columns a pass: the head width, or half

// the shapes it takes (the wrapper's `route` states the same rule)
__host__ __device__ constexpr bool takes(int L, int N, int P) {
  return (L == 64 || L == 128) && (N == 64 || N == 128) &&
         (P == 64 || P == 128);
}

// shared memory, in bytes from a 1024-aligned base: B hi and lo
// [N/32][L][32] (128-byte swizzle), Xᵀ hi and lo [L/32][PH][32] (the
// same), X as loaded [L][PH], cum, Δ and w·Δ [L], two mbarriers; the same
// at P = 64 and 128 (a head of 128 columns passes in two halves)
template <int L, int N>
struct Layout {
  static constexpr int B_BYTES = L * N * 4;
  static constexpr int XT_BYTES = PH * L * 4;
  static constexpr int X_BYTES = L * PH * 4;
  static constexpr int BHI = 0, BLO = B_BYTES, XTH = 2 * B_BYTES;
  static constexpr int XTL = XTH + XT_BYTES, XS = XTL + XT_BYTES;
  static constexpr int VEC = XS + X_BYTES, BARS = VEC + 3 * L * 4;
  static constexpr int SMEM = 1024 + BARS + 16;   // + alignment slack
};

__host__ __device__ constexpr long long smem_bytes(int L, int N) {
  return 1024LL + 4LL * (2 * L * N + 3 * PH * L + 3 * L) + 16;
}

// the float index of B(l, n) in B hi or lo
template <int L>
__device__ __forceinline__ int b_at(int l, int n) {
  return (n / 32) * L * 32 + l * 32 + ((((n % 32) / 4) ^ (l % 8)) * 4) +
         n % 4;
}

struct Args {
  const float* c;
  const float* dt;
  const float* la;
  float* y;
  float* st;
  float* dec;
  float* tot;
  int K, group, hpb;
};

// Xᵀ hi and lo from X [L][PH]: each thread writes one 16-byte chunk of
// each (row p, K positions 4·cg..4·cg+3, which hold l = 8(cg/2) + cg%2 +
// 0, 2, 4, 6)
template <int L>
__device__ __forceinline__ void build_xt(const float* xs, uint8_t* xth,
                                         uint8_t* xtl, int tid) {
#pragma unroll 2
  for (int q = tid; q < PH * L / 4; q += NT) {
    const int p = q % PH, cg = q / PH;
    const int l0 = 8 * (cg / 2) + cg % 2;
    uint4 hi, lo;
    split(xs[(l0 + 0) * PH + p], hi.x, lo.x);
    split(xs[(l0 + 2) * PH + p], hi.y, lo.y);
    split(xs[(l0 + 4) * PH + p], hi.z, lo.z);
    split(xs[(l0 + 6) * PH + p], hi.w, lo.w);
    const int off = kop_off(p, cg, PH);
    *reinterpret_cast<uint4*>(xth + off) = hi;
    *reinterpret_cast<uint4*>(xtl + off) = lo;
  }
}

// acc = Σ_s A_s·B_s over STEPS k8 steps in 3xTF32, four steps a wgmma
// group: B_s from the K-major operands at bh / bl (boxes of `rows` rows),
// A_s's fragments built by frag(s, hi, lo)
template <int NC, int STEPS, class Frag>
__device__ __forceinline__ void mma_steps(float* acc, uint32_t bh,
                                          uint32_t bl, int rows, Frag frag) {
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
  steps_rs<NC, 0, STEPS>(acc, bh, bl, rows, frag);
}

// rows r and r + 8 of a [64][NC] accumulator tile, from `out` (row r,
// column 2t) on, rows LD floats apart, as float2 stores (32 bytes a row a
// quad)
template <int NC, int LD>
__device__ __forceinline__ void store_tile(const float* acc, float* out) {
#pragma unroll
  for (int q = 0; q < NC / 8; ++q) {
    *reinterpret_cast<float2*>(out + 8 * q) =
        make_float2(acc[4 * q], acc[4 * q + 1]);
    *reinterpret_cast<float2*>(out + 8 * LD + 8 * q) =
        make_float2(acc[4 * q + 2], acc[4 * q + 3]);
  }
}

// y rows i0, i0 + 8 (and their warpgroup's 64) of one head's PH columns:
// P·X over the NJ columns the causal mask keeps; y's rows are P floats
template <int NJ, int P>
__device__ __forceinline__ void y_tile(const float* s0, int i0, int t,
                                       const float* cum, const float* dts,
                                       uint32_t xth, uint32_t xtl,
                                       float* yr) {
  const float ca = cum[i0], cb = cum[i0 + 8];
  float acc[PH / 2];
  mma_steps<PH, NJ / 8>(acc, xth, xtl, PH, [&](int s, uint32_t* hi,
                                               uint32_t* lo) {
    const int j = 8 * s + 2 * t;
    const float2 cj = *reinterpret_cast<const float2*>(cum + j);
    const float2 dj = *reinterpret_cast<const float2*>(dts + j);
    // P(i, j) = S0(i, j)·exp(cum_i - cum_j)·Δ_j, masked before the exp
    // (j > i gives exp(-1e30) = 0) so that no lane branches; the gate's
    // exp is the hardware ex2 (about 2^-21 of the gate where it is near
    // 1, below the 3xTF32 products' own error)
    const float a0 = s0[4 * s] * __expf(j <= i0 ? ca - cj.x : -1e30f) * dj.x;
    const float a1 =
        s0[4 * s + 1] * __expf(j + 1 <= i0 ? ca - cj.y : -1e30f) * dj.y;
    const float b0 =
        s0[4 * s + 2] * __expf(j <= i0 + 8 ? cb - cj.x : -1e30f) * dj.x;
    const float b1 =
        s0[4 * s + 3] * __expf(j + 1 <= i0 + 8 ? cb - cj.y : -1e30f) * dj.y;
    // fragment (row, k): (i0, t) (i0+8, t) (i0, t+4) (i0+8, t+4), and K
    // position t holds column 2t, t + 4 holds 2t + 1 (Xᵀ's order)
    split(a0, hi[0], lo[0]);
    split(b0, hi[1], lo[1]);
    split(a1, hi[2], lo[2]);
    split(b1, hi[3], lo[3]);
  });
  store_tile<PH, P>(acc, yr);
}

// state rows na, na + 8 (and their warpgroup's 64) of one head's PH
// columns: (w⊙Δ⊙B)ᵀ·X, the A operand read from B hi + lo; the state's rows
// are P floats
template <int L, int P>
__device__ __forceinline__ void state_tile(int na, int t, const float* bh,
                                           const float* bl, const float* wdt,
                                           uint32_t xth, uint32_t xtl,
                                           float* sr) {
  // B(l, n) for l = 8s + 2t (+1) and n = na (+8): a step of s moves 8
  // rows of 32 floats and keeps l % 8, so the swizzle, in place
  const int ia0 = b_at<L>(2 * t, na), ib0 = b_at<L>(2 * t, na + 8);
  const int ia1 = b_at<L>(2 * t + 1, na), ib1 = b_at<L>(2 * t + 1, na + 8);
  float acc[PH / 2];
  mma_steps<PH, L / 8>(acc, xth, xtl, PH, [&](int s, uint32_t* hi,
                                              uint32_t* lo) {
    const int o = 256 * s;
    const float2 wv = *reinterpret_cast<const float2*>(wdt + 8 * s + 2 * t);
    split((bh[ia0 + o] + bl[ia0 + o]) * wv.x, hi[0], lo[0]);
    split((bh[ib0 + o] + bl[ib0 + o]) * wv.x, hi[1], lo[1]);
    split((bh[ia1 + o] + bl[ia1 + o]) * wv.y, hi[2], lo[2]);
    split((bh[ib1 + o] + bl[ib1 + o]) * wv.y, hi[3], lo[3]);
  });
  store_tile<PH, P>(acc, sr);
}

__device__ __forceinline__ void sync_block() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
}

// warpgroup WG's part of the block (its code differs in the size of its
// S0 tile, so each warpgroup runs its own instance; every barrier is
// reached by all 256 threads)
template <int L, int N, int P, int WG>
__device__ __forceinline__ void run(uint8_t* sm, const CUtensorMap* tm_x,
                                    const CUtensorMap* tm_b, const Args& a) {
  using S = Layout<L, N>;
  constexpr int HALVES = P / PH;      // X's passes a head
  constexpr int NY = L / 64;          // y row tiles: warpgroup c takes c
  constexpr bool HAS_Y = WG < NY;
  constexpr int NJ = 64 * (WG + 1);   // the S0 columns its rows keep
  constexpr int E = L / 32;           // log a terms a lane of the scan adds
  const int tid = threadIdx.x, w = (tid / 32) % 4, lane = tid % 32;
  const int t = lane % 4;
  const int k = blockIdx.x, g = blockIdx.y;
  const int h0 = g * a.group + blockIdx.z * a.hpb;
  const int h1 = min(h0 + a.hpb, (g + 1) * a.group);
  const long long gk = (long long)g * a.K + k;
  const uint32_t base = smem_u32(sm);
  const uint32_t bhi = base + S::BHI, blo = base + S::BLO;
  const uint32_t xth = base + S::XTH, xtl = base + S::XTL;
  const uint32_t xs = base + S::XS;
  const uint32_t bfull = base + S::BARS, xfull = bfull + 8;
  float* cum = reinterpret_cast<float*>(sm + S::VEC);
  float* dts = cum + L;
  float* wdt = dts + L;

  if (tid == 0) {
    mbar_init(bfull, 1);
    mbar_init(xfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sync_block();
  if (tid == 0) {
    mbar_expect_tx(bfull, S::B_BYTES);
    for (int nb = 0; nb < N / 32; ++nb)
      tma_load(bhi + nb * L * ROW, tm_b, nb * 32, 0, (int)gk, bfull);
    mbar_expect_tx(xfull, S::X_BYTES);
    tma_load(xs, tm_x, 0, 0, h0 * a.K + k, xfull);
  }

  // C's rows i0, i0 + 8 as the A operand of S0 (natural order over n)
  const int i0 = 64 * WG + 16 * w + lane / 4;
  float cf[HAS_Y ? N / 8 : 1][4];
  if constexpr (HAS_Y) {
    const float* c0 = a.c + (gk * L + i0) * N + t;
#pragma unroll
    for (int s = 0; s < N / 8; ++s) {
      cf[s][0] = __ldg(c0 + 8 * s);
      cf[s][1] = __ldg(c0 + 8 * N + 8 * s);
      cf[s][2] = __ldg(c0 + 8 * s + 4);
      cf[s][3] = __ldg(c0 + 8 * N + 8 * s + 4);
    }
  }
  // log a and Δ of the first head, for the scan warp
  float pla[E], pdt[E];
  const bool scan = WG == 0 && w == 0;
  if (scan) load_terms<E>(a.la, a.dt, (long long)h0 * a.K + k, L, lane, pla,
                          pdt);

  // B hi and lo, in place of B
  mbar_wait(bfull, 0);
  split_in_place(sm + S::BHI, sm + S::BLO, L * N, tid, NT);
  fence_proxy_async();
  sync_block();

  // S0 = C·Bᵀ over this warpgroup's rows and the columns j < NJ
  float s0[HAS_Y ? NJ / 2 : 1];
  if constexpr (HAS_Y)
    mma_steps<NJ, N / 8>(s0, bhi, blo, L, [&](int s, uint32_t* hi,
                                              uint32_t* lo) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split(cf[s][e], hi[e], lo[e]);
    });

  const float* bh = reinterpret_cast<const float*>(sm + S::BHI);
  const float* bl = reinterpret_cast<const float*>(sm + S::BLO);
  // one pass per (head, half of its columns); `it` counts the passes
  for (int h = h0, it = 0; h < h1; ++h)
  for (int half = 0; half < HALVES; ++half, ++it) {
    const long long hk = (long long)h * a.K + k;
    if (scan && half == 0) {
      // cum = cumsum(log a)
      float c[E];
#pragma unroll
      for (int e = 0; e < E; ++e) c[e] = pla[e];
      const float last = warp_cumsum<E>(c, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int l = E * lane + e;
        cum[l] = c[e];
        dts[l] = pdt[e];
        wdt[l] = expf(last - c[e]) * pdt[e];
        a.dec[hk * L + l] = expf(c[e]);
      }
      if (lane == 0) a.tot[hk] = expf(last);
      if (h + 1 < h1) load_terms<E>(a.la, a.dt, hk + a.K, L, lane, pla, pdt);
    }
    mbar_wait(xfull, it & 1);
    build_xt<L>(reinterpret_cast<const float*>(sm + S::XS), sm + S::XTH,
                sm + S::XTL, tid);
    fence_proxy_async();
    sync_block();
    if (tid == 0 && (half + 1 < HALVES || h + 1 < h1)) {
      // the staging buffer is free: the next pass's columns
      const bool same = half + 1 < HALVES;
      mbar_expect_tx(xfull, S::X_BYTES);
      tma_load(xs, tm_x, same ? PH * (half + 1) : 0, 0,
               (int)(same ? hk : hk + a.K), xfull);
    }
    const int p0 = PH * half;
    if constexpr (HAS_Y)
      y_tile<NJ, P>(s0, i0, t, cum, dts, xth, xtl,
                    a.y + (hk * L + i0) * P + p0 + 2 * t);
    // state row tiles, dealt to the warpgroups after the y tiles
#pragma unroll
    for (int tt = 0; tt < N / 64; ++tt)
      if ((tt + NY) % 2 == WG) {
        const int na = 64 * tt + 16 * w + lane / 4;
        state_tile<L, P>(na, t, bh, bl, wdt, xth, xtl,
                         a.st + (hk * N + na) * P + p0 + 2 * t);
      }
    sync_block();   // Xᵀ is free (cum, Δ and w·Δ after the last half)
  }
}

// one block per (chunk, B/C group, slice of hpb heads of the group)
template <int L, int N, int P>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_sm90(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_b, Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if (threadIdx.x < 128)
    run<L, N, P, 0>(sm, &tm_x, &tm_b, a);
  else
    run<L, N, P, 1>(sm, &tm_x, &tm_b, a);
}

template <int L, int N, int P>
int launch(const float* x, const float* b, const Args& a, int M,
           cudaStream_t stream) {
  using S = Layout<L, N>;
  static_assert(S::SMEM == smem_bytes(L, N), "layout");
  static_assert(S::SMEM <= 232448, "one Hopper block's shared memory");
  CUtensorMap mx, mb;
  const uint64_t mk = (uint64_t)M * a.K, gk = (uint64_t)(M / a.group) * a.K;
  if (!tensor_map_3d(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, P, L, mk,
                     PH, L, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map_3d(&mb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, N, L, gk,
                     32, L, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kern = ssd_chunk_sm90<L, N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.K, M / a.group, (a.group + a.hpb - 1) / a.hpb);
  kern<<<grid, NT, S::SMEM, stream>>>(mx, mb, a);
  return (int)cudaGetLastError();
}

template <int P>
int launch_shape(int L, int N, const float* x, const float* b,
                 const Args& a, int M, cudaStream_t s) {
  if (L == 128 && N == 128) return launch<128, 128, P>(x, b, a, M, s);
  if (L == 128 && N == 64) return launch<128, 64, P>(x, b, a, M, s);
  if (L == 64 && N == 128) return launch<64, 128, P>(x, b, a, M, s);
  if (L == 64 && N == 64) return launch<64, 64, P>(x, b, a, M, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// 1 where the entry point runs `ssd_chunk_sm90` for chunks of L, state
// width N and head width P, 0 where it runs `ssd_chunk_kernel`
extern "C" int ssd_chunk_route(int L, int N, int P) {
  return tc::takes(L, N, P) ? 1 : 0;
}

// the dynamic shared memory of the kernel the entry point runs
extern "C" long long ssd_chunk_smem_bytes(int L, int N, int P) {
  if (tc::takes(L, N, P)) return tc::smem_bytes(L, N);
  return smem_floats(L, N, P) * (long long)sizeof(float);
}

// x [M,K,L,P], dt and la [M,K,L], b and c [M/group,K,L,N] float32; out y
// [M,K,L,P], state [M,K,N,P], in_decay [M,K,L], total [M,K].  hpb: the
// heads of a group that one block of `ssd_chunk_sm90` takes (the other
// kernel ignores it).  Returns a cudaError_t (0 on success).
extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* la, const float* b,
                                const float* c, float* y, float* st,
                                float* dec, float* tot, int M, int K, int L,
                                int P, int N, int group, int hpb,
                                void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (L < 1 || L > MAX_L || P < 1 || N < 1 || group < 1 || M % group ||
      M > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc::takes(L, N, P)) {
    const void* ptrs[] = {x, dt, la, b, c, y, st, dec, tot};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (hpb < 1 || hpb > group || (long long)M * K > INT_MAX)
      return (int)cudaErrorInvalidValue;
    const tc::Args a{c, dt, la, y, st, dec, tot, K, group, hpb};
    return P == 64 ? tc::launch_shape<64>(L, N, x, b, a, M, s)
                   : tc::launch_shape<128>(L, N, x, b, a, M, s);
  }
  const long long bytes = ssd_chunk_smem_bytes(L, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, M);
  ssd_chunk_kernel<<<grid, NT, (size_t)bytes, s>>>(
      x, dt, la, b, c, y, st, dec, tot, K, L, P, N, group);
  return (int)cudaGetLastError();
}
