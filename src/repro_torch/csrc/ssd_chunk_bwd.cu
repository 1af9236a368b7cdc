// ssd_chunk_bwd: the backward of the intra-chunk part of the Mamba-2 SSD
// layer (`ssd_chunk.cu`), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's backward
// (src/repro/kernels/ssd_scan/ops.py, `_bwd` of `_ssd_kernel_vjp`)
// recomputes through its plain chunked version (`ref.ssd_chunked_ref`).
// Per (batch·head m, chunk k), all float32, with B and C from the group
// g = m / group, and the forward's
//   cum = cumsum(la),  G_ij = exp(cum_i - cum_j)·[j <= i],  S = C Bᵀ,
//   M = S ⊙ G,  U = Δ ⊙ X,  y = M U,  e_j = exp(cum_L-1 - cum_j),
//   w = e ⊙ Δ,  state = (w ⊙ B)ᵀ X,  in_decay = exp(cum),
//   total = exp(cum_L-1),
// the gradients dy [L,P], dstate [N,P], ddec [L] and dtot give
//   dM = dy Uᵀ,  dU = Mᵀ dy,  dS = dM ⊙ G,  T = dM ⊙ M,
//   R = X dstateᵀ [L,N],  dw_j = Σ_n B_jn R_jn,
//   dX = Δ ⊙ dU + (w ⊙ B) dstate,  dΔ_j = Σ_p X_jp dU_jp + dw_j e_j,
//   dcum_i = Σ_j T_ij - Σ_j T_ji + ddec_i exp(cum_i) - dw_i w_i
//            (+ Σ_j dw_j w_j + dtot·exp(cum_L-1) at i = L-1),
//   dla_j = Σ_{i >= j} dcum_i,
// and for B/C row g, summed over the group's heads h:
//   dC = (Σ_h dS_h) B,  dB = (Σ_h dS_h)ᵀ C + Σ_h w_h ⊙ R_h.
// With V = B dstate [L,P] and Z = dU + e ⊙ V: dX = Δ ⊙ Z, dΔ_j = Σ_p X_jp
// Z_jp and dw_j = Σ_p X_jp V_jp, so no head needs R; and Σ_h w_h ⊙ R_h =
// Σ_(h,p) (w_h ⊙ X_h)(j,p) dstate_h(n,p) is one product over (head, p).
//
// Bound: bytes.  At mamba2-130m's training shape (B 8, T 4096: M = 192,
// K = 32, L = N = 128, P = 64, G = 8 B/C rows of 24 heads) each input
// read once and each output written once is 4·(M·K·L·(3P + 5) + M·K·N·P
// + M·K + 4·G·K·L·N) bytes, 0.89 GB: 0.265 ms at 3.35 TB/s.  Its least
// work, 2 operations a multiply-add over the causal half of dM and dU and
// the whole of R and dX's state term per head, and the causal half of
// C·Bᵀ, dC and dB once per chunk and B/C row, is 40.4 GFLOP: 0.082 ms at
// the TF32 tensor-core peak, 0.245 ms in three TF32 passes, 0.60 ms on
// the float32 pipes (67 TFLOP/s).  chip_smoke computes both from the
// shapes it runs.  Two routes, by the rule the wrapper's `route_bwd`
// states; no atomics on either, so two runs give the same bits.
//
// Tensor cores (L 64 or 128, N 64 or 128, P 64 or 128: the forward's
// `ssd_chunk_sm90` shapes), three launches.  Every product runs by wgmma
// in 3xTF32 (`tf32x3.cuh`: hi·hi + lo·hi + hi·lo of explicit TF32
// splits, about 2^-21 of a product, where one pass leaves 2^-11 and would
// break the 1e-4 tolerance).  A TF32 operand in shared memory must be
// K-major (hi and lo, 128-byte swizzle), and shared memory is the binding
// limit: a block that kept B, C, X, dy and dstate in the layouts of all
// the products, hi and lo, would need over 256 KB at L = N = 128, P = 64.
// So the work is cut by the orientation its products need, and only the
// slices' Σ dS and T's sums pass through memory (no per-head partial):
// - `ssd_bwd_ds`, one block of two warpgroups per (chunk, B/C row, slice
//   of the row's heads, `ops.heads_per_block`), rows i (warpgroup c owns
//   rows 64c..64c+63 and the columns j < 64c + 64 the causal mask keeps).
//   S = C·Bᵀ once (B by TMA, split in place; C from device memory into
//   registers as the A operand), kept in registers.  Per head, dM = dy·Xᵀ
//   with both from shared memory as TMA loads them (dy rows i and X rows
//   j are K-major over p as they lie), 64 columns of p a pass; then dS =
//   dM ⊙ Δ_j ⊙ G into the slice's Σ dS, kept in shared memory in fragment
//   order (each thread adds to its own registers' words, in ascending
//   head order), and T = dS ⊙ S's row sums (quads) and column sums (the
//   lanes of a column, then eight warps in order) as Σ_j T_ij - Σ_j T_ji
//   to device memory.  The next pass's X and dy load while a head's
//   elementwise work runs.  Shared memory at L = N = 128: 128 KB for B hi
//   and lo, then 128 KB for X and dy hi and lo and 48 KB for Σ dS: 186,896
//   bytes.
// - `ssd_bwd_dx`, the same grid, rows j.  Sᵀ = B·Cᵀ once, both operands
//   from shared memory (B hi and lo [N/32][L][32] for the block; C 64 of
//   its columns at a time), kept in registers (warpgroup c: rows j of
//   tile c, columns i >= 64c).  Per head, 32 columns of p a pass: the
//   pass's dstate and dy arrive by TMA in a staging buffer while the
//   previous pass computes, and are written transposed and split as
//   dstateᵀ [p][n] and dyᵀ [p][i] (dyᵀ's K order permuted so that Sᵀ's
//   accumulator registers, gated, are Mᵀ's A fragment as they stand: a
//   thread holds columns 2t, 2t + 1 of each group of 8, and position t
//   holds i = 2t, t + 4 holds 2t + 1); V = B·dstate with A from shared
//   memory, dw's terms, then the accumulator scaled by e and Mᵀ·dy
//   added: Z; dX = Δ ⊙ Z out, dΔ's terms.  Per head, one warp forms dcum
//   from the terms, `ssd_bwd_ds`'s T sums, ddec and dtot, and dla as its
//   reverse cumsum.  231,960 bytes, within 488 of a block's limit.
// - `ssd_bwd_db`, one block per (chunk, B/C row): the slices' Σ dS summed
//   in ascending slice order as it is read into A fragments; dC = (Σ
//   dS)·B and (Σ dS)ᵀ·C against Bᵀ and Cᵀ built in shared memory; then,
//   over the row's heads in ascending order, R_h = X_h·dstate_hᵀ with
//   both operands as TMA loads them (X rows j and dstate rows n are
//   K-major over p; 64 columns a pass, one pass ahead) in an accumulator
//   of its own, scaled by w on its rows and added to dB's in float32 (the
//   tensor core's float32 sums truncate: one accumulator over jamba's 128
//   heads drifted by 1.1e-4 of dB's max).  198,160 bytes at L = N = 128.
// Scratch at the training shape: one slice a row, Σ dS 16.8 MB and T's
// sums 3.1 MB (the CUDA-core pair's per-head partials were 0.70 GB).
// Head width 128 costs no more shared memory: `ssd_bwd_ds` and
// `ssd_bwd_db` pass p 64 columns at a time, `ssd_bwd_dx` 32.
//
// CUDA cores (every other shape: chunks up to 128, state widths up to 128
// and head widths up to 64), two launches:
// - `ssd_bwd_heads`, one block of 256 threads per (chunk, batch·head):
//   B, C, X and dy of its chunk in shared memory (B and C read from
//   their group, no per-head copy), log a scanned in order on one thread.
//   S = C Bᵀ in registers (the lower 64x64 tiles), then M = S ⊙ G over
//   C's buffer; dM tile by tile in registers gives dS (stored for the
//   second launch, lower tiles only), T's row sums (shuffles across the
//   16 threads of a row) and column sums (one partial per thread row,
//   summed in order); dU = Mᵀ dy, kept in registers for dX; dstate over
//   M's buffer; R gives dw and w ⊙ R (stored); B is scaled by w in place
//   for dX's state term.  The products are `ssd_tile.cuh`'s 4x4
//   micro-tiles (conflict-free reads on the odd row strides).  210 KB of
//   shared memory at L = N = 128, P = 64: one block per SM.
// - `ssd_bwd_groups`, one block per (chunk, B/C row): Σ_h dS_h and
//   Σ_h w_h ⊙ R_h over the group's heads in ascending order (the
//   reference sums them in its VJP of the per-head copy of B and C),
//   then dC and dB from B and C in shared memory (198 KB at 128).
// The two partials per head, dS [M,K,L,L] and w ⊙ R [M,K,L,N], pass
// through device memory.  Shapes: L <= 128, P <= 64 and N <= 128, where
// the shared memory of both kernels fits a block's 227 KB; the launch
// refuses the rest.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ssd_tile.cuh"
#include "tf32x3.cuh"

namespace {

using ssd_tile::mm;
using ssd_tile::zero;

constexpr int NT = 256;      // 16 x 16 threads
constexpr int MAX_L = 128;   // the L x L matrices fit 2 x 2 tiles of 64
constexpr int MAX_P = 64;    // dU and dX's rows fit one tile of 64
constexpr int MAX_N = 128;   // with L and P at theirs, 210 KB a block
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int ld_m(int L, int N) {
  return (N > L ? N : L) + 1;
}

// `ssd_bwd_heads`: B [L][N+1]; C, then M, then dstate; X and dy
// [L][P+1]; the vectors Δ, cum, e, row sums, dU·X sums, dw, 16 partial
// column sums
__host__ __device__ inline long long heads_floats(int L, int N, int P) {
  const long long cm = (long long)L * ld_m(L, N);
  const long long ds = (long long)N * (P + 1);
  return (long long)L * (N + 1) + (cm > ds ? cm : ds) +
         2LL * L * (P + 1) + 22LL * L;
}

// `ssd_bwd_groups`: Σ dS [L][L+1], B and C [L][N+1]
__host__ __device__ inline long long groups_floats(int L, int N) {
  return (long long)L * (L + 1) + 2LL * L * (N + 1);
}

// the sum over the 16 threads of a row of the block (lanes tx = 0..15 of
// a half-warp), in a fixed order
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(NT)
ssd_bwd_heads(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ la, const float* __restrict__ bm,
              const float* __restrict__ cm_, const float* __restrict__ dy,
              const float* __restrict__ dst, const float* __restrict__ ddec,
              const float* __restrict__ dtot, float* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ dla,
              float* __restrict__ ds_out, float* __restrict__ wr_out, int K,
              int L, int P, int N, int group) {
  extern __shared__ float smem[];
  const int ldb = N + 1, ldm = ld_m(L, N), ldx = P + 1;
  const long long cm = (long long)L * ldm, dsz = (long long)N * ldx;
  float* Bs = smem;                         // [L][N + 1], later w ⊙ B
  float* Ms = Bs + L * ldb;                 // C, then M, then dstate
  float* Xs = Ms + (cm > dsz ? cm : dsz);   // [L][P + 1]
  float* Ys = Xs + L * ldx;                 // [L][P + 1] dy
  float* dts = Ys + L * ldx;                // [L] Δ
  float* cum = dts + L;                     // [L]
  float* ev = cum + L;                      // [L] exp(cum_L-1 - cum)
  float* rowT = ev + L;                     // [L] Σ_j T_ij
  float* dlt = rowT + L;                    // [L] Σ_p X_jp dU_jp
  float* dwv = dlt + L;                     // [L] dw
  float* colT = dwv + L;                    // [16][L] partial Σ_i T_ij

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int k = blockIdx.x, m = blockIdx.y;
  const long long cmk = (long long)m * K + k;            // this chunk
  const long long cgk = (long long)(m / group) * K + k;  // its B/C row

  for (int l = tid; l < L; l += NT) {
    dts[l] = dt[cmk * L + l];
    cum[l] = la[cmk * L + l];
  }
  for (int e = tid; e < L * N; e += NT) {
    const int l = e / N, n = e % N;
    Bs[l * ldb + n] = bm[cgk * L * N + e];
    Ms[l * ldm + n] = cm_[cgk * L * N + e];
  }
  for (int e = tid; e < L * P; e += NT) {
    const int l = e / P, p = e % P;
    Xs[l * ldx + p] = x[cmk * L * P + e];
    Ys[l * ldx + p] = dy[cmk * L * P + e];
  }
  __syncthreads();
  if (tid == 0) {                       // cumsum in order, as the forward
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      acc += cum[l];
      cum[l] = acc;
    }
  }
  __syncthreads();
  const float cum_last = cum[L - 1];
  for (int l = tid; l < L; l += NT) ev[l] = expf(cum_last - cum[l]);

  // S = C Bᵀ in registers (the lower 64x64 tiles), then M = S ⊙ G over C
  {
    float sc[2][2][4][4];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
#pragma unroll
      for (int pj = 0; pj < 2; ++pj) {
        zero(sc[pi][pj]);
        if (pj <= pi && pi * 64 < L)
          mm(Ms, ldm, 1, Bs, 1, ldb, pi * 64, pj * 64, L, L, 0, N,
             sc[pi][pj], ty, tx);
      }
    __syncthreads();   // C is read: M overwrites it
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
              // mask before exp: the gate of j > i is 0
              const float g = j <= i ? expf(cum[i] - cum[j]) : 0.0f;
              Ms[i * ldm + j] = j <= i ? sc[pi][pj][a][b] * g : 0.0f;
            }
          }
  }
  __syncthreads();

  // dM = (dy Xᵀ) ⊙ Δ_j tile by tile: dS (stored), T's row and column sums
  {
    float rs[2][4], cs[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int a = 0; a < 4; ++a) rs[t][a] = cs[t][a] = 0.0f;
    float* dso = ds_out + cmk * L * L;
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
#pragma unroll
      for (int pj = 0; pj < 2; ++pj) {
        if (pj > pi || pi * 64 >= L) continue;
        float acc[4][4];
        zero(acc);
        mm(Ys, ldx, 1, Xs, 1, ldx, pi * 64, pj * 64, L, L, 0, P, acc, ty,
           tx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = pi * 64 + ty + 16 * a, j = pj * 64 + tx + 16 * b;
            if (i < L && j < L) {
              float dsv = 0.0f, t = 0.0f;
              if (j <= i) {
                const float dm = acc[a][b] * dts[j];
                dsv = dm * expf(cum[i] - cum[j]);
                t = dm * Ms[i * ldm + j];
              }
              dso[i * L + j] = dsv;
              rs[pi][a] += t;
              cs[pj][b] += t;
            }
          }
      }
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float v = row_sum16(rs[pi][a]);
        const int i = pi * 64 + ty + 16 * a;
        if (tx == 0 && i < L) rowT[i] = v;
      }
#pragma unroll
    for (int pj = 0; pj < 2; ++pj)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = pj * 64 + tx + 16 * b;
        if (j < L) colT[ty * L + j] = cs[pj][b];
      }
  }

  // dU = Mᵀ dy (row j reads rows i >= j of M); Δ ⊙ dU stays in registers
  float dxr[2][4][4];
#pragma unroll
  for (int jt = 0; jt < 2; ++jt) {
    zero(dxr[jt]);
    const int j0 = jt * 64;
    if (j0 >= L) continue;
    mm(Ms, 1, ldm, Ys, ldx, 1, j0, 0, L, P, j0, L, dxr[jt], ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      const int jr = j < L ? j : 0;
      float s = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = tx + 16 * b;
        if (p < P) s += Xs[jr * ldx + p] * dxr[jt][a][b];
        dxr[jt][a][b] *= dts[jr];
      }
      s = row_sum16(s);
      if (tx == 0 && j < L) dlt[j] = s;
    }
  }
  __syncthreads();   // M is read: dstate overwrites it
  float* Ds = Ms;    // [N][P + 1]
  for (int e = tid; e < N * P; e += NT) {
    const int n = e / P, p = e % P;
    Ds[n * ldx + p] = dst[cmk * N * P + e];
  }
  __syncthreads();

  // R = X dstateᵀ: dw = Σ_n B ⊙ R (rows), w ⊙ R stored
  {
    float* wro = wr_out + cmk * L * N;
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const int j0 = jt * 64;
      if (j0 >= L) continue;
      float dwp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int n0 = 0; n0 < N; n0 += 64) {
        float acc[4][4];
        zero(acc);
        mm(Xs, ldx, 1, Ds, 1, ldx, j0, n0, L, N, 0, P, acc, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = j0 + ty + 16 * a;
          const int jr = j < L ? j : 0;
          const float w = ev[jr] * dts[jr];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int n = n0 + tx + 16 * b;
            if (n < N) {
              dwp[a] += Bs[jr * ldb + n] * acc[a][b];
              if (j < L) wro[j * N + n] = w * acc[a][b];
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float v = row_sum16(dwp[a]);
        const int j = j0 + ty + 16 * a;
        if (tx == 0 && j < L) dwv[j] = v;
      }
    }
  }
  __syncthreads();   // B is read: w ⊙ B overwrites it
  for (int e = tid; e < L * N; e += NT) {
    const int l = e / N, n = e % N;
    Bs[l * ldb + n] *= ev[l] * dts[l];
  }
  __syncthreads();

  // dX = Δ ⊙ dU + (w ⊙ B) dstate
#pragma unroll
  for (int jt = 0; jt < 2; ++jt) {
    const int j0 = jt * 64;
    if (j0 >= L) continue;
    mm(Bs, ldb, 1, Ds, ldx, 1, j0, 0, L, P, 0, N, dxr[jt], ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + ty + 16 * a, p = tx + 16 * b;
        if (j < L && p < P)
          dx[cmk * L * P + (long long)j * P + p] = dxr[jt][a][b];
      }
  }

  // dΔ, dcum and its reverse cumsum (one thread, in order)
  for (int l = tid; l < L; l += NT) {
    ddt[cmk * L + l] = dlt[l] + dwv[l] * ev[l];
    float col = 0.0f;
    for (int r = 0; r < 16; ++r) col += colT[r * L + l];
    // dcum_l, before the terms of row L-1: kept in rowT
    rowT[l] = rowT[l] - col + ddec[cmk * L + l] * expf(cum[l]) -
              dwv[l] * ev[l] * dts[l];
  }
  __syncthreads();
  if (tid == 0) {
    float sw = 0.0f;
    for (int l = 0; l < L; ++l) sw += dwv[l] * ev[l] * dts[l];
    float acc = 0.0f;
    for (int l = L - 1; l >= 0; --l) {
      float d = rowT[l];
      if (l == L - 1) d += sw + dtot[cmk] * expf(cum_last);
      acc += d;
      dla[cmk * L + l] = acc;
    }
  }
}

__global__ void __launch_bounds__(NT)
ssd_bwd_groups(const float* __restrict__ bm, const float* __restrict__ cm_,
               const float* __restrict__ ds_in,
               const float* __restrict__ wr_in, float* __restrict__ db,
               float* __restrict__ dc, int K, int L, int N, int group) {
  extern __shared__ float smem[];
  const int ldd = L + 1, ldb = N + 1;
  float* Ss = smem;               // [L][L + 1] Σ_h dS_h
  float* Bs = Ss + L * ldd;       // [L][N + 1]
  float* Cs = Bs + L * ldb;       // [L][N + 1]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int k = blockIdx.x, g = blockIdx.y;
  const long long cgk = (long long)g * K + k;    // this B/C row's chunk
  const long long h0 = (long long)g * group;     // its first head

  for (int e = tid; e < L * N; e += NT) {
    const int l = e / N, n = e % N;
    Bs[l * ldb + n] = bm[cgk * L * N + e];
    Cs[l * ldb + n] = cm_[cgk * L * N + e];
  }
  {
    float sc[2][2][4][4];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
#pragma unroll
      for (int pj = 0; pj < 2; ++pj) zero(sc[pi][pj]);
    for (int h = 0; h < group; ++h) {          // ascending head order
      const float* src = ds_in + ((h0 + h) * K + k) * L * L;
#pragma unroll
      for (int pi = 0; pi < 2; ++pi)
#pragma unroll
        for (int pj = 0; pj < 2; ++pj) {
          if (pj > pi) continue;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int i = pi * 64 + ty + 16 * a;
              const int j = pj * 64 + tx + 16 * b;
              if (i < L && j < L) sc[pi][pj][a][b] += src[i * L + j];
            }
        }
    }
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
#pragma unroll
      for (int pj = 0; pj < 2; ++pj)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = pi * 64 + ty + 16 * a, j = pj * 64 + tx + 16 * b;
            if (i < L && j < L) Ss[i * ldd + j] = sc[pi][pj][a][b];
          }
  }
  __syncthreads();

  for (int i0 = 0; i0 < L; i0 += 64)
    for (int n0 = 0; n0 < N; n0 += 64) {
      // dC = (Σ dS) B: row i reads rows j <= i of B
      float acc[4][4];
      zero(acc);
      mm(Ss, ldd, 1, Bs, ldb, 1, i0, n0, L, N, 0, min(L, i0 + 64), acc,
         ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + ty + 16 * a, n = n0 + tx + 16 * b;
          if (i < L && n < N) dc[cgk * L * N + (long long)i * N + n] =
              acc[a][b];
        }
      // dB = (Σ dS)ᵀ C + Σ_h w_h ⊙ R_h: row j reads rows i >= j of C
      zero(acc);
      mm(Ss, 1, ldd, Cs, ldb, 1, i0, n0, L, N, i0, L, acc, ty, tx);
      for (int h = 0; h < group; ++h) {         // ascending head order
        const float* src = wr_in + ((h0 + h) * K + k) * L * N;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = i0 + ty + 16 * a, n = n0 + tx + 16 * b;
            if (j < L && n < N) acc[a][b] += src[j * N + n];
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = i0 + ty + 16 * a, n = n0 + tx + 16 * b;
          if (j < L && n < N) db[cgk * L * N + (long long)j * N + n] =
              acc[a][b];
        }
    }
}

}  // namespace

namespace tc {

using namespace tf32x3;
using ssd_tile::load_terms;
using ssd_tile::warp_cumsum;

constexpr int NT = 256;        // two warpgroups
constexpr int PH = 64;         // `ssd_bwd_ds`: X's and dy's columns a pass
constexpr int PC = 32;         // `ssd_bwd_dx`: the head's columns a pass

// the shapes the tensor-core kernels take (the wrapper's `route_bwd`
// states the same rule)
__host__ __device__ constexpr bool takes(int L, int N, int P) {
  return (L == 64 || L == 128) && (N == 64 || N == 128) &&
         (P == 64 || P == 128);
}

__device__ __forceinline__ void sync_block() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
}

// ---------------------------------------------------------------------
// `ssd_bwd_ds`: S = C·Bᵀ once, then per head dM, dS and T's sums
// ---------------------------------------------------------------------

struct ArgsDS {
  const float* c;
  const float* dt;
  const float* la;
  float* tcum;    // [M,K,L] Σ_j T_ij - Σ_j T_ji
  float* dsp;     // [slices,G,K,L,L] Σ_h dS_h of each slice
  int K, G, group, hpb, P;
};

// shared memory, bytes from a 1024-aligned base.  While S is formed: B hi
// and lo [N/32][L][32]; then X hi, X lo, dy hi, dy lo [2][L][32] each
// (PH columns) and the slice's Σ dS in fragment order (128 floats a
// register a warpgroup); after both, cum, Δ, the row sums of T, eight
// warps' column sums of T, and two mbarriers.
template <int L, int N>
struct LayoutDS {
  static constexpr int NY = L / 64;
  static constexpr int B_BYTES = L * N * 4;
  static constexpr int XB = L * PH * 4;
  static constexpr int ACC = 4 * XB;
  static constexpr int ACC_FLOATS = 128 * 32 * NY * (NY + 1) / 2;
  static constexpr int H_BYTES = ACC + ACC_FLOATS * 4;
  static constexpr int VEC = 2 * B_BYTES > H_BYTES ? 2 * B_BYTES : H_BYTES;
  static constexpr int BARS = VEC + 11 * L * 4;
  static constexpr int SMEM = 1024 + BARS + 16;
};

template <int L, int N, int WG>
__device__ __forceinline__ void run_ds(uint8_t* sm, const CUtensorMap* tm_b,
                                       const CUtensorMap* tm_x,
                                       const CUtensorMap* tm_dy,
                                       const ArgsDS& a) {
  using S = LayoutDS<L, N>;
  constexpr int NY = L / 64;
  constexpr bool HAS = WG < NY;       // warpgroup c owns rows 64c..64c+63
  constexpr int NJ = 64 * (WG + 1);   // the columns j <= i its rows keep
  constexpr int E = L / 32;
  const int tid = threadIdx.x, w = (tid / 32) % 4, lane = tid % 32;
  const int t = lane % 4, gq = lane / 4;
  const int k = blockIdx.x, g = blockIdx.y, z = blockIdx.z;
  const int h0 = g * a.group + z * a.hpb;
  const int h1 = min(h0 + a.hpb, (g + 1) * a.group);
  const int halves = a.P / PH;
  const long long gk = (long long)g * a.K + k;
  const uint32_t base = smem_u32(sm);
  const uint32_t bhi = base, blo = base + S::B_BYTES;
  const uint32_t xh = base, xl = base + S::XB;
  const uint32_t dh = base + 2 * S::XB, dl = base + 3 * S::XB;
  const uint32_t bfull = base + S::BARS, xfull = bfull + 8;
  // this thread's Σ dS registers: register e at acc[128 e]
  float* acc = reinterpret_cast<float*>(sm + S::ACC) +
               (WG == 0 ? 0 : 128 * 32) + tid % 128;
  float* cum = reinterpret_cast<float*>(sm + S::VEC);
  float* dts = cum + L;
  float* rowT = dts + L;
  float* colP = rowT + L;             // [8][L]

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
  }
  // C's rows i0, i0 + 8 as the A operand of S (natural order over n)
  const int i0 = 64 * WG + 16 * w + gq;
  float cf[HAS ? N / 8 : 1][4];
  if constexpr (HAS) {
    const float* c0 = a.c + (gk * L + i0) * N + t;
#pragma unroll
    for (int s = 0; s < N / 8; ++s) {
      cf[s][0] = __ldg(c0 + 8 * s);
      cf[s][1] = __ldg(c0 + 8 * N + 8 * s);
      cf[s][2] = __ldg(c0 + 8 * s + 4);
      cf[s][3] = __ldg(c0 + 8 * N + 8 * s + 4);
    }
  }
  float pla[E], pdt[E];
  const bool scan = WG == 0 && w == 0;
  if (scan) load_terms<E>(a.la, a.dt, (long long)h0 * a.K + k, L, lane, pla,
                          pdt);
  mbar_wait(bfull, 0);
  split_in_place(sm, sm + S::B_BYTES, L * N, tid, NT);
  fence_proxy_async();
  sync_block();

  // S = C·Bᵀ over this warpgroup's rows and the columns j < NJ
  float s0[HAS ? NJ / 2 : 1];
  if constexpr (HAS) {
#pragma unroll
    for (int e = 0; e < NJ / 2; ++e) s0[e] = 0.0f;
    steps_rs<NJ, 0, N / 8>(s0, bhi, blo, L, [&](int s, uint32_t* hi,
                                                uint32_t* lo) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split(cf[s][e], hi[e], lo[e]);
    });
  }
  sync_block();   // B is read: X, dy and Σ dS take its place
  if constexpr (HAS) {
#pragma unroll
    for (int e = 0; e < NJ / 2; ++e) acc[128 * e] = 0.0f;
  }
  // one pass per (head, PH columns); the next pass's loads are issued as
  // soon as the buffers are free
  auto issue = [&](int h, int half) {
    mbar_expect_tx(xfull, 2 * S::XB);
    const int row = h * a.K + k;
    for (int b = 0; b < PH / 32; ++b) {
      tma_load(xh + b * L * ROW, tm_x, PH * half + 32 * b, 0, row, xfull);
      tma_load(dh + b * L * ROW, tm_dy, PH * half + 32 * b, 0, row, xfull);
    }
  };
  if (tid == 0) issue(h0, 0);
  int it = 0;
  for (int h = h0; h < h1; ++h) {
    const long long hk = (long long)h * a.K + k;
    if (scan) {
      const float last = warp_cumsum<E>(pla, lane);
      (void)last;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        cum[E * lane + e] = pla[e];
        dts[E * lane + e] = pdt[e];
      }
      if (h + 1 < h1) load_terms<E>(a.la, a.dt, hk + a.K, L, lane, pla, pdt);
    }
    // dM = dy·Xᵀ over the head's columns, PH at a time
    float dm[HAS ? NJ / 2 : 1];
#pragma unroll
    for (int e = 0; e < (HAS ? NJ / 2 : 1); ++e) dm[e] = 0.0f;
    for (int half = 0; half < halves; ++half, ++it) {
      mbar_wait(xfull, it & 1);
      split_in_place(sm, sm + S::XB, L * PH, tid, NT);
      split_in_place(sm + 2 * S::XB, sm + 3 * S::XB, L * PH, tid, NT);
      fence_proxy_async();
      sync_block();
      if constexpr (HAS)
        steps_ss<NJ>(dm, 0, PH / 8, dh + 64 * WG * ROW, dl + 64 * WG * ROW,
                     L, xh, xl, L);
      sync_block();   // X and dy are read
      if (tid == 0 && (half + 1 < halves || h + 1 < h1))
        issue(half + 1 < halves ? h : h + 1,
              half + 1 < halves ? half + 1 : 0);
    }
    // dS = dM ⊙ Δ_j ⊙ G into Σ dS; T = dS ⊙ S: its row sums (quads) and
    // column sums (lanes of a column, then eight warps in order)
    if constexpr (HAS) {
      const float ca = cum[i0], cb = cum[i0 + 8];
      float ra = 0.0f, rb = 0.0f;
#pragma unroll
      for (int q = 0; q < NJ / 8; ++q) {
        const int j = 8 * q + 2 * t;
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        const float2 dj = *reinterpret_cast<const float2*>(dts + j);
        // masked before the exp: j > i gives exp(-1e30) = 0
        const float d0 = dm[4 * q] * dj.x *
                         __expf(j <= i0 ? ca - cj.x : -1e30f);
        const float d1 = dm[4 * q + 1] * dj.y *
                         __expf(j + 1 <= i0 ? ca - cj.y : -1e30f);
        const float d2 = dm[4 * q + 2] * dj.x *
                         __expf(j <= i0 + 8 ? cb - cj.x : -1e30f);
        const float d3 = dm[4 * q + 3] * dj.y *
                         __expf(j + 1 <= i0 + 8 ? cb - cj.y : -1e30f);
        acc[128 * (4 * q)] += d0;
        acc[128 * (4 * q + 1)] += d1;
        acc[128 * (4 * q + 2)] += d2;
        acc[128 * (4 * q + 3)] += d3;
        const float t0 = d0 * s0[4 * q], t1 = d1 * s0[4 * q + 1];
        const float t2 = d2 * s0[4 * q + 2], t3 = d3 * s0[4 * q + 3];
        ra += t0 + t1;
        rb += t2 + t3;
        float v0 = t0 + t2, v1 = t1 + t3;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          v0 += __shfl_xor_sync(FULL, v0, o);
          v1 += __shfl_xor_sync(FULL, v1, o);
        }
        if (gq == 0) {
          colP[(4 * WG + w) * L + j] = v0;
          colP[(4 * WG + w) * L + j + 1] = v1;
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        ra += __shfl_xor_sync(FULL, ra, o);
        rb += __shfl_xor_sync(FULL, rb, o);
      }
      if (t == 0) {
        rowT[i0] = ra;
        rowT[i0 + 8] = rb;
      }
    }
    sync_block();
    for (int l = tid; l < L; l += NT) {
      // warps 0-3 hold columns below 64, warps 4-7 every column
      float col = 0.0f;
      for (int v = l < 64 ? 0 : 4; v < 4 * NY; ++v) col += colP[v * L + l];
      a.tcum[hk * L + l] = rowT[l] - col;
    }
  }
  // the slice's Σ dS, rows i0 and i0 + 8, columns j < NJ
  if constexpr (HAS) {
    float* out = a.dsp + ((((long long)z * a.G + g) * a.K + k) * L + i0) * L
                 + 2 * t;
#pragma unroll
    for (int q = 0; q < NJ / 8; ++q) {
      *reinterpret_cast<float2*>(out + 8 * q) =
          make_float2(acc[128 * (4 * q)], acc[128 * (4 * q + 1)]);
      *reinterpret_cast<float2*>(out + 8 * L + 8 * q) =
          make_float2(acc[128 * (4 * q + 2)], acc[128 * (4 * q + 3)]);
    }
  }
}

// one block per (chunk, B/C row, slice of hpb heads of the row)
template <int L, int N>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_ds(const __grid_constant__ CUtensorMap tm_b,
           const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_dy, ArgsDS a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if (threadIdx.x < 128)
    run_ds<L, N, 0>(sm, &tm_b, &tm_x, &tm_dy, a);
  else
    run_ds<L, N, 1>(sm, &tm_b, &tm_x, &tm_dy, a);
}

// ---------------------------------------------------------------------
// `ssd_bwd_dx`: Sᵀ = B·Cᵀ once, then per head Z = e ⊙ (B·dstate) + Mᵀ·dy,
// dX = Δ ⊙ Z, dΔ = Σ_p X ⊙ Z, dw, dla
// ---------------------------------------------------------------------

struct ArgsDX {
  const float* x;
  const float* dt;
  const float* la;
  const float* ddec;
  const float* dtot;
  const float* tcum;
  float* dx;
  float* ddt;
  float* dla;
  int K, group, hpb, P;
};

// shared memory: B hi and lo [N/32][L][32] for the block; then, while Sᵀ
// is formed, C hi and lo 64 columns at a time [2][L][32], and per pass
// of PC columns dstateᵀ hi and lo [N/32][PC][32] and dyᵀ hi and lo
// [L/32][PC][32] (K positions permuted), where a head's dw and Σ X ⊙ Z
// [L] also go once its passes are done; the staging buffer of a pass's
// dstate [N][PC] and dy [L][PC] as TMA loads them (one pass ahead); cum,
// Δ, e [L]; three mbarriers.  At L = N = 128: 231,960 bytes.
template <int L, int N>
struct LayoutDX {
  static constexpr int B_BYTES = L * N * 4;
  static constexpr int R = 2 * B_BYTES;
  static constexpr int CH = L * 64 * 4;
  static constexpr int DT = PC * N * 4, YT = PC * L * 4;
  static constexpr int R_BYTES = 2 * CH > 2 * (DT + YT) ? 2 * CH
                                                        : 2 * (DT + YT);
  static constexpr int STG = R + R_BYTES;
  static constexpr int VEC = STG + DT + YT;
  static constexpr int BARS = VEC + 3 * L * 4;
  static constexpr int SMEM = 1024 + BARS + 24;
};

template <int L, int N, int WG>
__device__ __forceinline__ void run_dx(uint8_t* sm, const CUtensorMap* tm_b,
                                       const CUtensorMap* tm_c,
                                       const CUtensorMap* tm_d,
                                       const CUtensorMap* tm_y,
                                       const ArgsDX& a) {
  using S = LayoutDX<L, N>;
  constexpr int NY = L / 64;
  constexpr bool HAS = WG < NY;       // warpgroup c owns rows j 64c..
  constexpr int NI = L - 64 * WG;     // the columns i >= 64c its rows keep
  constexpr int E = L / 32;
  const int tid = threadIdx.x, w = (tid / 32) % 4, lane = tid % 32;
  const int t = lane % 4, gq = lane / 4;
  const int k = blockIdx.x, g = blockIdx.y;
  const int h0 = g * a.group + blockIdx.z * a.hpb;
  const int h1 = min(h0 + a.hpb, (g + 1) * a.group);
  const int P = a.P;
  const long long gk = (long long)g * a.K + k;
  const uint32_t base = smem_u32(sm);
  const uint32_t bhi = base, blo = base + S::B_BYTES;
  const uint32_t chi = base + S::R, clo = chi + S::CH;
  const uint32_t dth = base + S::R, dtl = dth + S::DT;
  const uint32_t yth = dtl + S::DT, ytl = yth + S::YT;
  const uint32_t stg = base + S::STG;
  const uint32_t bfull = base + S::BARS, cfull = bfull + 8, sfull = cfull + 8;
  uint8_t* rp = sm + S::R;
  const float* sd = reinterpret_cast<const float*>(sm + S::STG);   // [N][PC]
  const float* sy = sd + N * PC;                                  // [L][PC]
  float* cum = reinterpret_cast<float*>(sm + S::VEC);
  float* dts = cum + L;
  float* ev = dts + L;        // e = exp(cum_L-1 - cum)
  float* dwv = reinterpret_cast<float*>(rp);   // dw = Σ_p X ⊙ (B·dstate)
  float* ddv = dwv + L;                        // Σ_p X ⊙ Z

  if (tid == 0) {
    mbar_init(bfull, 1);
    mbar_init(cfull, 1);
    mbar_init(sfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sync_block();
  // a pass: dstate's and dy's columns p0.. of head h
  auto issue = [&](int h, int p0) {
    mbar_expect_tx(sfull, S::DT + S::YT);
    const int row = h * a.K + k;
    tma_load(stg, tm_d, p0, 0, row, sfull);
    tma_load(stg + S::DT, tm_y, p0, 0, row, sfull);
  };
  if (tid == 0) {
    issue(h0, 0);
    mbar_expect_tx(bfull, S::B_BYTES);
    for (int nb = 0; nb < N / 32; ++nb)
      tma_load(bhi + nb * L * ROW, tm_b, nb * 32, 0, (int)gk, bfull);
    mbar_expect_tx(cfull, S::CH);
    for (int nb = 0; nb < 2; ++nb)
      tma_load(chi + nb * L * ROW, tm_c, nb * 32, 0, (int)gk, cfull);
  }
  float pla[E], pdt[E];
  const bool scan = WG == 0 && w == 0;
  if (scan) load_terms<E>(a.la, a.dt, (long long)h0 * a.K + k, L, lane, pla,
                          pdt);
  mbar_wait(bfull, 0);
  split_in_place(sm, sm + S::B_BYTES, L * N, tid, NT);

  // Sᵀ = B·Cᵀ over this warpgroup's rows j and the columns i >= 64·WG, C
  // 64 of its columns (n) at a time
  const int j0 = 64 * WG + 16 * w + gq;
  float st[HAS ? NI / 2 : 1];
#pragma unroll
  for (int e = 0; e < (HAS ? NI / 2 : 1); ++e) st[e] = 0.0f;
  for (int hc = 0; hc < N / 64; ++hc) {
    mbar_wait(cfull, hc & 1);
    split_in_place(rp, rp + S::CH, L * 64, tid, NT);
    fence_proxy_async();
    sync_block();
    if constexpr (HAS)
      steps_ss<NI>(st, 0, 8, bhi + 2 * hc * L * ROW + 64 * WG * ROW,
                   blo + 2 * hc * L * ROW + 64 * WG * ROW, L,
                   chi + 64 * WG * ROW, clo + 64 * WG * ROW, L);
    sync_block();   // C's columns are read
    if (tid == 0 && hc + 1 < N / 64) {
      mbar_expect_tx(cfull, S::CH);
      for (int nb = 0; nb < 2; ++nb)
        tma_load(chi + nb * L * ROW, tm_c, 64 * (hc + 1) + nb * 32, 0,
                 (int)gk, cfull);
    }
  }

  float wl[E], cl[E];         // the scan warp's w and cum, for dla
  int it = 0;
  for (int h = h0; h < h1; ++h) {
    const long long hk = (long long)h * a.K + k;
    if (scan) {
      const float last = warp_cumsum<E>(pla, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int l = E * lane + e;
        const float ee = expf(last - pla[e]);
        cum[l] = pla[e];
        dts[l] = pdt[e];
        ev[l] = ee;
        cl[e] = pla[e];
        wl[e] = ee * pdt[e];
      }
      if (h + 1 < h1) load_terms<E>(a.la, a.dt, hk + a.K, L, lane, pla, pdt);
    }
    float dwa = 0.0f, dwb = 0.0f, dda = 0.0f, ddb = 0.0f;
    for (int p0 = 0; p0 < P; p0 += PC, ++it) {
      // dstateᵀ [p][n] and dyᵀ [p][i] (i in the permuted order) from the
      // staged pass, split; consecutive threads read consecutive p
      mbar_wait(sfull, it & 1);
      for (int q = tid; q < PC * N / 4; q += NT) {
        const int r = q % PC, c = q / PC;
        const float* src = sd + 4 * c * PC + r;
        uint4 hi, lo;
        split(src[0], hi.x, lo.x);
        split(src[PC], hi.y, lo.y);
        split(src[2 * PC], hi.z, lo.z);
        split(src[3 * PC], hi.w, lo.w);
        const int off = kop_off(r, c, PC);
        *reinterpret_cast<uint4*>(rp + off) = hi;
        *reinterpret_cast<uint4*>(rp + S::DT + off) = lo;
      }
      for (int q = tid; q < PC * L / 4; q += NT) {
        const int r = q % PC, c = q / PC;
        const float* src = sy + (8 * (c / 2) + c % 2) * PC + r;
        uint4 hi, lo;
        split(src[0], hi.x, lo.x);
        split(src[2 * PC], hi.y, lo.y);
        split(src[4 * PC], hi.z, lo.z);
        split(src[6 * PC], hi.w, lo.w);
        const int off = kop_off(r, c, PC);
        *reinterpret_cast<uint4*>(rp + 2 * S::DT + off) = hi;
        *reinterpret_cast<uint4*>(rp + 2 * S::DT + S::YT + off) = lo;
      }
      fence_proxy_async();
      sync_block();
      if (tid == 0 && (p0 + PC < P || h + 1 < h1))   // the staging is free
        issue(p0 + PC < P ? h : h + 1, p0 + PC < P ? p0 + PC : 0);
      if constexpr (HAS) {
        // V = B·dstate, then dw's terms X ⊙ V, then Z = e ⊙ V + Mᵀ·dy
        const float* xa = a.x + (hk * L + j0) * P + p0 + 2 * t;
        float2 xv[PC / 8][2];
#pragma unroll
        for (int q = 0; q < PC / 8; ++q) {
          xv[q][0] = __ldg(reinterpret_cast<const float2*>(xa + 8 * q));
          xv[q][1] =
              __ldg(reinterpret_cast<const float2*>(xa + 8 * P + 8 * q));
        }
        float z[PC / 2];
#pragma unroll
        for (int e = 0; e < PC / 2; ++e) z[e] = 0.0f;
        steps_ss<PC>(z, 0, N / 8, bhi + 64 * WG * ROW, blo + 64 * WG * ROW,
                     L, dth, dtl, PC);
        const float ea = ev[j0], eb = ev[j0 + 8];
#pragma unroll
        for (int q = 0; q < PC / 8; ++q) {
          dwa += xv[q][0].x * z[4 * q] + xv[q][0].y * z[4 * q + 1];
          dwb += xv[q][1].x * z[4 * q + 2] + xv[q][1].y * z[4 * q + 3];
          z[4 * q] *= ea;
          z[4 * q + 1] *= ea;
          z[4 * q + 2] *= eb;
          z[4 * q + 3] *= eb;
        }
        const float ca = cum[j0], cb = cum[j0 + 8];
        steps_rs<PC, 8 * WG, L / 8>(z, yth, ytl, PC, [&](int s, uint32_t* hi,
                                                        uint32_t* lo) {
          // Mᵀ(j, i) = Sᵀ(j, i)·exp(cum_i - cum_j) for i >= j, masked
          // before the exp; K position t holds i = 8s + 2t, t + 4 holds
          // 2t + 1 (dyᵀ's order)
          const int i = 8 * s + 2 * t, q = s - 8 * WG;
          const float2 ci = *reinterpret_cast<const float2*>(cum + i);
          const float a0 = st[4 * q] * __expf(i >= j0 ? ci.x - ca : -1e30f);
          const float a1 =
              st[4 * q + 1] * __expf(i + 1 >= j0 ? ci.y - ca : -1e30f);
          const float b0 =
              st[4 * q + 2] * __expf(i >= j0 + 8 ? ci.x - cb : -1e30f);
          const float b1 =
              st[4 * q + 3] * __expf(i + 1 >= j0 + 8 ? ci.y - cb : -1e30f);
          split(a0, hi[0], lo[0]);
          split(b0, hi[1], lo[1]);
          split(a1, hi[2], lo[2]);
          split(b1, hi[3], lo[3]);
        });
        // dX = Δ ⊙ Z; dΔ's terms X ⊙ Z
        const float da = dts[j0], db = dts[j0 + 8];
        float* out = a.dx + (hk * L + j0) * P + p0 + 2 * t;
#pragma unroll
        for (int q = 0; q < PC / 8; ++q) {
          dda += xv[q][0].x * z[4 * q] + xv[q][0].y * z[4 * q + 1];
          ddb += xv[q][1].x * z[4 * q + 2] + xv[q][1].y * z[4 * q + 3];
          *reinterpret_cast<float2*>(out + 8 * q) =
              make_float2(da * z[4 * q], da * z[4 * q + 1]);
          *reinterpret_cast<float2*>(out + 8 * P + 8 * q) =
              make_float2(db * z[4 * q + 2], db * z[4 * q + 3]);
        }
      }
      sync_block();   // dstateᵀ and dyᵀ are read
    }
    // dw and Σ X ⊙ Z of the head's rows, in the pass buffers (free now)
    if constexpr (HAS) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dwa += __shfl_xor_sync(FULL, dwa, o);
        dwb += __shfl_xor_sync(FULL, dwb, o);
        dda += __shfl_xor_sync(FULL, dda, o);
        ddb += __shfl_xor_sync(FULL, ddb, o);
      }
      if (t == 0) {
        dwv[j0] = dwa;
        dwv[j0 + 8] = dwb;
        ddv[j0] = dda;
        ddv[j0 + 8] = ddb;
      }
    }
    sync_block();
    if (scan) {
      // dΔ = Σ_p X ⊙ Z (dU's term and e ⊙ dw); dcum, then dla its
      // reverse cumsum: E terms on each lane, lanes scanned from the end
      float dc[E];
      float sw = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int l = E * lane + e;
        a.ddt[hk * L + l] = ddv[l];
        const float dww = dwv[l] * wl[e];
        sw += dww;
        dc[e] = __ldg(a.tcum + hk * L + l) +
                __ldg(a.ddec + hk * L + l) * expf(cl[e]) - dww;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) sw += __shfl_xor_sync(FULL, sw, o);
      if (lane == 31)
        dc[E - 1] += sw + __ldg(a.dtot + hk) * expf(cl[E - 1]);
#pragma unroll
      for (int e = E - 2; e >= 0; --e) dc[e] += dc[e + 1];
      float inc = dc[0];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(FULL, inc, o);
        if (lane + o < 32) inc += v;
      }
      float ex = __shfl_down_sync(FULL, inc, 1);
      if (lane == 31) ex = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) a.dla[hk * L + E * lane + e] = dc[e] + ex;
    }
    sync_block();   // dw and Σ X ⊙ Z are read: the next pass takes R
  }
}

template <int L, int N>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_dx(const __grid_constant__ CUtensorMap tm_b,
           const __grid_constant__ CUtensorMap tm_c,
           const __grid_constant__ CUtensorMap tm_d,
           const __grid_constant__ CUtensorMap tm_y, ArgsDX a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if (threadIdx.x < 128)
    run_dx<L, N, 0>(sm, &tm_b, &tm_c, &tm_d, &tm_y, a);
  else
    run_dx<L, N, 1>(sm, &tm_b, &tm_c, &tm_d, &tm_y, a);
}

// ---------------------------------------------------------------------
// `ssd_bwd_db`: per B/C row, the slices' Σ dS summed in order, dC, and dB
// with Σ_h w_h ⊙ R_h as one product over (head, p)
// ---------------------------------------------------------------------

struct ArgsDB {
  const float* b;
  const float* c;
  const float* dt;
  const float* la;
  const float* dsp;
  float* db;
  float* dc;
  int K, G, group, slices, P;
};

// shared memory: Bᵀ, then Cᵀ, hi and lo [L/32][N][32]; then, 64 columns
// of a head at a time, X hi and lo [2][L][32] and dstate hi and lo
// [2][N][32]; the staging buffer of X and dstate as TMA loads them (one
// pass ahead); w [L]; one mbarrier
template <int L, int N>
struct LayoutDB {
  static constexpr int T_BYTES = L * N * 4;
  static constexpr int XB = L * PH * 4, DB = N * PH * 4;
  static constexpr int R = 2 * T_BYTES > 2 * (XB + DB) ? 2 * T_BYTES
                                                       : 2 * (XB + DB);
  static constexpr int STG = R, WV = STG + XB + DB, BARS = WV + L * 4;
  static constexpr int SMEM = 1024 + BARS + 16;
};

// the sum over the slices of Σ dS(i, j), in ascending slice order
__device__ __forceinline__ float ds_sum(const float* p, long long stride,
                                        int slices) {
  float v = __ldg(p);
  for (int z = 1; z < slices; ++z) v += __ldg(p + z * stride);
  return v;
}

template <int L, int N, int WG>
__device__ __forceinline__ void run_db(uint8_t* sm, const CUtensorMap* tm_x,
                                       const CUtensorMap* tm_d,
                                       const ArgsDB& a) {
  using S = LayoutDB<L, N>;
  constexpr int NY = L / 64;
  constexpr bool HAS = WG < NY;
  constexpr int NJ = 64 * (WG + 1);
  constexpr int E = L / 32;
  const int tid = threadIdx.x, w = (tid / 32) % 4, lane = tid % 32;
  const int t = lane % 4, gq = lane / 4;
  const int k = blockIdx.x, g = blockIdx.y;
  const int halves = a.P / PH;
  const long long gk = (long long)g * a.K + k;
  const long long stride = (long long)a.G * a.K * L * L;   // a slice
  const float* ds = a.dsp + gk * L * L;
  const uint32_t base = smem_u32(sm);
  const uint32_t rh = base, rl = base + S::T_BYTES;
  const uint32_t xh = base, xl = base + S::XB;
  const uint32_t dh = base + 2 * S::XB, dl = dh + S::DB;
  const uint32_t stg = base + S::STG;
  const uint32_t dfull = base + S::BARS;
  float* wv = reinterpret_cast<float*>(sm + S::WV);
  const int i0 = 64 * WG + 16 * w + gq;    // rows i (dC) and j (dB)

  if (tid == 0) {
    mbar_init(dfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sync_block();
  const int hb = g * a.group;      // the row's first head
  // a pass: X's and dstate's columns 64·half.. of head h
  auto issue = [&](int h, int half) {
    mbar_expect_tx(dfull, S::XB + S::DB);
    const int row = h * a.K + k;
    for (int b = 0; b < PH / 32; ++b) {
      tma_load(stg + b * L * ROW, tm_x, PH * half + 32 * b, 0, row, dfull);
      tma_load(stg + S::XB + b * N * ROW, tm_d, PH * half + 32 * b, 0, row,
               dfull);
    }
  };
  if (tid == 0) issue(hb, 0);

  // Mᵀ of a row-major [L][N] matrix as a K-major operand of N rows; every
  // load of a thread is issued before the first store
  auto build_t = [&](const float* m) {
    constexpr int NQ = N * L / 4 / NT;
    float v[NQ][4];
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int q = tid + u * NT, r = q % N, c = q / N;
      const float* src = m + (gk * L + 4 * c) * N + r;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[u][e] = __ldg(src + e * N);
    }
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int q = tid + u * NT, r = q % N, c = q / N;
      uint4 hi, lo;
      split(v[u][0], hi.x, lo.x);
      split(v[u][1], hi.y, lo.y);
      split(v[u][2], hi.z, lo.z);
      split(v[u][3], hi.w, lo.w);
      const int off = kop_off(r, c, N);
      *reinterpret_cast<uint4*>(sm + off) = hi;
      *reinterpret_cast<uint4*>(sm + S::T_BYTES + off) = lo;
    }
    fence_proxy_async();
    sync_block();
  };

  // dC = (Σ dS)·B: rows i, the columns j <= i
  build_t(a.b);
  if constexpr (HAS) {
    float acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    const float* r0 = ds + (long long)i0 * L + t;
    steps_rs<N, 0, NJ / 8>(acc, rh, rl, N, [&](int s, uint32_t* hi,
                                               uint32_t* lo) {
      split(ds_sum(r0 + 8 * s, stride, a.slices), hi[0], lo[0]);
      split(ds_sum(r0 + 8 * L + 8 * s, stride, a.slices), hi[1], lo[1]);
      split(ds_sum(r0 + 8 * s + 4, stride, a.slices), hi[2], lo[2]);
      split(ds_sum(r0 + 8 * L + 8 * s + 4, stride, a.slices), hi[3], lo[3]);
    });
    float* out = a.dc + (gk * L + i0) * N + 2 * t;
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      *reinterpret_cast<float2*>(out + 8 * q) =
          make_float2(acc[4 * q], acc[4 * q + 1]);
      *reinterpret_cast<float2*>(out + 8 * N + 8 * q) =
          make_float2(acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
  sync_block();   // Bᵀ is read

  // dB = (Σ dS)ᵀ·C: rows j, the columns i >= 64·WG; then + Σ_h w_h ⊙ R_h
  build_t(a.c);
  float acc[HAS ? N / 2 : 1];
#pragma unroll
  for (int e = 0; e < (HAS ? N / 2 : 1); ++e) acc[e] = 0.0f;
  if constexpr (HAS) {
    const float* c0 = ds + i0 + (long long)t * L;
    steps_rs<N, 8 * WG, L / 8>(acc, rh, rl, N, [&](int s, uint32_t* hi,
                                                   uint32_t* lo) {
      // (Σ dS)ᵀ(j, i) = Σ dS(i, j) at i = 8s + t and + 4
      const float* p = c0 + 8LL * s * L;
      split(ds_sum(p, stride, a.slices), hi[0], lo[0]);
      split(ds_sum(p + 8, stride, a.slices), hi[1], lo[1]);
      split(ds_sum(p + 4 * L, stride, a.slices), hi[2], lo[2]);
      split(ds_sum(p + 4 * L + 8, stride, a.slices), hi[3], lo[3]);
    });
  }
  sync_block();   // Cᵀ is read: X and dstate take its place

  // Σ_h w_h ⊙ (X_h·dstate_hᵀ) over the row's heads in ascending order: a
  // head's R = X·dstateᵀ in an accumulator of its own (both operands from
  // shared memory as TMA loads them: X rows j and dstate rows n are
  // K-major over p), scaled by w on its rows and added to dB's in float32
  // (the tensor core's float32 sums truncate: one accumulator over
  // jamba's 128 heads drifted by 1.1e-4 of dB's max)
  float pla[E], pdt[E];
  const bool scan = WG == 0 && w == 0;
  if (scan) load_terms<E>(a.la, a.dt, (long long)hb * a.K + k, L, lane, pla,
                          pdt);
  int it = 0;
  for (int h = hb; h < hb + a.group; ++h) {
    const long long hk = (long long)h * a.K + k;
    if (scan) {
      const float last = warp_cumsum<E>(pla, lane);
#pragma unroll
      for (int e = 0; e < E; ++e)
        wv[E * lane + e] = expf(last - pla[e]) * pdt[e];
      if (h + 1 < hb + a.group)
        load_terms<E>(a.la, a.dt, hk + a.K, L, lane, pla, pdt);
    }
    float r[HAS ? N / 2 : 1];
#pragma unroll
    for (int e = 0; e < (HAS ? N / 2 : 1); ++e) r[e] = 0.0f;
    for (int half = 0; half < halves; ++half, ++it) {
      mbar_wait(dfull, it & 1);
      split_copy(sm + S::STG, sm, sm + S::XB, L * PH, tid, NT);
      split_copy(sm + S::STG + S::XB, sm + 2 * S::XB,
                 sm + 2 * S::XB + S::DB, N * PH, tid, NT);
      fence_proxy_async();
      sync_block();
      if (tid == 0 && (half + 1 < halves || h + 1 < hb + a.group))
        issue(half + 1 < halves ? h : h + 1,
              half + 1 < halves ? half + 1 : 0);
      if constexpr (HAS)
        steps_ss<N>(r, 0, PH / 8, xh + 64 * WG * ROW, xl + 64 * WG * ROW, L,
                    dh, dl, N);
      sync_block();   // X, dstate and w are read
    }
    if constexpr (HAS) {
      const float wa = wv[i0], wb = wv[i0 + 8];
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        acc[4 * q] += wa * r[4 * q];
        acc[4 * q + 1] += wa * r[4 * q + 1];
        acc[4 * q + 2] += wb * r[4 * q + 2];
        acc[4 * q + 3] += wb * r[4 * q + 3];
      }
    }
  }
  if constexpr (HAS) {
    float* out = a.db + (gk * L + i0) * N + 2 * t;
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      *reinterpret_cast<float2*>(out + 8 * q) =
          make_float2(acc[4 * q], acc[4 * q + 1]);
      *reinterpret_cast<float2*>(out + 8 * N + 8 * q) =
          make_float2(acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
}

template <int L, int N>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_db(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_d, ArgsDB a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if (threadIdx.x < 128)
    run_db<L, N, 0>(sm, &tm_x, &tm_d, a);
  else
    run_db<L, N, 1>(sm, &tm_x, &tm_d, a);
}

template <int L, int N>
constexpr long long smem_ln() {
  const long long a = LayoutDS<L, N>::SMEM, b = LayoutDX<L, N>::SMEM;
  const long long c = LayoutDB<L, N>::SMEM;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// the largest of the three kernels' dynamic shared memory (the same at
// head width 64 and 128)
inline long long smem_bytes(int L, int N) {
  if (L == 128 && N == 128) return smem_ln<128, 128>();
  if (L == 128 && N == 64) return smem_ln<128, 64>();
  if (L == 64 && N == 128) return smem_ln<64, 128>();
  return smem_ln<64, 64>();
}

template <class K>
cudaError_t set_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the three launches for chunks of L and state width N
template <int L, int N>
int launch(const float* x, const float* b, const float* c, const float* dy,
           const float* dst, ArgsDS ads, ArgsDX adx, ArgsDB adb, int M,
           cudaStream_t s) {
  static_assert(LayoutDS<L, N>::SMEM <= 232448, "ssd_bwd_ds");
  static_assert(LayoutDX<L, N>::SMEM <= 232448, "ssd_bwd_dx");
  static_assert(LayoutDB<L, N>::SMEM <= 232448, "ssd_bwd_db");
  const int K = ads.K, P = ads.P, G = ads.G;
  const uint64_t mk = (uint64_t)M * K, gk = (uint64_t)G * K;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const auto flat = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap mb, mc, mx, mdy, md, mdp, mdyp;
  if (!tensor_map_3d(&mb, f32, 4, b, N, L, gk, 32, L, sw) ||
      !tensor_map_3d(&mc, f32, 4, c, N, L, gk, 32, L, sw) ||
      !tensor_map_3d(&mx, f32, 4, x, P, L, mk, 32, L, sw) ||
      !tensor_map_3d(&mdy, f32, 4, dy, P, L, mk, 32, L, sw) ||
      !tensor_map_3d(&md, f32, 4, dst, P, N, mk, 32, N, sw) ||
      !tensor_map_3d(&mdp, f32, 4, dst, P, N, mk, PC, N, flat) ||
      !tensor_map_3d(&mdyp, f32, 4, dy, P, L, mk, PC, L, flat))
    return (int)cudaErrorInvalidValue;
  const int slices = (ads.group + ads.hpb - 1) / ads.hpb;
  const int sa = LayoutDS<L, N>::SMEM, sb = LayoutDX<L, N>::SMEM;
  const int sc = LayoutDB<L, N>::SMEM;
  cudaError_t err = set_smem(ssd_bwd_ds<L, N>, sa);
  if (err == cudaSuccess) err = set_smem(ssd_bwd_dx<L, N>, sb);
  if (err == cudaSuccess) err = set_smem(ssd_bwd_db<L, N>, sc);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_ds<L, N><<<dim3(K, G, slices), NT, sa, s>>>(mb, mx, mdy, ads);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dx<L, N><<<dim3(K, G, slices), NT, sb, s>>>(mb, mc, mdp, mdyp,
                                                       adx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_db<L, N><<<dim3(K, G), NT, sc, s>>>(mx, md, adb);
  return (int)cudaGetLastError();
}

}  // namespace tc

// 1 where the entry point runs the tensor-core kernels for chunks of L,
// state width N and head width P, 0 where it runs the CUDA-core pair
extern "C" int ssd_chunk_bwd_route(int L, int N, int P) {
  return tc::takes(L, N, P) ? 1 : 0;
}

// the largest dynamic shared memory of the kernels the entry point runs,
// in bytes
extern "C" long long ssd_chunk_bwd_smem_bytes(int L, int N, int P) {
  if (tc::takes(L, N, P)) return tc::smem_bytes(L, N);
  const long long a = heads_floats(L, N, P), b = groups_floats(L, N);
  return (a > b ? a : b) * (long long)sizeof(float);
}

// x, dy [M,K,L,P], dt and la [M,K,L], b and c [M/group,K,L,N], dstate
// [M,K,N,P], ddec [M,K,L], dtot [M,K] float32; out dx [M,K,L,P], ddt and
// dla [M,K,L], db and dc [M/group,K,L,N].  Scratch s1 and s2: for the
// CUDA-core pair each head's dS [M,K,L,L] and w ⊙ R [M,K,L,N]; for the
// tensor-core kernels each slice's Σ dS [slices,M/group,K,L,L] (slices =
// ⌈group / hpb⌉) and T's sums [M,K,L].  hpb: the heads of a B/C row that
// one block of `ssd_bwd_ds` and `ssd_bwd_dx` takes (the CUDA-core pair
// ignores it).  Launches on `stream`; returns a cudaError_t (0 on
// success).
extern "C" int ssd_chunk_bwd_launch(
    const float* x, const float* dt, const float* la, const float* b,
    const float* c, const float* dy, const float* dstate, const float* ddec,
    const float* dtot, float* dx, float* ddt, float* dla, float* db,
    float* dc, float* s1, float* s2, int M, int K, int L, int P, int N,
    int group, int hpb, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (L < 1 || L > MAX_L || P < 1 || N < 1 || N > MAX_N || group < 1 ||
      M % group || M > 65535 || K > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc::takes(L, N, P)) {
    const void* ptrs[] = {x, dt, la, b, c, dy, dstate, ddec, dtot,
                          dx, ddt, dla, db, dc, s1, s2};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (hpb < 1 || hpb > group || (long long)M * K > INT_MAX)
      return (int)cudaErrorInvalidValue;
    const int G = M / group;
    const tc::ArgsDS ads{c, dt, la, s2, s1, K, G, group, hpb, P};
    const tc::ArgsDX adx{x, dt, la, ddec, dtot, s2, dx, ddt, dla, K, group,
                         hpb, P};
    const tc::ArgsDB adb{b, c, dt, la, s1, db, dc, K, G, group,
                         (group + hpb - 1) / hpb, P};
    if (L == 128 && N == 128)
      return tc::launch<128, 128>(x, b, c, dy, dstate, ads, adx, adb, M, s);
    if (L == 128 && N == 64)
      return tc::launch<128, 64>(x, b, c, dy, dstate, ads, adx, adb, M, s);
    if (L == 64 && N == 128)
      return tc::launch<64, 128>(x, b, c, dy, dstate, ads, adx, adb, M, s);
    return tc::launch<64, 64>(x, b, c, dy, dstate, ads, adx, adb, M, s);
  }
  if (P > MAX_P) return (int)cudaErrorInvalidValue;
  const long long hb = heads_floats(L, N, P) * (long long)sizeof(float);
  const long long gb = groups_floats(L, N) * (long long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_heads, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hb);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      ssd_bwd_groups, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gb);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_heads<<<dim3(K, M), NT, (size_t)hb, s>>>(
      x, dt, la, b, c, dy, dstate, ddec, dtot, dx, ddt, dla, s1, s2, K, L, P,
      N, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_groups<<<dim3(K, M / group), NT, (size_t)gb, s>>>(
      b, c, s1, s2, db, dc, K, L, N, group);
  return (int)cudaGetLastError();
}
