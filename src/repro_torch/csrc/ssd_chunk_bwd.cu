// ssd_chunk_bwd: the backward of the intra-chunk part of the Mamba-2 SSD
// layer (`ssd_chunk.cu`), for Hopper (sm_90a), on the float32 pipes.
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
//
// Bound: bytes.  At mamba2-130m's training shape (B 8, T 4096: M = 192,
// K = 32, L = N = 128, P = 64, G = 8 B/C rows of 24 heads) each input
// read once and each output written once is 4·(M·K·L·(3P + 5) + M·K·N·P
// + M·K + 4·G·K·L·N) bytes, 0.89 GB: 0.265 ms at 3.35 TB/s.  Its least
// work, 2 operations a multiply-add over the causal half of dM and dU and
// the whole of R and dX's state term per head, and the causal half of
// C·Bᵀ, dC and dB once per chunk and B/C row, is 40.4 GFLOP: 0.082 ms at
// the TF32 tensor-core peak, 0.60 ms on the float32 pipes (67 TFLOP/s).
// chip_smoke computes both from the shapes it runs.
//
// Design: two launches, no atomics, so two runs give the same bits.
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
// through device memory (0.70 GB written and read at the training shape:
// dS's lower tiles 0.30, w ⊙ R 0.40; L2 holds little of it): a kernel
// that kept every head of a group in one block would need dS, B, C and
// the head's M, X, dy and dstate at once, 297 KB.  Shapes: L <= 128,
// P <= 64 and N <= 128, where the shared memory of both kernels fits a
// block's 227 KB; the launch refuses the rest.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ssd_tile.cuh"

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

// the larger dynamic shared memory of the two kernels, in bytes
extern "C" long long ssd_chunk_bwd_smem_bytes(int L, int N, int P) {
  const long long a = heads_floats(L, N, P), b = groups_floats(L, N);
  return (a > b ? a : b) * (long long)sizeof(float);
}

// x, dy [M,K,L,P], dt and la [M,K,L], b and c [M/group,K,L,N], dstate
// [M,K,N,P], ddec [M,K,L], dtot [M,K] float32; out dx [M,K,L,P], ddt and
// dla [M,K,L], db and dc [M/group,K,L,N]; scratch ds [M,K,L,L] and wr
// [M,K,L,N].  Two launches on `stream`.  Returns a cudaError_t (0 on
// success).
extern "C" int ssd_chunk_bwd_launch(
    const float* x, const float* dt, const float* la, const float* b,
    const float* c, const float* dy, const float* dstate, const float* ddec,
    const float* dtot, float* dx, float* ddt, float* dla, float* db,
    float* dc, float* ds, float* wr, int M, int K, int L, int P, int N,
    int group, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (L < 1 || L > MAX_L || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      group < 1 ||
      M % group || M > 65535 || K > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hb = heads_floats(L, N, P) * (long long)sizeof(float);
  const long long gb = groups_floats(L, N) * (long long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_heads, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hb);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      ssd_bwd_groups, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gb);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_heads<<<dim3(K, M), NT, (size_t)hb, s>>>(
      x, dt, la, b, c, dy, dstate, ddec, dtot, dx, ddt, dla, ds, wr, K, L, P,
      N, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_groups<<<dim3(K, M / group), NT, (size_t)gb, s>>>(
      b, c, ds, wr, db, dc, K, L, N, group);
  return (int)cudaGetLastError();
}
