// ssd_chunk: the intra-chunk part of the Mamba-2 SSD (state-space
// duality) layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_chunk_pallas`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_chunk_kernel`).  Per
// (batch·head m, chunk k), all float32:
//   cum      = cumsum(log a)                                  [L]
//   S        = exp(cum_i - cum_j) ⊙ [j <= i] ⊙ (C Bᵀ)          [L, L]
//   y        = S (Δ ⊙ X)                                      [L, P]
//   state    = ((exp(cum_L - cum) ⊙ Δ) ⊙ B)ᵀ X                 [N, P]
//   in_decay = exp(cum),  total = exp(cum_L)
// The carried-state term and the recurrence over chunks stay outside (in
// PyTorch, as the reference keeps them outside its kernel).
//
// Bound: operations (about L·L·N + L·L·P + L·N·P multiply-adds per
// chunk against 4·L·(P + 2 + 2·N/group) bytes read); it runs on the
// float32 pipes, not the tensor cores, in this first version.
//
// Design: one block of 256 threads per (chunk, batch·head).  The block
// stages X, Δ⊙X, B and C of its chunk in shared memory (B and C read from
// their group, m / group, with no per-head copy; 200 KB at L = N = 128,
// P = 64, so dynamic shared memory past the 48 KB default), scans log a
// in order on one thread, and runs three small products from shared
// memory, each thread holding a 4x4 register micro-tile (rows ty + 16a,
// columns tx + 16b, so a warp's reads are conflict-free).  The scores
// are kept in registers until C is no longer read, then overwrite C's
// buffer; B is scaled in place by exp(cum_L - cum)·Δ for the state.  The
// mask is applied before exp (j > i gives 0), and tiles wholly above the
// diagonal are skipped.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;     // 16 x 16 threads
constexpr int MAX_L = 128;  // the scores of a chunk fit 2 x 2 passes

// acc[a][b] += Σ_k A(i0 + ty + 16a, k) · B(k, j0 + tx + 16b), k < kend;
// A(i, k) = A[i·sai + k·sak], B(k, j) = B[k·sbk + j·sbj].  Rows and
// columns past ni / nj read row or column 0 and are never stored.
__device__ __forceinline__ void mm(const float* A, int sai, int sak,
                                   const float* B, int sbk, int sbj, int i0,
                                   int j0, int ni, int nj, int kend,
                                   float acc[4][4], int ty, int tx) {
  int ia[4], jb[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    ia[a] = (i < ni ? i : 0) * sai;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = j0 + tx + 16 * b;
    jb[b] = (j < nj ? j : 0) * sbj;
  }
#pragma unroll 4
  for (int kk = 0; kk < kend; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[ia[a] + kk * sak];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[kk * sbk + jb[b]];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += av[a] * bv[b];
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
}

__host__ __device__ inline int ld_c(int L, int N) {
  return (N > L ? N : L) + 1;
}

__host__ __device__ inline long long smem_floats(int L, int N, int P) {
  return (long long)L * (N + 1) + (long long)L * ld_c(L, N) +
         2LL * L * (P + 1) + 3LL * L;
}

__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ la, const float* __restrict__ bm,
                 const float* __restrict__ cm_, float* __restrict__ y,
                 float* __restrict__ st, float* __restrict__ dec,
                 float* __restrict__ tot, int K, int L, int P, int N,
                 int group) {
  extern __shared__ float smem[];
  const int ldb = N + 1, ldc = ld_c(L, N), ldx = P + 1;
  float* Bs = smem;                    // [L][N + 1], later w·Δ·B
  float* Cs = Bs + L * ldb;            // [L][ldc], later the scores S
  float* Xs = Cs + L * ldc;            // [L][P + 1]
  float* DXs = Xs + L * ldx;           // [L][P + 1] Δ ⊙ X
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
  __syncthreads();
  for (int e = tid; e < L * P; e += NT) {
    const int l = e / P, p = e % P;
    const float xv = x[cmk * L * P + e];
    Xs[l * ldx + p] = xv;
    DXs[l * ldx + p] = dts[l] * xv;
  }
  for (int e = tid; e < L * N; e += NT) {
    const int l = e / N, n = e % N;
    Bs[l * ldb + n] = bm[cgk * L * N + e];
    Cs[l * ldc + n] = cm_[cgk * L * N + e];
  }
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
        mm(Cs, ldc, 1, Bs, 1, ldb, pi * 64, pj * 64, L, L, N, sc[pi][pj],
           ty, tx);
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
  __syncthreads();

  // y = S (Δ ⊙ X): row i reads columns j <= i only
  for (int i0 = 0; i0 < L; i0 += 64)
    for (int j0 = 0; j0 < P; j0 += 64) {
      float acc[4][4];
      zero(acc);
      const int kend = min(L, i0 + 64);
      mm(Cs, ldc, 1, DXs, ldx, 1, i0, j0, L, P, kend, acc, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + ty + 16 * a, p = j0 + tx + 16 * b;
          if (i < L && p < P) y[cmk * L * P + (long long)i * P + p] =
              acc[a][b];
        }
    }
  // state = (w·Δ·B)ᵀ X
  for (int i0 = 0; i0 < N; i0 += 64)
    for (int j0 = 0; j0 < P; j0 += 64) {
      float acc[4][4];
      zero(acc);
      mm(Bs, 1, ldb, Xs, ldx, 1, i0, j0, N, P, L, acc, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = i0 + ty + 16 * a, p = j0 + tx + 16 * b;
          if (n < N && p < P) st[cmk * N * P + (long long)n * P + p] =
              acc[a][b];
        }
    }
}

}  // namespace

extern "C" long long ssd_chunk_smem_bytes(int L, int N, int P) {
  return smem_floats(L, N, P) * (long long)sizeof(float);
}

// x [M,K,L,P], dt and la [M,K,L], b and c [M/group,K,L,N] float32; out y
// [M,K,L,P], state [M,K,N,P], in_decay [M,K,L], total [M,K].  Returns a
// cudaError_t (0 on success).
extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* la, const float* b,
                                const float* c, float* y, float* st,
                                float* dec, float* tot, int M, int K, int L,
                                int P, int N, int group, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (L < 1 || L > MAX_L || P < 1 || N < 1 || group < 1 || M % group ||
      M > 65535)
    return (int)cudaErrorInvalidValue;
  const long long bytes = ssd_chunk_smem_bytes(L, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, M);
  ssd_chunk_kernel<<<grid, NT, (size_t)bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      x, dt, la, b, c, y, st, dec, tot, K, L, P, N, group);
  return (int)cudaGetLastError();
}
