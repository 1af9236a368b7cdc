// tropical_matmul: batched max-plus product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `tropical_matmul_pallas`
// (src/repro/kernels/tropical/kernel.py, body `_tropical_kernel`):
//   C[b, i, j] = max_k X[b, i, k] + A[b, k, j]   (float32).
//
// Bound: operations at fleet sizes (2·M·N·K add/compare over 12·(MK+KN+MN)
// bytes), bytes at small ones.  The semiring is (max, +), so the tensor
// cores cannot help (they only multiply-add); the work runs on the FP32
// pipes.
//
// Design: a classic shared-memory tiled product.  Each block owns a 64x64
// output tile of one batch item; 256 threads each hold a 4x4 register
// micro-tile.  The k dimension is swept in tiles of 16: the block stages a
// 64x16 slice of X and a 16x64 slice of A in shared memory, and every
// thread folds its 4x4 outputs over the 16 staged k.  The ragged edges
// load -inf (the identity of max), which is the reference's padding done
// in the kernel's edge masks instead of in memory.  Each term is one
// float32 add and max is exact, so the result equals the plain version
// bit for bit in any order.  The max is a comparison that lets NaN win
// (`v > acc || v != v`), so NaN propagates as torch.amax does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64, TN = 64, TK = 16;
constexpr int RM = 4, RN = 4;  // register micro-tile per thread

__device__ __forceinline__ float nan_max(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__global__ void __launch_bounds__(256)
tropical_kernel(const float* __restrict__ x, const float* __restrict__ a,
                float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[TK][TM + 1];   // X tile, k-major
  __shared__ float as[TK][TN];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  const float* xb = x + static_cast<long long>(b) * M * K;
  const float* ab = a + static_cast<long long>(b) * K * N;
  const int tid = threadIdx.x;
  const int ty = tid / (TN / RN), tx = tid % (TN / RN);
  const float ninf = -INFINITY;

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = ninf;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // stage X[i0:i0+64, k0:k0+16] (1024 values, 4 per thread)
    for (int e = tid; e < TM * TK; e += blockDim.x) {
      const int ii = e / TK, kk = e % TK;
      const int gi = i0 + ii, gk = k0 + kk;
      xs[kk][ii] = (gi < M && gk < K)
                       ? xb[static_cast<long long>(gi) * K + gk] : ninf;
    }
    // stage A[k0:k0+16, j0:j0+64]
    for (int e = tid; e < TK * TN; e += blockDim.x) {
      const int kk = e / TN, jj = e % TN;
      const int gk = k0 + kk, gj = j0 + jj;
      as[kk][jj] = (gk < K && gj < N)
                       ? ab[static_cast<long long>(gk) * N + gj] : ninf;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float xv[RM], av[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) xv[r] = xs[kk][ty * RM + r];
#pragma unroll
      for (int c = 0; c < RN; ++c) av[c] = as[kk][tx * RN + c];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c)
          acc[r][c] = nan_max(acc[r][c], __fadd_rn(xv[r], av[c]));
    }
    __syncthreads();
  }
  float* ob = out + static_cast<long long>(b) * M * N;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int gi = i0 + ty * RM + r;
    if (gi >= M) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int gj = j0 + tx * RN + c;
      if (gj < N) ob[static_cast<long long>(gi) * N + gj] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int tropical_matmul_launch(const float* x, const float* a,
                                      float* out, int B, int M, int K, int N,
                                      void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return 0;
  // the batch rides on grid.z, which holds at most 65535 blocks: larger
  // batches go in chunks of that many items, one launch each
  constexpr int kMaxZ = 65535;
  for (int b0 = 0; b0 < B; b0 += kMaxZ) {
    const int nb = B - b0 < kMaxZ ? B - b0 : kMaxZ;
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, nb);
    tropical_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        x + static_cast<long long>(b0) * M * K,
        a + static_cast<long long>(b0) * K * N,
        out + static_cast<long long>(b0) * M * N, M, K, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
