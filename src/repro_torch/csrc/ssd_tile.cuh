// The float32 register-tiled product shared by the CUDA-core SSD kernels
// (`ssd_chunk_kernel` in `ssd_chunk.cu`, both kernels of
// `ssd_chunk_bwd.cu`): 256 threads as 16 x 16, each holding a 4 x 4
// micro-tile of a 64 x 64 output tile at rows ty + 16a and columns
// tx + 16b, so that a warp's shared-memory reads are conflict-free where
// the strides are odd (the buffers are padded by one float a row).
#pragma once

namespace ssd_tile {

// acc[a][b] += Σ_k A(i0 + ty + 16a, k) · B(k, j0 + tx + 16b) for kbeg <=
// k < kend; A(i, k) = A[i·sai + k·sak], B(k, j) = B[k·sbk + j·sbj].  Rows
// and columns past ni / nj read row or column 0 and are never stored.
__device__ __forceinline__ void mm(const float* A, int sai, int sak,
                                   const float* B, int sbk, int sbj, int i0,
                                   int j0, int ni, int nj, int kbeg,
                                   int kend, float acc[4][4], int ty,
                                   int tx) {
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
  for (int kk = kbeg; kk < kend; ++kk) {
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

}  // namespace ssd_tile
