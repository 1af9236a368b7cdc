// Device code shared by the SSD kernels of `ssd_chunk.cu` and
// `ssd_chunk_bwd.cu`: the float32 register-tiled product of the CUDA-core
// kernels (`ssd_chunk_kernel`, `ssd_bwd_heads`, `ssd_bwd_groups`): 256
// threads as 16 x 16, each holding a 4 x 4 micro-tile of a 64 x 64 output
// tile at rows ty + 16a and columns tx + 16b, so that a warp's
// shared-memory reads are conflict-free where the strides are odd (the
// buffers are padded by one float a row); and the tensor-core kernels'
// cumsum of a head's log a on one warp.
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

// the E log a and Δ terms of lane `lane` of chunk hk (L terms) of a head
template <int E>
__device__ __forceinline__ void load_terms(const float* la, const float* dt,
                                           long long hk, int L, int lane,
                                           float* pla, float* pdt) {
  const long long at = hk * L + E * lane;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    pla[e] = __ldg(la + at + e);
    pdt[e] = __ldg(dt + at + e);
  }
}

// cum = cumsum(log a) of one head's chunk on one warp: c holds this lane's
// E terms (l = E·lane + e) and gets their inclusive cumsum (E terms in
// order on each lane, then a scan of the lane sums); returns cum at L-1
template <int E>
__device__ __forceinline__ float warp_cumsum(float* c, int lane) {
  constexpr unsigned full = 0xffffffffu;
#pragma unroll
  for (int e = 1; e < E; ++e) c[e] += c[e - 1];
  float inc = c[E - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(full, inc, o);
    if (lane >= o) inc += v;
  }
  float ex = __shfl_up_sync(full, inc, 1);
  if (lane == 0) ex = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) c[e] += ex;
  return __shfl_sync(full, c[E - 1], 31);
}

}  // namespace ssd_tile
