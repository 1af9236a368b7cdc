// Tropical (max-plus) kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernel `tropical_matmul_pallas`
// (src/repro/kernels/tropical/kernel.py, body `_tropical_kernel`) and the
// squarings around it in `ops.tropical_closure`:
//   C[b, i, j] = max_k X[b, i, k] + A[b, k, j]   (float32).
//
// Bounds.  Operations: 2·M·N·K (one add, one max per term) at the card's
// float32 rate, 67 TFLOP/s, which counts 2 per FMA: 0.2564 ms at
// 8 x 1024^3.  The semiring is (max, +), so the tensor cores cannot help
// and no instruction fuses the two: each term issues an FADD and an FMNMX.
// The issue floor is therefore 2·M·N·K thread-instructions at 132 SMs x
// 128 lanes a clock: 0.51 ms at 8 x 1024^3 and 1.98 GHz, half the stated
// bound, and the most a kernel of this semiring can reach on this card.
// Bytes (12·(MK + KN + MN) per item) bound only the small shapes.
//
// Two designs, one source:
//
// * `product_kernel` (`tropical_matmul_launch`): one block of 256 threads
//   per 128 x 128 output tile of one batch item; each thread holds 8 x 8
//   accumulators (rows ty*4+{0..3} and 64+ty*4+{0..3}, columns likewise
//   by tx), so each k reads its 8 X values and 8 A values with four 16-byte
//   shared loads.  k runs in tiles of 16 through a ring of three stages in
//   dynamic shared memory: X staged in quads of k ([k/4][row][4], so a
//   thread's four consecutive rows at one quad are 64 contiguous bytes and
//   a 16-byte copy from global lands whole), A row-major.  Full tiles are
//   filled with 16-byte `cp.async` copies whose completion arrives on the
//   stage's mbarrier (`cp.async.mbarrier.arrive.noinc`); the tile of k+2
//   is in flight while k computes.  Batch items ride on grid.z, in chunks
//   of 65,535.
// * `closure_kernel` (`tropical_closure_launch`), for S <= 128 (Alg 2's
//   service graphs): one block per batch item holds the whole S x S matrix
//   and a second buffer in shared memory, applies max(A, I), squares
//   ceil(log2(max(depth, 2))) times with a barrier between squarings, and
//   writes the last squaring's registers to global memory: one launch for
//   the whole closure.  A thread loads one element (up to 512 threads, so
//   the loads are in flight together) and owns 4 x 4 output tiles.
//
// Edge rule.  (max, +) pads with -inf, the identity of max.  The copy
// engines' out-of-bounds fill (zero, or NaN) is wrong here, so only whole
// tiles (every row, column and k inside, K and N multiples of 4, 16-byte
// aligned operands) take `cp.async`; a tile at an M, N or K edge is loaded
// element by element with -inf outside, as the plain version's padding
// would be.  The closure kernel pads its rows and columns to a multiple
// of 4 with -inf and never writes the padding, so a padded term is
// -inf + -inf = -inf whatever the matrix holds (+inf included).
//
// NaN rule.  The max is one instruction, `max.NaN.f32` (FMNMX with NaN
// propagation, sm_80 and later): a NaN term or accumulator gives NaN, as
// torch.amax does.  Its NaN is the canonical one, so NaN positions match
// the plain version's and payloads may not.
//
// Signed zeros.  Each term is one float32 add and max is exact, so the
// result is the plain version's bit for bit in any order, with one
// exception: a tie between +0 and -0.  Which of the two the plain version
// keeps depends on its order and its code path (std::max keeps the first,
// the vectorised CPU max the second), and `max.NaN.f32` takes +0.  A -0
// term needs a -0 operand (-0 + -0), so inputs without -0 are free of such
// ties; max(A, I) keeps A's -0 on the diagonal, as std::max(a, +0) does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::mbar_arrive;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int BM = 128, BN = 128, BK = 16, STAGES = 3, THREADS = 256;
static_assert(BK % 8 == 0 && BM == 128 && BN == 128 && THREADS == 256,
              "the copy and register maps assume these sizes");
constexpr int CLOSURE_MAX_S = 128;       // two S x S buffers in shared
constexpr int CLOSURE_THREADS = 512;

__device__ __forceinline__ float max_nan(float acc, float v) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(acc), "f"(v));
  return d;
}

// one arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void copy16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

struct Stage {
  float x[BK / 4][BM][4];   // X tile: k in quads, a row's quad contiguous
  float a[BK][BN];          // A tile, row-major
};

struct ProductSmem {
  Stage st[STAGES];
  unsigned long long full[STAGES];
};

struct ProductArgs {
  const float* x;
  const float* a;
  float* out;
  int M, K, N;
  int vec;   // K, N multiples of 4 and every operand 16-byte aligned
};

// Stages k tile `kt` of this block into `st`, then arrives on `bar`.
// Thread t fills the X quads and the A quads c = t + 256·e: X quad c is
// row (c / 8 / (BK / 4)) · 8 + c % 8 at quad c / 8 % (BK / 4), so eight
// neighbouring lanes copy eight rows into eight distinct bank groups and a
// warp reads 8 rows x 4 quads; A quad c is row c / 32 at column 4·(c % 32),
// 512 contiguous bytes a warp.
__device__ __forceinline__ void stage_tile(const ProductArgs& p,
                                           const float* xb, const float* ab,
                                           int i0, int j0, int kt, Stage& st,
                                           uint32_t bar) {
  const int k0 = kt * BK;
  const bool whole = p.vec && i0 + BM <= p.M && j0 + BN <= p.N &&
                     k0 + BK <= p.K;
#pragma unroll
  for (int e = 0; e < BK / 8; ++e) {
    const int c = threadIdx.x + e * THREADS;
    const int kq = (c >> 3) % (BK / 4);                   // X quad
    const int i = (c >> 3) / (BK / 4) * 8 + (c & 7);
    const int k = c >> 5, jq = c & 31;                    // A quad
    const long long gi = i0 + i, gk = k0 + 4 * kq;
    const long long ak = k0 + k, aj = j0 + 4 * jq;
    if (whole) {
      copy16(smem_u32(&st.x[kq][i][0]), xb + gi * p.K + gk);
      copy16(smem_u32(&st.a[k][4 * jq]), ab + ak * p.N + aj);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        st.x[kq][i][u] = (gi < p.M && gk + u < p.K)
                             ? xb[gi * p.K + gk + u] : -INFINITY;
        st.a[k][4 * jq + u] = (ak < p.K && aj + u < p.N)
                                  ? ab[ak * p.N + aj + u] : -INFINITY;
      }
    }
  }
  if (whole)
    mbar_arrive_copies(bar);
  else
    mbar_arrive(bar);
}

__global__ void __launch_bounds__(THREADS, 2)
product_kernel(ProductArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ProductSmem& sm = *reinterpret_cast<ProductSmem*>(smem_raw);
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const float* xb = p.x + static_cast<long long>(b) * p.M * p.K;
  const float* ab = p.a + static_cast<long long>(b) * p.K * p.N;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&sm.full[s]),
                                               THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = -INFINITY;

  const int nk = (p.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nk) stage_tile(p, xb, ab, i0, j0, s, sm.st[s],
                           smem_u32(&sm.full[s]));

  for (int t = 0; t < nk; ++t) {
    const int s = t % STAGES;
    mbar_wait(smem_u32(&sm.full[s]), (t / STAGES) & 1);
    // every thread is past tile t - 1, so its stage may be refilled
    __syncthreads();
    const int nt = t + STAGES - 1;
    if (nt < nk) {
      const int ns = nt % STAGES;
      stage_tile(p, xb, ab, i0, j0, nt, sm.st[ns], smem_u32(&sm.full[ns]));
    }
    const Stage& st = sm.st[s];
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 xv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        xv[r] = *reinterpret_cast<const float4*>(&st.x[kq][ty * 4 + r][0]);
        xv[4 + r] = *reinterpret_cast<const float4*>(
            &st.x[kq][64 + ty * 4 + r][0]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            &st.a[kq * 4 + u][tx * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(
            &st.a[kq * 4 + u][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float xr = u == 0 ? xv[r].x : u == 1 ? xv[r].y
                         : u == 2 ? xv[r].z : xv[r].w;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = max_nan(acc[r][c], __fadd_rn(xr, av[c]));
        }
      }
    }
  }

  float* ob = p.out + static_cast<long long>(b) * p.M * p.N;
  const bool whole = p.vec && i0 + BM <= p.M && j0 + BN <= p.N;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long gi = i0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = j0 + h * 64 + tx * 4;
      float* row = ob + gi * p.N;
      if (whole) {
        *reinterpret_cast<float4*>(row + gj) = make_float4(
            acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
            acc[r][4 * h + 3]);
      } else if (gi < p.M) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gj + c < p.N) row[gj + c] = acc[r][4 * h + c];
      }
    }
  }
}

// Row stride of the closure kernel's buffers: S padded to a multiple of 4
// (16-byte rows), plus 4 so that rows 4 apart start in other banks.
__host__ __device__ __forceinline__ int closure_pad(int S) {
  return (S + 3) & ~3;
}

__host__ __device__ __forceinline__ int closure_ld(int S) {
  return closure_pad(S) + 4;
}

__host__ __device__ __forceinline__ size_t closure_smem(int S) {
  return 2u * closure_pad(S) * closure_ld(S) * sizeof(float);
}

__global__ void __launch_bounds__(CLOSURE_THREADS)
closure_kernel(const float* __restrict__ a, float* __restrict__ out, int S,
               int n_sq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sp = closure_pad(S), ld = closure_ld(S);
  float* buf0 = reinterpret_cast<float*>(smem_raw);
  float* buf1 = buf0 + Sp * ld;
  const long long base = static_cast<long long>(blockIdx.x) * S * S;
  const float* ab = a + base;
  float* ob = out + base;

  // max(A, I) into buffer 0; -inf in both buffers' padding
#pragma unroll 4
  for (int e = threadIdx.x; e < Sp * Sp; e += blockDim.x) {
    const int i = e / Sp, j = e - i * Sp;
    const bool in = i < S && j < S;
    float v = -INFINITY;
    if (in) {
      v = ab[i * S + j];
      if (i == j) v = v < 0.f ? 0.f : v;   // std::max(v, +0): NaN, -0 kept
    }
    buf0[i * ld + j] = v;
    if (!in) buf1[i * ld + j] = -INFINITY;
  }

  const int nt = Sp / 4, tiles = nt * nt;
  for (int q = 0; q < n_sq; ++q) {
    // the previous squaring is whole before anyone reads it
    __syncthreads();
    const float* src = (q & 1) ? buf1 : buf0;
    float* dst = (q & 1) ? buf0 : buf1;
    const bool last = q == n_sq - 1;
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
      const int i0 = (t / nt) * 4, j0 = (t % nt) * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = -INFINITY;
      for (int k = 0; k < Sp; k += 4) {
        float4 xr[4], ar[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xr[r] = *reinterpret_cast<const float4*>(&src[(i0 + r) * ld + k]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ar[u] = *reinterpret_cast<const float4*>(&src[(k + u) * ld + j0]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float av[4] = {ar[u].x, ar[u].y, ar[u].z, ar[u].w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x = u == 0 ? xr[r].x : u == 1 ? xr[r].y
                          : u == 2 ? xr[r].z : xr[r].w;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = max_nan(acc[r][c], __fadd_rn(x, av[c]));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + r >= S) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (j0 + c >= S) continue;
          if (last)
            ob[(i0 + r) * S + j0 + c] = acc[r][c];
          else
            dst[(i0 + r) * ld + j0 + c] = acc[r][c];
        }
      }
    }
  }
}

// Allows both kernels their dynamic shared memory, once per device (so
// that a launch under stream capture makes no other API call).
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(product_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(ProductSmem)));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      closure_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(closure_smem(CLOSURE_MAX_S)));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// Sets both kernels' shared-memory limits on the current device; the
// wrapper calls it when it loads the library, before any launch.
extern "C" int tropical_prepare() { return static_cast<int>(prepare()); }

// The largest S the closure kernel takes.
extern "C" int tropical_closure_max_s() { return CLOSURE_MAX_S; }

extern "C" int tropical_matmul_launch(const float* x, const float* a,
                                      float* out, int B, int M, int K, int N,
                                      void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return 0;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // the batch rides on grid.z, which holds at most 65535 blocks: larger
  // batches go in chunks of that many items, one launch each
  constexpr int kMaxZ = 65535;
  for (int b0 = 0; b0 < B; b0 += kMaxZ) {
    const int nb = B - b0 < kMaxZ ? B - b0 : kMaxZ;
    ProductArgs p{x + static_cast<long long>(b0) * M * K,
                  a + static_cast<long long>(b0) * K * N,
                  out + static_cast<long long>(b0) * M * N, M, K, N,
                  aligned && K % 4 == 0 && N % 4 == 0};
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nb);
    product_kernel<<<grid, THREADS, sizeof(ProductSmem),
                     static_cast<cudaStream_t>(stream)>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// (I ⊕ A)^(2^n_sq) for B items of S x S, S <= tropical_closure_max_s().
extern "C" int tropical_closure_launch(const float* a, float* out, int B,
                                       int S, int n_sq, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (S > CLOSURE_MAX_S || n_sq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a thread per element of the padded matrix (up to 512), so that its
  // loads are in flight together; each of the (S_pad / 4)^2 output tiles
  // of 4 x 4 goes to one thread (several a thread above 512 tiles)
  const int elems = closure_pad(S) * closure_pad(S);
  const int threads = elems >= CLOSURE_THREADS ? CLOSURE_THREADS
                                               : (elems + 31) / 32 * 32;
  closure_kernel<<<B, threads, closure_smem(S),
                   static_cast<cudaStream_t>(stream)>>>(a, out, S, n_sq);
  return static_cast<int>(cudaGetLastError());
}
