// link_share: max-min fair NIC water-filling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `link_share_pallas`
// (src/repro/kernels/link_share/kernel.py:42, body `_link_share_kernel`,
// which runs `ref.waterfill`).  Per in-flight transfer: its share of the
// egress port of its source host (src, -1 = external client: no egress
// constraint) and of the ingress port of its destination host (dst), by
// `iters` rounds of progressive water-filling and one conservative final
// fill; the result is what repro_torch/kernels/link_share/ref.py computes,
// bit for bit.
//
// Bound: bytes, and far below them the launch.  A pass over the transfers
// reads src, dst and the active flag (9 bytes a lane) and the kernel
// writes one float rate; over the `iters + 1` passes that is well under a
// microsecond of device memory time at 8,000 lanes and tens of microseconds
// at 262,144.  What bounds it in practice is latency: each round needs one
// global water level (a min over every occupied port) before any transfer
// may move, so the rounds are serial.
//
// Design.  One block of 1024 threads owns the whole transfer set and the
// per-port tables, so the global min of each round is a block reduction
// and the rounds are separated by __syncthreads() rather than by kernel
// launches.  The block loops over the transfer axis (8 lanes a thread at
// 8192, 256 at 262,144; src/dst stream from L2 and device memory); each
// lane's rate and live flag live in device memory, touched by one thread
// only.  The port tables sit in shared memory: residual capacity (float),
// occupancy (int) and the saturation flag per egress and ingress port,
// 18 bytes a host (14 KB at 781 hosts).  A pass both moves the transfers
// of one round and counts the occupancy of the next.
//
// Exactness and determinism:
//   * occupancy counts are integer atomicAdds in shared memory (warp
//     aggregated with __match_any_sync): exact, order-free, below 2^24,
//     converted to float once;
//   * the water level is a block min-reduction: order-free (NaN
//     propagates, as jnp.min does);
//   * share = rem / max(n, 1) is one IEEE division (no --use_fast_math);
//   * the port drain rem - lam*n is one fused multiply-add, as the
//     reference's compiled program computes it (its jitted link_share and
//     its simulation tick); the file is built with --fmad=false, so
//     nothing else is contracted: the saturation test rem <= 1e-5 * cap
//     rounds its product on its own;
//   * each lane adds the round's water level in round order, as the plain
//     version does.
// Two launches on the same inputs give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return fminf(a, b);
}

__device__ __forceinline__ float nan_max0(float a) {
  return isnan(a) ? a : fmaxf(a, 0.0f);
}

__device__ __forceinline__ int clamp_host(int h, int n_hosts) {
  return h < 0 ? 0 : (h >= n_hosts ? n_hosts - 1 : h);
}

// Add one to n[h] for every lane of the warp that passes a valid h; the
// whole warp must call it together.
__device__ __forceinline__ void count_port(int* n, int h, bool on,
                                           int n_hosts) {
  const int key = (on && h >= 0 && h < n_hosts) ? h : -1;
  const unsigned peers = __match_any_sync(FULL, key);
  if (key >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(n + key, __popc(peers));
  }
}

__device__ float block_min(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(FULL, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
    for (int o = 16; o > 0; o >>= 1) {
      v = nan_min(v, __shfl_xor_sync(FULL, v, o));
    }
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  return red[WARPS];
}

__global__ void __launch_bounds__(THREADS) waterfill_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const bool* __restrict__ active, const float* __restrict__ cap_e,
    const float* __restrict__ cap_i, int n_lanes, int n_hosts, int iters,
    float* __restrict__ rate, uint8_t* __restrict__ live) {
  extern __shared__ float tables[];
  __shared__ float red[WARPS + 1];
  const int H = n_hosts;
  float* rem_e = tables;
  float* rem_i = rem_e + H;
  int* n_e = reinterpret_cast<int*>(rem_i + H);
  int* n_i = n_e + H;
  uint8_t* sat_e = reinterpret_cast<uint8_t*>(n_i + H);
  uint8_t* sat_i = sat_e + H;
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  for (int h = tid; h < H; h += THREADS) {
    rem_e[h] = cap_e[h];
    rem_i[h] = cap_i[h];
    n_e[h] = 0;
    n_i[h] = 0;
  }
  __syncthreads();

  // live = active & (dst >= 0); occupancy of round 0
  for (int base = 0; base < n_lanes; base += THREADS) {
    const int c = base + tid;
    const bool in = c < n_lanes;
    const int s = in ? src[c] : -1;
    const int d = in ? dst[c] : -1;
    const bool on = in && active[c] && d >= 0;
    if (in) {
      rate[c] = 0.0f;
      live[c] = on;
    }
    count_port(n_e, s, on && s >= 0, H);
    count_port(n_i, d, on, H);
  }
  __syncthreads();

  for (int r = 0; r < iters; ++r) {
    // global water level: min over occupied ports of the fair share
    float v = inf;
    for (int h = tid; h < H; h += THREADS) {
      if (n_e[h] > 0) {
        v = nan_min(v, __fdiv_rn(rem_e[h], static_cast<float>(n_e[h])));
      }
      if (n_i[h] > 0) {
        v = nan_min(v, __fdiv_rn(rem_i[h], static_cast<float>(n_i[h])));
      }
    }
    float lam = block_min(v, red);
    lam = isfinite(lam) ? fmaxf(lam, 0.0f) : 0.0f;

    // drain the ports, mark the saturated ones, clear the counts
    for (int h = tid; h < H; h += THREADS) {
      const int ne = n_e[h], ni = n_i[h];
      const float re = __fmaf_rn(-lam, static_cast<float>(ne), rem_e[h]);
      const float ri = __fmaf_rn(-lam, static_cast<float>(ni), rem_i[h]);
      rem_e[h] = re;
      rem_i[h] = ri;
      sat_e[h] = ne > 0 && re <= __fmul_rn(1e-5f, cap_e[h]);
      sat_i[h] = ni > 0 && ri <= __fmul_rn(1e-5f, cap_i[h]);
      n_e[h] = 0;
      n_i[h] = 0;
    }
    __syncthreads();

    // raise every live transfer, freeze those on saturated ports, count
    // the survivors for the next round
    for (int base = 0; base < n_lanes; base += THREADS) {
      const int c = base + tid;
      bool on = c < n_lanes && live[c];
      int s = -1, d = -1;
      if (on) {
        s = src[c];
        d = dst[c];
        rate[c] = __fadd_rn(rate[c], lam);
        const bool frozen = (s >= 0 && sat_e[clamp_host(s, H)])
            || sat_i[clamp_host(d, H)];
        if (frozen) {
          live[c] = 0;
          on = false;
        }
      }
      count_port(n_e, s, on && s >= 0, H);
      count_port(n_i, d, on, H);
    }
    __syncthreads();
  }

  // conservative final fill: residual fair shares, in place of the
  // residual capacities
  for (int h = tid; h < H; h += THREADS) {
    rem_e[h] = __fdiv_rn(rem_e[h], fmaxf(static_cast<float>(n_e[h]), 1.0f));
    rem_i[h] = __fdiv_rn(rem_i[h], fmaxf(static_cast<float>(n_i[h]), 1.0f));
  }
  __syncthreads();
  for (int c = tid; c < n_lanes; c += THREADS) {
    if (!live[c]) continue;
    const int s = src[c];
    const float fe = s >= 0 ? rem_e[clamp_host(s, H)] : inf;
    const float fill = nan_min(fe, rem_i[clamp_host(dst[c], H)]);
    rate[c] = __fadd_rn(rate[c], nan_max0(fill));
  }
}

}  // namespace

extern "C" int link_share_table_bytes(int n_hosts) {
  return n_hosts * (4 * static_cast<int>(sizeof(float)) + 2);
}

extern "C" int link_share_launch(const int32_t* src, const int32_t* dst,
                                 const bool* active, const float* cap_e,
                                 const float* cap_i, int n_lanes,
                                 int n_hosts, int iters, float* rate,
                                 uint8_t* live, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = link_share_table_bytes(n_hosts);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        waterfill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  waterfill_kernel<<<1, THREADS, smem, s>>>(src, dst, active, cap_e, cap_i,
                                            n_lanes, n_hosts, iters, rate,
                                            live);
  return static_cast<int>(cudaGetLastError());
}
