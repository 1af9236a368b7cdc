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
// Bound: bytes, and far below them the launch.  The kernel reads src, dst
// and the active flag (9 bytes a lane) once and writes one float rate;
// that is well under a microsecond of device memory time at 8,000 lanes
// and about a microsecond at 262,144.  What bounds it in practice is
// latency: each round needs one global water level (a min over every
// occupied port) before any transfer may move, so the rounds are serial.
//
// Design.
//   * Lanes in registers.  A thread holds up to 16 transfers for the whole
//     solve: each one's ports and flags packed in one word (host indices
//     below 2^14) and its rate.  src, dst and active are read once and
//     rate is written once.
//   * Incremental occupancy.  Round 0 counts every live transfer's ports;
//     after that each round subtracts only the transfers that freeze.
//     Integer decrements give exactly the recount's numbers.
//   * One block of 1024 threads up to 16,384 transfers (case1b+net,
//     SockShop's fabric): the port tables (residual capacity, occupancy,
//     saturation flag) sit in shared memory, the rounds are separated by
//     __syncthreads().
//   * Above that, a cooperative grid of one block per 16,384 transfers, all
//     resident (one an SM).  Each block keeps the full port tables in its
//     shared memory and computes the same water level and the same drained
//     capacities from the same numbers; the occupancy is one integer table
//     in device memory that each block adds its slice's count (and, each
//     round, its slice's freezes) into with atomics.  A round reads the
//     table, syncs the grid so that no block subtracts before every block
//     has read, subtracts, and syncs again.
//
// Exactness and determinism:
//   * occupancy counts are integer atomics (warp aggregated with
//     __match_any_sync): exact, order-free, below 2^24, converted to float
//     once;
//   * the water level is a block min-reduction over every occupied port,
//     identical in every block: order-free (NaN propagates, as jnp.min
//     does);
//   * share = rem / max(n, 1) is one IEEE division (no --use_fast_math);
//   * the port drain rem - lam*n is one fused multiply-add, as the
//     reference's compiled program computes it (its jitted link_share and
//     its simulation tick); the file is built with --fmad=false, so
//     nothing else is contracted: the saturation test rem <= 1e-5 * cap
//     rounds its product on its own;
//   * each lane adds the round's water level in round order, as the plain
//     version does.
// Two launches on the same inputs give the same bits.
//
// A batch of B points (the sweep axis of the simulator's tick: B pools of
// the same shape over each point's own port capacities) is one launch:
// one block a point up to 16,384 transfers; above, each point takes G =
// ceil(C / 16,384) blocks, the cooperative grid holds P = min(B, resident
// / G) groups of G, and group g solves points g, g + P, ... in turn (every
// block takes part in every grid barrier, a group past the last point with
// no lanes).  Each point's solve is the unbatched one on its own lanes,
// capacities and occupancy table ([B, 2, H]), so its rates are the bits of
// its unbatched launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ITEMS = 16;
constexpr int HOST_BITS = 14;        // host indices in a packed lane word
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned HOST_MASK = (1u << HOST_BITS) - 1u;
// packed lane word: egress host [0, 14), has_src 14, egress counted 15,
// ingress host [16, 30), ingress counted 30, live 31
constexpr unsigned HAS_SRC = 1u << 14, E_COUNTED = 1u << 15;
constexpr unsigned I_COUNTED = 1u << 30, LIVE = 1u << 31;

// Every pointer is to point 0 of the batch; point(a, b) moves them to b.
struct Args {
  const int32_t* src; const int32_t* dst; const bool* active;
  const float* cap_e; const float* cap_i;
  int n_lanes, n_hosts, iters, n_batch;
  float* rate; int* occupancy;   // [B, 2, H] in device memory (grid only)
};

__device__ __forceinline__ Args point(const Args& a, int b) {
  Args p = a;
  const int64_t C = a.n_lanes, H = a.n_hosts;
  p.src += b * C;
  p.dst += b * C;
  p.active += b * C;
  p.rate += b * C;
  p.cap_e += b * H;
  p.cap_i += b * H;
  p.occupancy += b * 2 * H;
  return p;
}

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

// Add `sign` to n[h] for every lane of the warp that passes `on`; the
// whole warp must call it together.
__device__ __forceinline__ void count_port(int* n, int h, bool on,
                                           int sign) {
  const int key = on ? h : -1;
  const unsigned peers = __match_any_sync(FULL, key);
  if (key >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(n + key, sign * __popc(peers));
  }
}

// Both ports of a lane word, for the lanes with `on` set.
__device__ __forceinline__ void count_lane(int* n_e, int* n_i, unsigned w,
                                           bool on, int sign) {
  count_port(n_e, w & HOST_MASK, on && (w & E_COUNTED), sign);
  count_port(n_i, (w >> 16) & HOST_MASK, on && (w & I_COUNTED), sign);
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

// The block's slice of counts (shared `tally`) into the device table, and
// the slice cleared.  Only in a grid launch.
__device__ __forceinline__ void flush(int* tally, int* occupancy, int H) {
  __syncthreads();
  for (int h = threadIdx.x; h < 2 * H; h += THREADS) {
    if (tally[h] != 0) atomicAdd(occupancy + h, tally[h]);
    tally[h] = 0;
  }
}

// The device table into the block's shared copy `n`.  Only in a grid
// launch.
__device__ __forceinline__ void fetch(int* n, const int* occupancy, int H) {
  for (int h = threadIdx.x; h < 2 * H; h += THREADS) {
    n[h] = __ldcg(occupancy + h);
  }
  __syncthreads();
}

// A grid-wide barrier in a cooperative launch, a block barrier otherwise.
template <bool GRID>
__device__ __forceinline__ void sync_all() {
  if constexpr (GRID) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// One point's water-fill: slice `slice` of its `slices` blocks (its
// transfers [slice, slice + 1) x THREADS x ITEMS), `live` false for a
// block of a group past the last point (no lanes, no writes, every
// barrier).
template <int ITEMS, bool GRID>
__device__ __forceinline__ void solve(const Args& a, int slice, int slices,
                                      bool live, float* tables, float* red) {
  const int H = a.n_hosts;
  const int n_lanes = live ? a.n_lanes : 0;
  float* rem_e = tables;
  float* rem_i = rem_e + H;
  int* n_e = reinterpret_cast<int*>(rem_i + H);   // n_i = n_e + H
  int* n_i = n_e + H;
  int* tally = GRID ? n_i + H : n_e;              // this block's counts
  uint8_t* sat_e = reinterpret_cast<uint8_t*>(n_i + H + (GRID ? 2 * H : 0));
  uint8_t* sat_i = sat_e + H;
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  for (int h = tid; h < H; h += THREADS) {
    rem_e[h] = a.cap_e[h];
    rem_i[h] = a.cap_i[h];
    n_e[h] = 0;
    n_i[h] = 0;
    if (GRID) tally[h] = tally[H + h] = 0;
  }
  if (GRID && live) {
    for (int h = slice * THREADS + tid; h < 2 * H; h += slices * THREADS) {
      a.occupancy[h] = 0;
    }
  }
  sync_all<GRID>();

  // live = active & (dst >= 0); this slice's occupancy of round 0
  unsigned w[ITEMS];
  float rate[ITEMS];
  const int first = slice * THREADS * ITEMS + tid;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int c = first + j * THREADS;
    w[j] = 0u;
    rate[j] = 0.0f;
    if (c < n_lanes) {
      const int s = a.src[c], d = a.dst[c];
      if (s >= 0) w[j] |= HAS_SRC | clamp_host(s, H);
      if (s >= 0 && s < H) w[j] |= E_COUNTED;
      w[j] |= static_cast<unsigned>(clamp_host(d, H)) << 16;
      if (d >= 0 && d < H) w[j] |= I_COUNTED;
      if (a.active[c] && d >= 0) w[j] |= LIVE;
    }
    count_lane(tally, tally + H, w[j], w[j] & LIVE, 1);
  }
  if (GRID) {
    flush(tally, a.occupancy, H);
    sync_all<GRID>();
  }

  for (int r = 0; r < a.iters; ++r) {
    if (GRID) fetch(n_e, a.occupancy, H);
    else __syncthreads();
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

    // drain the ports and mark the saturated ones
    for (int h = tid; h < H; h += THREADS) {
      const int ne = n_e[h], ni = n_i[h];
      const float re = __fmaf_rn(-lam, static_cast<float>(ne), rem_e[h]);
      const float ri = __fmaf_rn(-lam, static_cast<float>(ni), rem_i[h]);
      rem_e[h] = re;
      rem_i[h] = ri;
      sat_e[h] = ne > 0 && re <= __fmul_rn(1e-5f, a.cap_e[h]);
      sat_i[h] = ni > 0 && ri <= __fmul_rn(1e-5f, a.cap_i[h]);
    }
    __syncthreads();

    // raise every live transfer, freeze those on saturated ports and take
    // them off their ports' counts
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      bool frozen = false;
      if (w[j] & LIVE) {
        rate[j] = __fadd_rn(rate[j], lam);
        frozen = ((w[j] & HAS_SRC) && sat_e[w[j] & HOST_MASK])
            || sat_i[(w[j] >> 16) & HOST_MASK];
      }
      if (__any_sync(FULL, frozen)) {
        count_lane(tally, tally + H, w[j], frozen, -1);
      }
      if (frozen) w[j] &= ~LIVE;
    }
    if (GRID) {
      sync_all<GRID>();     // every block has read this round's counts
      flush(tally, a.occupancy, H);
      sync_all<GRID>();
    }
  }

  // conservative final fill: residual fair shares, in place of the
  // residual capacities
  if (GRID) fetch(n_e, a.occupancy, H);
  else __syncthreads();
  for (int h = tid; h < H; h += THREADS) {
    rem_e[h] = __fdiv_rn(rem_e[h], fmaxf(static_cast<float>(n_e[h]), 1.0f));
    rem_i[h] = __fdiv_rn(rem_i[h], fmaxf(static_cast<float>(n_i[h]), 1.0f));
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int c = first + j * THREADS;
    if (c >= n_lanes) continue;
    if (w[j] & LIVE) {
      const float fe = (w[j] & HAS_SRC) ? rem_e[w[j] & HOST_MASK] : inf;
      const float fill = nan_min(fe, rem_i[(w[j] >> 16) & HOST_MASK]);
      rate[j] = __fadd_rn(rate[j], nan_max0(fill));
    }
    a.rate[c] = rate[j];
  }
  __syncthreads();   // the tables are read before the next point's solve
}

// One block a point (a plain launch of B blocks), or in a cooperative grid
// groups of `slices` blocks, each group solving points group, group +
// groups, ... (`rounds` of them, the same count in every block).
template <int ITEMS, bool GRID>
__global__ void __launch_bounds__(THREADS, 1) waterfill_kernel(
    const Args a, int slices, int rounds) {
  extern __shared__ float tables[];
  __shared__ float red[WARPS + 1];
  if constexpr (!GRID) {
    solve<ITEMS, false>(point(a, blockIdx.x), 0, 1, true, tables, red);
  } else {
    const int groups = gridDim.x / slices;
    const int group = blockIdx.x / slices, slice = blockIdx.x % slices;
    for (int k = 0; k < rounds; ++k) {
      const int b = group + k * groups;
      const bool live = b < a.n_batch;
      solve<ITEMS, true>(point(a, live ? b : 0), slice, slices, live,
                         tables, red);
    }
  }
}

int items_for(int n_lanes) {
  return n_lanes <= 4 * THREADS ? 4 : (n_lanes <= 8 * THREADS ? 8 : 16);
}

int blocks_for(int n_lanes) {
  const int per = THREADS * items_for(n_lanes);
  return n_lanes <= 0 ? 1 : (n_lanes + per - 1) / per;
}

int table_bytes(int n_hosts, bool grid) {
  // residual capacities and occupancy (and the block's own counts in a
  // grid launch), 4 bytes each, and two saturation flags, per host
  return n_hosts * ((grid ? 6 : 4) * 4 + 2);
}

// Allow the kernel its dynamic shared memory (once per device and size,
// so that a launch under stream capture makes no other API call).
template <int ITEMS, bool GRID>
cudaError_t prepare(int smem) {
  static int done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || smem <= 48 * 1024 ||
      (dev < 64 && done[dev] >= smem)) return err;
  err = cudaFuncSetAttribute(waterfill_kernel<ITEMS, GRID>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < 64) done[dev] = smem;
  return err;
}

// The grid blocks of the kernel that can all be resident at once.
cudaError_t resident_blocks(int smem, int* n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = prepare<MAX_ITEMS, true>(smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, waterfill_kernel<MAX_ITEMS, true>, THREADS, smem);
  *n = sms * per_sm;
  return err;
}

template <int ITEMS, bool GRID>
cudaError_t launch(Args* a, cudaStream_t s) {
  const int smem = table_bytes(a->n_hosts, GRID);
  cudaError_t err = prepare<ITEMS, GRID>(smem);
  if (err != cudaSuccess) return err;
  if constexpr (!GRID) {
    waterfill_kernel<ITEMS, false><<<a->n_batch, THREADS, smem, s>>>(
        *a, 1, 1);
    return cudaGetLastError();
  } else {
    // the residency of a launch at this table size, once per device
    static int known[64][2] = {};
    int dev = 0, resident = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && known[dev][0] == smem) {
      resident = known[dev][1];
    } else {
      err = resident_blocks(smem, &resident);
      if (err != cudaSuccess) return err;
      if (dev < 64) {
        known[dev][0] = smem;
        known[dev][1] = resident;
      }
    }
    int slices = blocks_for(a->n_lanes);
    if (slices > resident) return cudaErrorCooperativeLaunchTooLarge;
    const int groups = a->n_batch < resident / slices ? a->n_batch
                                                      : resident / slices;
    int rounds = (a->n_batch + groups - 1) / groups;
    void* args[] = {a, &slices, &rounds};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(waterfill_kernel<ITEMS, true>),
        dim3(groups * slices), dim3(THREADS), args,
        static_cast<size_t>(smem), s);
  }
}

}  // namespace

// Shared memory the port tables of a launch over n_lanes transfers and
// n_hosts hosts take.
extern "C" int link_share_table_bytes(int n_hosts, int n_lanes) {
  return table_bytes(n_hosts, blocks_for(n_lanes) > 1);
}

// The most transfers one launch takes on the current device at n_hosts
// hosts: 16 a thread in blocks that are all resident at once.
extern "C" long long link_share_max_lanes(int n_hosts) {
  int resident = 0;
  if (resident_blocks(table_bytes(n_hosts, true), &resident)
      != cudaSuccess) return -1;
  return static_cast<long long>(resident) * THREADS * MAX_ITEMS;
}

// One launch over n_batch points of n_lanes transfers and n_hosts hosts
// each: every array holds the points one after another (src, dst, active
// and rate [B, n_lanes], cap_e and cap_i [B, n_hosts], the occupancy
// scratch [B, 2, n_hosts]).
extern "C" int link_share_launch(const int32_t* src, const int32_t* dst,
                                 const bool* active, const float* cap_e,
                                 const float* cap_i, int n_lanes,
                                 int n_hosts, int n_batch, int iters,
                                 float* rate, int* occupancy,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_hosts < 1 || n_hosts > (1 << HOST_BITS) || n_batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{src, dst, active, cap_e, cap_i, n_lanes, n_hosts, iters, n_batch,
         rate, occupancy};
  switch (items_for(n_lanes)) {
    case 4: return static_cast<int>(launch<4, false>(&a, s));
    case 8: return static_cast<int>(launch<8, false>(&a, s));
    default:
      return static_cast<int>(blocks_for(n_lanes) == 1
                                  ? launch<16, false>(&a, s)
                                  : launch<16, true>(&a, s));
  }
}
