// cloudlet_finish: the fused cloudlet execution tick for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cloudlet_finish_pallas`
// (src/repro/kernels/cloudlet_step/kernel.py, body `_cloudlet_kernel`).
// Per pool lane: progress `rem -= rate*dt` on executing lanes, the finish
// flag, the sub-tick finish time clipped to [t, t+dt] and the MI consumed;
// per instance a [I+1, 5] sum (used MI/s, finishes, sojourn, exec and wait
// time); per request max(finish), max(depth+1) and `outstanding -= fin`,
// updated in place in device memory.
//
// Bound: bytes, and far below them the launch.  A lane reads 7 words and
// writes 4 outputs; at the capacity cases that is well under a megabyte
// at case1b and about 12 MB at case2b.  What bounds a launch in practice is
// latency: the instance sums are serial folds.
//
// The instance sums are the reference's bits.  Each inst_acc[i, k] is the
// float32 left fold ((0 + x1) + x2) + ... over instance i's contributing
// lanes in ascending lane order: the order of the reference's serial
// scatter-add on the CPU and of the plain version.  Float addition does not
// associate, so the sums need an order, not atomics.  Design: sort inside
// the tile, then fold across tiles.
//   * A block of 1024 threads owns a tile of T = 1024 x ITEMS lanes.  Up to
//     16,384 lanes (case1b, SockShop) the tiles, 1,024 or 2,048 lanes, form
//     one thread-block cluster of at most 8 blocks, which the hardware
//     schedules together, in a plain launch; above (case2b, 64 tiles of 4,096
//     lanes), a cooperative grid.  Each thread runs the lane math of ITEMS
//     lanes striped over the block (coalesced), writes the per-lane outputs
//     and each contributing lane's five terms to a scratch [C, 8] (32 bytes a
//     lane: two 16-byte loads), and keys the lane by its instance row (non-
//     contributing lanes by I+1, which sorts last).
//   * The block puts the keys in lane order (CUB's block exchange) and stable-
//     sorts its (row, lane) pairs with CUB's block radix sort over the bits
//     the row needs (LSD radix sort is stable, so the lanes of a row stay in
//     lane order), copies the terms into sorted order (a second [C, 8], so
//     that a row's run is contiguous) and writes, per row, the run's [start,
//     end) in the tile to a table [tiles, I+1] of 16-bit pairs, setting the
//     tile's bit in the row's mask [I+1, ceil(tiles / 32)] (cleared at the
//     start, a sync before).  Only the marked entries are read, so the table
//     is never cleared.
//   * After one sync over the tiles (a __syncthreads at one tile, the
//     cluster's or the grid's barrier above), one thread per row walks the set
//     bits of its mask in order and folds its runs serially, all five columns
//     side by side, and writes the row: every row is written, so nothing is
//     zeroed beforehand.  A row of more than 64 lanes goes to a warp of its
//     block instead, which puts 64 lanes' terms at a time in shared memory,
//     column by column, and loads the next 64 while five lanes, one a column,
//     add them in lane order: the fold stays serial, the loads do not wait on
//     it.
// Why this and not count-scan-place: the sort keeps every run in lane
// order with no second pass over a segment, and a long run (most lanes on
// one instance, as SockShop can put hundreds on one) costs one serial
// fold.
//
// The rest is exact and free of order:
//   * req_crit / req_out use integer atomicMax / atomicSub;
//   * req_finish uses a float max through the ordered-int trick (int max
//     for non-negative values, unsigned min for negative ones).
// Out-of-range instance ids past the overflow row and request ids outside
// [0, R) are dropped, as the reference's mode="drop"; a lane that is not
// executing adds nothing (the plain version adds +0.0 to the overflow row,
// which no sum starting from +0.0 can tell apart).  The file is built with
// --fmad=false, so nvcc contracts nothing on its own: the one fused
// multiply-add (`rem - rate*dt`, which the reference's compiled program
// contracts) is written out, everything else rounds each operation as the
// plain version does.  min and max propagate NaN, as torch.minimum and
// torch.maximum do.
//
// A batch of B points (the sweep axis of the simulator's tick: B pools of
// the same shape, each with its own time, dt and request arrays) is one
// launch.  Each point keeps its own lanes, tiles, scratch, table and masks,
// and its instance sums are its own fold in ascending lane order, so every
// point's outputs are the bits of its unbatched launch.  Up to 16,384 lanes
// a point the grid is (tiles, B) and each point's tiles form their own
// cluster (clusterDim (tiles, 1, 1)), with their own barrier; the one-block
// route is (1, B).  The cooperative route's grid is bounded by what is
// resident at once (one 1,024-thread block an SM), so its blocks stride
// over the (point, tile) pairs for the sort, meet at one grid barrier, and
// stride over the (point, row) pairs for the fold: one launch and one
// barrier for any B.
//
// One launch a call, no host sync and no allocation: the wrapper keeps the
// scratch (terms, sorted terms, run table, row masks) per device and shape.
#include <cooperative_groups.h>
#include <cub/block/block_exchange.cuh>
#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL_EXEC = 2;
constexpr int THREADS = 1024;
constexpr int NT = 5;            // terms per lane (8 floats stored)
constexpr int MAX_ITEMS = 8;     // lanes a thread
constexpr int MAX_CLUSTER = 8;   // blocks in a cluster (the portable most)
constexpr int LONG_RUN = 64;     // a row with more lanes is folded by a warp
constexpr int LONG_ROWS = 1024;  // long rows a block lists (more: a thread)
constexpr int WARP_CHUNK = 64;   // lanes a warp loads at a time
constexpr int BUF_STRIDE = WARP_CHUNK + 1;   // a column of the buffer
constexpr unsigned FULL = 0xffffffffu;

// The launch's arguments.  Every pointer is to point 0 of the batch;
// point(a, b) moves them to point b and reads its time and dt.
struct Args {
  const int32_t* ints; int ni, c_status, c_inst, c_req, c_depth;
  const float* flts; int nf, c_rem, c_arrival, c_start;
  const float* rate; const float* time_ptr; const float* dt_ptr;
  int n_lanes, n_batch, tiles;
  float* req_finish; int32_t* req_crit; int32_t* req_out; int n_req;
  float* new_rem; bool* fin; float* tfin; float* consumed;
  float4* terms; float4* sterms; uint32_t* table; uint32_t* mask;
  int mask_words; float* inst_acc; int n_inst; int key_bits;
  float time, dt;   // point b's, set by point()
};

__device__ __forceinline__ Args point(const Args& a, int b) {
  Args p = a;
  const int64_t C = a.n_lanes, R = a.n_req, rows = a.n_inst + 1;
  p.ints += b * C * a.ni;
  p.flts += b * C * a.nf;
  p.rate += b * C;
  p.req_finish += b * R;
  p.req_crit += b * R;
  p.req_out += b * R;
  p.new_rem += b * C;
  p.fin += b * C;
  p.tfin += b * C;
  p.consumed += b * C;
  p.terms += b * C * 2;
  p.sterms += b * C * 2;
  p.table += b * a.tiles * rows;
  p.mask += b * rows * a.mask_words;
  p.inst_acc += b * rows * NT;
  p.time = a.time_ptr[b];
  p.dt = a.dt_ptr[b];
  return p;
}

template <int ITEMS>
using Sorter = cub::BlockRadixSort<unsigned, THREADS, ITEMS, int>;

template <int ITEMS>
using Exchange = cub::BlockExchange<unsigned, THREADS, ITEMS>;

template <int ITEMS>
union Shared {
  typename Exchange<ITEMS>::TempStorage exchange;
  typename Sorter<ITEMS>::TempStorage sort;
  unsigned key[THREADS * ITEMS];
  float fold[THREADS / 32][NT * BUF_STRIDE];   // a warp's long-row buffer
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// The lane math of lane c: writes its per-lane outputs and request updates
// and, for a contributing lane, its five terms; returns its sort key (the
// instance row, or n_inst + 1 for a lane that adds nothing).
__device__ __forceinline__ unsigned lane(const Args& a, int c) {
  const float dt = a.dt, time = a.time;
  const int32_t* row_i = a.ints + static_cast<int64_t>(c) * a.ni;
  const float* row_f = a.flts + static_cast<int64_t>(c) * a.nf;
  const int status = row_i[a.c_status];
  const int inst = row_i[a.c_inst];
  const float rem = row_f[a.c_rem];
  const float r = a.rate[c];

  const bool execm = status == CL_EXEC;
  const float prog = __fmul_rn(r, dt);
  const bool fin = execm && (rem <= prog) && (r > 0.0f);
  float tfin = 0.0f;
  if (fin) {
    const float t = __fadd_rn(time, __fdiv_rn(rem, nan_max(r, 1e-9f)));
    tfin = nan_min(nan_max(t, time), __fadd_rn(time, dt));
  }
  const float consumed = execm ? nan_min(prog, rem) : 0.0f;
  // rem - rate*dt with one rounding: the fused multiply-add of the
  // reference's compiled program
  const float left = __fmaf_rn(-r, dt, rem);
  a.new_rem[c] = execm ? nan_max(left, 0.0f) : rem;
  a.fin[c] = fin;
  a.tfin[c] = tfin;
  a.consumed[c] = consumed;
  if (fin) {
    const int req = row_i[a.c_req];
    if (req >= 0 && req < a.n_req) {
      atomic_max_float(a.req_finish + req, tfin);
      atomicMax(a.req_crit + req, row_i[a.c_depth] + 1);
      atomicSub(a.req_out + req, 1);
    }
  }
  const unsigned none = static_cast<unsigned>(a.n_inst) + 1u;
  const int irow = inst >= 0 ? inst : a.n_inst;
  if (!execm || irow > a.n_inst) return none;
  float4 x = make_float4(__fdiv_rn(consumed, dt), fin ? 1.0f : 0.0f, 0.0f,
                         0.0f);
  float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (fin) {
    const float arrival = row_f[a.c_arrival];
    const float started = nan_max(row_f[a.c_start], arrival);
    x.z = __fsub_rn(tfin, arrival);
    x.w = __fsub_rn(tfin, started);
    y.x = __fsub_rn(started, arrival);
  }
  a.terms[2 * static_cast<int64_t>(c)] = x;
  a.terms[2 * static_cast<int64_t>(c) + 1] = y;
  return static_cast<unsigned>(irow);
}

// How the tiles of a launch meet: one block, a thread-block cluster (at
// most 8 blocks, scheduled together by the hardware), or a cooperative
// grid (every block resident).
enum Mode { BLOCK, CLUSTER, GRID };

// A barrier over every tile of the launch, with the memory ordering that
// makes one tile's writes visible to the others.
template <Mode MODE>
__device__ __forceinline__ void sync_all() {
  if constexpr (MODE == GRID) {
    cg::this_grid().sync();
  } else if constexpr (MODE == CLUSTER) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// f(terms of the run, start, end) for each run of row r, tile by tile in
// ascending order: the tiles are the set bits of the row's mask.
template <int T, typename F>
__device__ __forceinline__ void for_each_run(const Args& a, int r, F f) {
  const int rows = a.n_inst + 1;
  for (int w = 0; w < a.mask_words; ++w) {
    uint32_t m = a.mask[static_cast<int64_t>(r) * a.mask_words + w];
    while (m) {
      const int t = w * 32 + __ffs(m) - 1;
      m &= m - 1;
      const uint32_t run = a.table[static_cast<int64_t>(t) * rows + r];
      f(a.sterms + static_cast<int64_t>(t) * T * 2,
        static_cast<int>(run & 0xffffu), static_cast<int>(run >> 16));
    }
  }
}

// One row's runs folded in lane order by one thread.
template <int T>
__device__ __forceinline__ void fold_row(const Args& a, int r) {
  float acc[NT] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for_each_run<T>(a, r, [&](const float4* s, int start, int end) {
    for (int p = start; p < end; ++p) {
      const float4 x = s[2 * p], y = s[2 * p + 1];
      acc[0] = __fadd_rn(acc[0], x.x);
      acc[1] = __fadd_rn(acc[1], x.y);
      acc[2] = __fadd_rn(acc[2], x.z);
      acc[3] = __fadd_rn(acc[3], x.w);
      acc[4] = __fadd_rn(acc[4], y.x);
    }
  });
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    a.inst_acc[static_cast<int64_t>(r) * NT + k] = acc[k];
  }
}

// The same fold by one warp, for a long row: the warp loads WARP_CHUNK
// lanes' terms at a time, puts them column by column into its shared
// buffer `buf` and, while the next chunk is in flight, lanes 0-4 add one
// column each in lane order.
template <int T>
__device__ __forceinline__ void fold_row_warp(const Args& a, int r,
                                              float* buf) {
  const int lane = threadIdx.x & 31;
  const float* col = buf + lane * BUF_STRIDE;
  float acc = 0.0f;   // column `lane` for lanes 0-4
  for_each_run<T>(a, r, [&](const float4* s, int start, int end) {
    float4 x[2], y[2];
    auto load = [&](int c0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = c0 + h * 32 + lane;
        const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        x[h] = p < end ? s[2 * p] : z;
        y[h] = p < end ? s[2 * p + 1] : z;
      }
    };
    load(start);
    for (int c0 = start; c0 < end; c0 += WARP_CHUNK) {
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h * 32 + lane;
        buf[i] = x[h].x;
        buf[BUF_STRIDE + i] = x[h].y;
        buf[2 * BUF_STRIDE + i] = x[h].z;
        buf[3 * BUF_STRIDE + i] = x[h].w;
        buf[4 * BUF_STRIDE + i] = y[h].x;
      }
      __syncwarp();
      if (c0 + WARP_CHUNK < end) load(c0 + WARP_CHUNK);
      const int n = min(WARP_CHUNK, end - c0);
      if (lane < NT) {
        if (n == WARP_CHUNK) {
#pragma unroll
          for (int i = 0; i < WARP_CHUNK; ++i) acc = __fadd_rn(acc, col[i]);
        } else {
          for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, col[i]);
        }
      }
    }
  });
  if (lane < NT) a.inst_acc[static_cast<int64_t>(r) * NT + lane] = acc;
}

// The lane math and the stable sort of tile `tile` of point p: its run
// table and its bit in the row masks.  Ends with the block synchronised,
// so the caller may reuse the shared storage.
template <int ITEMS>
__device__ __forceinline__ void sort_tile(const Args& p, int tile,
                                          Shared<ITEMS>& sh) {
  constexpr int T = THREADS * ITEMS;
  const int tid = threadIdx.x;
  const int base = tile * T;
  const int rows = p.n_inst + 1;
  const unsigned none = static_cast<unsigned>(rows);
  // the lane math, lanes striped over the threads (coalesced), then the
  // keys into lane order (ITEMS consecutive lanes a thread) for the sort
  unsigned keys[ITEMS];
  int vals[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int c = base + j * THREADS + tid;
    keys[j] = c < p.n_lanes ? lane(p, c) : none;
    vals[j] = tid * ITEMS + j;
  }
  Exchange<ITEMS>(sh.exchange).StripedToBlocked(keys, keys);
  __syncthreads();
  // sorted position q = j * THREADS + tid afterwards (striped)
  Sorter<ITEMS>(sh.sort).SortBlockedToStriped(keys, vals, 0, p.key_bits);
  __syncthreads();   // the sort's storage becomes the sorted key list
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) sh.key[j * THREADS + tid] = keys[j];
  __syncthreads();   // ... and the terms of every lane are visible
  // this tile's run table: per row (start | end << 16), read only where
  // the row's mask has the tile's bit
  uint16_t* half = reinterpret_cast<uint16_t*>(
      p.table + static_cast<int64_t>(tile) * rows);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int q = j * THREADS + tid;
    const unsigned k = keys[j];
    if (k >= none) continue;
    const float4* src = p.terms + static_cast<int64_t>(base + vals[j]) * 2;
    float4* dst = p.sterms + static_cast<int64_t>(base + q) * 2;
    dst[0] = src[0];
    dst[1] = src[1];
    if (q == 0 || sh.key[q - 1] != k) {
      half[2 * k] = static_cast<uint16_t>(q);
      atomicOr(p.mask + static_cast<int64_t>(k) * p.mask_words + tile / 32,
               1u << (tile % 32));
    }
    if (q == T - 1 || sh.key[q + 1] != k) {
      half[2 * k + 1] = static_cast<uint16_t>(q + 1);
    }
  }
  __syncthreads();   // the key list is read before the next tile's sort
}

// A batch of B points.  BLOCK and CLUSTER: block (tile, b) of a (tiles, B)
// grid, each point's tiles one cluster (or one block).  GRID: a
// cooperative grid that strides over (point, tile) pairs for the sort and
// over (point, row) pairs for the fold.
template <int ITEMS, Mode MODE>
__global__ void __launch_bounds__(THREADS, 1) finish_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<ITEMS>& sh = *reinterpret_cast<Shared<ITEMS>*>(smem_raw);
  __shared__ int long_rows[LONG_ROWS];
  __shared__ int n_long;
  constexpr int T = THREADS * ITEMS;
  const int tid = threadIdx.x;
  const int rows = a.n_inst + 1;
  const bool grid = MODE == GRID;
  // the pairs this block takes: (point, tile) for the sort; the first
  // point and row its threads fold, and the stride between them
  const int first_pair = grid ? blockIdx.x : blockIdx.y * a.tiles
                                                 + blockIdx.x;
  const int pair_stride = grid ? gridDim.x : a.tiles * a.n_batch;
  const int n_pairs = grid ? a.tiles * a.n_batch : first_pair + 1;
  // the row masks (bit t: the row has a run in tile t) start clear: a grid
  // clears every point's, a cluster its own point's
  {
    const int64_t len = static_cast<int64_t>(rows) * a.mask_words;
    const int64_t lo = grid ? 0 : len * blockIdx.y;
    const int64_t hi = grid ? len * a.n_batch : lo + len;
    const int64_t first = lo + static_cast<int64_t>(blockIdx.x) * THREADS
                          + tid;
    const int64_t step = static_cast<int64_t>(
        grid ? gridDim.x : a.tiles) * THREADS;
    for (int64_t i = first; i < hi; i += step) a.mask[i] = 0u;
  }
  if (tid == 0) n_long = 0;
  sync_all<MODE>();

  for (int q = first_pair; q < n_pairs; q += pair_stride) {
    const int b = q / a.tiles;
    sort_tile<ITEMS>(point(a, b), q % a.tiles, sh);
  }
  sync_all<MODE>();

  // one thread a row, one warp a long row: the row's runs, tile after
  // tile, folded in lane order.  A row is (point, row) as b * rows + r.
  const int64_t first_row = grid
      ? static_cast<int64_t>(blockIdx.x) * THREADS + tid
      : static_cast<int64_t>(blockIdx.y) * rows
            + static_cast<int64_t>(blockIdx.x) * THREADS + tid;
  const int64_t end_row = grid ? static_cast<int64_t>(rows) * a.n_batch
                               : static_cast<int64_t>(blockIdx.y + 1) * rows;
  const int64_t row_stride = static_cast<int64_t>(
      grid ? gridDim.x : a.tiles) * THREADS;
  for (int64_t g = first_row; g < end_row; g += row_stride) {
    const int b = static_cast<int>(g / rows), r = static_cast<int>(g % rows);
    const Args p = point(a, b);
    int total = 0;
    for_each_run<T>(p, r, [&](const float4*, int start, int end) {
      total += end - start;
    });
    if (total > LONG_RUN) {
      const int slot = atomicAdd(&n_long, 1);
      if (slot < LONG_ROWS) {
        long_rows[slot] = static_cast<int>(g);
        continue;
      }
    }
    fold_row<T>(p, r);
  }
  __syncthreads();   // the sort's storage becomes the warps' buffers
  const int n = min(n_long, LONG_ROWS);
  const int warp = tid >> 5;
  for (int i = warp; i < n; i += THREADS / 32) {
    const int g = long_rows[i];
    fold_row_warp<T>(point(a, g / rows), g % rows, sh.fold[warp]);
  }
}

// The launch over n_lanes lanes: lanes a thread, tiles and how they meet.
// Up to 16,384 lanes (case1b, SockShop) a plain launch of one block or of
// a cluster of up to 8 blocks of 1,024 or 2,048 lanes, which spreads the
// lane math over 8 SMs (one SM alone moves the pool's megabyte at a
// fraction of the card's rate) at a plain launch's host cost; a
// cooperative launch costs the host more.  Above, a cooperative grid of
// 4,096-lane tiles while every tile has an SM of its own, else of 8,192.
struct Route {
  int items, tiles;
  Mode mode;
};

Route route_for(int n_lanes, int sms) {
  const int per_cluster = MAX_CLUSTER * THREADS;
  for (int items : {1, 2}) {
    if (n_lanes <= per_cluster * items) {
      const int tiles = n_lanes <= 0 ? 1 : (n_lanes + THREADS * items - 1)
                                               / (THREADS * items);
      return {items, tiles, tiles == 1 ? BLOCK : CLUSTER};
    }
  }
  const int items =
      n_lanes <= static_cast<int64_t>(sms) * THREADS * 4 ? 4 : MAX_ITEMS;
  const int per = THREADS * items;
  return {items, (n_lanes + per - 1) / per, GRID};
}

cudaError_t sm_count(int* sms) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev]) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) known[dev] = *sms;
  return err;
}

// Allow the kernel its dynamic shared memory, once per device (so that a
// launch under stream capture makes no other API call).
template <int ITEMS, Mode MODE>
cudaError_t prepare(size_t* smem) {
  *smem = sizeof(Shared<ITEMS>);
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(finish_kernel<ITEMS, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The blocks of one launch that can all be resident at once (a
// cooperative grid may hold no more).
template <int ITEMS>
cudaError_t resident_blocks(size_t smem, int* n) {
  static int known[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev]) {
    *n = known[dev];
    return cudaSuccess;
  }
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, finish_kernel<ITEMS, GRID>, THREADS, smem);
  if (err != cudaSuccess) return err;
  *n = sms * per_sm;
  if (dev < 64) known[dev] = *n;
  return cudaSuccess;
}

template <int ITEMS, Mode MODE>
cudaError_t launch(Args* a, cudaStream_t s) {
  size_t smem = 0;
  cudaError_t err = prepare<ITEMS, MODE>(&smem);
  if (err != cudaSuccess) return err;
  if constexpr (MODE == BLOCK) {
    finish_kernel<ITEMS, BLOCK><<<dim3(1, a->n_batch), THREADS, smem, s>>>(
        *a);
    return cudaGetLastError();
  } else if constexpr (MODE == CLUSTER) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a->tiles;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a->tiles, a->n_batch);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, finish_kernel<ITEMS, CLUSTER>, *a);
  } else {
    int resident = 0;
    err = resident_blocks<ITEMS>(smem, &resident);
    if (err != cudaSuccess) return err;
    const long long pairs = static_cast<long long>(a->tiles) * a->n_batch;
    const int blocks = static_cast<int>(pairs < resident ? pairs : resident);
    void* args[] = {a};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(finish_kernel<ITEMS, GRID>),
        dim3(blocks), dim3(THREADS), args, smem, s);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// The launch over n_lanes lanes on the current device: returns how its
// tiles meet (0 one block, 1 a cluster, 2 a cooperative grid; -1 on a CUDA
// error) and writes their number to *tiles.  The wrapper sizes the scratch
// by it: the run table [tiles, n_inst + 1] and the row masks [n_inst + 1,
// ceil(tiles / 32)] of 32-bit words, terms and sorted terms n_lanes x 8
// floats each.
extern "C" int cloudlet_finish_route(int n_lanes, int* tiles) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  const Route r = route_for(n_lanes, sms);
  *tiles = r.tiles;
  return static_cast<int>(r.mode);
}

// The most lanes one launch takes on the current device: MAX_ITEMS lanes a
// thread in blocks that are all resident at once.
extern "C" long long cloudlet_finish_max_lanes() {
  int sms = 0, per_sm = 0;
  size_t smem = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  if (prepare<MAX_ITEMS, GRID>(&smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, finish_kernel<MAX_ITEMS, GRID>, THREADS, smem)
      != cudaSuccess) return -1;
  return static_cast<long long>(sms) * per_sm * THREADS * MAX_ITEMS;
}

// One launch over n_batch points of n_lanes lanes each: every array holds
// the points one after another (ints [B, n_lanes, ni], time and dt [B] on
// the device, request arrays [B, n_req], inst_acc [B, n_inst + 1, 5]; the
// scratch B times the unbatched launch's, the run table [B * tiles,
// n_inst + 1] and the row masks [B * (n_inst + 1), ceil(tiles / 32)]).
extern "C" int cloudlet_finish_launch(
    const int32_t* ints, int ni, int c_status, int c_inst, int c_req,
    int c_depth, const float* flts, int nf, int c_rem, int c_arrival,
    int c_start, const float* rate, const float* time_ptr,
    const float* dt_ptr, int n_lanes, int n_batch, float* req_finish,
    int32_t* req_crit, int32_t* req_out, int n_req, float* new_rem,
    bool* fin, float* tfin, float* consumed, float4* terms, float4* sterms,
    uint32_t* table, uint32_t* mask, float* inst_acc, int n_inst,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_batch < 1 || n_batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Route r = route_for(n_lanes, sms);
  Args a{ints, ni, c_status, c_inst, c_req, c_depth,
         flts, nf, c_rem, c_arrival, c_start,
         rate, time_ptr, dt_ptr, n_lanes, n_batch, r.tiles,
         req_finish, req_crit, req_out, n_req,
         new_rem, fin, tfin, consumed,
         terms, sterms, table, mask, (r.tiles + 31) / 32, inst_acc, n_inst,
         32 - __builtin_clz(static_cast<unsigned>(n_inst) + 1u),
         0.0f, 0.0f};
  if (r.mode == BLOCK) {
    err = launch<1, BLOCK>(&a, s);
  } else if (r.mode == CLUSTER) {
    err = r.items == 1 ? launch<1, CLUSTER>(&a, s)
                       : launch<2, CLUSTER>(&a, s);
  } else {
    err = r.items == 4 ? launch<4, GRID>(&a, s)
                       : launch<MAX_ITEMS, GRID>(&a, s);
  }
  return static_cast<int>(err);
}

// An empty kernel through the same launch path: the floor a launch-bound
// kernel's time is read against.
extern "C" int cloudlet_finish_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
