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
// Bound: bytes.  A lane reads 7 words and writes 4 outputs; the touched
// request and instance rows are few.  At the capacity cases that is well
// under a megabyte, so one launch is latency bound, not bandwidth bound.
//
// Design.  One thread per lane; the columns are read straight out of the
// stacked [C, NI] int32 / [C, NF] float32 pool blocks with the column
// offsets of the pool layout (no per-column copies).  The TPU kernel's
// sequential grid carried the sums from step to step; on Hopper blocks run
// in no order, so:
//   * req_crit / req_out use integer atomicMax / atomicAdd: exact and
//     independent of order;
//   * req_finish uses a float max through the ordered-int trick (int max
//     for non-negative values, unsigned min for negative ones): exact;
//   * the five instance sums are accumulated as int64 fixed point
//     (value * 2^32, range +-2^31 per sum) with atomicAdd, which is exact
//     and independent of order, then converted to float32 by a second
//     small kernel.  The result is the correctly rounded exact sum, so it
//     is the same bits on every run; against the plain version's serial
//     float32 sum it differs by at most that sum's own rounding error.
// Out-of-range instance ids past the overflow row and request ids outside
// [0, R) are dropped, as the reference's mode="drop".  The file is built
// with --fmad=false, so nvcc contracts nothing on its own: the one fused
// multiply-add (`rem - rate*dt`, which the reference's compiled program
// contracts) is written out, everything else rounds each operation as the
// plain version does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CL_EXEC = 2;
constexpr double FIX_SCALE = 4294967296.0;  // 2^32

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void add_fixed(long long* slot, float v) {
  long long q = __double2ll_rn(static_cast<double>(v) * FIX_SCALE);
  atomicAdd(reinterpret_cast<unsigned long long*>(slot),
            static_cast<unsigned long long>(q));
}

__global__ void lane_kernel(
    const int32_t* __restrict__ ints, int ni, int c_status, int c_inst,
    int c_req, int c_depth,
    const float* __restrict__ flts, int nf, int c_rem, int c_arrival,
    int c_start,
    const float* __restrict__ rate, const float* __restrict__ time_ptr,
    float dt, int n_lanes,
    float* __restrict__ req_finish, int32_t* __restrict__ req_crit,
    int32_t* __restrict__ req_out, int n_req,
    float* __restrict__ new_rem, bool* __restrict__ fin_out,
    float* __restrict__ tfin_out, float* __restrict__ consumed_out,
    long long* __restrict__ acc, int n_inst) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_lanes) return;
  const float time = *time_ptr;
  const int32_t* row_i = ints + static_cast<int64_t>(c) * ni;
  const float* row_f = flts + static_cast<int64_t>(c) * nf;
  const int status = row_i[c_status];
  const int inst = row_i[c_inst];
  const float rem = row_f[c_rem];
  const float r = rate[c];

  const bool execm = status == CL_EXEC;
  const float prog = __fmul_rn(r, dt);
  const bool fin = execm && (rem <= prog) && (r > 0.0f);
  float tfin = 0.0f;
  if (fin) {
    const float t = __fadd_rn(time, __fdiv_rn(rem, fmaxf(r, 1e-9f)));
    tfin = fminf(fmaxf(t, time), __fadd_rn(time, dt));
  }
  const float consumed = execm ? fminf(prog, rem) : 0.0f;
  // rem - rate*dt with one rounding: the fused multiply-add of the
  // reference's compiled program
  const float left = __fmaf_rn(-r, dt, rem);
  new_rem[c] = execm ? fmaxf(left, 0.0f) : rem;
  fin_out[c] = fin;
  tfin_out[c] = tfin;
  consumed_out[c] = consumed;
  if (!execm) return;   // non-executing lanes add only zeros

  const int irow = inst >= 0 ? inst : n_inst;
  if (irow <= n_inst) {
    float terms[5] = {__fdiv_rn(consumed, dt), 0.0f, 0.0f, 0.0f, 0.0f};
    if (fin) {
      const float arrival = row_f[c_arrival];
      const float started = fmaxf(row_f[c_start], arrival);
      terms[1] = 1.0f;
      terms[2] = __fsub_rn(tfin, arrival);
      terms[3] = __fsub_rn(tfin, started);
      terms[4] = __fsub_rn(started, arrival);
    }
    long long* slot = acc + static_cast<int64_t>(irow) * 5;
    for (int k = 0; k < 5; ++k) {
      if (terms[k] != 0.0f) add_fixed(slot + k, terms[k]);
    }
  }
  if (fin) {
    const int req = row_i[c_req];
    if (req >= 0 && req < n_req) {
      atomic_max_float(req_finish + req, tfin);
      atomicMax(req_crit + req, row_i[c_depth] + 1);
      atomicSub(req_out + req, 1);
    }
  }
}

__global__ void fixed_to_float(const long long* __restrict__ acc,
                               float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<float>(static_cast<double>(acc[i]) /
                                         FIX_SCALE);
}

}  // namespace

extern "C" int cloudlet_finish_launch(
    const int32_t* ints, int ni, int c_status, int c_inst, int c_req,
    int c_depth, const float* flts, int nf, int c_rem, int c_arrival,
    int c_start, const float* rate, const float* time_ptr, float dt,
    int n_lanes, float* req_finish, int32_t* req_crit, int32_t* req_out,
    int n_req, float* new_rem, bool* fin, float* tfin, float* consumed,
    long long* acc_fixed, float* inst_acc, int n_inst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_acc = (n_inst + 1) * 5;
  cudaError_t err = cudaMemsetAsync(acc_fixed, 0,
                                    sizeof(long long) * n_acc, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  if (n_lanes > 0) {
    lane_kernel<<<(n_lanes + threads - 1) / threads, threads, 0, s>>>(
        ints, ni, c_status, c_inst, c_req, c_depth, flts, nf, c_rem,
        c_arrival, c_start, rate, time_ptr, dt, n_lanes, req_finish,
        req_crit, req_out, n_req, new_rem, fin, tfin, consumed, acc_fixed,
        n_inst);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fixed_to_float<<<(n_acc + threads - 1) / threads, threads, 0, s>>>(
      acc_fixed, inst_acc, n_acc);
  return static_cast<int>(cudaGetLastError());
}
