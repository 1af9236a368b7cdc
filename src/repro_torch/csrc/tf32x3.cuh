// 3xTF32 products on Hopper's tensor cores (sm_90a), shared by the SSD
// kernels of `ssd_chunk.cu` and `ssd_chunk_bwd.cu`.
//
// A float32 x is split into two TF32 values, hi = x rounded to TF32 and
// lo = (x - hi) rounded to TF32 (the tensor core would truncate a raw
// float32), and d += hi·hi + lo·hi + hi·lo in float32 accumulators leaves
// about 2^-21 of each product where one TF32 pass leaves 2^-11.  wgmma
// takes a TF32 operand from shared memory only K-major: a "K-major
// operand" below is R rows (the M or N index of the product) of K values,
// stored as boxes of 32 K-values (128 bytes a row, R rows a box) with the
// 128-byte swizzle, at a 1024-byte aligned base.  The A operand comes from
// registers (the m64k8 fragment: a thread of lane l in warp w of its
// warpgroup holds rows 16w + l/4 and +8, K positions l%4 and +4) or from
// shared memory; B always from shared memory.
#pragma once

#include <stdint.h>

#include "sm90.cuh"

namespace tf32x3 {

using namespace sm90;

constexpr int ROW = 128;   // bytes of one swizzled row: 32 floats

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's value for every finite x, in two integer
// instructions where the cvt takes four
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo within 2^-22 |x|; hi and lo are TF32 values (low 13 bits 0)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// d[0 : NC/2] += A·B for one k8 step (m64nNCk8): `mma_rs_n*` with A from
// registers in the fragment order, `mma_ss_n*` with A from shared memory
// (a descriptor, K-major); B from shared memory, K-major.

__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_ss_n128(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int NC>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db) {
  static_assert(NC == 32 || NC == 64 || NC == 128, "wgmma width");
  if constexpr (NC == 32) mma_rs_n32(d, a, db);
  else if constexpr (NC == 64) mma_rs_n64(d, a, db);
  else mma_rs_n128(d, a, db);
}

template <int NC>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db) {
  static_assert(NC == 32 || NC == 64 || NC == 128, "wgmma width");
  if constexpr (NC == 32) mma_ss_n32(d, da, db);
  else if constexpr (NC == 64) mma_ss_n64(d, da, db);
  else mma_ss_n128(d, da, db);
}

// one k8 step in three TF32 passes: hi·hi + lo·hi + hi·lo
template <int NC>
__device__ __forceinline__ void mma3_rs(float* d, const uint32_t* ah,
                                        const uint32_t* al, uint64_t bh,
                                        uint64_t bl) {
  mma_rs<NC>(d, ah, bh);
  mma_rs<NC>(d, al, bh);
  mma_rs<NC>(d, ah, bl);
}

template <int NC>
__device__ __forceinline__ void mma3_ss(float* d, uint64_t ah, uint64_t al,
                                        uint64_t bh, uint64_t bl) {
  mma_ss<NC>(d, ah, bh);
  mma_ss<NC>(d, al, bh);
  mma_ss<NC>(d, ah, bl);
}

// the descriptor of k8 step s of a K-major operand whose boxes hold
// `rows` rows, from the row at `base` on (a multiple of 8 rows past a
// box's first)
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int rows, int s) {
  return sw128_desc(base + (s / 4) * rows * ROW + (s % 4) * 32, 16, 1024);
}

// the byte offset of K values 4c..4c+3 of row r in a K-major operand of
// `rows` rows (one 16-byte chunk)
__device__ __forceinline__ int kop_off(int r, int c, int rows) {
  return (c / 8) * rows * ROW + r * ROW + (((c % 8) ^ (r % 8)) * 16);
}

// splits the raw float32 values at `src` (`n` floats, as TMA loaded
// them) into hi and lo at the same offsets from `hi` and `lo` (`src` may
// be `hi`): every thread of the block (`nt` of them) takes 16 bytes at a
// time
__device__ __forceinline__ void split_copy(const uint8_t* src, uint8_t* hi,
                                           uint8_t* lo, int n, int tid,
                                           int nt) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* h4 = reinterpret_cast<uint4*>(hi);
  uint4* l4 = reinterpret_cast<uint4*>(lo);
  for (int e = tid; e < n / 4; e += nt) {
    const uint4 v = s4[e];
    uint4 h, l;
    split(__uint_as_float(v.x), h.x, l.x);
    split(__uint_as_float(v.y), h.y, l.y);
    split(__uint_as_float(v.z), h.z, l.z);
    split(__uint_as_float(v.w), h.w, l.w);
    h4[e] = h;
    l4[e] = l;
  }
}

__device__ __forceinline__ void split_in_place(uint8_t* hi, uint8_t* lo,
                                               int n, int tid, int nt) {
  split_copy(hi, hi, lo, n, tid, nt);
}

// acc += Σ_s A_s·B_s over the k8 steps s of [S0, S1) (S1 - S0 a multiple
// of 4) in 3xTF32, four steps a wgmma group: B_s from the K-major operands
// at bh / bl (boxes of `rows` rows), A_s's fragments built by frag(s, hi,
// lo).  The steps are unrolled, so that frag may index registers by s.
template <int NC, int S0, int S1, class Frag>
__device__ __forceinline__ void steps_rs(float* acc, uint32_t bh,
                                         uint32_t bl, int rows, Frag frag) {
  static_assert((S1 - S0) % 4 == 0, "steps in groups of 4");
#pragma unroll
  for (int b = S0; b < S1; b += 4) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) frag(b + u, ah[u], al[u]);
    pin<NC / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u)
      mma3_rs<NC>(acc, ah[u], al[u], kdesc(bh, rows, b + u),
                  kdesc(bl, rows, b + u));
    wgmma_commit_wait();
    pin<NC / 2>(acc);
  }
}

// acc += Σ_s A_s·B_s over the k8 steps of [s0, s1) in 3xTF32, A from the
// K-major operands at ah / al (boxes of `arows` rows, from this
// warpgroup's first row on), B from bh / bl (boxes of `brows` rows)
template <int NC>
__device__ __forceinline__ void steps_ss(float* acc, int s0, int s1,
                                         uint32_t ah, uint32_t al, int arows,
                                         uint32_t bh, uint32_t bl,
                                         int brows) {
  pin<NC / 2>(acc);
  wgmma_fence();
  for (int s = s0; s < s1; ++s)
    mma3_ss<NC>(acc, kdesc(ah, arows, s), kdesc(al, arows, s),
                kdesc(bh, brows, s), kdesc(bl, brows, s));
  wgmma_commit_wait();
  pin<NC / 2>(acc);
}

}  // namespace tf32x3
