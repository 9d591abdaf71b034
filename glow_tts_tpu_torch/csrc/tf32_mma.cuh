// Tensor-core pieces of the backward flow's GEMMs (flow_train_bwd.cu): the
// TF32 warp-level product mma.sync.m16n8k8 on float32 data, the split of a
// float32 value into two TF32 halves for the error-compensated 3xTF32
// product, and cp.async with zero fill.
//
// TF32 keeps 10 mantissa bits, so one pass is good to about 3 decimal
// digits: not enough for f32 gradients.  With a = a_hi + a_lo and b = b_hi +
// b_lo, both halves rounded to nearest, the sum a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi accumulated in float32 leaves only the a_lo.b_lo term out
// (2^-22 relative), at a third of the tensor cores' TF32 rate.
//
// Two things measured on an H100 shape the code.  cvt.rna.tf32.f32 runs at
// a fraction of the integer rate, so the rounding is an integer add and a
// mask (the same bits): 10 % off a flow step's backward.  And the tensor
// cores' own float32 accumulation truncates: over a depth of 1,920 it left
// 1.5e-5 of the result's max-abs where an FMA loop leaves 5e-7, so a warp
// adds its accumulators into a second set in plain float32 after every
// staged slice (flush), which brings it to 5e-7 for 8 % more time.
// Splitting every element once, where it is staged (global memory ->
// registers -> pairs in shared memory), instead of in every warp that reads
// it, was 24 % slower: it gives up the asynchronous copies.
//
// Fragments of m16n8k8 (lane = 4 g + t, g = 0..7, t = 0..3):
//   A [16 x 8] (row, k)  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)
//                        a3 (g + 8, t + 4)
//   B [8 x 8]  (k, col)  b0 (t, g)  b1 (t + 4, g)
//   C [16 x 8]           c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                        c3 (g + 8, 2t + 1)
// A thread reads its elements from shared memory by address, so either
// operand may lie there k-major or k-minor: nothing is transposed.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32 {

// float32 to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32
__device__ __forceinline__ uint32_t round_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi is x rounded to TF32 and lo the remainder, exact in
// float32 and at most 2^-11 |x|.  lo goes to the tensor cores as it is:
// they ignore its low 13 bits, which leaves 2^-21 |x| of either sign out
// (rounding lo too measured the same gradient error and 3 % more time;
// truncating hi as well 1.7 times the error for 3 % less).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (gmem
// must still be an address inside the tensor)
__device__ __forceinline__ void cp_async16_zfill(float* smem,
                                                 const float* gmem,
                                                 bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 8-deep step of a warp's [16 MT x 8 NT] tile: acc += A . B, where
// a_at(i, k) and b_at(k, j) read element (row i, depth k) and (depth k,
// column j) of the warp's operands.  PASSES is 1 (plain TF32) or 3 (3xTF32,
// small terms first).  The three products into one accumulator depend on
// each other, so the columns go in groups and a pass runs over the whole
// group (6 accumulators) before the next pass.
template <int MT, int NT, int PASSES, class LoadA, class LoadB>
__device__ __forceinline__ void warp_step(float (&acc)[MT][NT][4],
                                          const LoadA& a_at,
                                          const LoadB& b_at) {
  static_assert(PASSES == 1 || PASSES == 3, "1xTF32 or 3xTF32");
  constexpr int G = NT % 3 == 0 ? 3 : 2;   // columns of 8 in a group
  static_assert(NT % G == 0, "column groups");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float a[4] = {a_at(16 * mt + g, t), a_at(16 * mt + g + 8, t),
                        a_at(16 * mt + g, t + 4),
                        a_at(16 * mt + g + 8, t + 4)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (PASSES == 3) {
        split(a[e], a_hi[mt][e], a_lo[mt][e]);
      } else {
        a_hi[mt][e] = round_rna(a[e]);
      }
    }
  }
#pragma unroll
  for (int nt0 = 0; nt0 < NT; nt0 += G) {
    uint32_t b_hi[G][2], b_lo[G][2];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float b[2] = {b_at(t, 8 * (nt0 + j) + g),
                          b_at(t + 4, 8 * (nt0 + j) + g)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (PASSES == 3) {
          split(b[e], b_hi[j][e], b_lo[j][e]);
        } else {
          b_hi[j][e] = round_rna(b[e]);
        }
      }
    }
    if constexpr (PASSES == 3) {
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma(acc[mt][nt0 + j], a_lo[mt], b_hi[j]);
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma(acc[mt][nt0 + j], a_hi[mt], b_lo[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma(acc[mt][nt0 + j], a_hi[mt], b_hi[j]);
  }
}

#ifdef GLOW_BF16
// The bfloat16 builds' packing (the train kernels' epilogues, flow_ring.cuh).
// Fragments of m16n8k16 with bfloat16 operands (bf16_mma.cuh), two to a
// 32-bit register, the lower column (or depth) in the low half:
//   A [16 x 16] (row, k)  a0 (g, 2t..2t+1)  a1 (g + 8, 2t..2t+1)
//                         a2 (g, 2t+8..2t+9)  a3 (g + 8, 2t+8..2t+9)
//   B [16 x 8]  (k, col)  b0 (2t..2t+1, g)  b1 (2t+8..2t+9, g)
//   C [16 x 8]            as m16n8k8's
// A product of two bfloat16 values is exact in float32, so a product with
// f32 sums is the TPU kernel's bf16 dot with preferred_element_type f32.

// a pair of floats as a bfloat16x2 register, lo in the low half (cvt
// packs its first operand in the high half), to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

#endif

// sum += acc in float32 round-to-nearest, then acc = 0
template <int MT, int NT>
__device__ __forceinline__ void flush(float (&acc)[MT][NT][4],
                                      float (&sum)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum[mt][nt][e] += acc[mt][nt][e];
        acc[mt][nt][e] = 0.f;
      }
}

}  // namespace tf32
