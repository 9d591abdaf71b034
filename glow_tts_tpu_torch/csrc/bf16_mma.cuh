// Hopper pieces of the bfloat16 train kernels (flow_train_bwd.cu and
// flow_train_fwd.cu built with GLOW_BF16): bfloat16 tiles staged into shared
// memory as they are, 16 bytes at a time (cp.async, zero-filled where a row
// or a depth lies outside the operand), mma fragments built from them by
// ldmatrix, and the warpgroup product wgmma on tiles laid out in its
// 128-byte swizzle.
//
// mma.sync.m16n8k16 fragments (lane = 4 g + t; bfloat16 pairs, the lower
// depth or column in the low half):
//   A [16 x 16] (row, k)  a0 (g, 2t..2t+1)  a1 (g + 8, 2t..)  a2 (g, 2t+8..)
//                         a3 (g + 8, 2t+8..)
//   B [16 x 8]  (k, col)  b0 (2t..2t+1, g)  b1 (2t+8..2t+9, g)
// ldmatrix.x4 loads four 8 x 8 matrices of 16-bit values, lanes 8i..8i+7
// giving the addresses of matrix i's eight 16-byte rows; lane 4g + t
// receives row g, elements 2t and 2t+1 of each (with .trans, row 2t and 2t+1
// of column g).  So an operand stored with k contiguous gives its fragments
// plainly, and one stored with k as the row (the weight gradients' operands,
// frame-major) gives them with .trans.
//
// wgmma.m64nNk16 with both operands K-major in shared memory, each through
// a matrix descriptor: rows of 64 bfloat16 (128 bytes), the 16-byte chunk c
// of row r stored at chunk c ^ (r % 8) (the 128-byte swizzle), groups of 8
// rows 1024 bytes apart, the tile 1024-byte aligned.  The k-th 16-deep step
// of a row block is the same descriptor 32 k bytes further on.  The f32
// accumulator fragment of warp w of the warpgroup is mma's C fragment of
// rows 16 w .. 16 w + 15: d[4 j + 2 h + e] is (row 16 w + g + 8 h, column
// 8 j + 2 t + e).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bf16mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (gmem
// must still be an address inside the tensor)
__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(bytes));
}

// 8 bytes from global to shared memory, or 8 zero bytes when !valid (the
// same rule for gmem); through L1, the one path cp.async has for 8 bytes
__device__ __forceinline__ void cp_async8(uint32_t smem, const void* gmem,
                                          bool valid) {
  const int bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b, bfloat16 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of the 16-byte chunk c of row r in a tile of 128-byte rows
// in the 128-byte swizzle (ops/coupling_grad.py::sw128_offsets is its
// plain twin).
__host__ __device__ constexpr int sw128(int r, int c) {
  return r * 128 + ((c ^ (r % 8)) << 4);
}

// The matrix descriptor of a K-major tile in the 128-byte swizzle at shared
// address addr: start address >> 4 (bits 0-13), leading byte offset unused,
// stride byte offset 1024 >> 4 (bits 32-45), swizzle mode 1 (bits 62-63).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Shared memory written by the threads (cp.async included) is read by
// wgmma through the async proxy: each writer fences after its writes have
// landed and before the barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across a wgmma wait or fence
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 96] += A[64 x 16] . B[96 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

}  // namespace bf16mma
