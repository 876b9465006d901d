// Hopper's warp-level tensor-core and asynchronous-copy instructions, as
// the port's kernels use them (K2, gdfn.cu): cp.async of 16-byte chunks
// from global to shared memory, ldmatrix of 8x8 bf16 tiles from shared
// memory into mma fragments, and mma.sync m16n8k16 with bf16 operands and
// fp32 accumulators.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a[0] rows g, k 2t..2t+1; a[1] row g + 8;
//     a[2] row g, k 2t+8..; a[3] row g + 8, k 2t+8.. (two bf16 each);
//   B (16 x 8, "col": stored n-major, k contiguous): b[0] n = g,
//     k 2t..2t+1; b[1] n = g, k 2t+8..;
//   C/D (16 x 8, fp32): d[0..1] row g, columns 2t, 2t+1; d[2..3] row g + 8.
// ldsm_x4 on a row-major A tile: lane l gives the address of row l % 16,
// columns (l / 16) * 8 .. + 7. On an n-major B tile of two n8 blocks and
// k16: lane l gives n = (l % 8) + (l / 16) * 8, k = ((l / 8) % 2) * 8.
#pragma once

#include <stdint.h>

namespace vmt {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1 (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(s)),
               "l"(g));
}

// 4 bytes global -> shared (both 4-byte aligned); zeros where !in (g is
// then not read, but must be a valid address).
__device__ __forceinline__ void cp_async4(void* s, const void* g, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for every cp.async group this thread committed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two 8x8 tiles: lanes 0-15 give the addresses (rows of tile l / 8).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a . b: m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
}  // namespace vmt
