// Hopper's warp-level tensor-core and asynchronous-copy instructions, as
// the port's kernels use them (K2, gdfn.cu): cp.async of 16-byte chunks
// from global to shared memory, bulk copies by the copy engine (TMA) with
// their transaction barriers, ldmatrix of 8x8 bf16 tiles from shared
// memory into mma fragments, mma.sync m16n8k16 with bf16 operands and
// fp32 accumulators, and mma.sync m16n8k8 with TF32 operands, which K2's
// fp32 route runs three times per product on operands split in two
// (split TF32, below).
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
//
// m16n8k8 with TF32 (32-bit) elements: A a[0] row g, k t; a[1] row g + 8,
// k t; a[2] row g, k t + 4; a[3] row g + 8, k t + 4; B b[0] k t, n g;
// b[1] k t + 4, n g; C/D as above. An 8x8 b16 tile of ldmatrix is an 8x4
// tile of 32-bit elements, and lane l receives row l / 4, element l % 4:
// so the same ldsm_x4 / ldsm_x2 addressing, with 4 floats (16 bytes) in
// the place of 8 bf16, loads fp32 A and B fragments from row-major A and
// n-major B tiles.
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

// Hopper's bulk copy engine (TMA, its one-dimensional form) and the
// transaction barriers (mbarrier) it reports to: one thread asks for a
// contiguous global range (16-byte aligned, a multiple of 16 bytes) to be
// copied into shared memory, and every thread that needs it waits on the
// barrier's phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the copy engine.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on bar that also expects `bytes` of copies to complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` from global src to shared dst by the copy engine, completing on
// bar.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Waits until the phase of bar with this parity has completed; traps
// rather than hang if it never does (some seconds of polling).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) asm volatile("trap;");
  }
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

// d += a . b: m16n8k8, TF32 operands (fp32 bit patterns; the tensor core
// reads the sign, the exponent and the top 10 mantissa bits), fp32
// accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Split TF32: an fp32 value a = hi + lo + r, hi = a rounded to 11
// significant bits (TF32's 10 mantissa bits and the leading one) by
// Veltkamp's split, t = 8193 a, hi = t - (t - a), in fp32 adds and a
// multiply with no contraction (the conversion instructions, cvt.rna,
// issue at a fraction of the fp32 rate and held the kernel back), lo = a
// - hi (exact, at most 12 significant bits) cut to TF32 by zeroing its low
// 13 bits, the bits the tensor core does not read; |r| < 2^-22 |a|.
// (|a| < 2^114, so that 8193 a stays finite.)
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(a);
  const float t = __fmul_rn(f, 8193.f);
  const float h = __fsub_rn(t, __fsub_rn(t, f));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(f, h)) & 0xffffe000u;
}

// The cheaper split K5's fp32 route takes for its B operands: hi = a cut
// to TF32 (the low 13 bits zeroed, toward zero), lo = a - hi (exact, at
// most 13 significant bits) cut the same way; |a - hi - lo| < 2^-21 |a|,
// |lo| < 2^-10 |a|. Three instructions where Veltkamp's split takes five.
__device__ __forceinline__ void split_tf32_cut(uint32_t a, uint32_t& hi,
                                               uint32_t& lo) {
  hi = a & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(a), __uint_as_float(hi))) &
       0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&a)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) split_tf32(a[e], hi[e], lo[e]);
}

// d += a . b in fp32 accuracy on the tensor cores: lo.hi, hi.lo, then
// hi.hi, each product of two TF32 values exact in fp32; the dropped lo.lo
// and lo's cut are below 2^-21 of each product.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The same with the small terms in an accumulator of their own: dl +=
// lo.hi + hi.lo, d += hi.hi. Two dependency chains where one would wait
// out three mma latencies a step; the caller adds dl to d at the end.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float (&dl)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(dl, al, bh0, bh1);
  mma_tf32(dl, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace mma
}  // namespace vmt
