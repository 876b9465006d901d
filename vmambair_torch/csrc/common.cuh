// Shared device helpers of the port's kernels: dtype-flagged loads and
// stores (activations arrive as fp32 or bf16; all maths is fp32), the
// thresholded softplus, the hardware exp2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vmt {

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int CH = 32;        // sequence positions per chunk
constexpr int LDS = CH + 1;   // shared-memory row pitch (no bank conflicts)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ld_act(const void* p, long long i, int dt) {
  if (dt == DT_BF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  }
  return reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_act(void* p, long long i, int dt, float v) {
  if (dt == DT_BF16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

// The raw bits of E elements of an fp32 or bf16 tensor (bf16 zero-extended):
// r[e] = p[off(e)] for each e with ok(e). The dtype is decided once, around
// the whole unrolled loop, so every load writes its own register and
// nothing consumes it until raw_f32 converts it: a thread's loads are in
// flight together. (ld_act, which converts in place, makes the thread wait
// out each load before the next.)
template <int E, typename Off, typename Ok>
__device__ __forceinline__ void ld_raw_n(uint32_t (&r)[E], const void* p,
                                        int dt, Off off, Ok ok) {
  if (dt == DT_BF16) {
    const unsigned short* q = static_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (ok(e)) r[e] = q[off(e)];
    }
  } else {
    const uint32_t* q = static_cast<const uint32_t*>(p);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (ok(e)) r[e] = q[off(e)];
    }
  }
}

__device__ __forceinline__ float raw_f32(uint32_t r, int dt) {
  return __uint_as_float(dt == DT_BF16 ? r << 16 : r);
}

// *p = v where ok, as one predicated st.global: the compiler is told of no
// memory it touches (no "memory" clobber), so it does not hold loads of
// other memory back behind it, and no branch splits the code around it.
// For stores that no thread of the kernel reads back.
__device__ __forceinline__ void st_f32_if(float* p, float v, bool ok) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q st.global.f32 [%0], %1;\n\t}"
      :
      : "l"(p), "f"(v), "r"((unsigned)ok));
}

// Rounds v to the activation dtype (identity for fp32).
__device__ __forceinline__ float round_act(float v, int dt) {
  return dt == DT_BF16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// 2^x by the hardware approximation (a few ulp, as exp2f) without exp2f's
// rescaling for results below 2^-126: such a decay multiplies the state by
// less than 1e-38, so flushing it to 0 changes nothing. exp2f's extra
// instructions sat on the scan's critical path (6% of K1, measured).
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// softplus, linear above 20 (torch's threshold and the TPU kernel's).
__device__ __forceinline__ float softplus20(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return 0;
}

}  // namespace vmt
