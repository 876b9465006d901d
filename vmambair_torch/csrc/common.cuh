// Shared device helpers of the port's kernels: dtype-flagged loads and
// stores (activations arrive as fp32 or bf16; all maths is fp32), the
// thresholded softplus, and the chunk scan that K1 (oss_scan_fused.cu) and
// K4 (selective_scan.cu) both run.
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

// Scans one chunk of `len` positions for a tile of T channels.
//
// Thread (c = tid % T, s = tid / T), s < S, owns channel c and the states
// n = s + S * (NS * p + j), j < NS, for passes p = 0, 1, ... while n < N:
// NS states in registers at a time (NS is a template argument, so no
// register slot goes unused when S * NS divides N). For each position t it
// advances h_n = exp(delta A_n) h_n + delta u B_n and writes its share
// sum_n C_n h_n to ypart[s][c][t]; the caller adds the S shares. Positions
// go UNR at a time: their loads and exp2s are independent, so only the FMA
// on h is a chain. A position past `len` gets delta = 0, which leaves h as
// it is.
//
// d_s, u_s: [T][LDS] delta (bias and softplus applied) and input.
// Bs, Cs:   state n at row n, pitch ldbc (shared by the tile's channels).
// A2:       [T][N] A * log2(e).   h: [T][N] fp32 state carried over chunks.
// ypart:    [S][T][LDS].
constexpr int UNR = 4;

template <int NS>
__device__ __forceinline__ void scan_chunk(
    const float* d_s, const float* u_s, const float* Bs, const float* Cs,
    int ldbc, const float* A2, float* h, float* ypart, int T, int S, int N,
    int len, bool reverse) {
  const int tid = threadIdx.x;
  if (tid >= T * S) return;
  const int c = tid % T;
  const int s = tid / T;
  const float* dc = d_s + c * LDS;
  const float* uc = u_s + c * LDS;
  float* yp = ypart + (s * T + c) * LDS;
  bool first = true;
  for (int nb = s; nb < N; nb += NS * S) {
    float hr[NS], ar[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int n = nb + j * S;
      hr[j] = n < N ? h[c * N + n] : 0.f;
      ar[j] = n < N ? A2[c * N + n] : 0.f;
    }
    for (int i0 = 0; i0 < len; i0 += UNR) {
      int tk[UNR];
      float dt[UNR], du[UNR], acc[UNR];
#pragma unroll
      for (int k = 0; k < UNR; ++k) {
        const int i = min(i0 + k, len - 1);
        tk[k] = reverse ? len - 1 - i : i;
        const bool in = i0 + k < len;
        dt[k] = in ? dc[tk[k]] : 0.f;
        du[k] = in ? dt[k] * uc[tk[k]] : 0.f;
        acc[k] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        // a state past N (last pass only) reads row 0 and is dropped
        const int n = nb + j * S < N ? nb + j * S : 0;
        const float* bn = Bs + n * ldbc;
        const float* cn = Cs + n * ldbc;
#pragma unroll
        for (int k = 0; k < UNR; ++k) {
          hr[j] = exp2_ftz(dt[k] * ar[j]) * hr[j] + du[k] * bn[tk[k]];
          if (nb + j * S < N) acc[k] += cn[tk[k]] * hr[j];
        }
      }
#pragma unroll
      for (int k = 0; k < UNR; ++k) {
        if (i0 + k < len) yp[tk[k]] = first ? acc[k] : yp[tk[k]] + acc[k];
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int n = nb + j * S;
      if (n < N) h[c * N + n] = hr[j];
    }
    first = false;
  }
  if (first) {
    for (int t = 0; t < len; ++t) yp[t] = 0.f;
  }
}

// States a thread keeps in registers: the smallest power of two >= N / S,
// at most 16.
inline int states_per_thread(int N, int S) {
  const int need = (N + S - 1) / S;
  int ns = 1;
  while (ns < need && ns < 16) ns *= 2;
  return ns;
}

// Largest divisor of n that is at most cap.
inline int largest_divisor_le(int n, int cap) {
  for (int t = cap < n ? cap : n; t > 1; --t) {
    if (n % t == 0) return t;
  }
  return 1;
}

inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return 0;
}

}  // namespace vmt
