// The primitive-throughput probes of tools/kpeak.py, for the H100.
//
// Replaces tools/kpeak.py's five kernels (run :20, called :22): kern_fma on
// fp32 and on bf16 (:56), kern_exp (:69), kern_roll (:76) and
// kern_shift_concat (:83). Each computes kpeak's function on a contiguous
// (GRID, ROWS, LANES) array with the repetition count `rep` at run time:
//   fma:   a = 0.999 v; 8 chains c_i = v (1 + 0.01 i), rep / 8 times
//          c_i = a c_i + 0.001, then c_0 + ... + c_7 (bf16: __hfma2 on
//          bf16x2 pairs, so bf16 rounds once per step where JAX rounds the
//          product and the sum);
//   exp:   v = exp(-0.5 v), rep times (ex2.approx of v * -0.5 log2(e), the
//          scans' exp2);
//   roll:  v += roll(v, 1 + i % 8) along the row (pltpu.roll's direction,
//          jnp.roll's: element j takes element j - s), then * 1e-30;
//   shift: v += v shifted right by 2^(i % 7) along the row, zero-filled,
//          then * 1e-30.
// fma and exp run one element (bf16: one pair) per thread. roll and shift
// run one warp per row of LANES = 32 x EPL elements, element j = lane + 32 k
// in register k of its lane: a roll or shift by s < 32 is one __shfl_sync
// per register (every element crosses lanes, as every vreg crosses lanes
// in the TPU's lane roll), a shift by 32 or 64 a move between registers.
//
// What bounds each on the H100, timed at a rep where the bytes take under
// 5% of the run: fma the FMA pipes (fp32 67 TFLOP/s on the data sheet),
// exp the SFU (16 per clock per SM nominal, no data-sheet figure), roll and
// shift the shuffle unit. The exp probe's rate is the ex2 rate the scans'
// bounds use.
#include "common.cuh"

namespace vmt {

enum { PK_FMA = 0, PK_EXP = 1, PK_ROLL = 2, PK_SHIFT = 3 };
constexpr int PK_THREADS = 256;

__global__ void peak_fma_f32(const float* __restrict__ x,
                             float* __restrict__ y, long long n, int rep) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  const float a = v * 0.999f;
  float c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = v * (float)(1.0 + 0.01 * j);
  for (int r = 0; r < rep / 8; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = fmaf(a, c[j], 0.001f);
  }
  float acc = c[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) acc += c[j];
  y[i] = acc;
}

__global__ void peak_fma_bf16(const __nv_bfloat162* __restrict__ x,
                              __nv_bfloat162* __restrict__ y, long long n2,
                              int rep) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 v = x[i];
  const __nv_bfloat162 a = __hmul2(v, __float2bfloat162_rn(0.999f));
  const __nv_bfloat162 k = __float2bfloat162_rn(0.001f);
  __nv_bfloat162 c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = __hmul2(v, __float2bfloat162_rn((float)(1.0 + 0.01 * j)));
  }
  for (int r = 0; r < rep / 8; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = __hfma2(a, c[j], k);
  }
  __nv_bfloat162 acc = c[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) acc = __hadd2(acc, c[j]);
  y[i] = acc;
}

__global__ void peak_exp(const float* __restrict__ x, float* __restrict__ y,
                         long long n, int rep) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int r = 0; r < rep; ++r) v = exp2_ftz(v * (-0.5f * LOG2E));
  y[i] = v;
}

// One warp per row; SHIFT: zero-filled shift by 2^(i % 7), else the roll
// by 1 + i % 8.
template <int EPL, bool SHIFT>
__global__ void __launch_bounds__(PK_THREADS) peak_lanes(
    const float* __restrict__ x, float* __restrict__ y, long long rows,
    int rep) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp
  const float* xr = x + row * (32 * EPL);
  float v[EPL], a[EPL];
#pragma unroll
  for (int k = 0; k < EPL; ++k) v[k] = xr[lane + 32 * k];
  for (int i = 0; i < rep; ++i) {
    const int p = i % 7;
    if (SHIFT && p == 5) {  // by 32: register k takes register k - 1
#pragma unroll
      for (int k = EPL - 1; k >= 1; --k) v[k] += v[k - 1];
      continue;
    }
    if (SHIFT && p == 6) {  // by 64
#pragma unroll
      for (int k = EPL - 1; k >= 2; --k) v[k] += v[k - 2];
      continue;
    }
    const int s = SHIFT ? 1 << p : 1 + (i & 7);
    const int src = (lane - s) & 31;
#pragma unroll
    for (int k = 0; k < EPL; ++k) a[k] = __shfl_sync(0xffffffffu, v[k], src);
    // lanes below s take the previous register's value: from the row's end
    // for the roll, a zero for the shift's first register
    const bool wrap = lane < s;
#pragma unroll
    for (int k = 0; k < EPL; ++k) {
      const float prev = k > 0 ? a[k - 1] : (SHIFT ? 0.f : a[EPL - 1]);
      v[k] += wrap ? prev : a[k];
    }
  }
  float* yr = y + row * (32 * EPL);
#pragma unroll
  for (int k = 0; k < EPL; ++k) yr[lane + 32 * k] = v[k] * 1e-30f;
}

template <bool SHIFT>
static int launch_lanes(const float* x, float* y, long long rows, int lanes,
                        int rep, cudaStream_t st) {
  const unsigned blocks =
      (unsigned)((rows * 32 + PK_THREADS - 1) / PK_THREADS);
  switch (lanes) {
    case 128: peak_lanes<4, SHIFT><<<blocks, PK_THREADS, 0, st>>>(x, y, rows, rep); break;
    case 256: peak_lanes<8, SHIFT><<<blocks, PK_THREADS, 0, st>>>(x, y, rows, rep); break;
    case 512: peak_lanes<16, SHIFT><<<blocks, PK_THREADS, 0, st>>>(x, y, rows, rep); break;
    case 1024: peak_lanes<32, SHIFT><<<blocks, PK_THREADS, 0, st>>>(x, y, rows, rep); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace vmt

// x, y: contiguous (rows, lanes) of dtype dt (bf16 only for the fma probe;
// lanes even for it, 128, 256, 512 or 1024 for roll and shift).
extern "C" int vmt_peak(int probe, const void* x, int dt, void* y,
                        long long rows, int lanes, int rep, void* stream) {
  using namespace vmt;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = rows * lanes;
  if (rep < 0 || n < 1 || (dt == DT_BF16 && (probe != PK_FMA || n % 2))) {
    return (int)cudaErrorInvalidValue;
  }
  switch (probe) {
    case PK_FMA:
      if (dt == DT_BF16) {
        const long long n2 = n / 2;
        peak_fma_bf16<<<(unsigned)((n2 + PK_THREADS - 1) / PK_THREADS),
                        PK_THREADS, 0, st>>>(
            (const __nv_bfloat162*)x, (__nv_bfloat162*)y, n2, rep);
      } else {
        peak_fma_f32<<<(unsigned)((n + PK_THREADS - 1) / PK_THREADS),
                       PK_THREADS, 0, st>>>((const float*)x, (float*)y, n,
                                            rep);
      }
      return (int)cudaGetLastError();
    case PK_EXP:
      peak_exp<<<(unsigned)((n + PK_THREADS - 1) / PK_THREADS), PK_THREADS,
                 0, st>>>((const float*)x, (float*)y, n, rep);
      return (int)cudaGetLastError();
    case PK_ROLL:
      return launch_lanes<false>((const float*)x, (float*)y, rows, lanes,
                                 rep, st);
    case PK_SHIFT:
      return launch_lanes<true>((const float*)x, (float*)y, rows, lanes, rep,
                                st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
