// kprobe's two probes (tools/kprobe.py), the building blocks of a fused
// projection + scan kernel that reads (B, L, D) chunks: an in-kernel
// transpose pair and small in-kernel projections.
//
// Replaces tools/kprobe.py::probe_transpose's kernel (:45, call :52) and
// probe_proj's (:79, call :89). Both are position-wise on u (rows, D) =
// (B * L, D) contiguous, fp32 or bf16, and write y of u's shape and dtype:
//   transpose: y = u * 1.000001 in fp32, rounded to y's dtype, computed on
//              the tile transposed, (TL, D) -> (D, TL) and back;
//   proj:      xdbl = W_xp u^T, (RN, TL) in fp32 (W_xp (RN, D) fp32), then
//              y = (W_dt xdbl[:R] + 0.5 xdbl[R])^T (W_dt (D, R) fp32).
// On the TPU each grid step is one (b, chunk of 1024) block of a (B, L, D)
// array; the function does not depend on where a chunk ends, so here a
// block takes TL = 64 consecutive rows of the flattened (B * L, D) array.
//
// What bounds them on the H100: the transpose pair its bytes (u read and y
// written once); the projection the bytes as well when only the rows the
// output reads (R + 1) are counted, but it computes every row of xdbl in
// fp32 on the CUDA cores, as the TPU probe prices the full projection of
// a fused kernel: 2 RN D + 2 D R + D flops per position, a little above
// its bytes' time at RN = 38, D = 96, R = 6.
//
// Design: a block stages its tile through shared memory transposed,
// uT [D][TL + 1] fp32 (the pitch keeps a warp's column of channels off one
// bank), from coalesced loads of the contiguous (TL, D) tile, 8 raw loads
// in flight per thread (ld_raw_n). The transpose probe scales uT in place
// along its rows and reads it back transposed into coalesced stores. The
// projection probe keeps W_xp and W_dt in shared memory; 4 threads share a
// position, each computing every 4th row of xdbl over D (W_xp broadcast
// across the warp, uT read along the positions), into xdbl [RN][TL + 1];
// then each thread forms one output element (position, channel) from the
// R + 1 rows, in the order of the coalesced store.
#include "common.cuh"

namespace vmt {
namespace probe {

constexpr int TL = 64;          // rows (positions) of a tile
constexpr int TP = TL + 1;      // pitch of the transposed tile
constexpr int NTH = 256;        // threads of a block
constexpr int LE = 8;           // loads in flight per thread
constexpr int RG = NTH / TL;    // proj: threads sharing a position (4)
constexpr int MAX_RN = 64;      // proj: rows of W_xp
constexpr int RPT = MAX_RN / RG;  // proj: xdbl rows per thread (16)
constexpr int MAX_D = 256;      // channels: the tile and W_xp in smem
constexpr int MAX_SMEM = 232448;

// uT [D][TP] <- the n = rows * D elements of u from element `base`, as fp32.
__device__ __forceinline__ void load_tile_t(const void* __restrict__ u,
                                            int dt, long long base, int n,
                                            int D, float* uT) {
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < n; i0 += NTH * LE) {
    uint32_t r[LE];
    ld_raw_n<LE>(
        r, u, dt, [&](int e) { return base + i0 + e * NTH + tid; },
        [&](int e) { return i0 + e * NTH + tid < n; });
#pragma unroll
    for (int e = 0; e < LE; ++e) {
      const int i = i0 + e * NTH + tid;
      if (i < n) uT[(i % D) * TP + i / D] = raw_f32(r[e], dt);
    }
  }
}

__global__ void __launch_bounds__(NTH) transpose_kernel(
    const void* __restrict__ u, int dt, void* __restrict__ y,
    long long rows, int D) {
  extern __shared__ float uT[];  // [D][TP]
  const long long r0 = (long long)blockIdx.x * TL;
  const int nr = (int)min((long long)TL, rows - r0);
  const int n = nr * D;
  const long long base = r0 * D;
  load_tile_t(u, dt, base, n, D, uT);
  __syncthreads();
  // the probe's op on the transposed tile, along its rows
  for (int i = threadIdx.x; i < D * TL; i += NTH) {
    const int d = i / TL, l = i % TL;
    uT[d * TP + l] *= 1.000001f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += NTH) {
    st_act(y, base + i, dt, uT[(i % D) * TP + i / D]);
  }
}

__global__ void __launch_bounds__(NTH) proj_kernel(
    const void* __restrict__ u, int dt, void* __restrict__ y,
    const float* __restrict__ wxp, const float* __restrict__ wdt,
    long long rows, int D, int RN, int R) {
  extern __shared__ float sm[];
  float* uT = sm;                  // [D][TP]
  float* xd = uT + D * TP;         // [RN][TP]
  float* wx = xd + RN * TP;        // [RN][D]
  float* wd = wx + RN * D;         // [D][R]
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * TL;
  const int nr = (int)min((long long)TL, rows - r0);
  const int n = nr * D;
  const long long base = r0 * D;
  for (int i = tid; i < RN * D; i += NTH) wx[i] = wxp[i];
  for (int i = tid; i < D * R; i += NTH) wd[i] = wdt[i];
  load_tile_t(u, dt, base, n, D, uT);
  __syncthreads();
  // xdbl[r][l] = sum_k W_xp[r][k] uT[k][l], rows r = rg + RG j
  {
    const int l = tid % TL, rg = tid / TL;
    float acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
    for (int k = 0; k < D; ++k) {
      const float v = uT[k * TP + l];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = rg + RG * j;
        if (r < RN) acc[j] = fmaf(wx[r * D + k], v, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rg + RG * j;
      if (r < RN) xd[r * TP + l] = acc[j];
    }
  }
  __syncthreads();
  // y[l][d] = sum_{r < R} W_dt[d][r] xdbl[r][l] + 0.5 xdbl[R][l]
  for (int i = tid; i < n; i += NTH) {
    const int l = i / D, d = i % D;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s = fmaf(wd[d * R + r], xd[r * TP + l], s);
    st_act(y, base + i, dt, s + xd[R * TP + l] * 0.5f);
  }
}

}  // namespace probe
}  // namespace vmt

extern "C" int vmt_probe_transpose(const void* u, int dt, void* y,
                                   long long rows, int D, void* stream) {
  using namespace vmt::probe;
  if (D < 1 || D > MAX_D || rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)D * TP;
  int err = vmt::set_smem((const void*)transpose_kernel, smem);
  if (err) return err;
  const unsigned grid = (unsigned)((rows + TL - 1) / TL);
  transpose_kernel<<<grid, NTH, smem, (cudaStream_t)stream>>>(u, dt, y, rows,
                                                               D);
  return (int)cudaGetLastError();
}

extern "C" int vmt_probe_proj(const void* u, int dt, void* y,
                              const float* wxp, const float* wdt,
                              long long rows, int D, int RN, int R,
                              void* stream) {
  using namespace vmt::probe;
  if (D < 1 || D > MAX_D || RN > MAX_RN || R < 0 || R >= RN || rows < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)D * TP + RN * TP + RN * D + D * R);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = vmt::set_smem((const void*)proj_kernel, smem);
  if (err) return err;
  const unsigned grid = (unsigned)((rows + TL - 1) / TL);
  proj_kernel<<<grid, NTH, smem, (cudaStream_t)stream>>>(
      u, dt, y, wxp, wdt, rows, D, RN, R);
  return (int)cudaGetLastError();
}
