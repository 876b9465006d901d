// K1: the projection-fused spatial selective scan, forward.
//
// Replaces vmambair_tpu/ops/pallas_scan.py::_fused_kernel (built by
// _build_fused_fwd). For each (batch b, direction group g) and position, in
// scan order (reverse: back to front):
//   x_dbl = Wxp[g] . u            (R + 2N rows, fp32 sums)
//   delta = softplus(Wdt[g] . x_dbl[:R] + bias[g])
//   B, C  = x_dbl[R:R+N], x_dbl[R+N:]
//   h_t   = exp(delta_t A) h_{t-1} + delta_t B_t u_t,  y_t = C_t h_t + D u_t
// with the state in fp32; y in u's dtype.
//
// Layout: u, y (B, G, D, L) contiguous (the Dl policy), or (B, G, L, D)
// contiguous (the Ld policy, below), fp32 or bf16; Wxp (G, R+2N, D), Wdt
// (G, D, R), bias (G, D), A (G, D, N) (already -exp(A_log)), Ds (G, D), all
// fp32. `work`: fp32 scratch the caller allocates, B G L (2N + D) + 3 B G D
// nseg N floats (nseg = ceil(L / seg); cuda_scan.k1_workspace).
//
// What bounds it on the H100: the SFU. The function needs one exp2 per
// (b, l, d, n) (0.0963 ms at (8, 2, 96, 16384), N 16, at the SFU's nominal
// 16 exp2 per clock per SM); this design takes two (passes 1 and 3 each
// take one: 0.193 ms). Bytes (u read, y written) and the projection's fp32
// operations are below that.
//
// Design: four grids on the caller's stream, no grid-wide sync, no
// atomics, fixed orders only (two calls give the same bits).
//  0. oss_scan_fused_proj_kernel, grid (L / 64, G, B): a block stages the
//     group's Wxp and Wdt and u of 64 positions for all D channels in
//     shared memory, computes x_dbl once per (b, g, position) (fp32 sums
//     over the channels in order on the CUDA cores, as the TPU kernel's
//     preferred_element_type=float32), writes its B and C rows to scratch
//     (B, G, 2N, L) and delta, bias and softplus applied, to scratch
//     (B, G, D, L): the design (A) of writing delta out, at 2.4 kB of
//     device traffic per (b, g, position) at D = 96 bf16, against (B)'s
//     1.2 kB of recomputing delta from x_dbl's R rows in passes 1 and 3;
//     softplus then runs once per (b, d, l), not in both passes.
//  1-3. scan_seg.cuh's skeleton with scan_lpar.cuh's policy: pass 1 scans
//     each segment of `seg` positions from zero and keeps its end state
//     and decay, seg_scan_combine chains the segments, pass 3 replays each
//     segment from its entering state and writes y. B and C are read from
//     the scratch rows through the skeleton's (b, g, l, n) strides, delta
//     through its (b, g, l, d) ones. The segment length is the caller's:
//     cuda_scan.k1_segment picks it from L and the grid (1024 positions,
//     halved down to 256 while the grid has fewer than 1056 blocks).
// What this does about the chunk walk it replaced (one block per (b, g,
// tile of 12 channels) walking all L / 32 chunks in order, each tile
// recomputing x_dbl for its chunk):
//  - blocks: B G ceil(D / 4) ceil(L / seg) of 4 warps (6144 at (8, 2, 96,
//    16384)), against 64 to 128 blocks of 8 warps on 132 SMs;
//  - the walk over L: segments run in parallel, and inside a window of 256
//    positions a lane scans its 8 positions and a warp-shuffle tree joins
//    the lanes; only the windows of a segment and the segments' combine
//    (one FMA per segment) are sequential;
//  - the projection: once per position, not once per channel tile (4x to
//    16x the work before).
//
// K1c, the carry-saving forward of training (replaces _build_fused_fwd
// with save_carries=True, pallas_scan.py:1161-1175), is this kernel with a
// non-null `carries`: pass 3 also writes the fp32 state entering every
// chunk of CH positions, in scan order, to carries (B, G*D, n_chunks, N),
// indexed by the chunk's position in L: the layout of K4c, so the one
// backward kernel (K3, selective_scan_bwd.cu) serves both. It runs K1's
// pass 0 and K1's scan policy with the carries' stores added to pass 3
// (scan_lpar.cuh, CARRIES), which change no arithmetic of y: K1c's y is
// K1's, bit for bit (the CUDA tests and chip_smoke.py hold it so).
//
// kldio's kernel (replaces tools/kldio.py::_ld_kernel, the TPU probe that
// reads u and writes y channels-last) is this kernel with the Ld layout
// policy, exported as vmt_oss_scan_fused_ld_fwd. The policy changes only
// where u is read (pass 0 stages its tile in memory order, runs of
// channels) and where passes 1 and 3 read u and write y (their strides):
// every sum is the Dl kernel's, in its order, so the two give the same
// bits.
#include "scan_lpar.cuh"

namespace vmt {

constexpr int P0_TP = 64;                  // positions of a pass-0 block
constexpr int P0_THREADS = 256;
constexpr int P0_NG = P0_THREADS / 32;     // row groups, a warp each
constexpr int P0_PITCH = P0_TP + 1;        // u tile's row pitch
constexpr int P0_RB = 5;                   // x_dbl rows a thread sums at once
constexpr int P0_LOADS = 8;                // u loads a thread has in flight

// Layout policies of u and y: element i of a pass-0 tile in memory order
// is channel c, position t of the tile (split); at() is the offset of
// (c, position) in the (b, g) slab of D x L elements, su_l/su_d the slab's
// strides along L and along the channels.
struct Dl {  // (B, G, D, L): positions fastest
  __device__ static __forceinline__ void split(int i, int D, int& c,
                                               int& t) {
    c = i / P0_TP;
    t = i % P0_TP;
  }
  static long long su_l(int D, int L) { return 1; }
  static long long su_d(int D, int L) { return L; }
  __device__ static __forceinline__ long long at(int c, int t, int D,
                                                 int L) {
    return (long long)c * L + t;
  }
};

struct Ld {  // (B, G, L, D): channels fastest; a tile is one (len, D) run
  __device__ static __forceinline__ void split(int i, int D, int& c,
                                               int& t) {
    c = i % D;
    t = i / D;
  }
  static long long su_l(int D, int L) { return D; }
  static long long su_d(int D, int L) { return 1; }
  __device__ static __forceinline__ long long at(int c, int t, int D,
                                                 int L) {
    return (long long)t * D + c;
  }
};

// Pass 0: x_dbl of P0_TP positions of one (b, g); B and C rows to xbc
// (B, G, 2N, L), delta to (B, G, D, L), both fp32.
template <class Lay>
__global__ void __launch_bounds__(P0_THREADS) oss_scan_fused_proj_kernel(
    const void* __restrict__ u, int dt, const float* __restrict__ wxp,
    const float* __restrict__ wdt, const float* __restrict__ bias,
    float* __restrict__ xbc, float* __restrict__ delta, int G, int D, int L,
    int N, int R, int softplus) {
  extern __shared__ float sm[];
  const int M = R + 2 * N;
  const int g = blockIdx.y;
  const long long bg = (long long)blockIdx.z * G + g;  // b * G + g
  const int t0 = blockIdx.x * P0_TP;
  const int len = min(P0_TP, L - t0);
  const int tid = threadIdx.x;

  float* w_s = sm;                  // [M][D]   x_proj of group g
  float* u_s = w_s + M * D;         // [D][P0_PITCH]
  float* r_s = u_s + D * P0_PITCH;  // [R][P0_TP]  x_dbl's dt rows
  float* wdt_s = r_s + R * P0_TP;   // [D][R]
  float* bias_s = wdt_s + D * R;    // [D]

  for (int i = tid; i < M * D; i += P0_THREADS) {
    w_s[i] = wxp[(long long)g * M * D + i];
  }
  for (int i = tid; i < D * R; i += P0_THREADS) {
    wdt_s[i] = wdt[(long long)g * D * R + i];
  }
  for (int i = tid; i < D; i += P0_THREADS) bias_s[i] = bias[g * D + i];

  // u's tile in memory order, P0_LOADS loads of a thread in flight at
  // once; positions past L stage as 0
  const long long ub = bg * D * L;
  const int n = D * P0_TP;
  for (int i0 = 0; i0 < n; i0 += P0_LOADS * P0_THREADS) {
    uint32_t r[P0_LOADS];
    int cc[P0_LOADS], tt[P0_LOADS];
#pragma unroll
    for (int e = 0; e < P0_LOADS; ++e) {
      Lay::split(i0 + e * P0_THREADS + tid, D, cc[e], tt[e]);
      r[e] = 0u;
    }
    ld_raw_n(r, u, dt,
             [&](int e) { return ub + Lay::at(cc[e], t0 + tt[e], D, L); },
             [&](int e) {
               return i0 + e * P0_THREADS + tid < n && tt[e] < len;
             });
#pragma unroll
    for (int e = 0; e < P0_LOADS; ++e) {
      if (i0 + e * P0_THREADS + tid < n) {
        u_s[cc[e] * P0_PITCH + tt[e]] = raw_f32(r[e], dt);
      }
    }
  }
  __syncthreads();

  // x_dbl: lane pl of warp rg sums, for positions pl and pl + 32, rows
  // rg, rg + NG, ..., P0_RB at a time, over the channels in order (the
  // warp's weights one broadcast, 16 bytes at a time where the rows are
  // 16-byte aligned: D % 4 == 0)
  const int pl = tid % 32, rg = tid / 32;
  const int nr = (M - rg + P0_NG - 1) / P0_NG;
  const int D4 = D % 4 == 0 ? D : 0;
  for (int q0 = 0; q0 < nr; q0 += P0_RB) {
    float a0[P0_RB], a1[P0_RB];
    const float* wrow[P0_RB];
#pragma unroll
    for (int q = 0; q < P0_RB; ++q) {
      a0[q] = a1[q] = 0.f;
      // rows past the thread's read row rg and are dropped
      wrow[q] = w_s + (q0 + q < nr ? rg + (q0 + q) * P0_NG : rg) * D;
    }
    for (int c = 0; c < D4; c += 4) {
      float u0[4], u1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u0[e] = u_s[(c + e) * P0_PITCH + pl];
        u1[e] = u_s[(c + e) * P0_PITCH + pl + 32];
      }
#pragma unroll
      for (int q = 0; q < P0_RB; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(wrow[q] + c);
        a0[q] = fmaf(w.x, u0[0], a0[q]);
        a1[q] = fmaf(w.x, u1[0], a1[q]);
        a0[q] = fmaf(w.y, u0[1], a0[q]);
        a1[q] = fmaf(w.y, u1[1], a1[q]);
        a0[q] = fmaf(w.z, u0[2], a0[q]);
        a1[q] = fmaf(w.z, u1[2], a1[q]);
        a0[q] = fmaf(w.w, u0[3], a0[q]);
        a1[q] = fmaf(w.w, u1[3], a1[q]);
      }
    }
    for (int c = D4; c < D; ++c) {
      const float v0 = u_s[c * P0_PITCH + pl];
      const float v1 = u_s[c * P0_PITCH + pl + 32];
#pragma unroll
      for (int q = 0; q < P0_RB; ++q) {
        a0[q] = fmaf(wrow[q][c], v0, a0[q]);
        a1[q] = fmaf(wrow[q][c], v1, a1[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < P0_RB; ++q) {
      const int row = rg + (q0 + q) * P0_NG;
      if (q0 + q >= nr) continue;
      if (row < R) {
        r_s[row * P0_TP + pl] = a0[q];
        r_s[row * P0_TP + pl + 32] = a1[q];
      } else {
        float* o = xbc + (bg * 2 * N + row - R) * L + t0;
        if (pl < len) o[pl] = a0[q];
        if (pl + 32 < len) o[pl + 32] = a1[q];
      }
    }
  }
  __syncthreads();

  // delta: lane pl of warp rg takes positions pl and pl + 32 of channels
  // rg, rg + NG, ...
  for (int c = rg; c < D; c += P0_NG) {
    float d0 = 0.f, d1 = 0.f;
    for (int r = 0; r < R; ++r) {
      const float w = wdt_s[c * R + r];
      d0 = fmaf(w, r_s[r * P0_TP + pl], d0);
      d1 = fmaf(w, r_s[r * P0_TP + pl + 32], d1);
    }
    d0 += bias_s[c];
    d1 += bias_s[c];
    float* o = delta + (bg * D + c) * L + t0;
    if (pl < len) o[pl] = softplus ? softplus20(d0) : d0;
    if (pl + 32 < len) o[pl + 32] = softplus ? softplus20(d1) : d1;
  }
}

// Passes 1-3's policies: the L-parallel scan, and for K1c the same scan
// with its carries (each named, so that a profile tells K1's grids from
// the probes'). The carries cost K1c's pass 3 about a quarter of its time
// with or without a carries pointer (the H100, (8, 2, 96, 16384) bf16), so
// K1 takes the policy without them.
template <int NS>
struct OssFusedScan : LparScan<NS, false, false> {};
template <int NS>
struct OssFusedScanCarries : LparScan<NS, false, true> {};

template <class Lay>
static int fused_fwd(const void* u, int dt, void* y, const float* wxp,
                     const float* wdt, const float* bias, const float* A,
                     const float* Ds, float* carries, float* work, int B,
                     int G, int D, int L, int N, int R, int seg, int reverse,
                     int softplus, void* stream) {
  const int M = R + 2 * N;
  const size_t smem = sizeof(float) *
      ((size_t)M * D + (size_t)D * P0_PITCH + (size_t)R * P0_TP +
       (size_t)D * R + (size_t)D);
  if (B < 1 || G < 1 || D < 1 || L < 1 || N < 1 || R < 1 || seg < 1 ||
      B > 65535 || G > 65535 || smem > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const long long slab = (long long)B * G * L;
  const long long hs = (long long)B * G * D * ((L + seg - 1) / seg) * N;
  float* xbc = work;                   // (B, G, 2N, L)
  float* dl = xbc + slab * 2 * N;      // (B, G, D, L)
  float* hend = dl + slab * D;         // (B, G*D, nseg, N), three of them
  cudaStream_t st = (cudaStream_t)stream;
  int err = set_smem((const void*)oss_scan_fused_proj_kernel<Lay>, smem);
  if (err) return err;
  oss_scan_fused_proj_kernel<Lay>
      <<<dim3((L + P0_TP - 1) / P0_TP, G, B), P0_THREADS, smem, st>>>(
          u, dt, wxp, wdt, bias, xbc, dl, G, D, L, N, R, softplus);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long sl = Lay::su_l(D, L), sd = Lay::su_d(D, L);
  const long long gs = (long long)D * L, ns = (long long)2 * N * L;
  const SegArgs a{
      u, dt, G * gs, gs, sl, sd,                      // u
      dl, DT_F32, G * gs, gs, 1, L,                   // delta (B, G, D, L)
      A,
      xbc, DT_F32, G * ns, ns, 1, L,                  // B rows
      xbc + (long long)N * L, DT_F32, G * ns, ns, 1, L,  // C rows
      Ds, nullptr,                                    // bias: in pass 0
      y, dt, G * gs, gs, sl, sd,                      // y, u's layout
      nullptr, hend, hend + hs, hend + 2 * hs, nullptr, nullptr,
      G, L, D, N, seg, seg, reverse, 0, carries};     // softplus: pass 0
  return carries ? launch_seg_n<OssFusedScanCarries, SG_MAX_N>(a, B, stream)
                 : launch_seg_n<OssFusedScan, SG_MAX_N>(a, B, stream);
}

}  // namespace vmt

extern "C" int vmt_oss_scan_fused_fwd(
    const void* u, int dt, void* y, const float* wxp, const float* wdt,
    const float* bias, const float* A, const float* Ds, float* carries,
    float* work, int B, int G, int D, int L, int N, int R, int seg,
    int reverse, int softplus, void* stream) {
  return vmt::fused_fwd<vmt::Dl>(u, dt, y, wxp, wdt, bias, A, Ds, carries,
                                 work, B, G, D, L, N, R, seg, reverse,
                                 softplus, stream);
}

// kldio: u, y (B, G, L, D); the rest as vmt_oss_scan_fused_fwd (no carries)
extern "C" int vmt_oss_scan_fused_ld_fwd(
    const void* u, int dt, void* y, const float* wxp, const float* wdt,
    const float* bias, const float* A, const float* Ds, float* work, int B,
    int G, int D, int L, int N, int R, int seg, int reverse, int softplus,
    void* stream) {
  return vmt::fused_fwd<vmt::Ld>(u, dt, y, wxp, wdt, bias, A, Ds, nullptr,
                                 work, B, G, D, L, N, R, seg, reverse,
                                 softplus, stream);
}
