// K4: the plain grouped selective scan, forward.
//
// Replaces vmambair_tpu/ops/pallas_scan.py::_scan_kernel (built by
// _build_pallas_fwd). The same recurrence as K1 with delta, B and C given:
//   delta = softplus(delta_raw + bias)  (softplus optional)
//   h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t,  y_t = C_t h_t + D u_t
// Channels fall in G groups; each channel reads its group's B/C stripe.
//
// Layout: every activation is addressed through its strides, so callers
// pass views without copies: u, delta (B, L, D); B, C (B, L, G, N); y is
// written through (B, D, L) strides. Activations are fp32 or bf16 (each its
// own flag); A (D, N), Dskip (D,), bias (D,) fp32 and contiguous.
//
// What bounds it on the H100: the SFU, one exp2 per (b, l, d, n), as K1;
// at the model's calls the work is small (the latent direction pairs,
// (8, 256, 768) served; the channel scans, (8, C, 8) with C = 48 to 384,
// 16 warps of channels), and the launch, the loads' latency and the
// sequential part of the scan set the time.
//
// Design: scan_seg.cuh's skeleton with scan_lpar.cuh's fp32 policy, the
// one K1's passes 1-3 run (a block of 4 warps, a channel each; a lane
// scans 8 consecutive positions in registers and a warp-shuffle tree over
// the lanes joins them, 256 positions a window). The wrapper's segment
// (cuda_scan.k4_segment) decides the grids: where L fits one segment,
// every call of the model's main path, pass 3 runs alone from a zero
// state, one grid and no scratch; longer L takes pass 1, the combine and
// pass 3 over the caller's scratch `work` (hend, aend, hin: 3 B D nseg N
// floats). N up to 16 sits in registers at once; more states go in passes
// of 16 (the skeleton's PASSES), each pass staging its states' B and C
// rows and adding its C h to y, the warp's other states kept in shared
// memory (4 N floats a block); the sum over the states keeps its order.
// The window's loop over the states is unrolled K4_UNR at a time, not
// whole as in K1: at the model's calls a block runs one or two windows, so
// the code runs once and every instruction is fetched cold (the kernels
// between two K4 calls in a forward evict it); an eighth of the code
// costs fewer fetches than the interleaved states save.
//
// The state form (sequence-parallel scans, parallel/sp_scan.py; JAX's
// selective_scan_xla(h0=, return_last_state=), sp_scan.py:82, :97): an
// entering state h0 (B, D, N) fp32, the state before the scan's first
// position (position L - 1 when reverse), and the last state, the one after
// its last position, out to hlast (B, D, N) fp32. Either makes the wrapper
// pass scratch always, so that pass 1 and the combine run even within one
// segment: the combine starts its walk from h0 and ends it on the last
// state (scan_seg.cuh). The null pointers leave every other scan of the
// skeleton as it was, bit for bit (K1's and K3's recorded digests).
//
// K4c, the carry-saving forward of training (replaces _build_pallas_fwd
// with save_carries=True, pallas_scan.py:401-418), is this kernel with a
// non-null `carries`: pass 3 also writes the fp32 state entering every
// chunk of CH positions, in scan order, to carries (B, D, n_chunks, N),
// indexed by the chunk's position in L (the CARRIES form of the policy,
// K1c's), for the backward (K3, selective_scan_bwd.cu) to recompute the
// chunk from. The stores change no arithmetic of y: K4c's y is K4's.
#include "scan_lpar.cuh"

namespace vmt {

constexpr int K4_NS = 16;  // states in registers, a pass's
constexpr int K4_UNR = 2;  // states of the window's loop unrolled at once

// scan_lpar.cuh's policy (K1's, with K1c's carries where CARRIES), named
// for the profiler, which reads no hin where there is one segment, and
// which with PASSES walks N > 16 states in passes of K4_NS.
template <bool CARRIES, bool PASSES_>
struct SelectiveScanFwd : LparScan<K4_NS, false, CARRIES, K4_UNR> {
  using Base = LparScan<K4_NS, false, CARRIES, K4_UNR>;
  static constexpr int NS = K4_NS;
  static constexpr bool PASSES = PASSES_;

  // the entering state: hin's (pass 3 over segments) or zeros (pass 1, or
  // one segment); with passes, all N of them in the warp's row k.hs
  template <bool WRITE_Y>
  __device__ __forceinline__ void init(const SegArgs& a,
                                       const SegBlock<NS>& k) {
    Base::template init<false>(a, k);  // zero states, the carries' places
    const float* hin = WRITE_Y ? a.hin : nullptr;
    if (PASSES) {
      for (int n = k.lane; n < a.N; n += 32) {
        k.hs[n] = hin ? hin[k.hrow * a.N + n] : 0.f;
      }
      __syncwarp();
    }
    if (PASSES || hin) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        this->carry[j] = j >= a.N ? 0.f
                         : PASSES ? k.hs[j]
                                  : hin[k.hrow * a.N + j];
      }
    }
  }

  // the next pass: states `from`.. to the warp's row, states k.n0.. from
  // it (every lane holds the same states, the window's last lane's)
  __device__ __forceinline__ void pass(const SegArgs& a,
                                       const SegBlock<NS>& k, int from) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (k.lane == j && from + j < a.N) k.hs[from + j] = this->carry[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      this->carry[j] = k.n0 + j < a.N ? k.hs[k.n0 + j] : 0.f;
    }
    __syncwarp();
  }

  // pass 1: the segment's end state and decay of every state (with
  // passes, the row holds all N: each window's last pass stored its own)
  __device__ __forceinline__ void finish(const SegArgs& a,
                                         const SegBlock<NS>& k) {
    if constexpr (!PASSES) {
      Base::finish(a, k);
    } else {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        this->dsum += __shfl_xor_sync(FULL, this->dsum, s);
      }
      for (int n = k.lane; n < a.N; n += 32) {
        a.hend[k.hrow * a.N + n] = k.hs[n];
        a.aend[k.hrow * a.N + n] =
            exp2_ftz(a.A[(long long)k.c * a.N + n] * LOG2E * this->dsum);
      }
    }
  }
};

template <bool CARRIES>
static int k4_launch(const SegArgs& a, int B, cudaStream_t st) {
  return a.N > K4_NS ? launch_seg<SelectiveScanFwd<CARRIES, true>>(a, B, st)
                     : launch_seg<SelectiveScanFwd<CARRIES, false>>(a, B, st);
}

}  // namespace vmt

// work: null where L fits one segment of `seg` positions and neither h0
// nor hlast is given, else fp32 scratch of 3 B D ceil(L / seg) N floats
// (cuda_scan.k4_workspace). h0, hlast: (B, D, N) fp32 contiguous, or null.
extern "C" int vmt_selective_scan_fwd(
    const void* u, int u_dt, long long su_b, long long su_l, long long su_d,
    const void* dl, int d_dt, long long sd_b, long long sd_l, long long sd_d,
    const float* A, const void* Bm, int b_dt, long long sb_b, long long sb_l,
    long long sb_g, long long sb_n, const void* Cm, int c_dt, long long sc_b,
    long long sc_l, long long sc_g, long long sc_n, const float* Dskip,
    const float* bias, void* y, int y_dt, long long sy_b, long long sy_d,
    long long sy_l, float* carries, float* work, const float* h0,
    float* hlast, int B, int L, int D, int G, int N, int seg, int reverse,
    int softplus, void* stream) {
  using namespace vmt;
  if (B < 1 || L < 1 || G < 1 || D % G || N < 1 || N > 256 || seg < 1 ||
      B > 65535 || (long long)G * ((D / G + SG_WARPS - 1) / SG_WARPS) >
                       65535 || ((h0 || hlast) && !work)) {
    return (int)cudaErrorInvalidValue;
  }
  const int Dg = D / G;
  const long long hs =
      (long long)B * D * ((L + seg - 1) / seg) * N;  // each of the three
  const SegArgs a{
      u, u_dt, su_b, Dg * su_d, su_l, su_d,
      dl, d_dt, sd_b, Dg * sd_d, sd_l, sd_d,
      A,
      Bm, b_dt, sb_b, sb_g, sb_l, sb_n,
      Cm, c_dt, sc_b, sc_g, sc_l, sc_n,
      Dskip, bias,
      y, y_dt, sy_b, Dg * sy_d, sy_l, sy_d,
      nullptr, work, work ? work + hs : nullptr,
      work ? work + 2 * hs : nullptr, nullptr, nullptr,
      G, L, Dg, N, seg, seg, reverse, softplus, carries, h0, hlast};
  cudaStream_t st = (cudaStream_t)stream;
  return carries ? k4_launch<true>(a, B, st) : k4_launch<false>(a, B, st);
}
