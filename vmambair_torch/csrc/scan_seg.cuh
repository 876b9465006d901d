// The skeleton the L-parallel segmented scans share (scan_lpar.cu,
// scan_stack_bf16.cu, K1's passes 1-3 in oss_scan_fused.cu, and K4 in
// selective_scan.cu).
//
// Layout: u, delta and y addressed through (b, g, l, d) strides, B and C
// through (b, g, l, n) strides, so the DL (B, D, L) and the LD (B, L, D)
// layouts run alike. Activations fp32 or bf16; A (G*Dg, N), Dskip, bias
// fp32.
//
// Three launches on the caller's stream (no grid-wide sync). L is cut into
// segments of `seg` positions at the forward scan's positions (reverse
// scans too):
//  1. seg_scan_kernel<.., false, P>, grid (segment, group x channel tile,
//     b): each segment is scanned from a zero state; the policy P writes
//     its end state hend[b, c, s, n] and its fp32 decay aend[b, c, s, n].
//  2. seg_scan_combine, one thread per (b, c, n): a walk over the segments
//     in scan order (back to front when reverse) gives each its entering
//     state, hin[s] = h; h = aend[s] h + hend[s].
//  3. seg_scan_kernel<.., true, P>: each segment again, from hin, writing y.
// A scan with one segment may pass no hin: pass 3 then runs alone, from a
// zero state (the policy's init reads none), and needs no scratch.
// A block is 4 warps, one channel each, of one group; it walks its segment
// in windows of 256 positions (32 lanes x KP = 8 consecutive positions).
// Per window the block stages the group's B (and C) rows in shared memory
// once for its 4 channels, loaded along L (dynamic shared memory, NS rows
// of each: B and C take 33 KB at NS = 16, 66 KB at 32); each lane converts
// its own 8 positions' u and delta (softplus included). Positions past the
// segment get delta = 0 and u = 0, which leave a state as it is. What a
// window does with them is the policy's: scan_lpar.cuh's fp32 scan (and
// v16's reverse beside it; K1c's carries), scan_stack_bf16.cu's bf16
// stacks.
// A policy with PASSES = true walks N states in passes of NS (K4, N up to
// 256): per window, after the lane's u and delta, each pass stages its
// states' B (and C) rows and runs the policy's window on them, y summing
// over the passes; between passes the policy swaps its registers with
// the warp's state row in shared memory (SegBlock::hs, N floats, after
// the rows), which also holds every state for pass 1's finish. Without
// it, N <= NS and the one pass's code is the skeleton's without passes.
//
// A policy P is a struct with NS (states in registers) and
//   init<WRITE_Y>(a, k)      registers at the segment's start
//   pre<WRITE_Y>(a, k, w0, dv, yv)   before the window's staging
//   window<WRITE_Y>(a, k, w0, dv, du, b_s, c_s, yv)   the window's scan:
//                            adds C h to yv (yv enters as D u)
//   store(a, at, p)          further outputs of position p at offset at
//   finish(a, k)             pass 1's hend and aend (active warps only)
// and, with PASSES,
//   pass(a, k, from)         registers of states k.n0.. in place of
//                            those of states from.. (k.a2 already k.n0's)
#pragma once

#include <type_traits>

#include "common.cuh"

namespace vmt {

constexpr int SG_KP = 8;      // consecutive positions per lane
constexpr int SG_WIN = 32 * SG_KP;
constexpr int SG_WARPS = 4;   // channels to a block, one per warp
constexpr int SG_THREADS = 32 * SG_WARPS;
constexpr int SG_PP = 33;     // shared pitch of a position-in-lane row
constexpr int SG_MAX_N = 32;   // K1's limit; the probes' launches keep 16
constexpr unsigned FULL = 0xffffffffu;

// a window's staged B or C rows: state n at [n][p * SG_PP + lane] for the
// window's position 8 lane + p, conflict-free for the lanes' reads
using SegRows = float[SG_KP * SG_PP];

// Everything both passes read, in the order of the exported functions'
// parameters; a scan leaves the pointers it does not use null.
struct SegArgs {
  const void* u; int u_dt; long long su_b, su_g, su_l, su_d;
  const void* dl; int d_dt; long long sd_b, sd_g, sd_l, sd_d;
  const float* A;
  const void* Bm; int b_dt; long long sb_b, sb_g, sb_l, sb_n;
  const void* Cm; int c_dt; long long sc_b, sc_g, sc_l, sc_n;
  const float* Dskip; const float* bias;
  void* y; int y_dt; long long sy_b, sy_g, sy_l, sy_d;
  void* y2;                    // v16's second output
  float* hend; float* aend; float* hin;  // (B, G*Dg, nseg, N)
  float* rtot; float* rdec;    // v16's per-window reverse totals
  int G, L, Dg, N, seg, sub, reverse, softplus;
  float* carries;              // K1c: (B, G*Dg, ceil(L / CH), N), or null
};

// A block's place: its lane, channel, segment and (b, c, s) row.
template <int NS>
struct SegBlock {
  int lane, c, s0, slen;
  bool active;     // the warp's channel exists (else it stages only)
  long long hrow;  // (b, c, s)
  int n0;          // the pass's first state (0 without passes)
  float* hs;       // PASSES: the warp's N states in shared memory
  float a2[NS];    // A log2(e) of states n0 + j, 0 past N
  // position of scan index i of the segment
  __device__ __forceinline__ int pos(const SegArgs& a, int i) const {
    return a.reverse ? s0 + slen - 1 - i : s0 + i;
  }
};

// whether policy P walks the states in passes (its PASSES, else false)
template <class P, class = void>
struct SegPasses : std::false_type {};
template <class P>
struct SegPasses<P, std::void_t<decltype(P::PASSES)>>
    : std::bool_constant<P::PASSES> {};

// shared memory of a pass: NS rows of B, and of C where it writes y;
// with passes, the warps' state rows after them
template <class P, bool WRITE_Y>
size_t seg_smem(int N) {
  return (WRITE_Y ? 2 : 1) * P::NS * sizeof(SegRows) +
         (SegPasses<P>::value ? SG_WARPS * (size_t)N * sizeof(float) : 0);
}

template <int NS, bool WRITE_Y, class P>
__global__ void __launch_bounds__(SG_THREADS)
    seg_scan_kernel(const __grid_constant__ SegArgs a) {
  constexpr bool PASSES = SegPasses<P>::value;
  extern __shared__ float sg_sm[];
  SegRows* b_s = reinterpret_cast<SegRows*>(sg_sm);
  SegRows* c_s = b_s + NS;  // pass 3 only
  SegBlock<NS> k;
  k.lane = threadIdx.x & 31;
  k.n0 = 0;
  k.hs = PASSES ? sg_sm + (WRITE_Y ? 2 : 1) * NS * SG_KP * SG_PP +
                      (threadIdx.x >> 5) * a.N
                : nullptr;
  const int npass = PASSES ? (a.N + NS - 1) / NS : 1;
  const int ntile = (a.Dg + SG_WARPS - 1) / SG_WARPS;
  const int g = blockIdx.y / ntile;
  const int d = (blockIdx.y % ntile) * SG_WARPS + (threadIdx.x >> 5);
  // a warp past the group's channels stages with the block and writes
  // nothing: it reads the group's last channel
  k.active = d < a.Dg;
  k.c = g * a.Dg + min(d, a.Dg - 1);
  const int b = blockIdx.z;
  k.s0 = blockIdx.x * a.seg;
  k.slen = min(a.seg, a.L - k.s0);
  k.hrow = ((long long)b * a.G * a.Dg + k.c) * gridDim.x + blockIdx.x;
  // states n0 .. n0 + NS - 1 in registers: A, and the policy's own
  auto to_pass = [&](int n0) {
    const int from = k.n0;
    k.n0 = n0;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      k.a2[j] = n0 + j < a.N ? a.A[(long long)k.c * a.N + n0 + j] * LOG2E
                             : 0.f;
    }
    return from;
  };
  to_pass(0);
  P pol;
  pol.template init<WRITE_Y>(a, k);
  const int cd = k.c - g * a.Dg;
  const float dsk = a.Dskip ? a.Dskip[k.c] : 0.f;
  const float bs = a.bias ? a.bias[k.c] : 0.f;
  const long long ub = b * a.su_b + g * a.su_g + cd * a.su_d;
  const long long db = b * a.sd_b + g * a.sd_g + cd * a.sd_d;
  const long long yb = b * a.sy_b + g * a.sy_g + cd * a.sy_d;
  const long long bb = b * a.sb_b + g * a.sb_g;
  const long long cb = b * a.sc_b + g * a.sc_g;
  auto pos = [&](int i) { return k.pos(a, i); };
  for (int w0 = 0; w0 < k.slen; w0 += SG_WIN) {
    const int wlen = min(SG_WIN, k.slen - w0);
    // this lane's positions (scan index w0 + KP * lane + p) and the
    // window's B (and C) rows, thread q staging window positions q and
    // q + 128 of every row: raw bits (ld_raw_n), all of a thread's loads in
    // flight at once, converted after.
    int tp[SG_KP];
#pragma unroll
    for (int p = 0; p < SG_KP; ++p) {
      const int i = SG_KP * k.lane + p;
      tp[p] = i < wlen ? pos(w0 + i) : -1;
    }
    int tq[2];  // the staged positions q, q + 128
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int q = threadIdx.x + SG_THREADS * hq;
      tq[hq] = q < wlen ? pos(w0 + q) : -1;
    }
    uint32_t ru[SG_KP], rd[SG_KP], rb[2 * NS], rc[2 * NS];
    auto lane_ok = [&](int p) { return tp[p] >= 0; };
    ld_raw_n(ru, a.u, a.u_dt, [&](int p) { return ub + tp[p] * a.su_l; },
             lane_ok);
    ld_raw_n(rd, a.dl, a.d_dt, [&](int p) { return db + tp[p] * a.sd_l; },
             lane_ok);
    // staged element e: state n0 + e % NS of position tq[e / NS]; rows
    // past N and positions past the window stay 0
    auto ld_rows = [&]() {
      const int n0 = PASSES ? k.n0 : 0;
      auto row_ok = [&](int e) {
        return n0 + e % NS < a.N && tq[e / NS] >= 0;
      };
#pragma unroll
      for (int e = 0; e < 2 * NS; ++e) rb[e] = rc[e] = 0u;
      ld_raw_n(rb, a.Bm, a.b_dt,
               [&](int e) {
                 return bb + (n0 + e % NS) * a.sb_n + tq[e / NS] * a.sb_l;
               },
               row_ok);
      if (WRITE_Y) {
        ld_raw_n(rc, a.Cm, a.c_dt,
                 [&](int e) {
                   return cb + (n0 + e % NS) * a.sc_n + tq[e / NS] * a.sc_l;
                 },
                 row_ok);
      }
    };
    ld_rows();
    float dv[SG_KP], du[SG_KP], yv[SG_KP];
#pragma unroll
    for (int p = 0; p < SG_KP; ++p) {
      float dd = 0.f, uu = 0.f;
      if (tp[p] >= 0) {
        uu = raw_f32(ru[p], a.u_dt);
        dd = raw_f32(rd[p], a.d_dt) + bs;
        if (a.softplus) dd = softplus20(dd);
      }
      dv[p] = dd;
      du[p] = dd * uu;
      yv[p] = dsk * uu;
    }
    pol.template pre<WRITE_Y>(a, k, w0, dv, yv);
    for (int ps = 0;;) {
      __syncthreads();  // the previous window's reads of b_s, c_s are done
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int q = threadIdx.x + SG_THREADS * hq;
        const int at = (q % SG_KP) * SG_PP + q / SG_KP;
#pragma unroll
        for (int j = 0; j < NS; ++j) {  // rows past N are zeros
          b_s[j][at] = raw_f32(rb[hq * NS + j], a.b_dt);
          if (WRITE_Y) c_s[j][at] = raw_f32(rc[hq * NS + j], a.c_dt);
        }
      }
      __syncthreads();
      pol.template window<WRITE_Y>(a, k, w0, dv, du, b_s, c_s, yv);
      if constexpr (!PASSES) {
        break;
      } else {
        if (++ps == npass) break;
        pol.pass(a, k, to_pass(ps * NS));
        ld_rows();
      }
    }
    if constexpr (PASSES) {
      if (npass > 1) pol.pass(a, k, to_pass(0));  // the next window's first
    }
    if (WRITE_Y && k.active) {
#pragma unroll
      for (int p = 0; p < SG_KP; ++p) {
        if (tp[p] >= 0) {
          const long long at = yb + tp[p] * a.sy_l;
          st_act(a.y, at, a.y_dt, yv[p]);
          pol.store(a, at, p);
        }
      }
    }
  }
  if (!WRITE_Y && k.active) pol.finish(a, k);
}

// Pass 2: the entering state of every segment, one thread per (b, c, n).
// (static: each source that includes this header keeps its own; the
// policy names it, so that a profile tells the scans' combines apart)
template <class P>
static __global__ void seg_scan_combine(const float* __restrict__ hend,
                                        const float* __restrict__ aend,
                                        float* __restrict__ hin,
                                        long long rows, int N, int nseg,
                                        int reverse) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * N) return;
  const int n = (int)(idx % N);
  const long long bc = idx / N;  // b * D + c
  float h = 0.f;
  for (int i = 0; i < nseg; ++i) {
    const int s = reverse ? nseg - 1 - i : i;
    const long long at = (bc * nseg + s) * N + n;
    hin[at] = h;
    h = aend[at] * h + hend[at];
  }
}

template <class P>
static int launch_seg(const SegArgs& a, int B, cudaStream_t st) {
  const int nseg = (a.L + a.seg - 1) / a.seg;
  if (!a.hin && nseg > 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(nseg, a.G * ((a.Dg + SG_WARPS - 1) / SG_WARPS), B);
  const size_t sm3 = seg_smem<P, true>(a.N);
  int err = set_smem((const void*)seg_scan_kernel<P::NS, true, P>, sm3);
  if (err) return err;
  if (a.hin) {  // pass 1 and the combine
    const size_t sm1 = seg_smem<P, false>(a.N);
    err = set_smem((const void*)seg_scan_kernel<P::NS, false, P>, sm1);
    if (err) return err;
    seg_scan_kernel<P::NS, false, P><<<grid, SG_THREADS, sm1, st>>>(a);
    err = (int)cudaGetLastError();
    if (err) return err;
    const long long rows = (long long)B * a.G * a.Dg;
    seg_scan_combine<P>
        <<<(unsigned)((rows * a.N + 255) / 256), 256, 0, st>>>(
            a.hend, a.aend, a.hin, rows, a.N, nseg, a.reverse);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  seg_scan_kernel<P::NS, true, P><<<grid, SG_THREADS, sm3, st>>>(a);
  return (int)cudaGetLastError();
}

// The launch for N states in the smallest register count of 4, 8, 16
// (and 32 where MAXN allows it); the sizes every segmented scan refuses.
template <template <int> class P, int MAXN = 16>
static int launch_seg_n(const SegArgs& a, int B, void* stream) {
  static_assert(MAXN == 16 || MAXN == SG_MAX_N, "16 or 32 states");
  const long long tiles = (long long)a.G * ((a.Dg + SG_WARPS - 1) / SG_WARPS);
  if (a.N < 1 || a.N > MAXN || a.seg < 1 || a.L < 1 || a.Dg < 1 ||
      B > 65535 || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (a.N <= 4) return launch_seg<P<4>>(a, B, st);
  if (a.N <= 8) return launch_seg<P<8>>(a, B, st);
  if (MAXN == 16 || a.N <= 16) return launch_seg<P<16>>(a, B, st);
  return launch_seg<P<MAXN>>(a, B, st);
}

}  // namespace vmt
