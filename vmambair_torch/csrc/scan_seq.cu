// The sequential register scan, L split over segments: K7 and the
// sequential probes.
//
// Replaces vmambair_tpu/ops/pallas_scan.py::_scan_kernel_ld (K7, the
// channels-last scan, built by _build_pallas_fwd_ld), the probes
// tools/kseq.py::kernel_seq and kernel_seq_win ((G, L, 8, Dg) layout) and,
// on the channels-last layout, tools/kvariants.py::kernel_v12_ld. The
// recurrence is K4's:
//   delta = softplus(delta_raw + bias)  (softplus optional)
//   h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t,  y_t = C_t h_t + D u_t
//
// Layout: every activation is addressed through (b, g, l, d) strides, B and
// C through (b, g, l, n), so one kernel reads all the probes' layouts
// without copies: K7's (B, L, D) with B/C as (B, G, N, L, 1); kseq's
// (G, L, 8, Dg) with B/C as (G, L, N, 8, 1); the DL probes' (B, D, L) with
// B/C as (B, G, N, L). Activations fp32 or bf16 (each its own flag), y in
// its own dtype; A (G*Dg, N), Dskip, bias (G*Dg,) fp32 and contiguous.
//
// Design: a thread walks positions in order with its fp32 states in
// registers, as the TPU could not (Mosaic spilled kseq's 16-vreg state to
// VMEM every step, tools/kseq.py:28-41); there is no cross-lane scan. A
// block is one warp: 32 consecutive channels of one group (lanes past Dg
// stage and write nothing) over one segment of `seg` positions, so the
// grid is B * G * ceil(Dg / 32) * ceil(L / seg) warps and fills the card
// (the wrapper's cuda_scan.seq_segment, by the warps of the call's instance
// that the card holds at once: vmt_scan_seq_resident, below). Over more
// than one segment, three
// launches on the caller's stream, as scan_seg.cuh's:
//  1. each segment walked from a zero state: its end state to hbuf[b, s, n,
//     c] and its sum of delta to dsum[b, s, c] (the segment's decay is
//     exp2(A log2(e) sum), taken by the combine);
//  2. the combine, a thread per (b, n, c): the segments in scan order (back
//     to front when reverse), each one's entering state written over its
//     end state in hbuf;
//  3. each segment walked again from its entering state, writing y.
// Within one segment pass 3 runs alone from zero, without scratch.
// Segments sit at forward positions; a reverse scan walks each back to
// front. A segment is staged in windows of `win` positions (1, 8 or 16;
// WCAP, a template argument, >= win): u, delta, B_t and C_t are loaded
// with consecutive threads on whichever index is contiguous in memory
// (along L for the DL layout: the window is staged transposed, so global
// loads run along L), all of a thread's loads in flight at once as raw
// bits (ld_raw_step), and stored to shared memory in fp32. Before its walk
// each lane takes its own column of the window's delta through the
// channel's bias and softplus (softplus_fast; the positions are
// independent of each other and of h); the walk reads B_t and C_t as
// 16-byte broadcasts and issues a position's NS exp2s before its FMA
// chain (they do not depend on h). y leaves through shared memory, stored
// along the contiguous index. win = 1 is kseq's kernel_seq, 8 and 16 its
// kernel_seq_win.
// N up to 16 sits in registers (NS: 8 or 16); more states (K7, up to 256)
// go in register passes of 16 over each window (PASSES): each pass loads
// its states' A and their values from a row of shared memory (N floats a
// lane), walks the window and puts them back, y summed over the passes in
// shared memory (the window of 8: SEQ_PASS_WIN).
//
// What bounds it on the H100: the function takes one exp2 per (b, l, d,
// n); the two walks take two, so the design's bound is twice the
// function's (0.193 against 0.0963 ms at (8, 16384, 2 x 96, N = 16)). A
// thread per (b, channel) over all of L put 48 warps on the card at that
// shape, one to an SM, bound by one warp's latency (8.4 ms on an H100).
// The segments put 16 warps on every SM (a walk of 16 states holds about
// 120 registers), and there the issue of each position's ~100
// instructions, with the loads' latency only partly hidden by the other
// warps, sets the time (0.51 ms on an H100, PERF.md §6). tools/kwalk.py
// races edits of this source against it: the next window's raw bits in
// registers during the walk, 20 to 32 resident warps an SM (fewer
// registers a thread), exp2 on the FMA pipe for half the states; none
// was faster on both layouts. The ptxas report in build.log gives the
// registers and spills of each instance.
#include "common.cuh"

namespace vmt {

constexpr int SEQ_TC = 32;           // channels to a block (one warp)
constexpr int SEQ_TP = SEQ_TC + 1;   // shared row pitch of u, delta, y
constexpr int SEQ_NS = 16;           // states a register pass holds
constexpr int SEQ_MAX_N = 256;       // K7's (cuda_scan.MAX_SCAN_N)
constexpr int SEQ_MAX_WIN = 16;
constexpr int SEQ_PASS_WIN = 8;      // the window of the register passes
constexpr int SEQ_MIN_BLOCKS = 16;   // resident warps an SM, at least

// Everything the walks and the combine read, in the order of the exported
// function's parameters.
struct SeqArgs {
  const void* u; int u_dt; long long su_b, su_g, su_l, su_d;
  const void* dl; int d_dt; long long sd_b, sd_g, sd_l, sd_d;
  const float* A;
  const void* Bm; int b_dt; long long sb_b, sb_g, sb_l, sb_n;
  const void* Cm; int c_dt; long long sc_b, sc_g, sc_l, sc_n;
  const float* Dskip; const float* bias;
  void* y; int y_dt; long long sy_b, sy_g, sy_l, sy_d;
  float* hbuf;   // (B, nseg, N, G*Dg): end states, then entering states
  float* dsum;   // (B, nseg, G*Dg): each segment's sum of delta
  int G, L, Dg, N, win, seg, nseg, reverse, softplus;
};

// Which element of a window a thread stages in its e-th copy: index x(e)
// = x0 + xs e (a channel of u, delta, y; a state of B, C) at window
// position t(e) = t0 + ts e. Consecutive threads run along L where L is
// contiguous in memory (WCAP positions, then the next channel or state),
// else along the channels (states: NS of them, then the next position).
struct LaneMap {
  int x0, xs, t0, ts;
};

template <int WCAP>
__device__ __forceinline__ LaneMap act_map(bool lfast, int tid) {
  if (lfast) return {tid / WCAP, SEQ_TC / WCAP, tid % WCAP, 0};
  return {tid, 0, 0, 1};
}

template <int NS, int WCAP>
__device__ __forceinline__ LaneMap bc_map(bool lfast, int tid) {
  if (lfast) return {tid / WCAP, SEQ_TC / WCAP, tid % WCAP, 0};
  return {tid % NS, 0, tid / NS, SEQ_TC / NS};
}

// r[e] = the raw bits (bf16 zero-extended) of p[off + e step] where ok(e):
// one pointer stepped along the thread's elements, all loads issued before
// any is used. `step` enters through an empty asm, so the compiler keeps
// one pointer, not an address per element across the whole walk.
template <int E, typename Ok>
__device__ __forceinline__ void ld_raw_step(uint32_t (&r)[E], const void* p,
                                           int dt, long long off,
                                           long long step, Ok ok) {
  asm volatile("" : "+l"(step));
  if (dt == DT_BF16) {
    const unsigned short* q = static_cast<const unsigned short*>(p) + off;
#pragma unroll
    for (int e = 0; e < E; ++e, q += step) {
      if (ok(e)) r[e] = *q;
    }
  } else {
    const uint32_t* q = static_cast<const uint32_t*>(p) + off;
#pragma unroll
    for (int e = 0; e < E; ++e, q += step) {
      if (ok(e)) r[e] = *q;
    }
  }
}

// softplus, linear above 20 as softplus20, in a few instructions:
// max(x, 0) + log1p(e) with e = exp(-|x|) in (0, 1], log1p(e) = 2
// atanh(s), s = e / (2 + e) in (0, 1/3], by its series to s^13: within
// 1e-6 of log1pf(expf(x)) relative for x > -20 (2e-6 below, the rounding
// of x log2(e)).
__device__ __forceinline__ float softplus_fast(float x) {
  const float e = exp2_ftz(-fabsf(x) * LOG2E);
  const float s = __fdividef(e, 2.f + e);
  const float z = s * s;
  float p = 2.f / 13.f;
  p = fmaf(p, z, 2.f / 11.f);
  p = fmaf(p, z, 2.f / 9.f);
  p = fmaf(p, z, 2.f / 7.f);
  p = fmaf(p, z, 2.f / 5.f);
  p = fmaf(p, z, 2.f / 3.f);
  p = fmaf(p, z, 2.f);
  return x > 20.f ? x : fmaxf(x, 0.f) + s * p;
}

// One walk over one segment: WRITE_Y false is pass 1 (from zero; the end
// state and the sum of delta out), true is pass 3 (from the entering state,
// or zero without scratch; y out). NS: states in registers (>= N, or a
// pass's 16 with PASSES); WCAP: window capacity (>= win). The states past
// N are padding: A = 0 and B = C = 0 keep them at 0, so the state loop
// runs unguarded and its NS independent chains interleave.
template <int NS, int WCAP, bool PASSES, bool WRITE_Y>
__global__ void __launch_bounds__(SEQ_TC, SEQ_MIN_BLOCKS)
    scan_seq_kernel(const __grid_constant__ SeqArgs a) {
  // a thread's share of a window's B or C (without passes)
  constexpr int EB = WCAP * NS / SEQ_TC > 0 ? WCAP * NS / SEQ_TC : 1;
  static_assert(SEQ_TC % WCAP == 0 && NS % 4 == 0, "WCAP, NS");
  const int N = a.N, win = a.win;
  const int npass = PASSES ? (N + NS - 1) / NS : 1;
  const int np = npass * NS;  // shared row pitch of B, C (16-byte rows)
  extern __shared__ __align__(16) float sm[];
  float* b_s = sm;                   // [win][np], states past N 0
  float* c_s = b_s + win * np;       // [win][np], states past N 0
  float* u_s = c_s + win * np;       // [win][SEQ_TP]
  float* d_s = u_s + win * SEQ_TP;   // [win][SEQ_TP]
  float* y_s = d_s + win * SEQ_TP;   // [win][SEQ_TP]
  float* hs = y_s + win * SEQ_TP;    // PASSES: [N][SEQ_TC]

  // block -> (b, g, segment, channel tile); the tiles of a segment adjacent
  const int ntile = (a.Dg + SEQ_TC - 1) / SEQ_TC;
  int bid = blockIdx.x;
  const int tile = bid % ntile;
  bid /= ntile;
  const int s = bid % a.nseg;
  bid /= a.nseg;
  const int g = bid % a.G;
  const int b = bid / a.G;
  const int d0 = tile * SEQ_TC;
  const int tc = min(SEQ_TC, a.Dg - d0);  // channels of this tile
  const int tid = threadIdx.x;
  const bool active = tid < tc;
  const int CD = a.G * a.Dg;
  const int c = g * a.Dg + d0 + min(tid, tc - 1);  // the lane's channel
  const int s0 = s * a.seg;
  const int slen = min(a.seg, a.L - s0);
  const long long row = (long long)b * a.nseg + s;  // (b, s) of the scratch

  float a2[NS], h[NS];
  auto load_a2 = [&](int n0) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      a2[j] = n0 + j < N ? a.A[(long long)c * N + n0 + j] * LOG2E : 0.f;
    }
  };
  load_a2(0);
  const bool from_hin = WRITE_Y && a.hbuf != nullptr;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    h[j] = from_hin && j < N ? a.hbuf[(row * N + j) * CD + c] : 0.f;
  }
  if constexpr (PASSES) {
    for (int n = 0; n < N; ++n) {
      hs[n * SEQ_TC + tid] = from_hin ? a.hbuf[(row * N + n) * CD + c] : 0.f;
    }
  }
  const float dsk = a.Dskip ? a.Dskip[c] : 0.f;
  const float bs = a.bias ? a.bias[c] : 0.f;
  float dsum = 0.f;
  for (int i = tid; i < 2 * win * np; i += SEQ_TC) b_s[i] = 0.f;

  // offsets are in elements of each tensor's own dtype
  const long long ub = b * a.su_b + g * a.su_g + d0 * a.su_d;
  const long long db = b * a.sd_b + g * a.sd_g + d0 * a.sd_d;
  const long long yb = b * a.sy_b + g * a.sy_g + d0 * a.sy_d;
  const long long bb = b * a.sb_b + g * a.sb_g;
  const long long cb = b * a.sc_b + g * a.sc_g;
  const bool u_lfast = a.su_l == 1, d_lfast = a.sd_l == 1;
  const bool y_lfast = a.sy_l == 1;
  const bool b_lfast = a.sb_l == 1, c_lfast = a.sc_l == 1;
  const int nwin = (slen + win - 1) / win;
  // window k of the walk: its first position
  auto first_pos = [&](int k) {
    return s0 + (a.reverse ? nwin - 1 - k : k) * win;
  };

  // Window k into shared memory in fp32: every element a thread stages
  // loaded first (raw bits, all in flight at once), then stored. `lt` is
  // the thread's index made opaque to the compiler each window, so that no
  // per-element offset is kept in registers across the walk.
  auto stage = [&](int k, int lt) {
    const int t0 = first_pos(k), len = min(win, s0 + slen - t0);
    auto act = [&](float* w, const void* p, int dt, bool lfast,
                   long long base, long long sx, long long sl) {
      const LaneMap m = act_map<WCAP>(lfast, lt);
      auto ok = [&](int e) {
        return m.x0 + m.xs * e < tc && m.t0 + m.ts * e < len;
      };
      uint32_t r[WCAP];
      ld_raw_step(r, p, dt, base + m.x0 * sx + (t0 + m.t0) * sl,
                  m.xs * sx + m.ts * sl, ok);
#pragma unroll
      for (int e = 0; e < WCAP; ++e) {
        if (ok(e)) {
          w[(m.t0 + m.ts * e) * SEQ_TP + m.x0 + m.xs * e] = raw_f32(r[e], dt);
        }
      }
    };
    act(u_s, a.u, a.u_dt, u_lfast, ub, a.su_d, a.su_l);
    act(d_s, a.dl, a.d_dt, d_lfast, db, a.sd_d, a.sd_l);
    if constexpr (PASSES) {
      // all N states of the window's B and C rows, an element at a time
      for (int i = lt; i < len * N; i += SEQ_TC) {
        int n = b_lfast ? i / len : i % N, t = b_lfast ? i % len : i / N;
        b_s[t * np + n] =
            ld_act(a.Bm, bb + n * a.sb_n + (t0 + t) * a.sb_l, a.b_dt);
        if (WRITE_Y) {
          n = c_lfast ? i / len : i % N;
          t = c_lfast ? i % len : i / N;
          c_s[t * np + n] =
              ld_act(a.Cm, cb + n * a.sc_n + (t0 + t) * a.sc_l, a.c_dt);
        }
      }
    } else {
      auto rows = [&](float* w, const void* p, int dt, bool lfast,
                      long long base, long long sn, long long sl) {
        const LaneMap m = bc_map<NS, WCAP>(lfast, lt);
        auto ok = [&](int e) {
          return m.x0 + m.xs * e < N && m.t0 + m.ts * e < len;
        };
        uint32_t r[EB];
        ld_raw_step(r, p, dt, base + m.x0 * sn + (t0 + m.t0) * sl,
                    m.xs * sn + m.ts * sl, ok);
#pragma unroll
        for (int e = 0; e < EB; ++e) {
          if (ok(e)) {
            w[(m.t0 + m.ts * e) * np + m.x0 + m.xs * e] = raw_f32(r[e], dt);
          }
        }
      };
      rows(b_s, a.Bm, a.b_dt, b_lfast, bb, a.sb_n, a.sb_l);
      if (WRITE_Y) rows(c_s, a.Cm, a.c_dt, c_lfast, cb, a.sc_n, a.sc_l);
    }
  };

  for (int k = 0; k < nwin; ++k) {
    const int t0 = first_pos(k), len = min(win, s0 + slen - t0);
    int lt = tid;
    asm volatile("" : "+r"(lt));
    __syncwarp();  // every lane is done with window k - 1 (and the padding)
    stage(k, lt);
    __syncwarp();
    if (active) {
      // the lane's own column of delta through bias and softplus, the
      // positions independent of each other (and of h)
#pragma unroll
      for (int t = 0; t < WCAP; ++t) {
        if (t < len) {
          float* dp = d_s + t * SEQ_TP + tid;
          const float dv = *dp + bs;
          *dp = a.softplus ? softplus_fast(dv) : dv;
        }
      }
      for (int p = 0; p < npass; ++p) {
        const int n0 = p * NS;
        if constexpr (PASSES) {
          load_a2(n0);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            h[j] = n0 + j < N ? hs[(n0 + j) * SEQ_TC + tid] : 0.f;
          }
        }
        for (int si = 0; si < len; ++si) {
          const int t = a.reverse ? len - 1 - si : si;
          const float dv = d_s[t * SEQ_TP + tid];
          if (!WRITE_Y && p == 0) dsum += dv;
          const float uv = u_s[t * SEQ_TP + tid];
          const float du = dv * uv;
          const float4* b4 =
              reinterpret_cast<const float4*>(b_s + t * np + n0);
          float ex[NS];
#pragma unroll
          for (int j = 0; j < NS; ++j) ex[j] = exp2_ftz(dv * a2[j]);
#pragma unroll
          for (int q = 0; q < NS / 4; ++q) {
            const float4 bv = b4[q];
            h[4 * q] = fmaf(ex[4 * q], h[4 * q], du * bv.x);
            h[4 * q + 1] = fmaf(ex[4 * q + 1], h[4 * q + 1], du * bv.y);
            h[4 * q + 2] = fmaf(ex[4 * q + 2], h[4 * q + 2], du * bv.z);
            h[4 * q + 3] = fmaf(ex[4 * q + 3], h[4 * q + 3], du * bv.w);
          }
          if (WRITE_Y) {
            const float4* c4 =
                reinterpret_cast<const float4*>(c_s + t * np + n0);
            // 4 short chains; a pass adds its sum to the previous ones'
            float acc[4] = {p == 0 ? dsk * uv : y_s[t * SEQ_TP + tid], 0.f,
                            0.f, 0.f};
#pragma unroll
            for (int q = 0; q < NS / 4; ++q) {
              const float4 cv = c4[q];
              acc[0] = fmaf(cv.x, h[4 * q], acc[0]);
              acc[1] = fmaf(cv.y, h[4 * q + 1], acc[1]);
              acc[2] = fmaf(cv.z, h[4 * q + 2], acc[2]);
              acc[3] = fmaf(cv.w, h[4 * q + 3], acc[3]);
            }
            y_s[t * SEQ_TP + tid] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
          }
        }
        if constexpr (PASSES) {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            if (n0 + j < N) hs[(n0 + j) * SEQ_TC + tid] = h[j];
          }
        }
      }
    }
    if (WRITE_Y) {
      __syncwarp();
      const LaneMap m = act_map<WCAP>(y_lfast, lt);
#pragma unroll
      for (int e = 0; e < WCAP; ++e) {
        const int x = m.x0 + m.xs * e, t = m.t0 + m.ts * e;
        if (x < tc && t < len) {
          st_act(a.y, yb + x * a.sy_d + (t0 + t) * a.sy_l, a.y_dt,
                 y_s[t * SEQ_TP + x]);
        }
      }
    }
    // this window's shared rows are rewritten only after the next window's
    // barrier, which every lane reaches after these reads
  }
  if (!WRITE_Y && active) {
    a.dsum[row * CD + c] = dsum;
    if constexpr (PASSES) {
      for (int n = 0; n < N; ++n) {
        a.hbuf[(row * N + n) * CD + c] = hs[n * SEQ_TC + tid];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (j < N) a.hbuf[(row * N + j) * CD + c] = h[j];
      }
    }
  }
}

// Pass 2: the entering state of every segment, a thread per (b, n, c) (c
// fastest, so that the reads of hbuf coalesce): h = 0; over the segments
// in scan order, hin[s] = h, h = exp2(A log2(e) dsum[s]) h + hend[s],
// hin written over hend. Eight segments' loads are issued before their
// chain.
static __global__ void scan_seq_combine(const float* __restrict__ A,
                                 float* __restrict__ hbuf,
                                 const float* __restrict__ dsum, int B,
                                 int CD, int N, int nseg, int reverse) {
  constexpr int U = 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N * CD) return;
  const int c = (int)(idx % CD);
  const int n = (int)((idx / CD) % N);
  const long long b = idx / ((long long)CD * N);
  const float a2 = A[(long long)c * N + n] * LOG2E;
  float h = 0.f;
  for (int i0 = 0; i0 < nseg; i0 += U) {
    float he[U], ds[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = i0 + k;
      if (i < nseg) {
        const long long r = b * nseg + (reverse ? nseg - 1 - i : i);
        he[k] = hbuf[(r * N + n) * CD + c];
        ds[k] = dsum[r * CD + c];
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = i0 + k;
      if (i < nseg) {
        const long long r = b * nseg + (reverse ? nseg - 1 - i : i);
        hbuf[(r * N + n) * CD + c] = h;
        h = fmaf(exp2_ftz(a2 * ds[k]), h, he[k]);
      }
    }
  }
}

// The dynamic shared memory of a walk's block: the window's B and C rows,
// u, delta and y, and with PASSES the lane's N states.
template <int NS, bool PASSES>
static size_t walk_smem(int N, int win) {
  const int npass = PASSES ? (N + NS - 1) / NS : 1;
  return sizeof(float) * ((size_t)win * (2 * npass * NS + 3 * SEQ_TP) +
                          (PASSES ? (size_t)N * SEQ_TC : 0));
}

template <int NS_, int WCAP_, bool PASSES_>
struct SeqInst {
  static constexpr int NS = NS_, WCAP = WCAP_;
  static constexpr bool PASSES = PASSES_;
};

// f(SeqInst<NS, WCAP, PASSES>{}) for the instance that N states in
// windows of win positions take.
template <class F>
static int seq_instance(int N, int win, F f) {
  if (N > SEQ_NS) return f(SeqInst<SEQ_NS, SEQ_PASS_WIN, true>{});
  if (N <= 8) {
    if (win <= 1) return f(SeqInst<8, 1, false>{});
    if (win <= 8) return f(SeqInst<8, 8, false>{});
    return f(SeqInst<8, 16, false>{});
  }
  if (win <= 1) return f(SeqInst<16, 1, false>{});
  if (win <= 8) return f(SeqInst<16, 8, false>{});
  return f(SeqInst<16, 16, false>{});
}

template <int NS, int WCAP, bool PASSES, bool WRITE_Y>
static int launch_walk(const SeqArgs& a, int blocks, size_t smem,
                       cudaStream_t st) {
  const void* fn = (const void*)scan_seq_kernel<NS, WCAP, PASSES, WRITE_Y>;
  int err = set_smem(fn, smem);
  if (err) return err;
  scan_seq_kernel<NS, WCAP, PASSES, WRITE_Y><<<blocks, SEQ_TC, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int NS, int WCAP, bool PASSES>
static int launch_seq(const SeqArgs& a, int B, cudaStream_t st) {
  const int ntile = (a.Dg + SEQ_TC - 1) / SEQ_TC;
  const long long blocks = (long long)B * a.G * ntile * a.nseg;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem<NS, PASSES>(a.N, a.win);
  if (a.nseg > 1) {
    int err = launch_walk<NS, WCAP, PASSES, false>(a, (int)blocks, smem, st);
    if (err) return err;
    const long long rows = (long long)B * a.N * a.G * a.Dg;
    scan_seq_combine<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
        a.A, a.hbuf, a.dsum, B, a.G * a.Dg, a.N, a.nseg, a.reverse);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_walk<NS, WCAP, PASSES, true>(a, (int)blocks, smem, st);
}

// The blocks (warps) of one walk's instance that an SM holds at once.
template <int NS, int WCAP, bool PASSES, bool WRITE_Y>
static int walk_resident(int N, int win, int* per) {
  const void* fn = (const void*)scan_seq_kernel<NS, WCAP, PASSES, WRITE_Y>;
  const size_t smem = walk_smem<NS, PASSES>(N, win);
  int err = set_smem(fn, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per, fn, SEQ_TC,
                                                            smem);
}

}  // namespace vmt

// The warps of a call's walks (N states, windows of win) that the card
// holds at once: its SMs times the blocks, one warp each, that an SM holds
// of the walk holding fewer (pass 3, or pass 1), by the occupancy API.
// cuda_scan.seq_segment sizes the segments by it.
extern "C" int vmt_scan_seq_resident(int N, int win, int* out,
                                     void* stream) {
  using namespace vmt;
  (void)stream;
  if (N < 1 || N > SEQ_MAX_N || win < 1 || win > SEQ_MAX_WIN ||
      (N > SEQ_NS && win > SEQ_PASS_WIN)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev, sms, err;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  return seq_instance(N, win, [&](auto i) {
    using I = decltype(i);
    int p1 = 0, p3 = 0;
    int e = walk_resident<I::NS, I::WCAP, I::PASSES, false>(N, win, &p1);
    if (!e) e = walk_resident<I::NS, I::WCAP, I::PASSES, true>(N, win, &p3);
    *out = sms * (p1 < p3 ? p1 : p3);
    return e;
  });
}

// work: ceil(L / seg) > 1 segments take B * nseg * G * Dg * (N + 1) fp32
// floats of scratch (hbuf, then dsum); one segment takes none (null).
extern "C" int vmt_scan_seq_fwd(
    const void* u, int u_dt, long long su_b, long long su_g, long long su_l,
    long long su_d, const void* dl, int d_dt, long long sd_b, long long sd_g,
    long long sd_l, long long sd_d, const float* A, const void* Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* Cm, int c_dt, long long sc_b, long long sc_g, long long sc_l,
    long long sc_n, const float* Dskip, const float* bias, void* y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d,
    float* work, int B, int G, int L, int Dg, int N, int win, int seg,
    int reverse, int softplus, void* stream) {
  using namespace vmt;
  if (N < 1 || N > SEQ_MAX_N || win < 1 || win > SEQ_MAX_WIN || L < 1 ||
      Dg < 1 || seg < 1 || (N > SEQ_NS && win > SEQ_PASS_WIN)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nseg = (L + seg - 1) / seg;
  if (nseg > 1 && !work) return (int)cudaErrorInvalidValue;
  float* hbuf = nseg > 1 ? work : nullptr;
  float* dsum = nseg > 1 ? work + (size_t)B * nseg * N * G * Dg : nullptr;
  const SeqArgs a{u, u_dt, su_b, su_g, su_l, su_d, dl, d_dt, sd_b, sd_g,
                  sd_l, sd_d, A, Bm, b_dt, sb_b, sb_g, sb_l, sb_n, Cm, c_dt,
                  sc_b, sc_g, sc_l, sc_n, Dskip, bias, y, y_dt, sy_b, sy_g,
                  sy_l, sy_d, hbuf, dsum, G, L, Dg, N, win, seg, nseg,
                  reverse, softplus};
  cudaStream_t st = (cudaStream_t)stream;
  return seq_instance(N, win, [&](auto i) {
    using I = decltype(i);
    return launch_seq<I::NS, I::WCAP, I::PASSES>(a, B, st);
  });
}
