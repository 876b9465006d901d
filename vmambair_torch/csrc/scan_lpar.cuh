// The L-parallel scan policy of scan_seg.cuh's skeleton: scan_lpar.cu's
// probes and K1's passes 1 and 3 (oss_scan_fused.cu).
//
// Per state n (a lane holds only its KP decays and inputs of a state) each
// lane scans its KP positions in registers, a 5-step warp-shuffle
// Hillis-Steele over the lanes' (decay product, end state) pairs gives
// every lane its entering state (the v1 form: Hillis inside a window,
// sequential across windows), and in pass 3 the lane replays its positions
// from it for y. Pass 1 sums the segment's deltas and writes its decay
// exp2(A log2(e) sum) per state; the decay of a long segment underflows to
// 0 (ftz), which is exact in effect.
//
// With REV2, kvariants' v16: the same pass also writes y2, the reverse
// scan restarted from zero at the end of every segment (scan_lpar.cu's
// note says how).
//
// With CARRIES (K1c), pass 3 also writes the fp32 state entering every
// chunk of CH positions to a.carries (B, G*Dg, ceil(L / CH), N), indexed by
// the chunk's position in L: the lane that replays a chunk's first
// position in scan order writes the state before it. In a segment those
// positions sit CH apart in scan order, at one offset cq among a lane's KP
// positions (0 where the segment starts, or ends back to front, on a chunk
// boundary; else a ragged L or a segment length that is no multiple of CH
// moves it), plus, back to front, the segment's first position where it
// ends at L; so a lane keeps the state at p = 0 and at p = cq, and stores
// each after its state's replay, with stores that nothing else waits on
// (st_f32_if). The stores change no arithmetic of y. (State j of the
// registers is state k.n0 + j: K4 walks N in passes, scan_seg.cuh.)
//
// UNR states of the window's loop are unrolled at once, all NS by
// default. A window runs its code once, so a kernel that runs few windows
// a block (K4) pays for its code's size in instruction fetches; with UNR <
// NS the code shrinks that many times, the states' registers go to local
// memory (the L1), and fewer chains interleave.
#pragma once

#include "scan_seg.cuh"

namespace vmt {

template <int NS_, bool REV2, bool CARRIES = false, int UNR = NS_>
struct LparScan {
  static constexpr int NS = NS_;
  float carry[NS];  // the forward state entering the window
  float dsum;       // pass 1: the segment's sum of deltas
  float rin[NS];    // v16, pass 3: the reverse state entering from behind
  float y2v[SG_KP];
  // K1c, pass 3: the lane's chunk starts (below) at p = 0 and at p = cq,
  // whether each is one (ca, cb) and where its carries go (ia, ib)
  int cq;
  bool ca, cb;
  long long crow, ia, ib;

  // where window w's reverse values are
  static __device__ __forceinline__ long long ridx(const SegArgs& a,
                                                   const SegBlock<NS>& k,
                                                   int w, int j) {
    const int nwin = (a.seg + SG_WIN - 1) / SG_WIN;
    return (k.hrow * nwin + w) * a.N + j;
  }

  template <bool WRITE_Y>
  __device__ __forceinline__ void init(const SegArgs& a,
                                       const SegBlock<NS>& k) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      carry[j] = WRITE_Y && j < a.N ? a.hin[k.hrow * a.N + j] : 0.f;
    }
    dsum = 0.f;
    if (CARRIES) {
      ca = cb = false;
      ia = ib = 0;
      crow = ((long long)blockIdx.z * a.G * a.Dg + k.c) *
             ((a.L + CH - 1) / CH) * a.N;
      // chunk starts fall CH apart in scan order, at the scan indices
      // congruent to cq modulo SG_KP (and, back to front, at the segment's
      // first index where it ends at L)
      cq = (a.reverse ? k.s0 + k.slen : SG_KP - k.s0 % SG_KP) % SG_KP;
    }
  }

  // whether position t is the first that the scan visits of its chunk:
  // its first position forward; back to front its last (L - 1 for a
  // ragged last chunk)
  static __device__ __forceinline__ bool chunk_first(const SegArgs& a,
                                                     int t) {
    return a.reverse ? t % CH == CH - 1 || t == a.L - 1 : t % CH == 0;
  }

  template <bool WRITE_Y>
  __device__ __forceinline__ void pre(const SegArgs& a,
                                      const SegBlock<NS>& k, int w0,
                                      const float (&dv)[SG_KP],
                                      const float (&yv)[SG_KP]) {
#pragma unroll
    for (int p = 0; p < SG_KP; ++p) {
      dsum += dv[p];
      y2v[p] = yv[p];  // D u
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      rin[j] = REV2 && WRITE_Y && j < a.N ? a.rtot[ridx(a, k, w0 / SG_WIN, j)]
                                          : 0.f;
    }
    if (CARRIES && WRITE_Y && a.carries) {
      const int i = w0 + SG_KP * k.lane;
      const int ta = k.pos(a, i), tb = k.pos(a, i + cq);
      ca = i < k.slen && chunk_first(a, ta);
      cb = cq > 0 && i + cq < k.slen && chunk_first(a, tb);
      ia = crow + (long long)(ta / CH) * a.N;
      ib = crow + (long long)(tb / CH) * a.N;
    }
  }

  template <bool WRITE_Y>
  __device__ __forceinline__ void window(const SegArgs& a,
                                         const SegBlock<NS>& k, int w0,
                                         const float (&dv)[SG_KP],
                                         const float (&du)[SG_KP],
                                         const SegRows* b_s,
                                         const SegRows* c_s,
                                         float (&yv)[SG_KP]) {
    const int lane = k.lane;
    // unguarded over the NS states: past N, A = 0 and B = C = 0 keep a
    // state at 0, and the states' chains interleave (UNR of them at once)
#pragma unroll(UNR)
    for (int j = 0; j < NS; ++j) {
      float av[SG_KP], x[SG_KP];
      float P = 1.f, H = 0.f;  // the lane's decay product and end state
#pragma unroll
      for (int p = 0; p < SG_KP; ++p) {
        av[p] = exp2_ftz(dv[p] * k.a2[j]);
        x[p] = du[p] * b_s[j][p * SG_PP + lane];
        H = av[p] * H + x[p];
        P *= av[p];
      }
      if (REV2) {
        // the lane's reverse state from zero at its end, then the suffix
        // scan over the lanes: (Ps, Gs) of lanes lane..31
        float Gs = 0.f, Ps = P;
#pragma unroll
        for (int p = SG_KP - 1; p >= 0; --p) Gs = av[p] * Gs + x[p];
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const float Pn = __shfl_down_sync(FULL, Ps, s);
          const float Gn = __shfl_down_sync(FULL, Gs, s);
          if (lane + s < 32) {
            Gs = Ps * Gn + Gs;
            Ps = Ps * Pn;
          }
        }
        if (!WRITE_Y) {
          // the window's total and decay, kept by lane j for state j
          const float gw = __shfl_sync(FULL, Gs, 0);
          const float pw = __shfl_sync(FULL, Ps, 0);
          if (k.active && lane == j && j < a.N) {
            a.rtot[ridx(a, k, w0 / SG_WIN, j)] = gw;
            a.rdec[ridx(a, k, w0 / SG_WIN, j)] = pw;
          }
        } else {
          // the state after this lane's positions, then its positions back
          // to front
          const float Pn = __shfl_down_sync(FULL, Ps, 1);
          const float Gn = __shfl_down_sync(FULL, Gs, 1);
          float g2 = lane == 31 ? rin[j] : Pn * rin[j] + Gn;
#pragma unroll
          for (int p = SG_KP - 1; p >= 0; --p) {
            g2 = av[p] * g2 + x[p];
            y2v[p] += c_s[j][p * SG_PP + lane] * g2;
          }
        }
      }
      // inclusive Hillis-Steele over the lanes: (P, H) of lanes 0..lane
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const float Pp = __shfl_up_sync(FULL, P, s);
        const float Hp = __shfl_up_sync(FULL, H, s);
        if (lane >= s) {
          H = P * Hp + H;
          P = P * Pp;
        }
      }
      const float hl = P * carry[j] + H;  // state after the lane's positions
      const float prev = __shfl_up_sync(FULL, hl, 1);
      if (WRITE_Y) {
        float hh = lane ? prev : carry[j];
        float hb = hh;  // K1c: the state before position cq
        if (CARRIES) {
          st_f32_if(a.carries + ia + k.n0 + j, hh, ca && k.n0 + j < a.N);
        }
#pragma unroll
        for (int p = 0; p < SG_KP; ++p) {
          if (CARRIES && p > 0) hb = p == cq ? hh : hb;
          hh = av[p] * hh + x[p];
          yv[p] += c_s[j][p * SG_PP + lane] * hh;
        }
        if (CARRIES) {
          st_f32_if(a.carries + ib + k.n0 + j, hb, cb && k.n0 + j < a.N);
        }
      }
      carry[j] = __shfl_sync(FULL, hl, 31);
    }
  }

  __device__ __forceinline__ void store(const SegArgs& a, long long at,
                                        int p) const {
    if (REV2) st_act(a.y2, at, a.y_dt, y2v[p]);
  }

  __device__ __forceinline__ void finish(const SegArgs& a,
                                         const SegBlock<NS>& k) {
    const int lane = k.lane;
    if (REV2 && lane < a.N) {
      // each window's total -> the reverse state entering it from behind,
      // back to front over the segment's windows (this lane wrote state
      // `lane`'s values in pass 1's windows)
      float gg = 0.f;
      for (int w = (k.slen + SG_WIN - 1) / SG_WIN - 1; w >= 0; --w) {
        const long long at = ridx(a, k, w, lane);
        const float tot = a.rtot[at];
        a.rtot[at] = gg;
        gg = a.rdec[at] * gg + tot;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) dsum += __shfl_xor_sync(FULL, dsum, s);
    if (lane < a.N && lane < NS) {
      float v = carry[0], a2 = k.a2[0];
#pragma unroll
      for (int j = 1; j < NS; ++j) {
        v = lane == j ? carry[j] : v;
        a2 = lane == j ? k.a2[j] : a2;
      }
      a.hend[k.hrow * a.N + lane] = v;
      a.aend[k.hrow * a.N + lane] = exp2_ftz(a2 * dsum);
    }
  }
};

template <int NS>
using LparFwd = LparScan<NS, false>;
template <int NS>
using LparRev2 = LparScan<NS, true>;

}  // namespace vmt
