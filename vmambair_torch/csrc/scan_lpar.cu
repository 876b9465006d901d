// The L-parallel segmented scan.
//
// Replaces, on the card, the exact families of
// tools/kvariants.py::build: the Hillis-Steele forms v0, v1 and their
// relatives v6, v8, v8s, v9, v11, and the log-domain forms v13, v14, v15,
// v15b, v19; on the channels-last layout, kernel_v12_ld (build_ld). Each
// computes K4's function with an fp32 state:
//   delta = softplus(delta_raw + bias)  (softplus optional)
//   h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t,  y_t = C_t h_t + D u_t
//
// Layout, passes, blocks and windows: scan_seg.cuh's skeleton. This
// file's policy (LparScan): per state n (a lane holds only its KP decays
// and inputs of a state) each lane scans its KP positions in registers, a
// 5-step warp-shuffle Hillis-Steele over the lanes' (decay product, end
// state) pairs gives every lane its entering state (the v1 form: Hillis
// inside a window, sequential across windows), and in pass 3 the lane
// replays its positions from it for y. Pass 1 sums the segment's deltas
// and writes its decay exp2(A log2(e) sum) per state; the decay of a long
// segment underflows to 0 (ftz), which is exact in effect.
//
// What bounds it on the H100: the SFU. The function needs one exp2 per
// (b, l, d, n); passes 1 and 3 each take one, so the kernel issues twice
// the function's exp2s and reads u, delta and B twice. Unlike the
// sequential walks (K4, scan_seq.cu) every SM is busy: B * G *
// ceil(Dg / 4) * ceil(L / seg) blocks.
//
// With REV2 (`vmt_scan_combined_fwd`), kvariants' kernel_v16
// (tools/kvariants.py:710): the same pass also writes y2 = D u + C h_rev,
// h_rev the reverse scan (h_t = a_t h_{t+1} + x_t, the same a_t =
// exp(delta_t A) and x_t = delta_t B_t u_t as the forward) restarted from
// zero at the end of every segment. Both directions share each position's
// load, prologue, staged B/C, exp2 and x_t; the reverse adds its own
// state FMA and its C h_rev FMA. The reverse needs the state after a
// window before it can walk the window back to front, while the passes
// walk windows front to back; so pass 1 also keeps each window's reverse
// total from zero and its decay (rtot, rdec: one per (b, c, segment,
// window, n), a lane's 8 positions walked back to front and a 5-step
// suffix Hillis-Steele over the lanes), and its epilogue turns them, back
// to front, into the state entering each window from behind. Pass 3 runs
// the lanes' suffix scan again from that state and replays each lane's
// positions back to front for y2. (Staging a whole segment instead would
// need a second exp2 per (position, state) or 256 KB of decays.) No
// combine across segments: the reverse is segment-local by definition.
#include "scan_seg.cuh"

namespace vmt {

template <int NS_, bool REV2>
struct LparScan {
  static constexpr int NS = NS_;
  float carry[NS];  // the forward state entering the window
  float dsum;       // pass 1: the segment's sum of deltas
  float rin[NS];    // v16, pass 3: the reverse state entering from behind
  float y2v[SG_KP];

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
    // state at 0, and the states' chains interleave
#pragma unroll
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
#pragma unroll
        for (int p = 0; p < SG_KP; ++p) {
          hh = av[p] * hh + x[p];
          yv[p] += c_s[j][p * SG_PP + lane] * hh;
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

// hend, aend, hin: (B, G*Dg, nseg, N) fp32 scratch the caller allocates,
// nseg = ceil(L / seg).
extern "C" int vmt_scan_lpar_fwd(
    const void* u, int u_dt, long long su_b, long long su_g, long long su_l,
    long long su_d, const void* dl, int d_dt, long long sd_b, long long sd_g,
    long long sd_l, long long sd_d, const float* A, const void* Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* Cm, int c_dt, long long sc_b, long long sc_g, long long sc_l,
    long long sc_n, const float* Dskip, const float* bias, void* y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d,
    float* hend, float* aend, float* hin, int B, int G, int L, int Dg, int N,
    int seg, int reverse, int softplus, void* stream) {
  const vmt::SegArgs a{
      u, u_dt, su_b, su_g, su_l, su_d, dl, d_dt, sd_b, sd_g, sd_l, sd_d, A,
      Bm, b_dt, sb_b, sb_g, sb_l, sb_n, Cm, c_dt, sc_b, sc_g, sc_l, sc_n,
      Dskip, bias, y, y_dt, sy_b, sy_g, sy_l, sy_d, nullptr, hend, aend, hin,
      nullptr, nullptr, G, L, Dg, N, seg, seg, reverse, softplus};
  return vmt::launch_seg_n<vmt::LparFwd>(a, B, stream);
}

// kvariants' v16: y forward as vmt_scan_lpar_fwd (reverse must be 0) and
// y2, with y's dtype and strides, the reverse scan restarted at every
// segment's end. rtot, rdec: (B, G*Dg, nseg, ceil(seg / 256), N) fp32
// scratch.
extern "C" int vmt_scan_combined_fwd(
    const void* u, int u_dt, long long su_b, long long su_g, long long su_l,
    long long su_d, const void* dl, int d_dt, long long sd_b, long long sd_g,
    long long sd_l, long long sd_d, const float* A, const void* Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* Cm, int c_dt, long long sc_b, long long sc_g, long long sc_l,
    long long sc_n, const float* Dskip, const float* bias, void* y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d, void* y2,
    float* hend, float* aend, float* hin, float* rtot, float* rdec, int B,
    int G, int L, int Dg, int N, int seg, int reverse, int softplus,
    void* stream) {
  if (reverse) return (int)cudaErrorInvalidValue;
  const vmt::SegArgs a{
      u, u_dt, su_b, su_g, su_l, su_d, dl, d_dt, sd_b, sd_g, sd_l, sd_d, A,
      Bm, b_dt, sb_b, sb_g, sb_l, sb_n, Cm, c_dt, sc_b, sc_g, sc_l, sc_n,
      Dskip, bias, y, y_dt, sy_b, sy_g, sy_l, sy_d, y2, hend, aend, hin, rtot,
      rdec, G, L, Dg, N, seg, seg, 0, softplus};
  return vmt::launch_seg_n<vmt::LparRev2>(a, B, stream);
}
