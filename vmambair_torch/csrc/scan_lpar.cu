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
// Layout, passes, blocks and windows: scan_seg.cuh's skeleton; the
// window's scan: scan_lpar.cuh's policy (LparScan), which K1's passes 1
// and 3 run too.
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
#include "scan_lpar.cuh"

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
