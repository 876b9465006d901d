// The L-parallel scan with bf16 stacks.
//
// Replaces, on the card, kvariants' bf16-stack variants
// (tools/kvariants.py): kernel_v3 (:122), the (a, b) pairs of the scan
// rounded to bf16 and composed in bf16 over the whole chunk, and
// kernel_v10 (:326), v8s with its b stack in bf16 over sub-chunks of 128
// (each step's decay rounded to bf16, the decay products and sums of
// delta fp32). Both carry the state across stacks in fp32:
//   delta = softplus(delta_raw + bias)  (softplus optional)
//   within a stack: (a, b)_t = (a_1 ... a_t, sum_s a_{s+1} ... a_t x_s),
//     a_t = exp(delta_t A), x_t = delta_t B_t u_t,
//   h_t = a_t h0 + b_t in fp32 (h0: the state entering the stack),
//   y_t = C_t h_t + D u_t in fp32.
// The stack's element is the affine map h -> a h + b, composed as
// (l, then r) = (l.a r.a, r.a l.b + r.b): v3 (A_BF16) keeps a and b as
// bf16 pairs (__hmul2 and __hfma2, one rounding each); v10 keeps a in fp32
// (the decay products, exp(A sd) to within fp32 rounding) and rounds it to
// bf16 where it multiplies the b stack. Inputs a and b are rounded where
// the TPU kernels round them.
//
// Layout, passes, blocks and windows: scan_seg.cuh's skeleton, with L cut
// into segments of `seg` positions (a multiple of the stack span `sub`,
// so no stack crosses a segment); pass 1 writes each segment's end state
// and its fp32 decay per state (the product of its windows' decays); for
// v3, where the segment is the stack, pass 2's h = aend h + hend is the
// TPU's carry a_last h0 + b_last. This file's policy (StackScan) is the
// window's scan.
//
// Rounding depth. bf16 error grows with the length of the chain of
// compositions behind a value, so every chain is kept logarithmic, as the
// TPU's Hillis-Steele keeps it at log2(chunk): a Sklansky tree over a
// lane's 8 positions (depth 3), a Hillis-Steele over the lanes of the
// stack by shuffles (depth 5), and, for a stack longer than a window, the
// stack so far composed with each window's total (one per window: 3 for
// v3's 1024). The last composition of each position, its lane's prefix
// then its own, feeds only that position's state. By default
// (LAST_BF16 false) it is applied in fp32 straight into h: one bf16
// rounding fewer than the TPU's last Hillis-Steele step, which keeps the
// kernel inside the bf16 envelope of its plain version at every shape the
// tests and the probes run (the two are different trees of bf16
// roundings, each some way off the exact scan). With LAST_BF16 it is
// composed in bf16 as the TPU's last step is, then applied in fp32: the
// TPU's rounding points, for timing the same work as the TPU kernels. A
// stack shorter than a window (v10's 128: 16 lanes) restarts at its first
// lane; the window's stacks then join by an fp32 Hillis-Steele over their
// totals. States go two at a time as __nv_bfloat162 pairs, so the stack
// runs on HFMA2 / HMUL2.
//
// What bounds it on the H100: as scan_lpar, the SFU (one exp2 per (b, l,
// d, n) and pass, two passes) and the FMA pipe; the bf16 pairs halve the
// stack's FMA instructions, not the fp32 work around it (h and y per
// position).
#include "scan_seg.cuh"

namespace vmt {

using bf2 = __nv_bfloat162;

__device__ __forceinline__ bf2 bf2_of(float x, float y) {
  return __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ bf2 shfl_up_bf2(bf2 v, int k) {
  unsigned r = *reinterpret_cast<unsigned*>(&v);
  r = __shfl_up_sync(FULL, r, k);
  return *reinterpret_cast<bf2*>(&r);
}

__device__ __forceinline__ bf2 shfl_bf2(bf2 v, int src) {
  unsigned r = *reinterpret_cast<unsigned*>(&v);
  r = __shfl_sync(FULL, r, src);
  return *reinterpret_cast<bf2*>(&r);
}

// The stack's element for a pair of states.
template <bool A_BF16>
struct Stack;

template <>
struct Stack<true> {  // v3: a and b in bf16
  bf2 a, b;
  static __device__ __forceinline__ Stack ident() {
    return {bf2_of(1.f, 1.f), bf2_of(0.f, 0.f)};
  }
  static __device__ __forceinline__ Stack of(float a0, float a1, bf2 b) {
    return {bf2_of(a0, a1), b};
  }
  static __device__ __forceinline__ Stack then(Stack l, Stack r) {
    return {__hmul2(l.a, r.a), __hfma2(r.a, l.b, r.b)};
  }
  __device__ __forceinline__ float2 af() const {
    return __bfloat1622float2(a);
  }
  // a as it multiplies a b stack (bf16)
  __device__ __forceinline__ float2 ab() const { return af(); }
  __device__ __forceinline__ Stack up(int k) const {
    return {shfl_up_bf2(a, k), shfl_up_bf2(b, k)};
  }
  __device__ __forceinline__ Stack at(int src) const {
    return {shfl_bf2(a, src), shfl_bf2(b, src)};
  }
};

template <>
struct Stack<false> {  // v10: a in fp32, b in bf16
  float a0, a1;
  bf2 b;
  static __device__ __forceinline__ Stack ident() {
    return {1.f, 1.f, bf2_of(0.f, 0.f)};
  }
  static __device__ __forceinline__ Stack of(float a0, float a1, bf2 b) {
    return {a0, a1, b};
  }
  static __device__ __forceinline__ Stack then(Stack l, Stack r) {
    return {l.a0 * r.a0, l.a1 * r.a1,
            __hfma2(bf2_of(r.a0, r.a1), l.b, r.b)};
  }
  __device__ __forceinline__ float2 af() const { return make_float2(a0, a1); }
  __device__ __forceinline__ float2 ab() const {
    return __bfloat1622float2(bf2_of(a0, a1));
  }
  __device__ __forceinline__ Stack up(int k) const {
    return {__shfl_up_sync(FULL, a0, k), __shfl_up_sync(FULL, a1, k),
            shfl_up_bf2(b, k)};
  }
  __device__ __forceinline__ Stack at(int src) const {
    return {__shfl_sync(FULL, a0, src), __shfl_sync(FULL, a1, src),
            shfl_bf2(b, src)};
  }
};

template <int NS_, bool A_BF16, bool LAST_BF16>
struct StackScan {
  static constexpr int NS = NS_;
  static constexpr int NP = NS / 2;  // state pairs
  using St = Stack<A_BF16>;
  float carry[NS];  // the fp32 state entering the window
  float dec[NS];    // pass 1: the segment's decay so far
  St wp[NP];        // the stack from its start to this window's start
                    // (stacks longer than a window)

  template <bool WRITE_Y>
  __device__ __forceinline__ void init(const SegArgs& a,
                                       const SegBlock<NS>& k) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      carry[j] = WRITE_Y && j < a.N ? a.hin[k.hrow * a.N + j] : 0.f;
      dec[j] = 1.f;
    }
#pragma unroll
    for (int jj = 0; jj < NP; ++jj) wp[jj] = St::ident();
  }

  template <bool WRITE_Y>
  __device__ __forceinline__ void pre(const SegArgs&, const SegBlock<NS>&,
                                      int, const float (&)[SG_KP],
                                      const float (&)[SG_KP]) {}

  template <bool WRITE_Y>
  __device__ __forceinline__ void window(const SegArgs& a,
                                         const SegBlock<NS>& k, int w0,
                                         const float (&dv)[SG_KP],
                                         const float (&du)[SG_KP],
                                         const SegRows* b_s,
                                         const SegRows* c_s,
                                         float (&yv)[SG_KP]) {
    const int lane = k.lane;
    // a stack shorter than the window spans `lps` lanes; a longer one,
    // whole windows (lps = 32)
    const int lps = min(32, a.sub / SG_KP);
    const int lin = lane & (lps - 1);  // the lane's place in its stack
    // a long stack: does it start, end, in this window (it ends at the
    // segment's end too)
    const bool starts = w0 % a.sub == 0;
    const bool ends = (w0 + SG_WIN) % a.sub == 0 || w0 + SG_WIN >= k.slen;
    // states past N: A = 0 and B = C = 0 keep them at 0
#pragma unroll
    for (int jj = 0; jj < NP; ++jj) {
      const int j0 = 2 * jj, j1 = 2 * jj + 1;
      St e[SG_KP];
#pragma unroll
      for (int p = 0; p < SG_KP; ++p) {
        e[p] = St::of(exp2_ftz(dv[p] * k.a2[j0]), exp2_ftz(dv[p] * k.a2[j1]),
                      bf2_of(du[p] * b_s[j0][p * SG_PP + lane],
                             du[p] * b_s[j1][p * SG_PP + lane]));
      }
      // Sklansky over the lane's positions: at level s, each position in
      // the upper half of a block of 2s takes the last of the lower half
#pragma unroll
      for (int s = 1; s < SG_KP; s <<= 1) {
#pragma unroll
        for (int p = 0; p < SG_KP; ++p) {
          if (p & s) e[p] = St::then(e[(p & ~(s - 1)) - 1], e[p]);
        }
      }
      // Hillis-Steele over the lanes of the stack: t, the stack from its
      // start to the end of this lane
      St t = e[SG_KP - 1];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const St ts = t.up(s);
        if (s < lps && lin >= s) t = St::then(ts, t);
      }
      // pre: the stack from its start to the start of this lane
      St pre = t.up(1);
      if (lin == 0) pre = St::ident();
      if (lps == 32 && !starts) pre = St::then(wp[jj], pre);
      // hs: the fp32 state entering this lane's stack; (ta, tb): the
      // window's fp32 map on the carry
      float2 hs, ta, tb;
      const float2 h0 = make_float2(carry[j0], carry[j1]);
      if (lps < 32) {
        // several stacks in the window: each one's total sits at its last
        // lane; an fp32 Hillis-Steele over the stacks, `lps` lanes apart
        const St tot = t.at(lane | (lps - 1));
        float2 ea = tot.af(), eb = __bfloat1622float2(tot.b);
        for (int s = lps; s < 32; s <<= 1) {
          const float pa0 = __shfl_up_sync(FULL, ea.x, s);
          const float pa1 = __shfl_up_sync(FULL, ea.y, s);
          const float pb0 = __shfl_up_sync(FULL, eb.x, s);
          const float pb1 = __shfl_up_sync(FULL, eb.y, s);
          if (lane >= s) {
            eb = make_float2(ea.x * pb0 + eb.x, ea.y * pb1 + eb.y);
            ea = make_float2(ea.x * pa0, ea.y * pa1);
          }
        }
        ta = make_float2(__shfl_sync(FULL, ea.x, 31),
                         __shfl_sync(FULL, ea.y, 31));
        tb = make_float2(__shfl_sync(FULL, eb.x, 31),
                         __shfl_sync(FULL, eb.y, 31));
        // the stacks before this lane's
        float xa0 = __shfl_up_sync(FULL, ea.x, lps);
        float xa1 = __shfl_up_sync(FULL, ea.y, lps);
        float xb0 = __shfl_up_sync(FULL, eb.x, lps);
        float xb1 = __shfl_up_sync(FULL, eb.y, lps);
        if (lane < lps) xa0 = xa1 = 1.f, xb0 = xb1 = 0.f;
        hs = make_float2(xa0 * h0.x + xb0, xa1 * h0.y + xb1);
      } else {
        hs = h0;
        St full = t.at(31);
        if (!starts) full = St::then(wp[jj], full);
        if (ends) {
          ta = full.af();
          tb = __bfloat1622float2(full.b);
          wp[jj] = St::ident();
        } else {
          ta = make_float2(1.f, 1.f);
          tb = make_float2(0.f, 0.f);
          wp[jj] = full;
        }
      }
      carry[j0] = ta.x * carry[j0] + tb.x;
      carry[j1] = ta.y * carry[j1] + tb.y;
      dec[j0] *= ta.x;
      dec[j1] *= ta.y;
      if (WRITE_Y) {
        // each position: pre then its own (a, b), into its state
        const float2 pa = pre.af(), pb = __bfloat1622float2(pre.b);
#pragma unroll
        for (int p = 0; p < SG_KP; ++p) {
          float hv0, hv1;
          if (LAST_BF16) {
            // composed in bf16, as the TPU's last Hillis-Steele step
            const St q = St::then(pre, e[p]);
            const float2 qa = q.af(), qb = __bfloat1622float2(q.b);
            hv0 = qa.x * hs.x + qb.x;
            hv1 = qa.y * hs.y + qb.y;
          } else {
            // in fp32, straight into the state
            const float2 ea = e[p].af(), eab = e[p].ab();
            const float2 eb = __bfloat1622float2(e[p].b);
            hv0 = pa.x * ea.x * hs.x + (eab.x * pb.x + eb.x);
            hv1 = pa.y * ea.y * hs.y + (eab.y * pb.y + eb.y);
          }
          yv[p] += c_s[j0][p * SG_PP + lane] * hv0 +
                   c_s[j1][p * SG_PP + lane] * hv1;
        }
      }
    }
  }

  __device__ __forceinline__ void store(const SegArgs&, long long,
                                        int) const {}

  __device__ __forceinline__ void finish(const SegArgs& a,
                                         const SegBlock<NS>& k) {
    const int lane = k.lane;
    if (lane < a.N && lane < NS) {
      float h = carry[0], d = dec[0];
#pragma unroll
      for (int j = 1; j < NS; ++j) {
        h = lane == j ? carry[j] : h;
        d = lane == j ? dec[j] : d;
      }
      a.hend[k.hrow * a.N + lane] = h;
      a.aend[k.hrow * a.N + lane] = d;
    }
  }
};

template <int NS>
using StackAB = StackScan<NS, true, false>;
template <int NS>
using StackABLast = StackScan<NS, true, true>;
template <int NS>
using StackB = StackScan<NS, false, false>;
template <int NS>
using StackBLast = StackScan<NS, false, true>;

}  // namespace vmt

// hend, aend, hin: (B, G*Dg, nseg, N) fp32 scratch the caller allocates,
// nseg = ceil(L / seg). seg a multiple of sub; sub a power of two >= 8;
// a_bf16: 1 for v3's (a, b) stack, 0 for v10's b stack; last_bf16: 1 to
// compose each position's last step in bf16 (the TPU's rounding). Forward
// only.
extern "C" int vmt_scan_stack_fwd(
    const void* u, int u_dt, long long su_b, long long su_g, long long su_l,
    long long su_d, const void* dl, int d_dt, long long sd_b, long long sd_g,
    long long sd_l, long long sd_d, const float* A, const void* Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* Cm, int c_dt, long long sc_b, long long sc_g, long long sc_l,
    long long sc_n, const float* Dskip, const float* bias, void* y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d,
    float* hend, float* aend, float* hin, int B, int G, int L, int Dg, int N,
    int seg, int sub, int a_bf16, int last_bf16, int reverse, int softplus,
    void* stream) {
  using namespace vmt;
  if (sub < SG_KP || (sub & (sub - 1)) || seg < sub || seg % sub ||
      reverse) {
    return (int)cudaErrorInvalidValue;
  }
  const SegArgs a{
      u, u_dt, su_b, su_g, su_l, su_d, dl, d_dt, sd_b, sd_g, sd_l, sd_d, A,
      Bm, b_dt, sb_b, sb_g, sb_l, sb_n, Cm, c_dt, sc_b, sc_g, sc_l, sc_n,
      Dskip, bias, y, y_dt, sy_b, sy_g, sy_l, sy_d, nullptr, hend, aend, hin,
      nullptr, nullptr, G, L, Dg, N, seg, sub, 0, softplus};
  if (a_bf16) {
    return last_bf16 ? launch_seg_n<StackABLast>(a, B, stream)
                     : launch_seg_n<StackAB>(a, B, stream);
  }
  return last_bf16 ? launch_seg_n<StackBLast>(a, B, stream)
                   : launch_seg_n<StackB>(a, B, stream);
}
