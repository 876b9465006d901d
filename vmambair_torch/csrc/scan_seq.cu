// The sequential-over-L register scan: K7 and the sequential probes.
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
// Design: one thread per (b, channel) walks L (back to front when reverse)
// with its N <= 16 fp32 states in registers (NS, a template argument: 8
// or 16). A block is a tile of 32 channels of one (b, group). u, delta,
// B_t and C_t come through shared memory in windows of `win` <= 16
// positions (WCAP, a template argument of 1, 8 or 16, >= win, sizes
// the registers below), staged by the block with consecutive
// threads on whichever index is contiguous in memory (along L for the DL
// layout: the window is staged transposed, so global loads run along L);
// y leaves through shared memory the same way. Each thread fetches its
// share of the next window into registers while the current window is
// scanned, as Pallas's block pipelining fetches kseq's next block on the
// TPU: raw bits, converted only when staged (ld_raw_n in common.cuh),
// because a load whose value is converted in place stalls the warp until
// it lands (one load latency per element, paid in series). win = 1 is kseq's kernel_seq, 8
// and 16 its kernel_seq_win.
//
// What bounds it on the H100: each position costs a thread N exp2s on the
// SFU and N independent FMAs on the state; with one thread per (b,
// channel) the probe shape (B = 8, D = 192) fills 48 warps on 132 SMs, one
// warp to an SM sub-partition, so the walk is bound by one warp's issue:
// about L x N SFU issues of 8 clocks. The register state is the point of
// the design: the TPU spilled its 16-vreg state to VMEM every step
// (tools/kseq.py:28-41); the ptxas report in build.log says whether this
// kernel spills.
#include "common.cuh"

namespace vmt {

constexpr int SEQ_TC = 32;           // channels to a block (one warp)
constexpr int SEQ_TP = SEQ_TC + 1;   // shared row pitch of u, delta, y
constexpr int SEQ_MAX_N = 16;
constexpr int SEQ_MAX_WIN = 16;

// NS: states in registers (>= N); WCAP: window capacity (>= win), which
// sizes the registers a thread fetches the next window into. The states
// past N are padding: A = 0 and B = C = 0 keep them at 0, so the state loop
// runs unguarded and its NS independent chains interleave.
template <int NS, int WCAP>
__global__ void __launch_bounds__(SEQ_TC) scan_seq_kernel(
    const void* __restrict__ u, int u_dt, long long su_b, long long su_g,
    long long su_l, long long su_d, const void* __restrict__ dl, int d_dt,
    long long sd_b, long long sd_g, long long sd_l, long long sd_d,
    const float* __restrict__ A, const void* __restrict__ Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* __restrict__ Cm, int c_dt, long long sc_b, long long sc_g,
    long long sc_l, long long sc_n, const float* __restrict__ Dskip,
    const float* __restrict__ bias, void* __restrict__ y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d, int G,
    int L, int Dg, int N, int win, int reverse, int softplus) {
  // a thread's share of a window: u and delta WCAP elements, B and C EB
  constexpr int EB = WCAP > 1 ? WCAP / 2 : 1;
  static_assert(SEQ_TC % WCAP == 0, "WCAP: a power of two up to 32");
  constexpr int NP = NS + 1;           // shared row pitch of B, C
  extern __shared__ float sm[];
  float* u_s = sm;                     // [win][SEQ_TP]
  float* d_s = u_s + win * SEQ_TP;     // [win][SEQ_TP]
  float* y_s = d_s + win * SEQ_TP;     // [win][SEQ_TP]
  float* b_s = y_s + win * SEQ_TP;     // [win][NP], states past N 0
  float* c_s = b_s + win * NP;         // [win][NP], states past N 0

  const int ntile = (Dg + SEQ_TC - 1) / SEQ_TC;
  const int tile = blockIdx.x % ntile;
  const int g = (blockIdx.x / ntile) % G;
  const int b = blockIdx.x / (ntile * G);
  const int d0 = tile * SEQ_TC;
  const int tc = min(SEQ_TC, Dg - d0);  // channels of this tile
  const int c0 = g * Dg + d0;           // first channel, in [0, G * Dg)
  const int tid = threadIdx.x;
  const bool active = tid < tc;

  float a2[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a2[j] = active && j < N ? A[(long long)(c0 + tid) * N + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }
  const float dsk = active && Dskip ? Dskip[c0 + tid] : 0.f;
  for (int i = tid; i < 2 * win * NP; i += SEQ_TC) b_s[i] = 0.f;
  __syncthreads();  // the padding is written before any staging

  // offsets are in elements of each tensor's own dtype
  const long long ub = b * su_b + g * su_g + d0 * su_d;
  const long long db = b * sd_b + g * sd_g + d0 * sd_d;
  const long long yb = b * sy_b + g * sy_g + d0 * sy_d;
  const long long bb = b * sb_b + g * sb_g;
  const long long cb = b * sc_b + g * sc_g;
  const bool u_lfast = su_l == 1, d_lfast = sd_l == 1, y_lfast = sy_l == 1;
  const bool b_lfast = sb_l == 1, c_lfast = sc_l == 1;
  const int nwin = (L + win - 1) / win;
  auto first_pos = [&](int k) { return (reverse ? nwin - 1 - k : k) * win; };

  // Which element of a window a thread holds in its e-th register: a
  // (channel x, position t) of u and delta, a (state n, position t) of B
  // and C. Consecutive threads run along L when L is contiguous in memory
  // (WCAP positions, then the next channel or state), else along x or n.
  auto act_at = [&](int e, bool lfast, int& x, int& t) {
    if (lfast) { x = tid / WCAP + (SEQ_TC / WCAP) * e; t = tid % WCAP; }
    else { x = tid; t = e; }
  };
  auto bc_at = [&](int e, bool lfast, int& n, int& t) {
    if (lfast) { n = tid / WCAP + (SEQ_TC / WCAP) * e; t = tid % WCAP; }
    else { n = tid % SEQ_MAX_N; t = tid / SEQ_MAX_N + 2 * e; }
  };

  // the next window, fetched into registers while the current one is
  // scanned: raw bits, converted only when staged, so all of a thread's
  // loads are in flight at once
  uint32_t ru[WCAP], rd[WCAP], rb[EB], rc[EB];
  auto fetch = [&](int k) {
    const int t0 = first_pos(k), len = min(win, L - t0);
    // one tensor's share: its (x or n, t) mapping, offset and mask
    auto act = [&](uint32_t (&r)[WCAP], const void* p, int dt, bool lfast,
                   long long base, long long sx, long long sl) {
      ld_raw_n(r, p, dt,
               [&](int e) {
                 int x, t;
                 act_at(e, lfast, x, t);
                 return base + x * sx + (t0 + t) * sl;
               },
               [&](int e) {
                 int x, t;
                 act_at(e, lfast, x, t);
                 return x < tc && t < len;
               });
    };
    auto bcs = [&](uint32_t (&r)[EB], const void* p, int dt, bool lfast,
                   long long base, long long sn, long long sl) {
      ld_raw_n(r, p, dt,
               [&](int e) {
                 int n, t;
                 bc_at(e, lfast, n, t);
                 return base + n * sn + (t0 + t) * sl;
               },
               [&](int e) {
                 int n, t;
                 bc_at(e, lfast, n, t);
                 return n < N && t < len;
               });
    };
    act(ru, u, u_dt, u_lfast, ub, su_d, su_l);
    act(rd, dl, d_dt, d_lfast, db, sd_d, sd_l);
    bcs(rb, Bm, b_dt, b_lfast, bb, sb_n, sb_l);
    bcs(rc, Cm, c_dt, c_lfast, cb, sc_n, sc_l);
  };

  fetch(0);
  for (int k = 0; k < nwin; ++k) {
    const int t0 = first_pos(k), len = min(win, L - t0);
    // registers -> shared, delta through bias and softplus; the previous
    // window's reads of u_s .. c_s ended before the last barrier
#pragma unroll
    for (int e = 0; e < WCAP; ++e) {
      int x, t;
      act_at(e, u_lfast, x, t);
      if (x < tc && t < len) u_s[t * SEQ_TP + x] = raw_f32(ru[e], u_dt);
      act_at(e, d_lfast, x, t);
      if (x < tc && t < len) {
        float dv = raw_f32(rd[e], d_dt);
        if (bias) dv += bias[c0 + x];
        if (softplus) dv = softplus20(dv);
        d_s[t * SEQ_TP + x] = dv;
      }
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      int n, t;
      bc_at(e, b_lfast, n, t);
      if (n < N && t < len) b_s[t * NP + n] = raw_f32(rb[e], b_dt);
      bc_at(e, c_lfast, n, t);
      if (n < N && t < len) c_s[t * NP + n] = raw_f32(rc[e], c_dt);
    }
    __syncthreads();
    if (k + 1 < nwin) fetch(k + 1);
    if (active) {
      for (int s = 0; s < len; ++s) {
        const int t = reverse ? len - 1 - s : s;
        const float dv = d_s[t * SEQ_TP + tid];
        const float uv = u_s[t * SEQ_TP + tid];
        const float du = dv * uv;
        const float* bt = b_s + t * NP;
        const float* ct = c_s + t * NP;
        float acc[4] = {dsk * uv, 0.f, 0.f, 0.f};  // 4 short chains
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          h[j] = exp2_ftz(dv * a2[j]) * h[j] + du * bt[j];
          acc[j & 3] += ct[j] * h[j];
        }
        y_s[t * SEQ_TP + tid] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < WCAP; ++e) {
      int x, t;
      act_at(e, y_lfast, x, t);
      if (x < tc && t < len) {
        st_act(y, yb + x * sy_d + (t0 + t) * sy_l, y_dt, y_s[t * SEQ_TP + x]);
      }
    }
    // y_s is rewritten only after the next window's barrier, which every
    // thread reaches after this store
  }
}

template <int NS, int WCAP, typename... Args>
static int launch_seq(int blocks, size_t smem, cudaStream_t stream,
                      Args... args) {
  scan_seq_kernel<NS, WCAP><<<blocks, SEQ_TC, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int NS, typename... Args>
static int launch_seq_win(int win, int blocks, size_t smem,
                          cudaStream_t stream, Args... args) {
  if (win <= 1) return launch_seq<NS, 1>(blocks, smem, stream, args...);
  if (win <= 8) return launch_seq<NS, 8>(blocks, smem, stream, args...);
  return launch_seq<NS, 16>(blocks, smem, stream, args...);
}

}  // namespace vmt

extern "C" int vmt_scan_seq_fwd(
    const void* u, int u_dt, long long su_b, long long su_g, long long su_l,
    long long su_d, const void* dl, int d_dt, long long sd_b, long long sd_g,
    long long sd_l, long long sd_d, const float* A, const void* Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* Cm, int c_dt, long long sc_b, long long sc_g, long long sc_l,
    long long sc_n, const float* Dskip, const float* bias, void* y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d, int B,
    int G, int L, int Dg, int N, int win, int reverse, int softplus,
    void* stream) {
  using namespace vmt;
  if (N < 1 || N > SEQ_MAX_N || win < 1 || win > SEQ_MAX_WIN || L < 1 ||
      Dg < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // B and C rows at the pitch of the largest NS
  const size_t smem =
      sizeof(float) * (size_t)win * (3 * SEQ_TP + 2 * (SEQ_MAX_N + 1));
  const int blocks = B * G * ((Dg + SEQ_TC - 1) / SEQ_TC);
  cudaStream_t st = (cudaStream_t)stream;
#define VMT_SEQ_LAUNCH(NS_)                                                 \
  launch_seq_win<NS_>(win, blocks, smem, st, u, u_dt, su_b, su_g, su_l,    \
                      su_d, dl, d_dt, sd_b, sd_g, sd_l, sd_d, A, Bm, b_dt, \
                      sb_b, sb_g, sb_l, sb_n, Cm, c_dt, sc_b, sc_g, sc_l,  \
                      sc_n, Dskip, bias, y, y_dt, sy_b, sy_g, sy_l, sy_d,  \
                      G, L, Dg, N, win, reverse, softplus)
  if (N <= 8) return VMT_SEQ_LAUNCH(8);
  return VMT_SEQ_LAUNCH(16);
#undef VMT_SEQ_LAUNCH
}
