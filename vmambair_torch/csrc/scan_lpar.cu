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
// Layout: addressed through (b, g, l, d) and (b, g, l, n) strides as
// scan_seq.cu, so it runs on the DL (B, D, L) and the LD (B, L, D) layouts
// alike. Activations fp32 or bf16; A (G*Dg, N), Dskip, bias fp32.
//
// Design: three separate launches on the caller's stream (no grid-wide
// sync). L is cut into segments of `seg` positions at the forward scan's
// positions (reverse scans too).
//  1. scan_lpar_kernel<.., false>, grid (segment, group x channel tile,
//     b): each segment is scanned from a zero state; it writes its end
//     state hend[b, c, s, n] and the sum of its deltas sdel[b, c, s] (its
//     log2-decay is A[c, n] log2(e) sdel, stored once for all n).
//  2. scan_lpar_combine, one thread per (b, c, n): a walk over the
//     segments in scan order (back to front when reverse) gives each its
//     entering state, hin[s] = h; h = exp2(A2 sdel[s]) h + hend[s]. The
//     decay of a long segment underflows to 0 (ftz), which is exact in
//     effect.
//  3. scan_lpar_kernel<.., true>: each segment again, from hin, writing y.
// A block is 4 warps, one channel each, of one group; it walks its segment
// in windows of 256 positions (32 lanes x KP = 8 consecutive positions).
// Per window the block stages the group's B (and C) rows in shared memory
// once for its 4 channels, loaded along L. Per state n (a lane holds
// only its KP decays and inputs of a state): each lane scans its KP
// positions in registers, a 5-step warp-shuffle Hillis-Steele over the
// lanes' (decay product, end state) pairs gives every lane its entering
// state (the v1 form: Hillis inside a window, sequential across windows),
// and in pass 3 the lane replays its positions from it for y. Positions
// past the segment's end get delta = 0, which leaves the state as it is.
//
// What bounds it on the H100: the SFU. The function needs one exp2 per
// (b, l, d, n); passes 1 and 3 each take one, so the kernel issues twice
// the function's exp2s and reads u, delta and B twice. Unlike the
// sequential walks (K4, scan_seq.cu) every SM is busy: B * G *
// ceil(Dg / 4) * ceil(L / seg) blocks.
#include "common.cuh"

namespace vmt {

constexpr int LP_KP = 8;      // consecutive positions per lane
constexpr int LP_WIN = 32 * LP_KP;
constexpr int LP_WARPS = 4;   // channels to a block, one per warp
constexpr int LP_THREADS = 32 * LP_WARPS;
constexpr int LP_PP = 33;     // shared pitch of a position-in-lane row
constexpr int LP_MAX_N = 16;
constexpr unsigned FULL = 0xffffffffu;

template <int NS, bool WRITE_Y>
__global__ void __launch_bounds__(LP_THREADS) scan_lpar_kernel(
    const void* __restrict__ u, int u_dt, long long su_b, long long su_g,
    long long su_l, long long su_d, const void* __restrict__ dl, int d_dt,
    long long sd_b, long long sd_g, long long sd_l, long long sd_d,
    const float* __restrict__ A, const void* __restrict__ Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* __restrict__ Cm, int c_dt, long long sc_b, long long sc_g,
    long long sc_l, long long sc_n, const float* __restrict__ Dskip,
    const float* __restrict__ bias, void* __restrict__ y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d,
    float* __restrict__ hend, float* __restrict__ sdel,
    const float* __restrict__ hin, int G, int L, int Dg, int N, int seg,
    int reverse, int softplus) {
  // the window's B rows (and C rows), state n at [n][p * LP_PP + lane] for
  // the window's position 8 lane + p: conflict-free for the lanes' reads
  __shared__ float b_s[LP_MAX_N][LP_KP * LP_PP];
  __shared__ float c_s[WRITE_Y ? LP_MAX_N : 1][LP_KP * LP_PP];
  const int lane = threadIdx.x & 31;
  const int ntile = (Dg + LP_WARPS - 1) / LP_WARPS;
  const int g = blockIdx.y / ntile;
  const int d = (blockIdx.y % ntile) * LP_WARPS + (threadIdx.x >> 5);
  // a warp past the group's channels stages with the block and writes
  // nothing: it reads the group's last channel
  const bool active = d < Dg;
  const int c = g * Dg + min(d, Dg - 1);
  const int D = G * Dg;
  const int s = blockIdx.x;
  const int b = blockIdx.z;
  const int nseg = gridDim.x;
  const int s0 = s * seg;
  const int slen = min(seg, L - s0);

  float a2[NS], carry[NS];
  const long long hrow = ((long long)b * D + c) * nseg + s;  // (b, c, s)
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a2[j] = j < N ? A[(long long)c * N + j] * LOG2E : 0.f;
    carry[j] = WRITE_Y && j < N ? hin[hrow * N + j] : 0.f;
  }
  const float dsk = Dskip ? Dskip[c] : 0.f;
  const float bs = bias ? bias[c] : 0.f;
  const long long ub = b * su_b + g * su_g + (c - g * Dg) * su_d;
  const long long db = b * sd_b + g * sd_g + (c - g * Dg) * sd_d;
  const long long yb = b * sy_b + g * sy_g + (c - g * Dg) * sy_d;
  const long long bb = b * sb_b + g * sb_g;
  const long long cb = b * sc_b + g * sc_g;
  // position of scan index i of this segment
  auto pos = [&](int i) { return reverse ? s0 + slen - 1 - i : s0 + i; };
  float dsum = 0.f;

  for (int w0 = 0; w0 < slen; w0 += LP_WIN) {
    const int wlen = min(LP_WIN, slen - w0);
    // this lane's positions (scan index w0 + KP * lane + p) and the
    // window's B (and C) rows, thread q staging window positions q and
    // q + 128 of every row: raw bits (ld_raw_n), all of a thread's loads in
    // flight at once, converted after.
    int tp[LP_KP];
#pragma unroll
    for (int p = 0; p < LP_KP; ++p) {
      const int i = LP_KP * lane + p;
      tp[p] = i < wlen ? pos(w0 + i) : -1;
    }
    int tq[2];  // the staged positions q, q + 128
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int q = threadIdx.x + LP_THREADS * hq;
      tq[hq] = q < wlen ? pos(w0 + q) : -1;
    }
    uint32_t ru[LP_KP], rd[LP_KP], rb[2 * NS], rc[2 * NS];
    auto lane_ok = [&](int p) { return tp[p] >= 0; };
    ld_raw_n(ru, u, u_dt, [&](int p) { return ub + tp[p] * su_l; }, lane_ok);
    ld_raw_n(rd, dl, d_dt, [&](int p) { return db + tp[p] * sd_l; },
             lane_ok);
    // staged element e: state e % NS of position tq[e / NS]; rows past N
    // and positions past the window stay 0
    auto row_ok = [&](int e) { return e % NS < N && tq[e / NS] >= 0; };
#pragma unroll
    for (int e = 0; e < 2 * NS; ++e) rb[e] = rc[e] = 0u;
    ld_raw_n(rb, Bm, b_dt,
             [&](int e) { return bb + (e % NS) * sb_n + tq[e / NS] * sb_l; },
             row_ok);
    if (WRITE_Y) {
      ld_raw_n(rc, Cm, c_dt,
               [&](int e) {
                 return cb + (e % NS) * sc_n + tq[e / NS] * sc_l;
               },
               row_ok);
    }
    float dv[LP_KP], du[LP_KP], yv[LP_KP];
#pragma unroll
    for (int p = 0; p < LP_KP; ++p) {
      float dd = 0.f, uu = 0.f;
      if (tp[p] >= 0) {
        uu = raw_f32(ru[p], u_dt);
        dd = raw_f32(rd[p], d_dt) + bs;
        if (softplus) dd = softplus20(dd);
      }
      dv[p] = dd;
      du[p] = dd * uu;
      yv[p] = dsk * uu;
      dsum += dd;
    }
    __syncthreads();  // the previous window's reads of b_s, c_s are done
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int q = threadIdx.x + LP_THREADS * hq;
      const int at = (q % LP_KP) * LP_PP + q / LP_KP;
#pragma unroll
      for (int j = 0; j < NS; ++j) {  // rows past N are zeros
        b_s[j][at] = raw_f32(rb[hq * NS + j], b_dt);
        if (WRITE_Y) c_s[j][at] = raw_f32(rc[hq * NS + j], c_dt);
      }
    }
    __syncthreads();
    // unguarded over the NS states: past N, A = 0 and B = C = 0 keep a
    // state at 0, and the states' chains interleave
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float a[LP_KP], x[LP_KP];
      float P = 1.f, H = 0.f;  // the lane's decay product and end state
#pragma unroll
      for (int p = 0; p < LP_KP; ++p) {
        a[p] = exp2_ftz(dv[p] * a2[j]);
        x[p] = du[p] * b_s[j][p * LP_PP + lane];
        H = a[p] * H + x[p];
        P *= a[p];
      }
      // inclusive Hillis-Steele over the lanes: (P, H) of lanes 0..lane
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const float Pp = __shfl_up_sync(FULL, P, k);
        const float Hp = __shfl_up_sync(FULL, H, k);
        if (lane >= k) {
          H = P * Hp + H;
          P = P * Pp;
        }
      }
      const float hl = P * carry[j] + H;  // state after the lane's positions
      const float prev = __shfl_up_sync(FULL, hl, 1);
      if (WRITE_Y) {
        float hh = lane ? prev : carry[j];
#pragma unroll
        for (int p = 0; p < LP_KP; ++p) {
          hh = a[p] * hh + x[p];
          yv[p] += c_s[j][p * LP_PP + lane] * hh;
        }
      }
      carry[j] = __shfl_sync(FULL, hl, 31);
    }
    if (WRITE_Y && active) {
#pragma unroll
      for (int p = 0; p < LP_KP; ++p) {
        if (tp[p] >= 0) st_act(y, yb + tp[p] * sy_l, y_dt, yv[p]);
      }
    }
  }
  if (!WRITE_Y && active) {
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) dsum += __shfl_xor_sync(FULL, dsum, k);
    if (lane < N && lane < NS) {
      float v = carry[0];
#pragma unroll
      for (int j = 1; j < NS; ++j) v = lane == j ? carry[j] : v;
      hend[hrow * N + lane] = v;
    }
    if (lane == 0) sdel[hrow] = dsum;
  }
}

// Pass 2: the entering state of every segment, one thread per (b, c, n).
__global__ void scan_lpar_combine(const float* __restrict__ A,
                                  const float* __restrict__ hend,
                                  const float* __restrict__ sdel,
                                  float* __restrict__ hin, int B, int D,
                                  int N, int nseg, int reverse) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * D * N) return;
  const int n = (int)(idx % N);
  const long long bc = idx / N;  // b * D + c
  const int c = (int)(bc % D);
  const float a2 = A[(long long)c * N + n] * LOG2E;
  float h = 0.f;
  for (int k = 0; k < nseg; ++k) {
    const int s = reverse ? nseg - 1 - k : k;
    const long long row = bc * nseg + s;
    hin[row * N + n] = h;
    h = exp2_ftz(a2 * sdel[row]) * h + hend[row * N + n];
  }
}

template <int NS, typename... Args>
static int launch_lpar(dim3 grid, cudaStream_t st, const float* A,
                       float* hend, float* sdel, float* hin, int B, int D,
                       int N, int nseg, int reverse, Args... args) {
  // pass 1 and pass 3 take the same arguments; each ignores the pointers
  // it does not use
  scan_lpar_kernel<NS, false><<<grid, LP_THREADS, 0, st>>>(args...);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long threads = (long long)B * D * N;
  scan_lpar_combine<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      A, hend, sdel, hin, B, D, N, nseg, reverse);
  err = (int)cudaGetLastError();
  if (err) return err;
  scan_lpar_kernel<NS, true><<<grid, LP_THREADS, 0, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace vmt

// hend, hin: (B, G*Dg, nseg, N) fp32; sdel: (B, G*Dg, nseg) fp32; scratch
// the caller allocates, nseg = ceil(L / seg).
extern "C" int vmt_scan_lpar_fwd(
    const void* u, int u_dt, long long su_b, long long su_g, long long su_l,
    long long su_d, const void* dl, int d_dt, long long sd_b, long long sd_g,
    long long sd_l, long long sd_d, const float* A, const void* Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* Cm, int c_dt, long long sc_b, long long sc_g, long long sc_l,
    long long sc_n, const float* Dskip, const float* bias, void* y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d,
    float* hend, float* sdel, float* hin, int B, int G, int L, int Dg, int N,
    int seg, int reverse, int softplus, void* stream) {
  using namespace vmt;
  const int D = G * Dg;
  const int tiles = G * ((Dg + LP_WARPS - 1) / LP_WARPS);
  if (N < 1 || N > LP_MAX_N || seg < 1 || L < 1 || Dg < 1 || B > 65535 ||
      tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int nseg = (L + seg - 1) / seg;
  const dim3 grid(nseg, tiles, B);
  cudaStream_t st = (cudaStream_t)stream;
#define VMT_LPAR_LAUNCH(NS_)                                                  \
  launch_lpar<NS_>(grid, st, A, hend, sdel, hin, B, D, N, nseg, reverse, u,  \
                   u_dt, su_b, su_g, su_l, su_d, dl, d_dt, sd_b, sd_g, sd_l, \
                   sd_d, A, Bm, b_dt, sb_b, sb_g, sb_l, sb_n, Cm, c_dt,      \
                   sc_b, sc_g, sc_l, sc_n, Dskip, bias, y, y_dt, sy_b, sy_g, \
                   sy_l, sy_d, hend, sdel, (const float*)hin, G, L, Dg, N,   \
                   seg, reverse, softplus)
  if (N <= 4) return VMT_LPAR_LAUNCH(4);
  if (N <= 8) return VMT_LPAR_LAUNCH(8);
  return VMT_LPAR_LAUNCH(16);
#undef VMT_LPAR_LAUNCH
}
