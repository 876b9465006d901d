// The separated-exponent scans: the matmul dual and the cumsum form.
//
// Replaces, on the card, kvariants' (tools/kvariants.py) kernel_v22 (:784;
// with Z in bf16, v23), kernel_v24 (:863; mid-referenced, v25), kernel_v26
// (:955) and kernel_v4 (:151). Within each window of `sub` positions, cut
// into blocks of `blk`, with sigma_t the block-local inclusive cumsum of
// delta and s_t = A log2(e) sigma_t:
//   Z_p = exp2(min(-s_p, 120)) b_p,  b_p = delta_p u_p B_p
//   H_t = sum_{p <= t, same block} Z_p        (the TPU's Z @ T)
//   h_t = exp2(s_t) H_t, then the blocks chained by their end states,
// the state entering the window folded into its first b as
// b_0 += exp2(A log2(e) delta_0) carry. The forms differ in how the blocks
// chain and where a value is rounded:
//   v22  E = exp2(s); block j: h = E (H + h at block j-1's end), one block
//        after another; ZBF16: Z rounded to bf16 before the sum (v23);
//   v24  E = exp2(min(s, 120)); h = E H + E c_j, c_0 = 0, c_1 = e_0,
//        c_j = e_{j-1} + d_{j-1} c_{j-1}, e the blocks' end h = E H and d
//        their end E; MID (v25): sigma referenced at the block's lane
//        blk/2 - 1, d = E_end exp2(A2 sigma_mid), c_j scaled by
//        exp2(A2 sigma_mid) (both clamps can bind);
//   v26  v25 with e = exp2(A2 (sigma_end - sigma_mid)) H_end and d =
//        exp2(A2 sigma_end) recomputed from sigma's block ends, and one
//        h = E (H + c_j);
//   v4   the window one block, natural exp and no clamp: h = exp(A sigma)
//        (cumsum_t du B exp(-A sigma) + carry).
// Subnormals are flushed to zero where a later factor up to 2^120 would
// make them count, at the plain versions' points: every exp2 (it is
// ex2.approx.ftz) and exp, Z, H and the mid-scaled block states c. The
// TPU has no subnormals. y = C h + D u in fp32.
//
// The windows are walked one after another along L, the carry from one to
// the next as the TPU kernels carry it across windows and chunks (the
// TPU's grid chunk plays no part in the function). Where a clamp binds
// the window is no exact composition of its parts, so L is not split
// across blocks: one warp walks a (b, channel) row from end to end.
//
// Layout: u, delta and y through (b, g, l, d) strides, B and C through
// (b, g, l, n) strides (the view-addressed scans' convention, scan_seq.cu);
// A (G*Dg, N), Dskip, bias fp32; activations fp32 or bf16. Reverse scans
// address position L-1-i for scan index i: the reverse function is the
// forward one on the flipped sequence (causality, block ends, mid lanes
// and window order all flip with it), as the plain versions define it.
//
// Design: a block of 4 warps, one channel each, of one group. Lane l holds
// the window's KP = sub/32 consecutive positions l KP .. l KP + KP - 1.
// Per window the block stages the group's B and C rows for the window in
// shared memory; each lane converts its own positions' u and delta. sigma
// is computed once per (channel, position) and shared by the N states:
// a sum over the lane's KP positions, then a segmented Hillis-Steele over
// the lanes of each block by shuffles. Per state, H is the same segmented
// sum of Z (the block-triangular product, computed here: no matrix unit, no
// library), and the fix-ups run the m = sub/blk block chain by shuffles
// from the block-end lanes. The carry of each state sits in shared memory
// between windows.
//
// What bounds it on the H100: the walk. A warp runs its row's L/sub windows
// one after another, each state's block sums a chain of log2(blk/KP)
// dependent shuffles and its fix-ups m - 1 more; two exp2s per (b, l, d, n)
// (E and Z) against the exact scans' one. The loads are converted where
// they land (ld_act): issuing each window's loads together as raw bits
// (ld_raw_n), with or without fetching a window ahead, took the kernel to
// 255 registers (two blocks to an SM in place of three) and made it
// 1.1-1.8x slower on an H100.
#include "common.cuh"

namespace vmt {

constexpr int SD_WARPS = 4;  // channels to a block, one per warp
constexpr int SD_THREADS = 32 * SD_WARPS;
constexpr int SD_MAX_N = 16;
constexpr int SD_PP = 33;  // shared pitch of a position-in-lane row
constexpr float SD_CLAMP = 120.f;
constexpr unsigned SD_FULL = 0xffffffffu;

enum { FORM_V4 = 4, FORM_V22 = 22, FORM_V24 = 24, FORM_V26 = 26 };

struct DualArgs {
  const void* u; int u_dt; long long su_b, su_g, su_l, su_d;
  const void* dl; int d_dt; long long sd_b, sd_g, sd_l, sd_d;
  const float* A;
  const void* Bm; int b_dt; long long sb_b, sb_g, sb_l, sb_n;
  const void* Cm; int c_dt; long long sc_b, sc_g, sc_l, sc_n;
  const float* Dskip; const float* bias;
  void* y; int y_dt; long long sy_b, sy_g, sy_l, sy_d;
  int G, L, Dg, N, blk, reverse, softplus;
};

// v's exclusive sum over the lanes before this one in its segment of
// `seg` lanes (a power of two), by a Hillis-Steele over the segment.
__device__ __forceinline__ float seg_exclusive(float v, int lane, int seg) {
  const int lin = lane & (seg - 1);
  float incl = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float o = __shfl_up_sync(SD_FULL, incl, s);
    if (s < seg && lin >= s) incl += o;
  }
  const float ex = __shfl_up_sync(SD_FULL, incl, 1);
  return lin == 0 ? 0.f : ex;
}

// An inclusive sum over positions that restarts at each block: the
// lane's KP positions in order, then the lanes before it in the block.
template <int KP>
__device__ __forceinline__ void block_cumsum(float (&v)[KP], int lane,
                                             int bl) {
#pragma unroll
  for (int p = 1; p < KP; ++p) v[p] += v[p - 1];
  const float ex = seg_exclusive(v[KP - 1], lane, bl);
#pragma unroll
  for (int p = 0; p < KP; ++p) v[p] = ex + v[p];
}

// x, or 0 where x is subnormal.
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < 1.17549435e-38f ? 0.f : x;
}

template <int KP, int FORM, bool MID, bool ZBF16>
__global__ void __launch_bounds__(SD_THREADS)
    scan_dual_kernel(const __grid_constant__ DualArgs a) {
  constexpr int SUB = 32 * KP;
  __shared__ float b_s[SD_MAX_N][KP * SD_PP];
  __shared__ float c_s[SD_MAX_N][KP * SD_PP];
  __shared__ float carry_s[SD_WARPS][SD_MAX_N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ntile = (a.Dg + SD_WARPS - 1) / SD_WARPS;
  const int g = blockIdx.x / ntile;
  const int dd = (blockIdx.x % ntile) * SD_WARPS + warp;
  // a warp past the group's channels stages with the block and writes
  // nothing: it reads the group's last channel
  const bool active = dd < a.Dg;
  const int cd = min(dd, a.Dg - 1);
  const int c = g * a.Dg + cd;
  const int b = blockIdx.y;
  const int blk = FORM == FORM_V4 ? SUB : a.blk;
  const int bl = blk / KP;      // lanes to a block
  const int m = SUB / blk;      // blocks to a window
  const int jb = lane / bl;     // this lane's block
  const int first = jb * bl;    // its first lane
  const float dsk = a.Dskip ? a.Dskip[c] : 0.f;
  const float bs = a.bias ? a.bias[c] : 0.f;
  const long long ub = b * a.su_b + g * a.su_g + cd * a.su_d;
  const long long db = b * a.sd_b + g * a.sd_g + cd * a.sd_d;
  const long long yb = b * a.sy_b + g * a.sy_g + cd * a.sy_d;
  const long long bb = b * a.sb_b + g * a.sb_g;
  const long long cb = b * a.sc_b + g * a.sc_g;
  auto pos = [&](int i) { return a.reverse ? a.L - 1 - i : i; };
  if (lane < SD_MAX_N) carry_s[warp][lane] = 0.f;

  for (int w0 = 0; w0 < a.L; w0 += SUB) {
    float dv[KP], du[KP], yv[KP];
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const long long t = pos(w0 + lane * KP + p);
      const float uu = ld_act(a.u, ub + t * a.su_l, a.u_dt);
      float d = ld_act(a.dl, db + t * a.sd_l, a.d_dt) + bs;
      if (a.softplus) d = softplus20(d);
      dv[p] = d;
      du[p] = d * uu;
      yv[p] = dsk * uu;
    }
    __syncthreads();  // the previous window's reads of b_s, c_s are done
    for (int e = threadIdx.x; e < a.N * SUB; e += SD_THREADS) {
      const int n = e / SUB, i = e % SUB;
      const long long t = pos(w0 + i);
      const int at = (i % KP) * SD_PP + i / KP;
      b_s[n][at] = ld_act(a.Bm, bb + n * a.sb_n + t * a.sb_l, a.b_dt);
      c_s[n][at] = ld_act(a.Cm, cb + n * a.sc_n + t * a.sc_l, a.c_dt);
    }
    __syncthreads();
    // sigma, shared by the N states; its block's mid (lane blk/2 - 1) and
    // end values
    float sig[KP];
#pragma unroll
    for (int p = 0; p < KP; ++p) sig[p] = dv[p];
    block_cumsum(sig, lane, bl);
    const float sig_mid =
        MID ? __shfl_sync(SD_FULL, sig[KP - 1], first + bl / 2 - 1) : 0.f;
    const float sig_end = __shfl_sync(SD_FULL, sig[KP - 1], first + bl - 1);
    float sp[KP];  // sigma as the exponents take it
#pragma unroll
    for (int p = 0; p < KP; ++p) sp[p] = MID ? sig[p] - sig_mid : sig[p];

    for (int n = 0; n < a.N; ++n) {
      const float an = a.A[(long long)c * a.N + n];
      const float a2 = an * LOG2E;
      const float cin = carry_s[warp][n];
      float e[KP], H[KP], h[KP];
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        float bq = du[p] * b_s[n][p * SD_PP + lane];
        if (FORM == FORM_V4) {
          const float x = an * sig[p];
          e[p] = ftz(expf(x));
          H[p] = bq * expf(-x);
        } else {
          if (p == 0 && lane == 0) bq = bq + exp2_ftz(a2 * dv[0]) * cin;
          const float s = a2 * sp[p];
          e[p] = exp2_ftz(FORM == FORM_V22 ? s : fminf(s, SD_CLAMP));
          float z = ftz(exp2_ftz(fminf(-s, SD_CLAMP)) * bq);
          if (ZBF16) z = round_act(z, DT_BF16);
          H[p] = z;
        }
      }
      block_cumsum(H, lane, bl);
      if (FORM != FORM_V4) {
#pragma unroll
        for (int p = 0; p < KP; ++p) H[p] = ftz(H[p]);
      }
      if (FORM == FORM_V4) {
#pragma unroll
        for (int p = 0; p < KP; ++p) h[p] = e[p] * (H[p] + cin);
      } else if (FORM == FORM_V22) {
        // block j: E (H + h at block j-1's end), block after block
        float hprev = 0.f;
        for (int j = 1; j < m; ++j) {
          const float ev = e[KP - 1] * (H[KP - 1] + hprev);
          const float v = __shfl_sync(SD_FULL, ev, j * bl - 1);
          if (jb == j) hprev = v;
        }
#pragma unroll
        for (int p = 0; p < KP; ++p) h[p] = e[p] * (H[p] + hprev);
      } else {
        // the block-end states e (h = E H at the end lane) and decays d,
        // then c_j = e_{j-1} + d_{j-1} c_{j-1}
        float eh, dec, emid = 1.f;
        if (MID) emid = exp2_ftz(a2 * sig_mid);
        if (FORM == FORM_V24) {
          eh = e[KP - 1] * H[KP - 1];
          dec = MID ? e[KP - 1] * emid : e[KP - 1];
        } else {
          eh = exp2_ftz(a2 * (sig_end - sig_mid)) * H[KP - 1];
          dec = exp2_ftz(a2 * sig_end);
        }
        float run = 0.f, cj = 0.f;
        for (int j = 1; j < m; ++j) {
          const float ehj = __shfl_sync(SD_FULL, eh, j * bl - 1);
          const float dj = __shfl_sync(SD_FULL, dec, j * bl - 1);
          run = j == 1 ? ehj : ehj + dj * run;
          if (jb == j) cj = run;
        }
        if (MID) cj = ftz(cj * emid);
#pragma unroll
        for (int p = 0; p < KP; ++p) {
          h[p] = FORM == FORM_V24 ? e[p] * H[p] + e[p] * cj
                                  : e[p] * (H[p] + cj);
        }
      }
      if (lane == 31) carry_s[warp][n] = h[KP - 1];
#pragma unroll
      for (int p = 0; p < KP; ++p) yv[p] += c_s[n][p * SD_PP + lane] * h[p];
    }
    if (active) {
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        st_act(a.y, yb + (long long)pos(w0 + lane * KP + p) * a.sy_l, a.y_dt,
               yv[p]);
      }
    }
  }
}

template <int KP, int FORM, bool MID, bool ZBF16>
static int launch_dual(const DualArgs& a, int B, cudaStream_t st) {
  const dim3 grid(a.G * ((a.Dg + SD_WARPS - 1) / SD_WARPS), B);
  scan_dual_kernel<KP, FORM, MID, ZBF16><<<grid, SD_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KP>
static int launch_form(const DualArgs& a, int B, int form, int mid,
                       int zbf16, cudaStream_t st) {
  switch (form) {
    case FORM_V4:
      return launch_dual<KP, FORM_V4, false, false>(a, B, st);
    case FORM_V22:
      return zbf16 ? launch_dual<KP, FORM_V22, false, true>(a, B, st)
                   : launch_dual<KP, FORM_V22, false, false>(a, B, st);
    case FORM_V24:
      return mid ? launch_dual<KP, FORM_V24, true, false>(a, B, st)
                 : launch_dual<KP, FORM_V24, false, false>(a, B, st);
    default:
      return launch_dual<KP, FORM_V26, true, false>(a, B, st);
  }
}

}  // namespace vmt

// sub 128 or 256, L a multiple of sub; blk 16, 32, 64 or 128, at most sub
// (ignored for form 4, whose block is the window); form 22, 24, 26 or 4;
// mid only with form 24 (form 26 is always mid-referenced); zbf16 only
// with form 22. N <= 16. Forward only.
extern "C" int vmt_scan_dual_fwd(
    const void* u, int u_dt, long long su_b, long long su_g, long long su_l,
    long long su_d, const void* dl, int d_dt, long long sd_b, long long sd_g,
    long long sd_l, long long sd_d, const float* A, const void* Bm, int b_dt,
    long long sb_b, long long sb_g, long long sb_l, long long sb_n,
    const void* Cm, int c_dt, long long sc_b, long long sc_g, long long sc_l,
    long long sc_n, const float* Dskip, const float* bias, void* y, int y_dt,
    long long sy_b, long long sy_g, long long sy_l, long long sy_d, int B,
    int G, int L, int Dg, int N, int sub, int blk, int form, int mid,
    int zbf16, int reverse, int softplus, void* stream) {
  using namespace vmt;
  const bool blk_ok = blk == 16 || blk == 32 || blk == 64 || blk == 128;
  const bool form_ok = form == FORM_V4 || form == FORM_V22 ||
                       form == FORM_V24 || form == FORM_V26;
  const long long tiles = (long long)G * ((Dg + SD_WARPS - 1) / SD_WARPS);
  if ((sub != 128 && sub != 256) || !blk_ok || blk > sub || !form_ok ||
      (mid && form != FORM_V24) || (zbf16 && form != FORM_V22) || L < sub ||
      L % sub || N < 1 || N > SD_MAX_N || Dg < 1 || B < 1 || B > 65535 ||
      tiles > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const DualArgs a{
      u, u_dt, su_b, su_g, su_l, su_d, dl, d_dt, sd_b, sd_g, sd_l, sd_d, A,
      Bm, b_dt, sb_b, sb_g, sb_l, sb_n, Cm, c_dt, sc_b, sc_g, sc_l, sc_n,
      Dskip, bias, y, y_dt, sy_b, sy_g, sy_l, sy_d, G, L, Dg, N, blk,
      reverse, softplus};
  cudaStream_t st = (cudaStream_t)stream;
  return sub == 128 ? launch_form<4>(a, B, form, mid, zbf16, st)
                    : launch_form<8>(a, B, form, mid, zbf16, st);
}
