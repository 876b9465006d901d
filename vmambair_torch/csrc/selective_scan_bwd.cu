// K3: the selective-scan backward.
//
// Replaces vmambair_tpu/ops/pallas_scan.py::_scan_bwd_kernel (built by
// _build_pallas_bwd, reduced by _scan_bwd_dl). Given the forward's inputs,
// the output cotangent dy and the fp32 state entering each chunk (saved by
// the carry-saving forwards K1c/K4c), it computes, per chunk walked in the
// opposite direction to the forward:
//   h_t   recomputed from the chunk's carry;
//   dh_t  = C_t dy_t + a_{t+1} dh_{t+1}      (a_t = exp(delta_t A)),
//           the decay of the chunk's first scanned position folded into the
//           dh carried to the next chunk walked;
//   w_t   = dh_t a_t h_{t-1}                  (product kept from the recompute)
//   du    = delta sum_n B_n dh_n + D dy
//   ddelta_raw = (u sum_n B_n dh_n + sum_n A_n w_n) * sigmoid(raw)  (softplus;
//           the raw delta is linear above 20, where the factor is 1)
//   dB_n  = sum_d delta u dh_n,  dC_n = sum_d dy h_n   (over the group)
//   dA_n  = sum_t delta w_n,  dD = sum_t dy u,  dbias = sum_t ddelta_raw
// in fp32 (the sums over states and over channels in fp64), for forward
// and reverse scans. Inputs are addressed through their
// strides as in K4 (u, delta, dy (B, L, D); B, C (B, L, G, N)), fp32 or
// bf16 each.
//
// Reductions across blocks are left to the caller, as _scan_bwd_dl does:
// dB/dC come out per channel tile (B, D/T, N, L), dA per batch (B, D, N),
// dD and dbias per batch (B, D); the wrapper sums them with torch. Every
// sum inside the block runs in a fixed order, so the result is the same
// from run to run (no atomics).
//
// What bounds it on the H100: like the forwards, the walk over L: per
// chunk two dependent passes over its positions (recompute, then the
// adjoint), each an exp and a log-depth tree of FMAs per state, and
// barriers around the cross-thread sums. Its bytes (inputs read once,
// du/ddelta and the partials written once) take a fraction of that time.
//
// Design: one block of 512 threads per (b, tile of T <= 8 channels of one
// group) (of 128, 256, 512 and 1024 threads the fastest at the training
// shapes); states go in passes of 16 (any N <= 256). Per chunk the block
// stages u, delta (bias and softplus applied, with the softplus
// derivative), dy and the group's B/C rows in shared memory. A chunk of CH
// = 32 positions is one warp wide: each warp takes the (channel, state)
// pairs of the pass in turn, lane i holding the chunk's i-th position in
// scan order, and runs both passes as the TPU kernel's _scan_block does, a
// Hillis-Steele tree of 5 shuffle steps over the affine pairs:
//   recompute  (a_t, b_t = delta_t u_t B_t), the chunk's carry folded into
//              its first pair (b <- a h_carry + b), giving h_t and
//              a_t h_{t-1};
//   adjoint    (a_{t+1}, C_t dy_t) in the opposite order, the dh carried
//              from the chunk walked before folded into its last pair,
//              giving dh_t and w_t; sum_t delta_t w_t by a butterfly.
// Each factor thus passes through log2(32) = 5 roundings, not up to 32 as
// in a sequential walk. Each pair's h, a h_prev, dh and w go to shared
// memory; the block then sums over states (du, ddelta) and over channels
// (dB, dC partials) from there, in fp64: where the state grows, those
// sums cancel by many orders of magnitude, and summed in fp32 they put K3
// 29% further from the exact gradients (ROADMAP F2's growing recipe). The
// dh carry and the dA sums stay in shared memory across chunks.
//
// a_t is CUDA's expf of delta A, not the SFU's ex2.approx of delta A log2(e)
// that the forwards use: where the state grows (a_t > 1), each factor's
// rounding reaches the gradients undamped, and the SFU's exp put K3 up to
// 10x further from the exact gradients than the fp32 plain version
// (tests/test_torch_port_cuda.py, the growing recipe).
#include "common.cuh"

namespace vmt {

constexpr int K3_NB = 16;       // states per pass
constexpr int K3_TMAX = 8;      // channels per block
constexpr int K3_THREADS = 512;
static_assert(CH == 32, "K3 runs a chunk as one warp, a position per lane");

__global__ void __launch_bounds__(K3_THREADS) selective_scan_bwd_kernel(
    const void* __restrict__ u, int u_dt, long long su_b, long long su_d,
    long long su_l, const void* __restrict__ dl, int d_dt, long long sd_b,
    long long sd_d, long long sd_l, const float* __restrict__ A,
    const void* __restrict__ Bm, int b_dt, long long sb_b, long long sb_g,
    long long sb_n, long long sb_l, const void* __restrict__ Cm, int c_dt,
    long long sc_b, long long sc_g, long long sc_n, long long sc_l,
    const float* __restrict__ Dskip, const float* __restrict__ bias,
    const void* __restrict__ dy, int y_dt, long long sy_b, long long sy_d,
    long long sy_l, const float* __restrict__ carries,
    float* __restrict__ du, float* __restrict__ ddl, float* __restrict__ dBp,
    float* __restrict__ dCp, float* __restrict__ dAp,
    float* __restrict__ dDp, float* __restrict__ dbp, int D, int L, int N,
    int G, int T, int reverse, int softplus) {
  extern __shared__ float sm[];
  const int ntile = D / T;
  const int b = blockIdx.x / ntile;
  const int tile = blockIdx.x % ntile;
  const int c0 = tile * T;
  const int g = c0 / (D / G);

  // the sums over states in fp64, first (8-byte aligned)
  double* sB_s = reinterpret_cast<double*>(sm);  // [T][LDS] sum_n B_n dh_n
  double* dAw_s = sB_s + T * LDS;  // [T][LDS] sum_n A_n w_n, then ddelta
  float* d_s = reinterpret_cast<float*>(dAw_s + T * LDS);  // [T][LDS] delta
  float* sg_s = d_s + T * LDS;           // [T][LDS] d delta / d raw
  float* u_s = sg_s + T * LDS;           // [T][LDS]
  float* dy_s = u_s + T * LDS;           // [T][LDS]
  float* B_s = dy_s + T * LDS;           // [N][LDS]
  float* C_s = B_s + N * LDS;            // [N][LDS]
  float* h_s = C_s + N * LDS;            // [T*NB][LDS] h
  float* w_s = h_s + T * K3_NB * LDS;    // [T*NB][LDS] a h_prev, then w
  float* dh_s = w_s + T * K3_NB * LDS;   // [T*NB][LDS] dh
  float* A_s = dh_s + T * K3_NB * LDS;   // [T][N] A
  float* dhc_s = A_s + T * N;            // [T][N] dh carried between chunks
  float* dA_s = dhc_s + T * N;           // [T][N] dA sums

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  for (int i = tid; i < T * N; i += nth) {
    A_s[i] = A[(long long)c0 * N + i];
    dhc_s[i] = 0.f;
    dA_s[i] = 0.f;
  }
  const long long ub = b * su_b + c0 * su_d;
  const long long db = b * sd_b + c0 * sd_d;
  const long long yb = b * sy_b + c0 * sy_d;
  const long long bb = b * sb_b + g * sb_g;
  const long long cb = b * sc_b + g * sc_g;
  const bool u_tfast = su_l == 1;
  const bool d_tfast = sd_l == 1;
  const bool y_tfast = sy_l == 1;
  const bool b_tfast = sb_l == 1;
  const bool c_tfast = sc_l == 1;

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarp = nth / 32;
  float accD = 0.f, accB = 0.f;  // dD, dbias of channel tid (tid < T)

  const int nchunks = (L + CH - 1) / CH;
  for (int k = 0; k < nchunks; ++k) {
    // opposite to the forward: a forward scan's chunks back to front
    const int ck = reverse ? k : nchunks - 1 - k;
    const int t0 = ck * CH;
    const int len = min(CH, L - t0);
    __syncthreads();
    for (int i = tid; i < T * CH; i += nth) {
      int cc, t;
      if (u_tfast) { cc = i / CH; t = i % CH; } else { cc = i % T; t = i / T; }
      u_s[cc * LDS + t] =
          t < len ? ld_act(u, ub + cc * su_d + (t0 + t) * su_l, u_dt) : 0.f;
      if (y_tfast) { cc = i / CH; t = i % CH; } else { cc = i % T; t = i / T; }
      dy_s[cc * LDS + t] =
          t < len ? ld_act(dy, yb + cc * sy_d + (t0 + t) * sy_l, y_dt) : 0.f;
      if (d_tfast) { cc = i / CH; t = i % CH; } else { cc = i % T; t = i / T; }
      float dv = 0.f, sg = 1.f;
      if (t < len) {
        dv = ld_act(dl, db + cc * sd_d + (t0 + t) * sd_l, d_dt);
        if (bias) dv += bias[c0 + cc];
        if (softplus) {
          sg = dv > 20.f ? 1.f : 1.f / (1.f + expf(-dv));
          dv = softplus20(dv);
        }
      }
      d_s[cc * LDS + t] = dv;
      sg_s[cc * LDS + t] = sg;
      sB_s[(i / CH) * LDS + i % CH] = 0.0;
      dAw_s[(i / CH) * LDS + i % CH] = 0.0;
    }
    for (int i = tid; i < N * CH; i += nth) {
      int n, t;
      if (b_tfast) { n = i / CH; t = i % CH; } else { n = i % N; t = i / N; }
      B_s[n * LDS + t] =
          t < len ? ld_act(Bm, bb + n * sb_n + (t0 + t) * sb_l, b_dt) : 0.f;
      if (c_tfast) { n = i / CH; t = i % CH; } else { n = i % N; t = i / N; }
      C_s[n * LDS + t] =
          t < len ? ld_act(Cm, cb + n * sc_n + (t0 + t) * sc_l, c_dt) : 0.f;
    }
    __syncthreads();

    for (int n0 = 0; n0 < N; n0 += K3_NB) {
      const int nb = min(K3_NB, N - n0);
      // lane i: the chunk's i-th position in scan order, at tp; lanes past
      // len hold the identity pair (1, 0)
      const bool in = lane < len;
      const int tp = in ? (reverse ? len - 1 - lane : lane) : 0;
      for (int p = warp; p < T * nb; p += nwarp) {
        const int c = p / nb, j = p % nb, n = n0 + j;
        const int row = (c * K3_NB + j) * LDS + tp;
        const float dt = d_s[c * LDS + tp];
        const float a = in ? expf(dt * A_s[c * N + n]) : 1.f;
        // recompute: h = a h_prev + b, the chunk's carry folded into lane 0
        const float h0 =
            carries[(((long long)b * D + c0 + c) * nchunks + ck) * N + n];
        float hb = in ? dt * u_s[c * LDS + tp] * B_s[n * LDS + tp] : 0.f;
        if (lane == 0) hb = fmaf(a, h0, hb);
        float ha = a;
#pragma unroll
        for (int s = 1; s < 32; s *= 2) {
          const float pa = __shfl_up_sync(0xffffffffu, ha, s);
          const float pb = __shfl_up_sync(0xffffffffu, hb, s);
          if (lane >= s) {
            hb = fmaf(ha, pb, hb);
            ha *= pa;
          }
        }
        const float hprev = __shfl_up_sync(0xffffffffu, hb, 1);
        const float ah = a * (lane == 0 ? h0 : hprev);
        // adjoint: dh = C dy + a_next dh_next, back over the chunk; the dh
        // carried from the chunk walked before is folded into lane len - 1
        const float anext = __shfl_down_sync(0xffffffffu, a, 1);
        float ga = lane + 1 < len ? anext : 1.f;
        float gb = 0.f;
        if (in) {
          const float cv = C_s[n * LDS + tp], yv = dy_s[c * LDS + tp];
          gb = lane == len - 1 ? fmaf(cv, yv, dhc_s[c * N + n]) : cv * yv;
        }
#pragma unroll
        for (int s = 1; s < 32; s *= 2) {
          const float qa = __shfl_down_sync(0xffffffffu, ga, s);
          const float qb = __shfl_down_sync(0xffffffffu, gb, s);
          if (lane + s < 32) {
            gb = fmaf(ga, qb, gb);
            ga *= qa;
          }
        }
        const float w = gb * ah;
        // dA's share of the chunk, a butterfly (the same order every run)
        float dA = in ? dt * w : 0.f;
#pragma unroll
        for (int s = 16; s > 0; s /= 2) {
          dA += __shfl_xor_sync(0xffffffffu, dA, s);
        }
        if (in) {
          h_s[row] = hb;
          dh_s[row] = gb;
          w_s[row] = w;
        }
        if (lane == 0) {
          dhc_s[c * N + n] = a * gb;  // a dh at the chunk's first position
          dA_s[c * N + n] += dA;
        }
      }
      __syncthreads();
      // sums over the pass's states, per (channel, position), in fp64:
      // where the state grows, their terms cancel by many orders
      for (int i = tid; i < T * len; i += nth) {
        const int cc = i / len, t = i % len;
        double sb = 0.0, aw = 0.0;
        for (int jj = 0; jj < nb; ++jj) {
          const int row = (cc * K3_NB + jj) * LDS + t;
          sb += (double)B_s[(n0 + jj) * LDS + t] * dh_s[row];
          aw += (double)A[(long long)(c0 + cc) * N + n0 + jj] * w_s[row];
        }
        sB_s[cc * LDS + t] += sb;
        dAw_s[cc * LDS + t] += aw;
      }
      // sums over the tile's channels, per (state, position), in fp64
      for (int i = tid; i < nb * len; i += nth) {
        const int jj = i / len, t = i % len;
        double sb = 0.0, sc = 0.0;
        for (int cc = 0; cc < T; ++cc) {
          const int row = (cc * K3_NB + jj) * LDS + t;
          sb += (double)(d_s[cc * LDS + t] * u_s[cc * LDS + t]) * dh_s[row];
          sc += (double)dy_s[cc * LDS + t] * h_s[row];
        }
        const long long o =
            (((long long)b * ntile + tile) * N + n0 + jj) * L + t0 + t;
        dBp[o] = (float)sb;
        dCp[o] = (float)sc;
      }
      __syncthreads();
    }

    for (int i = tid; i < T * len; i += nth) {
      const int cc = i / len, t = i % len;
      const double sb = sB_s[cc * LDS + t];
      const float yv = dy_s[cc * LDS + t];
      const float dd = (float)((u_s[cc * LDS + t] * sb + dAw_s[cc * LDS + t])
                               * sg_s[cc * LDS + t]);
      const long long o = ((long long)b * D + c0 + cc) * L + t0 + t;
      du[o] = (float)(d_s[cc * LDS + t] * sb) +
              (Dskip ? Dskip[c0 + cc] * yv : 0.f);
      ddl[o] = dd;
      dAw_s[cc * LDS + t] = dd;
    }
    __syncthreads();
    if (tid < T) {
      for (int t = 0; t < len; ++t) {
        accD += dy_s[tid * LDS + t] * u_s[tid * LDS + t];
        accB += (float)dAw_s[tid * LDS + t];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < T * N; i += nth) {
    dAp[((long long)b * D + c0) * N + i] = dA_s[i];
  }
  if (tid < T) {
    dDp[(long long)b * D + c0 + tid] = accD;
    dbp[(long long)b * D + c0 + tid] = accB;
  }
}

}  // namespace vmt

extern "C" int vmt_selective_scan_bwd(
    const void* u, int u_dt, long long su_b, long long su_l, long long su_d,
    const void* dl, int d_dt, long long sd_b, long long sd_l, long long sd_d,
    const float* A, const void* Bm, int b_dt, long long sb_b, long long sb_l,
    long long sb_g, long long sb_n, const void* Cm, int c_dt, long long sc_b,
    long long sc_l, long long sc_g, long long sc_n, const float* Dskip,
    const float* bias, const void* dy, int y_dt, long long sy_b,
    long long sy_l, long long sy_d, const float* carries, float* du,
    float* ddl, float* dBp, float* dCp, float* dAp, float* dDp, float* dbp,
    int B, int L, int D, int G, int N, int T, int reverse, int softplus,
    void* stream) {
  using namespace vmt;
  // T channels to a block, chosen by the caller (it sets the layout of the
  // dB/dC partials the caller reduces)
  if (T < 1 || T > K3_TMAX || (D / G) % T) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(double) * 2 * (size_t)T * LDS +
      sizeof(float) *
          ((size_t)(4 * T + 2 * N + 3 * T * K3_NB) * LDS + 3 * (size_t)T * N);
  int err = set_smem((const void*)selective_scan_bwd_kernel, smem);
  if (err) return err;
  selective_scan_bwd_kernel<<<B * (D / T), K3_THREADS, smem,
                              (cudaStream_t)stream>>>(
      u, u_dt, su_b, su_d, su_l, dl, d_dt, sd_b, sd_d, sd_l, A, Bm, b_dt,
      sb_b, sb_g, sb_n, sb_l, Cm, c_dt, sc_b, sc_g, sc_n, sc_l, Dskip, bias,
      dy, y_dt, sy_b, sy_d, sy_l, carries, du, ddl, dBp, dCp, dAp, dDp, dbp,
      D, L, N, G, T, reverse, softplus);
  return (int)cudaGetLastError();
}
