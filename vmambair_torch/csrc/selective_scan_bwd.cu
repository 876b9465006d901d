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
// in fp32, for forward and reverse scans. Inputs are addressed through their
// strides as in K4 (u, delta, dy (B, L, D); B, C (B, L, G, N)), fp32 or
// bf16 each.
//
// Reductions across blocks are left to the caller, as _scan_bwd_dl does:
// dB/dC come out per channel tile (B, D/T, N, L), dA per batch (B, D, N),
// dD and dbias per batch (B, D); the wrapper sums them with torch. Every
// sum inside the block runs in a fixed order, so the result is the same
// from run to run (no atomics).
//
// What bounds it on the H100: like the forwards, the sequential walk over
// L: per chunk two dependent passes over its positions (recompute, then
// the adjoint), each an exp2 and an FMA chain per state, and barriers
// around the cross-thread sums. Its bytes (inputs read once, du/ddelta and
// the partials written once) take a fraction of that time.
//
// Design: one block per (b, tile of T <= 8 channels of one group), 16
// threads to a channel, one state each per pass (passes of 16 states cover
// any N <= 256). Per chunk the block stages u, delta (bias and softplus
// applied, with the softplus derivative), dy and the group's B/C rows in
// shared memory; each thread recomputes h and a*h_prev for its (channel,
// state) over the chunk into shared memory, then runs the adjoint back over
// the chunk, storing dh and w beside them; the block then sums over states
// (du, ddelta) and over channels (dB, dC partials) from shared memory. The
// dh carry and the dA sums stay in shared memory across chunks.
#include "common.cuh"

namespace vmt {

constexpr int K3_NB = 16;    // states per pass, one per thread
constexpr int K3_TMAX = 8;   // channels per block

__global__ void __launch_bounds__(K3_NB * K3_TMAX) selective_scan_bwd_kernel(
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

  float* d_s = sm;                       // [T][LDS] delta
  float* sg_s = d_s + T * LDS;           // [T][LDS] d delta / d raw
  float* u_s = sg_s + T * LDS;           // [T][LDS]
  float* dy_s = u_s + T * LDS;           // [T][LDS]
  float* sB_s = dy_s + T * LDS;          // [T][LDS] sum_n B_n dh_n
  float* dAw_s = sB_s + T * LDS;         // [T][LDS] sum_n A_n w_n, then ddelta
  float* B_s = dAw_s + T * LDS;          // [N][LDS]
  float* C_s = B_s + N * LDS;            // [N][LDS]
  float* h_s = C_s + N * LDS;            // [T*NB][LDS] h
  float* w_s = h_s + T * K3_NB * LDS;    // [T*NB][LDS] a h_prev, then w
  float* dh_s = w_s + T * K3_NB * LDS;   // [T*NB][LDS] dh
  float* A2_s = dh_s + T * K3_NB * LDS;  // [T][N] A log2(e)
  float* dhc_s = A2_s + T * N;           // [T][N] dh carried between chunks
  float* dA_s = dhc_s + T * N;           // [T][N] dA sums

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  for (int i = tid; i < T * N; i += nth) {
    A2_s[i] = A[(long long)c0 * N + i] * LOG2E;
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

  // thread (c, j): channel c of the tile, state n0 + j of the pass
  const int c = tid / K3_NB;
  const int j = tid % K3_NB;
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
      sB_s[(i / CH) * LDS + i % CH] = 0.f;
      dAw_s[(i / CH) * LDS + i % CH] = 0.f;
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
      const bool active = j < nb;
      const int n = active ? n0 + j : 0;  // an idle slot reads row 0
      const float a2 = A2_s[c * N + n];
      const float* dc = d_s + c * LDS;
      const float* uc = u_s + c * LDS;
      const float* yc = dy_s + c * LDS;
      const float* bn = B_s + n * LDS;
      const float* cn = C_s + n * LDS;
      float* hrow = h_s + tid * LDS;
      float* wrow = w_s + tid * LDS;
      float* dhrow = dh_s + tid * LDS;
      // recompute the chunk in scan order from the state entering it
      float h = carries[(((long long)b * D + c0 + c) * nchunks + ck) * N + n];
      for (int i = 0; i < len; ++i) {
        const int t = reverse ? len - 1 - i : i;
        const float ah = exp2_ftz(dc[t] * a2) * h;
        h = ah + dc[t] * uc[t] * bn[t];
        hrow[t] = h;
        wrow[t] = ah;
      }
      // the adjoint, back over the chunk; nxt = a_{i+1} dh_{i+1}
      float nxt = dhc_s[c * N + n];
      float dA = 0.f;
      for (int i = len - 1; i >= 0; --i) {
        const int t = reverse ? len - 1 - i : i;
        const float dht = cn[t] * yc[t] + nxt;
        nxt = exp2_ftz(dc[t] * a2) * dht;
        const float w = dht * wrow[t];
        dhrow[t] = dht;
        wrow[t] = w;
        dA += dc[t] * w;
      }
      if (active) {
        dhc_s[c * N + n] = nxt;
        dA_s[c * N + n] += dA;
      }
      __syncthreads();
      // sums over the pass's states, per (channel, position)
      for (int i = tid; i < T * len; i += nth) {
        const int cc = i / len, t = i % len;
        float sb = 0.f, aw = 0.f;
        for (int jj = 0; jj < nb; ++jj) {
          const int row = (cc * K3_NB + jj) * LDS + t;
          sb += B_s[(n0 + jj) * LDS + t] * dh_s[row];
          aw += A[(long long)(c0 + cc) * N + n0 + jj] * w_s[row];
        }
        sB_s[cc * LDS + t] += sb;
        dAw_s[cc * LDS + t] += aw;
      }
      // sums over the tile's channels, per (state, position)
      for (int i = tid; i < nb * len; i += nth) {
        const int jj = i / len, t = i % len;
        float sb = 0.f, sc = 0.f;
        for (int cc = 0; cc < T; ++cc) {
          const int row = (cc * K3_NB + jj) * LDS + t;
          sb += d_s[cc * LDS + t] * u_s[cc * LDS + t] * dh_s[row];
          sc += dy_s[cc * LDS + t] * h_s[row];
        }
        const long long o =
            (((long long)b * ntile + tile) * N + n0 + jj) * L + t0 + t;
        dBp[o] = sb;
        dCp[o] = sc;
      }
      __syncthreads();
    }

    for (int i = tid; i < T * len; i += nth) {
      const int cc = i / len, t = i % len;
      const float sb = sB_s[cc * LDS + t];
      const float yv = dy_s[cc * LDS + t];
      const float dd =
          (u_s[cc * LDS + t] * sb + dAw_s[cc * LDS + t]) * sg_s[cc * LDS + t];
      const long long o = ((long long)b * D + c0 + cc) * L + t0 + t;
      du[o] = d_s[cc * LDS + t] * sb + (Dskip ? Dskip[c0 + cc] * yv : 0.f);
      ddl[o] = dd;
      dAw_s[cc * LDS + t] = dd;
    }
    __syncthreads();
    if (tid < T) {
      for (int t = 0; t < len; ++t) {
        accD += dy_s[tid * LDS + t] * u_s[tid * LDS + t];
        accB += dAw_s[tid * LDS + t];
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
  const size_t smem = sizeof(float) *
      ((size_t)(6 * T + 2 * N + 3 * T * K3_NB) * LDS + 3 * (size_t)T * N);
  int err = set_smem((const void*)selective_scan_bwd_kernel, smem);
  if (err) return err;
  selective_scan_bwd_kernel<<<B * (D / T), T * K3_NB, smem,
                              (cudaStream_t)stream>>>(
      u, u_dt, su_b, su_d, su_l, dl, d_dt, sd_b, sd_d, sd_l, A, Bm, b_dt,
      sb_b, sb_g, sb_n, sb_l, Cm, c_dt, sc_b, sc_g, sc_n, sc_l, Dskip, bias,
      dy, y_dt, sy_b, sy_d, sy_l, carries, du, ddl, dBp, dCp, dAp, dDp, dbp,
      D, L, N, G, T, reverse, softplus);
  return (int)cudaGetLastError();
}
