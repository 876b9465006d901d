// K4: the plain grouped selective scan, forward.
//
// Replaces vmambair_tpu/ops/pallas_scan.py::_scan_kernel (built by
// _build_pallas_fwd). The same recurrence as K1 with delta, B and C given:
//   delta = softplus(delta_raw + bias)  (softplus optional)
//   h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t,  y_t = C_t h_t + D u_t
// Channels fall in G groups; each channel reads its group's B/C stripe.
//
// Layout: every activation is addressed through its strides, so callers
// pass views without copies: u, delta (B, L, D); B, C (B, L, G, N); y is
// written through (B, D, L) strides. Activations are fp32 or bf16 (each its
// own flag); A (D, N), Dskip (D,), bias (D,) fp32 and contiguous.
//
// What bounds it on the H100: as K1, the sequential walk over L per channel
// (latency of exp2 + FMA per state and position). In the model it serves
// the latent spatial scans (D = 384 per direction pair, L = 256 at a 128
// tile) and the channel scans (L = C, 2 groups of 4 channels), which are
// small: there the launch and the chunk loop dominate.
//
// Design: one block per (b, channel tile of T channels inside one group);
// a loop over chunks of CH positions (reverse: back to front) carries the
// fp32 state in shared memory. Per chunk the block stages u, delta and the
// group's B/C rows and runs scan_chunk (common.cuh), S threads to a
// channel; states go through registers NS at a time, so any N <= 256 works.
//
// K4c, the carry-saving forward of training (replaces _build_pallas_fwd
// with save_carries=True, pallas_scan.py:401-418), is this kernel with a
// non-null `carries`: at the start of every chunk the block also writes the
// fp32 state entering it to carries (B, D, n_chunks, N), indexed by the
// chunk's position in L, for the backward (K3, selective_scan_bwd.cu) to
// recompute the chunk from. It adds B * D * n_chunks * N * 4 bytes of
// writes (1/CH of the state traffic the scan does in registers).
#include "common.cuh"

namespace vmt {

template <int NS>
__global__ void selective_scan_kernel(
    const void* __restrict__ u, int u_dt, long long su_b, long long su_d,
    long long su_l, const void* __restrict__ dl, int d_dt, long long sd_b,
    long long sd_d, long long sd_l, const float* __restrict__ A,
    const void* __restrict__ Bm, int b_dt, long long sb_b, long long sb_g,
    long long sb_n, long long sb_l, const void* __restrict__ Cm, int c_dt,
    long long sc_b, long long sc_g, long long sc_n, long long sc_l,
    const float* __restrict__ Dskip, const float* __restrict__ bias,
    void* __restrict__ y, int y_dt, long long sy_b, long long sy_d,
    long long sy_l, float* __restrict__ carries, int D, int L, int N, int G,
    int T, int S, int reverse, int softplus) {
  extern __shared__ float sm[];
  const int ntile = D / T;
  const int b = blockIdx.x / ntile;
  const int c0 = (blockIdx.x % ntile) * T;
  const int g = c0 / (D / G);

  float* u_s = sm;                  // [T][LDS]
  float* d_s = u_s + T * LDS;       // [T][LDS]
  float* bc = d_s + T * LDS;        // [2N][LDS]: B rows, then C rows
  float* ypart = bc + 2 * N * LDS;  // [S][T][LDS]
  float* h = ypart + S * T * LDS;   // [T][N]
  float* A2 = h + T * N;            // [T][N]

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  for (int i = tid; i < T * N; i += nth) {
    h[i] = 0.f;
    A2[i] = A[(long long)c0 * N + i] * LOG2E;
  }
  // offsets are in elements of each tensor's own dtype
  const long long ub = b * su_b + c0 * su_d;
  const long long db = b * sd_b + c0 * sd_d;
  const long long bb = b * sb_b + g * sb_g;
  const long long cb = b * sc_b + g * sc_g;
  const long long yb = b * sy_b + c0 * sy_d;
  // which index runs fastest in memory decides the thread mapping
  const bool u_tfast = su_l == 1;
  const bool d_tfast = sd_l == 1;
  const bool b_tfast = sb_l == 1;
  const bool c_tfast = sc_l == 1;

  const int nchunks = (L + CH - 1) / CH;
  for (int k = 0; k < nchunks; ++k) {
    const int ck = reverse ? nchunks - 1 - k : k;
    const int t0 = ck * CH;
    const int len = min(CH, L - t0);
    __syncthreads();
    if (carries) {  // K4c: the state entering this chunk
      for (int i = tid; i < T * N; i += nth) {
        carries[(((long long)b * D + c0 + i / N) * nchunks + ck) * N +
                i % N] = h[i];
      }
    }
    for (int i = tid; i < T * CH; i += nth) {
      int c, t;
      if (u_tfast) { c = i / CH; t = i % CH; } else { c = i % T; t = i / T; }
      u_s[c * LDS + t] =
          t < len ? ld_act(u, ub + c * su_d + (t0 + t) * su_l, u_dt) : 0.f;
      if (d_tfast) { c = i / CH; t = i % CH; } else { c = i % T; t = i / T; }
      float dv = 0.f;
      if (t < len) {
        dv = ld_act(dl, db + c * sd_d + (t0 + t) * sd_l, d_dt);
        if (bias) dv += bias[c0 + c];
        if (softplus) dv = softplus20(dv);
      }
      d_s[c * LDS + t] = dv;
    }
    for (int i = tid; i < N * CH; i += nth) {
      int n, t;
      if (b_tfast) { n = i / CH; t = i % CH; } else { n = i % N; t = i / N; }
      bc[n * LDS + t] =
          t < len ? ld_act(Bm, bb + n * sb_n + (t0 + t) * sb_l, b_dt) : 0.f;
      if (c_tfast) { n = i / CH; t = i % CH; } else { n = i % N; t = i / N; }
      bc[(N + n) * LDS + t] =
          t < len ? ld_act(Cm, cb + n * sc_n + (t0 + t) * sc_l, c_dt) : 0.f;
    }
    __syncthreads();
    scan_chunk<NS>(d_s, u_s, bc, bc + N * LDS, LDS, A2, h, ypart, T, S, N, len,
               reverse != 0);
    __syncthreads();
    for (int i = tid; i < T * len; i += nth) {
      const int c = i / len, t = i % len;
      float acc = Dskip ? Dskip[c0 + c] * u_s[c * LDS + t] : 0.f;
      for (int s = 0; s < S; ++s) acc += ypart[(s * T + c) * LDS + t];
      st_act(y, yb + c * sy_d + (t0 + t) * sy_l, y_dt, acc);
    }
  }
}

template <int NS, typename... Args>
static int launch(size_t smem, int blocks, int threads, cudaStream_t stream,
                  Args... args) {
  int err = set_smem((const void*)selective_scan_kernel<NS>, smem);
  if (err) return err;
  selective_scan_kernel<NS><<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace vmt

extern "C" int vmt_selective_scan_fwd(
    const void* u, int u_dt, long long su_b, long long su_l, long long su_d,
    const void* dl, int d_dt, long long sd_b, long long sd_l, long long sd_d,
    const float* A, const void* Bm, int b_dt, long long sb_b, long long sb_l,
    long long sb_g, long long sb_n, const void* Cm, int c_dt, long long sc_b,
    long long sc_l, long long sc_g, long long sc_n, const float* Dskip,
    const float* bias, void* y, int y_dt, long long sy_b, long long sy_d,
    long long sy_l, float* carries, int B, int L, int D, int G, int N,
    int reverse, int softplus, void* stream) {
  using namespace vmt;
  const int T = largest_divisor_le(D / G, 32);
  const int S = N < 8 ? N : 8;
  const size_t smem = sizeof(float) *
      ((size_t)(2 * T + 2 * N + S * T) * LDS + 2 * (size_t)T * N);
  const int blocks = B * (D / T);
  cudaStream_t st = (cudaStream_t)stream;
#define VMT_K4_LAUNCH(NS_)                                                  \
  launch<NS_>(smem, blocks, T * S, st, u, u_dt, su_b, su_d, su_l, dl, d_dt, \
              sd_b, sd_d, sd_l, A, Bm, b_dt, sb_b, sb_g, sb_n, sb_l, Cm,    \
              c_dt, sc_b, sc_g, sc_n, sc_l, Dskip, bias, y, y_dt, sy_b,    \
              sy_d, sy_l, carries, D, L, N, G, T, S, reverse, softplus)
  switch (states_per_thread(N, S)) {
    case 1: return VMT_K4_LAUNCH(1);
    case 2: return VMT_K4_LAUNCH(2);
    case 4: return VMT_K4_LAUNCH(4);
    case 8: return VMT_K4_LAUNCH(8);
    default: return VMT_K4_LAUNCH(16);
  }
#undef VMT_K4_LAUNCH
}
