// K1: the projection-fused spatial selective scan, forward.
//
// Replaces vmambair_tpu/ops/pallas_scan.py::_fused_kernel (built by
// _build_fused_fwd). For each (batch b, direction group g) and chunk of L,
// in order (reverse: back to front):
//   x_dbl = Wxp[g] . u            (R + 2N rows)
//   delta = softplus(Wdt[g] . x_dbl[:R] + bias[g])
//   B, C  = x_dbl[R:R+N], x_dbl[R+N:]
//   h_t   = exp(delta_t A) h_{t-1} + delta_t B_t u_t,  y_t = C_t h_t + D u_t
// with the state in fp32, carried from chunk to chunk.
//
// Layout: u, y (B, G, D, L) contiguous (the Dl policy), or (B, G, L, D)
// contiguous (the Ld policy, below), fp32 or bf16; Wxp (G, R+2N, D), Wdt
// (G, D, R), bias (G, D), A (G, D, N) (already -exp(A_log)), Ds (G, D), all
// fp32.
//
// What bounds it on the H100: the recurrence is sequential in L, so each
// block walks all L / CH chunks in turn, and every chunk passes through u
// staging, the projection, delta, the scan and the combine, separated by
// barriers, with one block of 8 warps per SM. That per-chunk latency is
// the limit (the projection and the scan take most of it, measured by
// switching phases off), not bandwidth: u is read once and y written once.
//
// Design: one block of 256 threads per (b, g, channel tile of T
// channels). The TPU's sequential chunk grid axis becomes a loop over
// chunks of CH positions inside the block. The group's x_proj weights are
// staged in shared memory once. Per chunk the block stores u for all D
// channels in shared memory (the projection contracts over D, so each tile
// recomputes x_dbl for the chunk) while the next chunk's u is already
// loading into registers, computes x_dbl (each thread six rows at one
// position, weights read 16 bytes at a time) and delta for its T channels, and runs scan_chunk: thread (c, s)
// keeps the states s, s+S, ... of channel c in registers, so S threads
// share a channel's N states and the walk per thread is N/S states long.
// Only D <= 256 is taken (the prefetch holds a chunk of u in registers). The TPU's
// matmul dual (_scan_block_dual) is not ported: this is the exact
// recurrence.
//
// K1c, the carry-saving forward of training (replaces _build_fused_fwd
// with save_carries=True, pallas_scan.py:1161-1175), is this kernel with a
// non-null `carries`: at the start of every chunk the block also writes
// the fp32 state entering it to carries (B, G*D, n_chunks, N), indexed by
// the chunk's position in L: the layout of K4c, so the one backward kernel
// (K3, selective_scan_bwd.cu) serves both.
//
// kldio's kernel (replaces tools/kldio.py::_ld_kernel, the TPU probe that
// reads u and writes y channels-last) is this kernel with the Ld layout
// policy, exported as vmt_oss_scan_fused_ld_fwd. The TPU kernel folded the
// relayouts into MXU products (an identity block under the projection
// weight, an identity contraction for y); here the policy only changes the
// addressing. A chunk's (CH, D) slab of u is contiguous in (B, G, L, D):
// the prefetch reads it in memory order, thread by thread, and the store
// into u_all (D, CH) transposes it in shared memory (pitch LDS, so a warp's
// 32 channels of one position hit 32 banks). y is read out of the scan's
// partial sums in (CH, T) order, so that neighbouring threads write the T
// neighbouring channels of one position: rows of T contiguous elements.
// Every sum is the Dl kernel's, in its order: the two policies give the
// same bits.
#include "common.cuh"

namespace vmt {

constexpr int K1_THREADS = 256;

// Layout policies. A chunk's elements are loaded in memory order: runs of
// run(D) elements, the minor index running along a run (ct() names the
// channel c and position t of (major, minor)); ld_off() is the offset of
// the chunk's element i, at (c, t), in the (b, g) slab of D x L elements.
// split_y gives (c, t) of element i of the T x len output in store order;
// at() the offset of (c, t) in the slab.
struct Dl {  // (B, G, D, L): positions fastest
  __device__ static __forceinline__ int run(int D) { return CH; }
  __device__ static __forceinline__ void ct(int major, int minor, int& c,
                                            int& t) {
    c = major;
    t = minor;
  }
  __device__ static __forceinline__ long long ld_off(int i, int c, int t,
                                                     int t0, int D, int L) {
    return at(c, t0 + t, D, L);
  }
  __device__ static __forceinline__ void split_y(int i, int T, int len,
                                                 int& c, int& t) {
    c = i / len;
    t = i % len;
  }
  __device__ static __forceinline__ long long at(int c, int t, int D,
                                                 int L) {
    return (long long)c * L + t;
  }
};

struct Ld {  // (B, G, L, D): channels fastest; a chunk is one (CH, D) run
  __device__ static __forceinline__ int run(int D) { return D; }
  __device__ static __forceinline__ void ct(int major, int minor, int& c,
                                            int& t) {
    c = minor;
    t = major;
  }
  __device__ static __forceinline__ long long ld_off(int i, int c, int t,
                                                     int t0, int D, int L) {
    return (long long)t0 * D + i;
  }
  __device__ static __forceinline__ void split_y(int i, int T, int len,
                                                 int& c, int& t) {
    c = i % T;
    t = i / T;
  }
  __device__ static __forceinline__ long long at(int c, int t, int D,
                                                 int L) {
    return (long long)t * D + c;
  }
};

// (c, t) of a thread's slots j = 0, 1, ...: element tid + j K1_THREADS of a
// chunk in load order, stepped without a division per slot (Ld's run is
// the runtime D).
template <class Lay>
struct Slots {
  int mj, mn;
  const int run, dmj, dmn;
  __device__ __forceinline__ Slots(int tid, int D)
      : run(Lay::run(D)), dmj(K1_THREADS / Lay::run(D)),
        dmn(K1_THREADS % Lay::run(D)) {
    mj = tid / run;
    mn = tid % run;
  }
  __device__ __forceinline__ void get(int& c, int& t) const {
    Lay::ct(mj, mn, c, t);
  }
  __device__ __forceinline__ void next() {
    mj += dmj;
    mn += dmn;
    if (mn >= run) {
      mn -= run;
      ++mj;
    }
  }
};

constexpr int K1_PF = 32;     // prefetch registers: D * CH / K1_THREADS <= 32
constexpr int K1_RB = 6;      // projection rows a thread sums at once

template <int NS, class Lay>
__global__ void __launch_bounds__(K1_THREADS) oss_scan_fused_kernel(
    const void* __restrict__ u, int dt, void* __restrict__ y,
    const float* __restrict__ wxp, const float* __restrict__ wdt,
    const float* __restrict__ bias, const float* __restrict__ A,
    const float* __restrict__ Ds, float* __restrict__ carries, int G, int D,
    int L, int N, int R, int T, int S, int reverse, int softplus) {
  extern __shared__ float sm[];
  const int M = R + 2 * N;
  const int ntile = D / T;
  const int tile = blockIdx.x % ntile;
  const int bg = blockIdx.x / ntile;  // b * G + g
  const int g = bg % G;
  const int c0 = tile * T;

  float* w_s = sm;                   // [M][D]   x_proj of group g
  float* u_all = w_s + M * D;        // [D][LDS]
  float* xdbl = u_all + D * LDS;     // [M][LDS]
  float* d_s = xdbl + M * LDS;       // [T][LDS]
  float* ypart = d_s + T * LDS;      // [S][T][LDS]
  float* h = ypart + S * T * LDS;    // [T][N]
  float* A2 = h + T * N;             // [T][N]
  float* wdt_s = A2 + T * N;         // [T][R]   dt_proj of the tile
  float* bias_s = wdt_s + T * R;     // [T]
  float* ds_s = bias_s + T;          // [T]

  const long long ubase = (long long)bg * D * L;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  for (int i = tid; i < T * N; i += nth) {
    h[i] = 0.f;
    A2[i] = A[((long long)g * D + c0) * N + i] * LOG2E;
  }
  for (int i = tid; i < M * D; i += nth) w_s[i] = wxp[(long long)g * M * D + i];
  for (int i = tid; i < T * R; i += nth) {
    wdt_s[i] = wdt[((long long)g * D + c0) * R + i];
  }
  for (int i = tid; i < T; i += nth) {
    bias_s[i] = bias[(long long)g * D + c0 + i];
    ds_s[i] = Ds[(long long)g * D + c0 + i];
  }

  // the next chunk of u is loaded into registers while this one is worked;
  // slot j of thread tid holds element tid + j * K1_THREADS of the chunk,
  // in the layout's load order. The registers hold raw bits (bf16 in the
  // low half), so no instruction waits on a load until the store to
  // shared memory.
  const int nchunks = (L + CH - 1) / CH;
  unsigned int pf[K1_PF];
  auto prefetch = [&](int k) {
    const int ck = reverse ? nchunks - 1 - k : k;
    const int t0 = ck * CH;
    Slots<Lay> sl(tid, D);
    if (dt == DT_BF16) {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(u);
#pragma unroll
      for (int j = 0; j < K1_PF; ++j, sl.next()) {
        const int i = tid + j * K1_THREADS;
        int c, t;
        sl.get(c, t);
        pf[j] = (i < D * CH && t0 + t < L)
                    ? (unsigned int)
                          src[ubase + Lay::ld_off(i, c, t, t0, D, L)]
                    : 0u;
      }
    } else {
      const unsigned int* src = reinterpret_cast<const unsigned int*>(u);
#pragma unroll
      for (int j = 0; j < K1_PF; ++j, sl.next()) {
        const int i = tid + j * K1_THREADS;
        int c, t;
        sl.get(c, t);
        pf[j] = (i < D * CH && t0 + t < L)
                    ? src[ubase + Lay::ld_off(i, c, t, t0, D, L)]
                    : 0u;
      }
    }
  };
  prefetch(0);

  // projection: lane = position t, thread group rg = rows rg, rg + NG, ...
  const int NG = nth / CH;
  const int pt = tid % CH, rg = tid / CH;
  const int nr = (M - rg + NG - 1) / NG;
  // w_s sits at the start of shared memory, so its rows are 16-byte
  // aligned when D % 4 == 0; otherwise the scalar loop takes all of D
  const int D4 = D % 4 == 0 ? D : 0;

  for (int k = 0; k < nchunks; ++k) {
    const int ck = reverse ? nchunks - 1 - k : k;
    const int t0 = ck * CH;
    const int len = min(CH, L - t0);
    __syncthreads();  // the previous chunk's readers are done
    if (carries) {  // K1c: the state entering this chunk
      for (int i = tid; i < T * N; i += nth) {
        carries[(((long long)bg * D + c0 + i / N) * nchunks + ck) * N +
                i % N] = h[i];
      }
    }
    {
      Slots<Lay> sl(tid, D);
#pragma unroll
      for (int j = 0; j < K1_PF; ++j, sl.next()) {
        if (tid + j * K1_THREADS < D * CH) {
          int c, t;
          sl.get(c, t);
          u_all[c * LDS + t] = __uint_as_float(
              dt == DT_BF16 ? pf[j] << 16 : pf[j]);
        }
      }
    }
    __syncthreads();
    if (k + 1 < nchunks) prefetch(k + 1);
    for (int q0 = 0; q0 < nr; q0 += K1_RB) {
      float acc[K1_RB];
      const float* wrow[K1_RB];
#pragma unroll
      for (int q = 0; q < K1_RB; ++q) {
        acc[q] = 0.f;
        // rows past M read row rg and are dropped
        wrow[q] = w_s + (q0 + q < nr ? rg + (q0 + q) * NG : rg) * D;
      }
      // four input channels at a time, one 16-byte load per weight row
      for (int c = 0; c < D4; c += 4) {
        const float u0 = u_all[c * LDS + pt];
        const float u1 = u_all[(c + 1) * LDS + pt];
        const float u2 = u_all[(c + 2) * LDS + pt];
        const float u3 = u_all[(c + 3) * LDS + pt];
#pragma unroll
        for (int q = 0; q < K1_RB; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(wrow[q] + c);
          acc[q] += w.x * u0 + w.y * u1 + w.z * u2 + w.w * u3;
        }
      }
      for (int c = D4; c < D; ++c) {
        const float uv = u_all[c * LDS + pt];
#pragma unroll
        for (int q = 0; q < K1_RB; ++q) acc[q] += wrow[q][c] * uv;
      }
#pragma unroll
      for (int q = 0; q < K1_RB; ++q) {
        if (q0 + q < nr) xdbl[(rg + (q0 + q) * NG) * LDS + pt] = acc[q];
      }
    }
    __syncthreads();
    for (int i = tid; i < T * CH; i += nth) {
      const int c = i / CH, t = i % CH;
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc += wdt_s[c * R + r] * xdbl[r * LDS + t];
      acc += bias_s[c];
      d_s[c * LDS + t] = softplus ? softplus20(acc) : acc;
    }
    __syncthreads();
    scan_chunk<NS>(d_s, u_all + c0 * LDS, xdbl + R * LDS, xdbl + (R + N) * LDS,
               LDS, A2, h, ypart, T, S, N, len, reverse != 0);
    __syncthreads();
    for (int i = tid; i < T * len; i += nth) {
      int c, t;
      Lay::split_y(i, T, len, c, t);
      float acc = ds_s[c] * u_all[(c0 + c) * LDS + t];
      for (int s = 0; s < S; ++s) acc += ypart[(s * T + c) * LDS + t];
      st_act(y, ubase + Lay::at(c0 + c, t0 + t, D, L), dt, acc);
    }
  }
}

template <int NS, class Lay>
static int launch(const void* u, int dt, void* y, const float* wxp,
                  const float* wdt, const float* bias, const float* A,
                  const float* Ds, float* carries, int B, int G, int D, int L,
                  int N, int R, int T, int S, int reverse, int softplus,
                  size_t smem, cudaStream_t stream) {
  int err = set_smem((const void*)oss_scan_fused_kernel<NS, Lay>, smem);
  if (err) return err;
  oss_scan_fused_kernel<NS, Lay>
      <<<B * G * (D / T), K1_THREADS, smem, stream>>>(
          u, dt, y, wxp, wdt, bias, A, Ds, carries, G, D, L, N, R, T, S,
          reverse, softplus);
  return (int)cudaGetLastError();
}

template <class Lay>
static int fused_fwd(const void* u, int dt, void* y, const float* wxp,
                     const float* wdt, const float* bias, const float* A,
                     const float* Ds, float* carries, int B, int G, int D,
                     int L, int N, int R, int reverse, int softplus,
                     void* stream) {
  // channel tiles of at most 12, 16 threads to a channel: the fastest of
  // the tile sizes 8-48 and 4-16 threads per channel tried at the model's
  // shapes (more blocks against more recomputed projection)
  const int T = largest_divisor_le(D, 12);
  const int S = N < 16 ? N : 16;
  const int M = R + 2 * N;
  if (D * CH > K1_PF * K1_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)(D + M + T + S * T) * LDS + 2 * (size_t)T * N +
       (size_t)M * D + (size_t)T * R + 2 * (size_t)T);
  cudaStream_t st = (cudaStream_t)stream;
#define VMT_K1_LAUNCH(NS_)                                                 \
  launch<NS_, Lay>(u, dt, y, wxp, wdt, bias, A, Ds, carries, B, G, D, L, N, \
                   R, T, S, reverse, softplus, smem, st)
  switch (states_per_thread(N, S)) {
    case 1: return VMT_K1_LAUNCH(1);
    case 2: return VMT_K1_LAUNCH(2);
    case 4: return VMT_K1_LAUNCH(4);
    case 8: return VMT_K1_LAUNCH(8);
    default: return VMT_K1_LAUNCH(16);
  }
#undef VMT_K1_LAUNCH
}

}  // namespace vmt

extern "C" int vmt_oss_scan_fused_fwd(
    const void* u, int dt, void* y, const float* wxp, const float* wdt,
    const float* bias, const float* A, const float* Ds, float* carries, int B,
    int G, int D, int L, int N, int R, int reverse, int softplus,
    void* stream) {
  return vmt::fused_fwd<vmt::Dl>(u, dt, y, wxp, wdt, bias, A, Ds, carries, B,
                                 G, D, L, N, R, reverse, softplus, stream);
}

// kldio: u, y (B, G, L, D); the rest as vmt_oss_scan_fused_fwd (no carries)
extern "C" int vmt_oss_scan_fused_ld_fwd(
    const void* u, int dt, void* y, const float* wxp, const float* wdt,
    const float* bias, const float* A, const float* Ds, int B, int G, int D,
    int L, int N, int R, int reverse, int softplus, void* stream) {
  return vmt::fused_fwd<vmt::Ld>(u, dt, y, wxp, wdt, bias, A, Ds, nullptr, B,
                                 G, D, L, N, R, reverse, softplus, stream);
}
