// K3: the selective-scan backward, in L-parallel segments.
//
// Replaces vmambair_tpu/ops/pallas_scan.py::_scan_bwd_kernel (built by
// _build_pallas_bwd, reduced by _scan_bwd_dl). Given the forward's inputs,
// the output cotangent dy and the fp32 state entering each chunk of CH = 32
// positions (saved by the carry-saving forwards K1c/K4c), it computes
//   h_t   recomputed from the chunk's carry;
//   dh_t  = C_t dy_t + a_{t+1} dh_{t+1}      (a_t = exp(delta_t A)),
//           the adjoint, run opposite to the forward scan;
//   w_t   = dh_t a_t h_{t-1}
//   du    = delta sum_n B_n dh_n + D dy
//   ddelta_raw = (u sum_n B_n dh_n + sum_n A_n w_n) * sigmoid(raw)  (softplus;
//           the raw delta is linear above 20, where the factor is 1)
//   dB_n  = sum_d delta u dh_n,  dC_n = sum_d dy h_n   (over the group)
//   dA_n  = sum_t delta w_n,  dD = sum_t dy u,  dbias = sum_t ddelta_raw
// in fp32 (the sums over states and over channels in fp64), for forward
// and reverse scans. Inputs are addressed through their strides as in K4
// (u, delta, dy (B, L, D); B, C (B, L, G, N)), fp32 or bf16 each.
//
// What bounds it on the H100: not bytes (inputs, carries and outputs move
// in a few hundredths of a millisecond at the training shapes) but the
// in-chunk trees of the main pass. Per (b, channel, state) and chunk of 32
// positions a warp runs about 25 shuffles (two 5-step trees of two
// values each, the butterfly of dA shared by two tasks, two neighbour
// shuffles) and about 12 shared-memory loads and stores; shuffles and
// shared-memory accesses share one pipe of about one warp instruction per
// clock per SM, which the main pass keeps busy. A walk over L in one block
// per (b, channel tile) had left most of the card idle (192 blocks on 132
// SMs at (8,4096,192), 96 at (8,4096,96)) and every chunk's loads exposed.
//
// Design. The recurrence of h does not force a walk: the carries make
// every chunk's recompute independent. Only the adjoint dh crosses
// chunks, and it is a linear recurrence, so L is cut into segments of
// `seg` positions (a multiple of CH, cut at the forward's positions for
// reverse scans too) and scanned as scan_seg.cuh scans the forward:
//  1. selective_scan_bwd_seg_kernel, grid (segment, channel tile, b): each
//     segment's adjoint from dh = 0 over its chunks (it needs delta, A, C
//     and dy only), each (channel, state) walked position by position in
//     one thread, one fma a position: a fifth of a tree's work, and no
//     shuffle. Per (b, c, segment, n) it writes the dh it hands to the
//     chunk walked next (a dh at its first scanned position) and the
//     segment's decay, a running product. The segment walked last hands
//     nothing on and is skipped.
//  2. selective_scan_bwd_combine, one thread per (b, c, n): the segments
//     in the adjoint's order (back to front for a forward scan) give each
//     its entering dh.
//  3. selective_scan_bwd_kernel, the same grid: each chunk recomputed from
//     its carry, the adjoint from the segment's entering dh, chunk to
//     chunk; it writes du, ddelta and the dB/dC partials, and per (b,
//     segment) partials of dA, dD and dbias.
// With one segment (L <= seg) only pass 3 runs, from dh = 0: then du,
// ddelta, dB and dC are the bits of the chunk walk this replaced (held by
// tools/k3_digests.json), and pass 1's order never meets the F2 recipe
// (L = 40). Reductions across blocks are left to the caller, in a fixed
// order: dB/dC per channel tile (B, D/T, N, L), dA (B, nseg, D, N), dD and
// dbias (B, nseg, D). No atomics: two calls give the same bits.
//
// A block is T <= 8 warps, one channel each, of one group (the wrapper
// picks T). Each chunk's u, delta, dy, the group's B/C rows and the
// carries are staged one chunk ahead by cp.async into a two-slot ring in
// shared memory (bf16 elements travel in their 32-bit word and are
// unpacked in place), so the next chunk's loads fly while this one is
// computed. In pass 3 lane i of a warp holds the chunk's i-th position in
// scan order (lanes past the chunk read the zeros staged there: the
// identity pair); the warp runs its channel's states in ascending order,
// two at a time interleaved (independent chains; no sum changes order),
// each as the TPU kernel's _scan_block does, a Hillis-Steele tree of 5
// shuffle steps over the affine pairs (each step's shuffle predicate
// masks the lanes without a partner):
//   recompute  (a_t, b_t = delta_t u_t B_t), the chunk's carry folded into
//              its first pair (b <- a h_carry + b), giving h_t, a_t h_{t-1};
//   adjoint    (a_{t+1}, C_t dy_t) in the opposite order, the dh carried
//              from the chunk walked before folded into its last pair,
//              giving dh_t and w_t; sum_t delta_t w_t by a butterfly.
// The sums over states (du, ddelta) accumulate in each lane's registers,
// in fp64, state by state; h and dh go to shared memory, where the block
// sums over the tile's channels (dB, dC partials) in fp64, channel by
// channel. dD and dbias sum per lane over the segment, then by a tree
// over the lanes. A is read from shared memory.
//
// Why expf and the fp64 sums stay (ROADMAP F2): where the state grows
// (a_t > 1), each factor's rounding reaches the gradients undamped, and
// the SFU's ex2.approx put K3 up to 10x further from the exact gradients
// than the fp32 plain version; summed in fp32, the sums over states and
// channels (which cancel by many orders there) put it 29% further. The
// main pass's in-chunk order is the one tests/k3_order.py models and the
// F2 guards of tests/test_torch_port_cuda.py hold; pass 1's walk is held
// to the same order-independent bound (tests/f2_bound.py) over segments.
#include "common.cuh"

namespace vmt {

constexpr int K3_NB = 16;    // states to a pass of the channel sums
constexpr int K3_TMAX = 8;   // channels to a block, one warp each
constexpr int K3_PAIR = 2;   // (channel, state) tasks a warp interleaves
static_assert(CH == 32, "K3 runs a chunk as one warp, a position per lane");

struct K3Args {
  const void* u; int u_dt; long long su_b, su_l, su_d;
  const void* dl; int d_dt; long long sd_b, sd_l, sd_d;
  const float* A;
  const void* Bm; int b_dt; long long sb_b, sb_l, sb_g, sb_n;
  const void* Cm; int c_dt; long long sc_b, sc_l, sc_g, sc_n;
  const float* Dskip; const float* bias;
  const void* dy; int y_dt; long long sy_b, sy_l, sy_d;
  const float* carries;
  float* du; float* ddl; float* dBp; float* dCp;
  float* dAp; float* dDp; float* dbp;
  float* hend; float* aend; float* hin;  // (B, D, nseg, N); nseg > 1 only
  int D, L, N, G, T, seg, nseg, reverse, softplus;
};

// floats of one ring slot: u, delta, dy [T][LDS]; B, C [N][LDS]; the
// carries entering the chunk [T][N]
__host__ __device__ constexpr int k3_slot(int T, int N) {
  return 3 * T * LDS + 2 * N * LDS + T * N;
}

// shared memory of a pass: du_d, y_d [T][LDS] in fp64; A_f, dhc, acc
// [T][N]; pass 3 h, dh [T][K3_NB][CH], pass 1 a_next [T][N] and delta
// [T][CH]; the two slots
__host__ __device__ constexpr size_t k3_smem(int T, int N, bool main) {
  return sizeof(double) * 2 * T * LDS +
         sizeof(float) * (3 * T * N +
                          (main ? 2 * T * K3_NB * CH : T * N + T * CH) +
                          2 * k3_slot(T, N));
}

// *dst <- the 32-bit word holding element `off` of an fp32 or bf16
// tensor, by cp.async; zeros where !ok (nothing is read)
__device__ __forceinline__ void k3_cp(float* dst, const void* p,
                                      long long off, int dt, bool ok) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p) +
                       (ok ? off << (dt == DT_BF16 ? 1 : 2) : 0);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"((unsigned)__cvta_generic_to_shared(dst)),
                 "l"(at & ~(uintptr_t)3), "r"(ok ? 4 : 0)
               : "memory");
}

// One step of the Hillis-Steele tree over affine pairs (a, b), from the
// lane st below (UP) or above: where that lane exists, b <- a b' + b and
// a <- a a' (as fmaf and a product). The shuffle's own predicate says
// whether the lane exists, so the step takes no compare and no select.
template <bool UP>
__device__ __forceinline__ void k3_step(float& a, float& b, int st) {
  if (UP) {
    asm volatile("{\n\t.reg .pred p;\n\t.reg .f32 pa, pb;\n\t"
                 "shfl.sync.up.b32 pa|p, %0, %2, 0, -1;\n\t"
                 "shfl.sync.up.b32 pb, %1, %2, 0, -1;\n\t"
                 "@p fma.rn.f32 %1, %0, pb, %1;\n\t"
                 "@p mul.rn.f32 %0, %0, pa;\n\t}"
                 : "+f"(a), "+f"(b)
                 : "r"(st));
  } else {
    asm volatile("{\n\t.reg .pred p;\n\t.reg .f32 pa, pb;\n\t"
                 "shfl.sync.down.b32 pa|p, %0, %2, 31, -1;\n\t"
                 "shfl.sync.down.b32 pb, %1, %2, 31, -1;\n\t"
                 "@p fma.rn.f32 %1, %0, pb, %1;\n\t"
                 "@p mul.rn.f32 %0, %0, pa;\n\t}"
                 : "+f"(a), "+f"(b)
                 : "r"(st));
  }
}

// the bf16 element `off` of p, staged in its word at *w, as fp32 in place
__device__ __forceinline__ void k3_unpack(float* w, const void* p,
                                          long long off) {
  const uint32_t r = __float_as_uint(*w);
  const bool hi = ((reinterpret_cast<uintptr_t>(p) >> 1) + off) & 1;
  *w = __uint_as_float(hi ? r & 0xffff0000u : r << 16);
}

// f(dst, tensor, element offset, dtype, ok) for each element of chunk ck
// that a pass stages in `slot`: delta, dy (and pass 3's u) of the tile's
// channels at [c][t], warp c staging channel c, lane t position t; the
// group's C (and pass 3's B) rows at [n][t], consecutive threads along the
// rows' fastest axis; pass 3's carries at [c][n], warp c those of channel
// c. Positions past the chunk are zeros.
template <bool MAIN, class F>
__device__ __forceinline__ void k3_chunk(const K3Args& a, float* slot, int b,
                                         int c0, int g, int ck, F f) {
  const int T = a.T, N = a.N, t0 = ck * CH, len = min(CH, a.L - t0);
  const int lane = threadIdx.x & 31, c = threadIdx.x >> 5;
  float* u_s = slot;
  float* d_s = u_s + T * LDS;
  float* y_s = d_s + T * LDS;
  float* B_s = y_s + T * LDS;
  float* C_s = B_s + N * LDS;
  float* h0_s = C_s + N * LDS;
  const bool ok = lane < len;
  const long long t = t0 + lane;
  auto act = [&](const void* p, int dt, long long sb, long long sl,
                 long long sd, float* dst) {
    f(dst + c * LDS + lane, p, b * sb + (c0 + c) * sd + t * sl, dt, ok);
  };
  auto rows = [&](const void* p, int dt, long long sb, long long sg,
                  long long sn, long long sl, float* dst) {
    const bool tfast = sl == 1;
    for (int i = threadIdx.x; i < N * CH; i += blockDim.x) {
      const int n = tfast ? i / CH : i % N, tc = tfast ? i % CH : i / N;
      f(dst + n * LDS + tc, p, b * sb + g * sg + n * sn + (t0 + tc) * sl,
        dt, tc < len);
    }
  };
  act(a.dl, a.d_dt, a.sd_b, a.sd_l, a.sd_d, d_s);
  act(a.dy, a.y_dt, a.sy_b, a.sy_l, a.sy_d, y_s);
  rows(a.Cm, a.c_dt, a.sc_b, a.sc_g, a.sc_n, a.sc_l, C_s);
  if (MAIN) {
    act(a.u, a.u_dt, a.su_b, a.su_l, a.su_d, u_s);
    rows(a.Bm, a.b_dt, a.sb_b, a.sb_g, a.sb_n, a.sb_l, B_s);
    const long long row =
        (((long long)b * a.D + c0 + c) * ((a.L + CH - 1) / CH) + ck) * N;
    for (int n = lane; n < N; n += 32) {
      f(h0_s + c * N + n, a.carries, row + n, DT_F32, true);
    }
  }
}

// Pass 1: the adjoint of one segment from dh = 0, each (channel, state)
// walked position by position in one thread (thread i: pairs i, i +
// blockDim, ...): dh = fma(a_next, dh, C dy), one rounding a position,
// its decay a running product. Its dh, a_next and decay stay in shared
// memory between chunks (g_s, an_s, acc_s); warp c first writes channel
// c's delta of the chunk to dt_s.
__device__ __forceinline__ void k3_walk(const K3Args& a, const float* d_s,
                                        const float* y_s, const float* C_s,
                                        const float* A_f, float* dt_s,
                                        float* g_s, float* an_s, float* acc_s,
                                        int c, int lane, int len, float bias) {
  const int N = a.N;
  float dt = 0.f;
  if (lane < len) {
    dt = d_s[c * LDS + lane];
    if (a.bias) dt += bias;
    if (a.softplus) dt = softplus20(dt);
  }
  dt_s[c * CH + lane] = dt;
  __syncthreads();
  for (int p = threadIdx.x; p < a.T * N; p += blockDim.x) {
    const int cp = p / N, n = p % N;
    const float An = A_f[p];
    float gv = g_s[p], an = an_s[p], dec = acc_s[p];
    const float* dtc = dt_s + cp * CH;
    const float* yc = y_s + cp * LDS;
    const float* cn = C_s + n * LDS;
    for (int i = len - 1; i >= 0; --i) {  // opposite to the scan
      const int tp = a.reverse ? len - 1 - i : i;
      const float av = expf(dtc[tp] * An);
      gv = fmaf(an, gv, cn[tp] * yc[tp]);
      an = av;
      dec *= av;
    }
    g_s[p] = gv;
    an_s[p] = an;
    acc_s[p] = dec;
  }
}

// Pass 1 (MAIN false) and pass 3 (MAIN true) of one (segment, channel
// tile, b) block.
template <bool MAIN>
__device__ __forceinline__ void k3_pass(const K3Args& a) {
  extern __shared__ double k3_sm[];
  const int T = a.T, N = a.N;
  // pass 1 skips the segment walked last: segment 0 of a forward scan
  const int s = MAIN || a.reverse ? blockIdx.x : blockIdx.x + 1;
  const int tile = blockIdx.y, b = blockIdx.z;
  const int c0 = tile * T, g = c0 / (a.D / a.G);
  const int lane = threadIdx.x & 31, c = threadIdx.x >> 5;
  double* du_d = k3_sm;                // [T][LDS] delta u per position
  double* y_d = du_d + T * LDS;        // [T][LDS] dy per position
  float* A_f = reinterpret_cast<float*>(y_d + T * LDS);  // [T][N] A
  float* dhc_s = A_f + T * N;   // [T][N] dh handed on (pass 1: dh walked)
  float* acc_s = dhc_s + T * N;        // [T][N] dA (pass 3), decay (pass 1)
  float* h_s = acc_s + T * N;          // [T][K3_NB][CH] h (pass 3)
  float* g_s = h_s + T * K3_NB * CH;   // [T][K3_NB][CH] dh (pass 3)
  // pass 1: a_next [T][N] and delta [T][CH] in place of h and dh
  float* an_s = h_s;
  float* dt_s = an_s + T * N;
  float* ring = MAIN ? g_s + T * K3_NB * CH : dt_s + T * CH;
  const int slot = k3_slot(T, N);

  for (int i = threadIdx.x; i < T * N; i += blockDim.x) {
    const float av = a.A[(long long)c0 * N + i];
    A_f[i] = av;
    const long long r =
        (((long long)b * a.D + c0 + i / N) * a.nseg + s) * N + i % N;
    dhc_s[i] = MAIN && a.hin ? a.hin[r] : 0.f;
    acc_s[i] = MAIN ? 0.f : 1.f;
    if (!MAIN) an_s[i] = 0.f;
  }
  const int cps = a.seg / CH, nck_all = (a.L + CH - 1) / CH;
  const int ck0 = s * cps, ck1 = min(ck0 + cps, nck_all), nck = ck1 - ck0;
  // the k-th chunk walked: opposite to the forward scan
  auto chunk = [&](int k) { return a.reverse ? ck0 + k : ck1 - 1 - k; };
  auto stage = [&](int k) {
    k3_chunk<MAIN>(a, ring + (k & 1) * slot, b, c0, g, chunk(k),
                   [](float* dst, const void* p, long long off, int dt,
                      bool ok) { k3_cp(dst, p, off, dt, ok); });
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const bool bf16 =
      (a.d_dt | a.y_dt | a.c_dt | (MAIN ? a.u_dt | a.b_dt : 0)) != DT_F32;
  const int ntile = a.D / T;
  const float bias = a.bias ? a.bias[c0 + c] : 0.f;
  float accD = 0.f, accB = 0.f;  // this lane's dD, dbias over the segment

  stage(0);
  for (int k = 0; k < nck; ++k) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk k staged; chunk k - 1 done with its slot
    if (k + 1 < nck) stage(k + 1);
    const int ck = chunk(k), t0 = ck * CH, len = min(CH, a.L - t0);
    float* u_s = ring + (k & 1) * slot;
    float* d_s = u_s + T * LDS;
    float* y_s = d_s + T * LDS;
    float* B_s = y_s + T * LDS;
    float* C_s = B_s + N * LDS;
    float* h0_s = C_s + N * LDS;
    if (bf16) {
      k3_chunk<MAIN>(a, u_s, b, c0, g, ck,
                     [](float* w, const void* p, long long off, int dt,
                        bool ok) {
                       if (dt == DT_BF16 && ok) k3_unpack(w, p, off);
                     });
      __syncthreads();
    }
    if (!MAIN) {
      k3_walk(a, d_s, y_s, C_s, A_f, dt_s, dhc_s, an_s, acc_s, c, lane, len,
              bias);
      continue;
    }
    // lane i: the chunk's i-th position in scan order, at tp; a lane past
    // len reads the zeros staged past the chunk and holds the identity
    // pair (1, 0) with dt = 0
    const bool in = lane < len;
    const int tp = in && a.reverse ? len - 1 - lane : lane;
    float dt = 0.f, sg = 1.f;
    if (in) {
      dt = d_s[c * LDS + tp];
      if (a.bias) dt += bias;
      if (a.softplus) {
        sg = dt > 20.f ? 1.f : 1.f / (1.f + expf(-dt));
        dt = softplus20(dt);
      }
    }
    const float uv = u_s[c * LDS + tp], yv = y_s[c * LDS + tp];
    du_d[c * LDS + tp] = (double)(dt * uv);
    y_d[c * LDS + tp] = (double)yv;
    double sbt = 0.0, awt = 0.0;  // sum_n B_n dh_n, sum_n A_n w_n
    for (int n0 = 0; n0 < N; n0 += K3_NB) {
      const int nb = min(K3_NB, N - n0);
      double sbp = 0.0, awp = 0.0;  // the pass's share, state by state
      // the pass's rows from this warp's channel and this lane's position
      const float* Ac = A_f + c * N + n0;
      const float* h0c = h0_s + c * N + n0;
      float* dhcc = dhc_s + c * N + n0;
      float* accc = acc_s + c * N + n0;
      const float* Bt = B_s + n0 * LDS + tp;
      const float* Ct = C_s + n0 * LDS + tp;
      float* hrow = h_s + c * K3_NB * CH + tp;
      float* grow = g_s + c * K3_NB * CH + tp;
      auto pair = [&](int j) {
        int jq[K3_PAIR];
        bool ok[K3_PAIR];
        float Av[K3_PAIR], av[K3_PAIR], ha[K3_PAIR], hb[K3_PAIR];
        float h0[K3_PAIR], Bv[K3_PAIR], ga[K3_PAIR], gb[K3_PAIR];
        float w[K3_PAIR];
#pragma unroll
        for (int q = 0; q < K3_PAIR; ++q) {
          ok[q] = j + q < nb;  // a task past N repeats the last state
          jq[q] = min(j + q, nb - 1);
          Av[q] = Ac[jq[q]];
          av[q] = expf(dt * Av[q]);  // 1 past len (dt = 0)
          // recompute: h = a h_prev + b, the chunk's carry folded into
          // lane 0
          h0[q] = h0c[jq[q]];
          Bv[q] = Bt[jq[q] * LDS];
          hb[q] = dt * uv * Bv[q];
          if (lane == 0) hb[q] = fmaf(av[q], h0[q], hb[q]);
          ha[q] = av[q];
        }
#pragma unroll
        for (int st = 1; st < 32; st *= 2) {
#pragma unroll
          for (int q = 0; q < K3_PAIR; ++q) k3_step<true>(ha[q], hb[q], st);
        }
        // adjoint: dh = C dy + a_next dh_next, back over the chunk; the dh
        // carried from the chunk walked before is folded into lane len - 1
#pragma unroll
        for (int q = 0; q < K3_PAIR; ++q) {
          const float anext = __shfl_down_sync(0xffffffffu, av[q], 1);
          ga[q] = lane + 1 < len ? anext : 1.f;
          const float cv = Ct[jq[q] * LDS];
          gb[q] = lane == len - 1 ? fmaf(cv, yv, dhcc[jq[q]]) : cv * yv;
        }
#pragma unroll
        for (int st = 1; st < 32; st *= 2) {
#pragma unroll
          for (int q = 0; q < K3_PAIR; ++q) k3_step<false>(ga[q], gb[q], st);
        }
#pragma unroll
        for (int q = 0; q < K3_PAIR; ++q) {
          const float hprev = __shfl_up_sync(0xffffffffu, hb[q], 1);
          w[q] = gb[q] * (av[q] * (lane == 0 ? h0[q] : hprev));
        }
        // both tasks' dA share of the chunk in one butterfly: after the
        // first step lanes 0-15 carry task 0's, lanes 16-31 task 1's
        static_assert(K3_PAIR == 2, "the butterfly pairs two tasks");
        const float dA0 = in ? dt * w[0] : 0.f, dA1 = in ? dt * w[1] : 0.f;
        float dA = lane < 16 ? dA0 : dA1;
        dA += __shfl_xor_sync(0xffffffffu, lane < 16 ? dA1 : dA0, 16);
#pragma unroll
        for (int st = 8; st > 0; st /= 2) {
          dA += __shfl_xor_sync(0xffffffffu, dA, st);
        }
#pragma unroll
        for (int q = 0; q < K3_PAIR; ++q) {
          if (!ok[q]) continue;
          hrow[jq[q] * CH] = hb[q];
          grow[jq[q] * CH] = gb[q];
          sbp = fma((double)Bv[q], (double)gb[q], sbp);
          awp = fma((double)Av[q], (double)w[q], awp);
          if (lane == 0) dhcc[jq[q]] = av[q] * gb[q];  // a dh at the
          if (lane == 16 * q) accc[jq[q]] += dA;       // first position
        }
      };
      if (nb == K3_NB) {  // a full pass: addresses fold into the code
#pragma unroll
        for (int j = 0; j < K3_NB; j += K3_PAIR) pair(j);
      } else {
        for (int j = 0; j < nb; j += K3_PAIR) pair(j);
      }
      sbt += sbp;
      awt += awp;
      __syncthreads();  // the pass's h and dh are in h_s, g_s
      // sums over the tile's channels, per (state, position), in fp64:
      // lane t of warp c takes position t of the pass's states c, c + T,
      // ..., two at a time on one load of each channel's delta u and dy
      for (int j0 = c; j0 < nb && lane < len; j0 += 2 * T) {
        const int j1 = j0 + T;
        double sb0 = 0.0, sc0 = 0.0, sb1 = 0.0, sc1 = 0.0;
        for (int cc = 0; cc < T; ++cc) {
          const double du = du_d[cc * LDS + lane], yy = y_d[cc * LDS + lane];
          const int r0 = (cc * K3_NB + j0) * CH + lane;
          sb0 = fma(du, (double)g_s[r0], sb0);
          sc0 = fma(yy, (double)h_s[r0], sc0);
          if (j1 < nb) {
            sb1 = fma(du, (double)g_s[r0 + T * CH], sb1);
            sc1 = fma(yy, (double)h_s[r0 + T * CH], sc1);
          }
        }
        const long long o =
            (((long long)b * ntile + tile) * N + n0 + j0) * a.L + t0 + lane;
        a.dBp[o] = (float)sb0;
        a.dCp[o] = (float)sc0;
        if (j1 < nb) {
          a.dBp[o + (long long)T * a.L] = (float)sb1;
          a.dCp[o + (long long)T * a.L] = (float)sc1;
        }
      }
      if (n0 + K3_NB < N) __syncthreads();  // h_s, g_s free again
    }
    if (in) {
      const long long o = ((long long)b * a.D + c0 + c) * a.L + t0 + tp;
      // D dy by an fma onto the rounded sum (the chunk walk's bits)
      a.du[o] = a.Dskip ? fmaf(a.Dskip[c0 + c], yv, (float)(dt * sbt))
                        : (float)(dt * sbt) + 0.f;
      const float dd = (float)(fma((double)uv, sbt, awt) * sg);
      a.ddl[o] = dd;
      accD += yv * uv;
      accB += dd;
    }
  }
  __syncthreads();  // every lane's dhc_s and acc_s
  if (MAIN) {
    const long long at = ((long long)b * a.nseg + s) * a.D + c0;
    for (int i = threadIdx.x; i < T * N; i += blockDim.x) {
      a.dAp[at * N + i] = acc_s[i];
    }
    // dD and dbias of the segment: a tree over the lanes
#pragma unroll
    for (int st = 16; st > 0; st /= 2) {
      accD += __shfl_xor_sync(0xffffffffu, accD, st);
      accB += __shfl_xor_sync(0xffffffffu, accB, st);
    }
    if (lane == 0) {
      a.dDp[at + c] = accD;
      a.dbp[at + c] = accB;
    }
  } else {
    // the dh handed on: a dh at the segment's first scanned position
    for (int i = threadIdx.x; i < T * N; i += blockDim.x) {
      const long long r =
          (((long long)b * a.D + c0 + i / N) * a.nseg + s) * N + i % N;
      a.hend[r] = an_s[i] * dhc_s[i];
      a.aend[r] = acc_s[i];
    }
  }
}

__global__ void __launch_bounds__(32 * K3_TMAX)
    selective_scan_bwd_seg_kernel(const __grid_constant__ K3Args a) {
  k3_pass<false>(a);
}

// 4 blocks of 8 warps to an SM: 64 registers a thread (no spills)
__global__ void __launch_bounds__(32 * K3_TMAX, 4)
    selective_scan_bwd_kernel(const __grid_constant__ K3Args a) {
  k3_pass<true>(a);
}

// Pass 2: the dh entering every segment, one thread per (b, c, n), the
// segments in the adjoint's order. A segment that receives 0 passes on
// its own dh only (its decay, which may overflow where the state grows,
// is not multiplied into 0).
__global__ void selective_scan_bwd_combine(const float* __restrict__ hend,
                                           const float* __restrict__ aend,
                                           float* __restrict__ hin,
                                           long long rows, int N, int nseg,
                                           int reverse) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * N) return;
  const int n = (int)(idx % N);
  const long long bc = idx / N;  // b * D + c
  float h = 0.f;
  for (int i = 0; i < nseg; ++i) {
    const int s = reverse ? i : nseg - 1 - i;
    const long long at = (bc * nseg + s) * N + n;
    hin[at] = h;
    if (i + 1 < nseg) h = h != 0.f ? fmaf(aend[at], h, hend[at]) : hend[at];
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
    float* work, int B, int L, int D, int G, int N, int T, int seg,
    int reverse, int softplus, void* stream) {
  using namespace vmt;
  // T channels to a block, chosen by the caller (it sets the layout of the
  // dB/dC partials the caller reduces); seg a multiple of the chunk
  const int nseg = seg > 0 ? (L + seg - 1) / seg : 0;
  if (T < 1 || T > K3_TMAX || G < 1 || D % G || (D / G) % T || N < 1 ||
      L < 1 || seg < CH || seg % CH || B < 1 || B > 65535 ||
      D / T > 65535 || (nseg > 1 && !work)) {
    return (int)cudaErrorInvalidValue;
  }
  K3Args a{u,     u_dt,  su_b,  su_l,    su_d,    dl,      d_dt,   sd_b,
           sd_l,  sd_d,  A,     Bm,      b_dt,    sb_b,    sb_l,   sb_g,
           sb_n,  Cm,    c_dt,  sc_b,    sc_l,    sc_g,    sc_n,   Dskip,
           bias,  dy,    y_dt,  sy_b,    sy_l,    sy_d,    carries, du,
           ddl,   dBp,   dCp,   dAp,     dDp,     dbp,     nullptr, nullptr,
           nullptr, D,   L,     N,       G,       T,       seg,    nseg,
           reverse, softplus};
  const long long rows = (long long)B * D;
  if (nseg > 1) {
    a.hend = work;
    a.aend = work + rows * nseg * N;
    a.hin = work + 2 * rows * nseg * N;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const size_t sm1 = k3_smem(T, N, false), sm3 = k3_smem(T, N, true);
  int err = set_smem((const void*)selective_scan_bwd_seg_kernel, sm1);
  if (!err) err = set_smem((const void*)selective_scan_bwd_kernel, sm3);
  if (err) return err;
  if (nseg > 1) {
    selective_scan_bwd_seg_kernel<<<dim3(nseg - 1, D / T, B), 32 * T, sm1,
                                    st>>>(a);
    err = (int)cudaGetLastError();
    if (err) return err;
    selective_scan_bwd_combine<<<(unsigned)((rows * N + 255) / 256), 256, 0,
                                 st>>>(a.hend, a.aend, a.hin, rows, N, nseg,
                                       reverse);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  selective_scan_bwd_kernel<<<dim3(nseg, D / T, B), 32 * T, sm3, st>>>(a);
  return (int)cudaGetLastError();
}
