// kprobe's two probes (tools/kprobe.py), the building blocks of a fused
// projection + scan kernel that reads (B, L, D) chunks: an in-kernel
// transpose pair and small in-kernel projections.
//
// Replaces tools/kprobe.py::probe_transpose's kernel (:45, call :52) and
// probe_proj's (:79, call :89). Both are position-wise on u (rows, D) =
// (B * L, D) contiguous, fp32 or bf16, and write y of u's shape and dtype:
//   transpose: y = u * 1.000001 in fp32, rounded to y's dtype, computed on
//              the tile transposed, (TL, D) -> (D, TL) and back;
//   proj:      xdbl = W_xp u^T, (RN, TL) in fp32 (W_xp (RN, D) fp32), then
//              y = (W_dt xdbl[:R] + 0.5 xdbl[R])^T (W_dt (D, R) fp32).
// On the TPU each grid step is one (b, chunk of 1024) block of a (B, L, D)
// array; the function does not depend on where a chunk ends, so here a
// tile is consecutive rows of the flattened (B * L, D) array (64 in the
// edge paths, 32 a warp in the projection's tensor-core route).
//
// What bounds them on the H100: bytes. The transpose pair moves u and y
// once; so does the projection, counting the rows of xdbl the output reads
// (R + 1). It computes every row of xdbl all the same, as the TPU probe
// prices the full projection of a fused kernel, on the tensor cores, where
// that work (about 0.003 ms at the probe's shape) stays under the bytes.
//
// The transpose pair (`transpose16_kernel`): a bytes-bound copy with a
// relayout inside, so every part of it moves 16 bytes at a time (8 bf16 or
// 4 fp32, "a chunk"). A block of 256 threads walks tiles of TL positions
// (the launch picks TL: a multiple of 8 chunks, about 32 KB a tile), one
// after another, with the next two tiles' cp.async loads in flight (a
// ring of three in shared memory; two blocks an SM) while this one is
// transposed and stored. A tile's (TL, D) rows arrive by cp.async
// (neighbouring threads on neighbouring chunks) into X, its chunks XOR-
// swizzled by the position block (row / V). Pass A: a thread takes a V x V
// block (V positions x one chunk of channels) from X, transposes it in
// registers, scales each value along its channel row (fp32, the probe's
// op) and writes V chunks of the (D, TL) layout T (each a channel's V
// positions), swizzled by the channel chunk. Pass B: a thread takes V of
// T's chunks (V channels x V positions), transposes them back in
// registers and stores V rows' chunks to y with 16-byte streaming stores,
// eight neighbouring threads on one row's eight neighbouring chunks. Both
// swizzles put the eight threads of each quarter-warp on eight distinct
// 16-byte bank groups in every shared-memory access. Each thread's block
// coordinates are computed once, before the tile loop: nothing divides by
// D per element. Where D is no multiple of V, or u or y is not 16-byte
// aligned (a view at an odd storage offset), the launch takes the edge
// path `transpose_edge_kernel`: element by element, one tile a block,
// staged (D, TL + 1) in the storage dtype, the (position, channel) walk
// advanced by adds; the same bits.
//
// The projection probe (`proj_mma_kernel`): one wave of resident blocks; each
// warp walks warp tiles of 32 rows behind a cp.async ring of two of its own
// (no block barrier after the weights; a third slot would cost fp32 two of its
// seven warps an SM, and ran 1.2x slower), every row padded by 16 bytes so
// that ldmatrix's 8 rows fall on 8 bank groups. xdbl^T = u W_xp^T on the
// tensor cores with u as the A operand as it lies: bf16 u against three bf16
// parts of W_xp (m16n8k16; a bf16 u times a bf16 part is exact in the fp32
// sums, and three parts hold all 24 bits of W_xp, where two TF32 parts would
// hold 22 and need u converted first), fp32 u in split TF32 (three m16n8k8
// products per k-step, as K2's and K5's fp32 routes; u cut to TF32 by masking,
// W_xp by Veltkamp's split). RN is padded to 40, every row computed. The
// output y = xdbl[:, :8] B' (W_dt's R columns, 0.5 at R) is one more split-
// TF32 product per 8 channels whose A fragments are xdbl's accumulators as
// they lie, rounded once and written over the tile, then stored in 16-byte
// chunks. Each block splits and stages the weights' fragments once. Where D is
// no multiple of 16, RN > 40, R >= 8 or a pointer is not 16-byte aligned, the
// edge path `proj_edge_kernel` (CUDA cores, fp32): the tile staged transposed,
// uT [D][TL + 1], W_xp and W_dt in shared memory, 4 threads a position each
// computing every 4th row of xdbl, then one output element a thread.
#include "common.cuh"
#include "mma.cuh"

namespace vmt {
namespace probe {

constexpr int TL = 64;          // rows (positions) of a tile
constexpr int TP = TL + 1;      // pitch of the transposed tile
constexpr int NTH = 256;        // threads of a block
constexpr int LE = 8;           // loads in flight per thread
constexpr int RG = NTH / TL;    // proj: threads sharing a position (4)
constexpr int MAX_RN = 64;      // proj: rows of W_xp
constexpr int RPT = MAX_RN / RG;  // proj: xdbl rows per thread (16)
constexpr int MAX_D = 256;      // channels: the tile and W_xp in smem
constexpr int MAX_SMEM = 232448;

// uT [D][TP] <- the n = rows * D elements of u from element `base`, as fp32.
__device__ __forceinline__ void load_tile_t(const void* __restrict__ u,
                                            int dt, long long base, int n,
                                            int D, float* uT) {
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < n; i0 += NTH * LE) {
    uint32_t r[LE];
    ld_raw_n<LE>(
        r, u, dt, [&](int e) { return base + i0 + e * NTH + tid; },
        [&](int e) { return i0 + e * NTH + tid < n; });
#pragma unroll
    for (int e = 0; e < LE; ++e) {
      const int i = i0 + e * NTH + tid;
      if (i < n) uT[(i % D) * TP + i / D] = raw_f32(r[e], dt);
    }
  }
}

// -- the transpose pair ------------------------------------------------------

// V elements of T in a 16-byte chunk, and the probe's op on one element
// (fp32, rounded back to T).
template <class T>
struct Chunk;
// RING: the tiles of the cp.async ring, RING - 1 of them in flight while
// one is transposed; MAXB: the V x V blocks a thread takes per pass and
// tile (a 32 KB tile has 256 of them in bf16, 512 in fp32; pass B rounds
// a row's chunks up to groups of 8); MINB: blocks an SM (bf16's 8 x 8
// blocks take the registers of one block an SM unless bounded)
template <>
struct Chunk<float> {
  static constexpr int V = 4;
  static constexpr int DT = DT_F32;
  static constexpr int RING = 3;
  static constexpr int MAXB = 4;
  static constexpr int MINB = 1;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
  static constexpr int DT = DT_BF16;
  static constexpr int RING = 3;
  static constexpr int MAXB = 2;
  static constexpr int MINB = 2;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The V x V block b of a tile as an element array: w[e] the chunk of row
// (or channel) e; out[j] <- the probe's op on column j, as a chunk.
template <class T>
__device__ __forceinline__ void transpose_scale(const uint4 (&w)[Chunk<T>::V],
                                                uint4 (&out)[Chunk<T>::V]) {
  constexpr int V = Chunk<T>::V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    T* o = reinterpret_cast<T*>(&out[j]);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const T v = reinterpret_cast<const T*>(&w[e])[j];
      if constexpr (Chunk<T>::DT == DT_BF16)
        o[e] = __float2bfloat16(__bfloat162float(v) * 1.000001f);
      else
        o[e] = v * 1.000001f;
    }
  }
}

// The same transpose without the op (pass B's way back).
template <class T>
__device__ __forceinline__ void transpose_chunks(
    const uint4 (&w)[Chunk<T>::V], uint4 (&out)[Chunk<T>::V]) {
  constexpr int V = Chunk<T>::V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    T* o = reinterpret_cast<T*>(&out[j]);
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = reinterpret_cast<const T*>(&w[e])[j];
  }
}

// u, y (rows, D) of T, 16-byte aligned, D a multiple of V; tl positions a
// tile (a multiple of 8 V); the tiles walked from blockIdx.x by gridDim.x.
// Shared memory: X[RING] (tl NC chunks each, the cp.async ring) and T (tl
// NC chunks), NC = D / V the chunks of a row. X holds chunk (row, cc) at
// (row NC + cc) ^ ((row / V) & 7); T holds chunk (channel c, position
// block pb) at (c NPB + pb) ^ ((c / V) & 7), NPB = tl / V. The XOR changes
// the low 3 bits of the index only: a permutation of each buffer, whose
// chunk count is a multiple of 8.
template <class T>
__global__ void __launch_bounds__(NTH, Chunk<T>::MINB) transpose16_kernel(
    const uint4* __restrict__ u, uint4* __restrict__ y, long long rows, int D,
    int tl) {
  constexpr int V = Chunk<T>::V, RING = Chunk<T>::RING;
  constexpr int MAXB = Chunk<T>::MAXB;
  extern __shared__ uint4 sm16[];
  const int NC = D / V, NPB = tl / V, TC = tl * NC;
  uint4* X = sm16;
  uint4* Tt = sm16 + RING * TC;
  const int tid = threadIdx.x;
  const long long ntiles = (rows + tl - 1) / tl;
  // this thread's blocks, once: pass A (pb fastest: a quarter-warp on 8
  // position blocks of one channel chunk), pass B (groups of GW channel
  // chunks fastest, then the position blocks: eight threads on one row's
  // eight chunks). A block past the tile's has pb = -1.
  const int GW = NC < 8 ? NC : 8;
  int a_pb[MAXB], a_cc[MAXB], b_pb[MAXB], b_cc[MAXB];
#pragma unroll
  for (int i = 0; i < MAXB; ++i) {
    const int b = tid + i * NTH;
    a_pb[i] = b < NPB * NC ? b % NPB : -1;
    a_cc[i] = b / NPB;
    const int lo = b % GW, rest = b / GW;
    b_pb[i] = rest % NPB;
    b_cc[i] = (rest / NPB) * GW + lo;
    if (b_cc[i] >= NC) b_pb[i] = -1;
  }

  auto load = [&](long long tile, uint4* buf) {
    const long long r0 = tile * tl;
    const int nr = (int)min((long long)tl, rows - r0);
    const uint4* g = u + r0 * NC;
    // row = i / NC by a running count: no division per chunk
    int row = tid / NC, cc = tid - row * NC;
    const int srow = NTH / NC, scc = NTH - srow * NC;
    for (int i = tid; i < nr * NC; i += NTH) {
      mma::cp_async16(buf + ((row * NC + cc) ^ ((row / V) & 7)), g + i);
      row += srow;
      cc += scc;
      if (cc >= NC) {
        cc -= NC;
        ++row;
      }
    }
  };

  // the ring: RING - 1 tiles in flight ahead of the one transposed
  long long tile = blockIdx.x;
#pragma unroll
  for (int r = 0; r < RING - 1; ++r) {
    const long long t = tile + (long long)r * gridDim.x;
    if (t < ntiles) load(t, X + r * TC);
    mma::cp_async_commit();
  }
  for (int k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    const long long next = tile + (long long)(RING - 1) * gridDim.x;
    if (next < ntiles) load(next, X + ((k + RING - 1) % RING) * TC);
    mma::cp_async_commit();
    cp_async_wait<RING - 1>();  // this tile's chunks are in
    __syncthreads();  // for every thread; the last tile's readers of T and
                      // of the slot just refilled are done
    const uint4* Xk = X + (k % RING) * TC;
    // pass A: X -> T, transposed, the op on each channel's row
#pragma unroll
    for (int i = 0; i < MAXB; ++i) {
      if (a_pb[i] < 0) continue;
      const int pb = a_pb[i], cc = a_cc[i];
      uint4 w[V], o[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        w[e] = Xk[((pb * V + e) * NC + cc) ^ (pb & 7)];
      transpose_scale<T>(w, o);
#pragma unroll
      for (int j = 0; j < V; ++j)
        Tt[((cc * V + j) * NPB + pb) ^ (cc & 7)] = o[j];
    }
    __syncthreads();
    // pass B: T -> y, transposed back, 16-byte stores of the valid rows,
    // streaming (evict-first: nothing here reads y back)
    const long long r0 = tile * tl;
    const int nr = (int)min((long long)tl, rows - r0);
    uint4* g = y + r0 * NC;
#pragma unroll
    for (int i = 0; i < MAXB; ++i) {
      if (b_pb[i] < 0) continue;
      const int pb = b_pb[i], cc = b_cc[i];
      uint4 w[V], o[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        w[j] = Tt[((cc * V + j) * NPB + pb) ^ (cc & 7)];
      transpose_chunks<T>(w, o);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (pb * V + e < nr) __stcs(g + (pb * V + e) * NC + cc, o[e]);
    }
  }
}

// The edge path: any D, any alignment of u and y. One tile of 64 rows a
// block, staged uT [D][TL + 1] in T's own type; the (row, channel) of the
// i-th element advanced by adds.
template <class T>
__global__ void __launch_bounds__(NTH) transpose_edge_kernel(
    const T* __restrict__ u, T* __restrict__ y, long long rows, int D) {
  extern __shared__ __align__(16) unsigned char sme[];
  T* uT = reinterpret_cast<T*>(sme);  // [D][TP]
  const long long r0 = (long long)blockIdx.x * TL;
  const int nr = (int)min((long long)TL, rows - r0);
  const int n = nr * D;
  const long long base = r0 * D;
  const int tid = threadIdx.x;
  const int srow = NTH / D, sd = NTH - srow * D;
  {
    int l = tid / D, d = tid - l * D;
    for (int i = tid; i < n; i += NTH) {
      uT[d * TP + l] = u[base + i];
      l += srow;
      d += sd;
      if (d >= D) {
        d -= D;
        ++l;
      }
    }
  }
  __syncthreads();
  // the probe's op on the transposed tile, along its rows
  for (int i = tid; i < D * TL; i += NTH) {
    T* p = uT + (i / TL) * TP + (i % TL);  // TL a power of two: shifts
    if constexpr (Chunk<T>::DT == DT_BF16)
      *p = __float2bfloat16(__bfloat162float(*p) * 1.000001f);
    else
      *p = *p * 1.000001f;
  }
  __syncthreads();
  int l = tid / D, d = tid - l * D;
  for (int i = tid; i < n; i += NTH) {
    y[base + i] = uT[d * TP + l];
    l += srow;
    d += sd;
    if (d >= D) {
      d -= D;
      ++l;
    }
  }
}

// The transpose pair on u, y (rows, D) of T: the 16-byte route where D is
// a multiple of V and both pointers are 16-byte aligned, else the edge
// path.
template <class T>
static int transpose_launch(const void* u, void* y, long long rows, int D,
                            cudaStream_t stream) {
  constexpr int V = Chunk<T>::V;
  const bool fast = D % V == 0 &&
                    (((uintptr_t)u | (uintptr_t)y) & 15) == 0;
  if (!fast) {
    const size_t smem = sizeof(T) * (size_t)D * TP;
    int err = set_smem((const void*)transpose_edge_kernel<T>, smem);
    if (err) return err;
    const unsigned grid = (unsigned)((rows + TL - 1) / TL);
    transpose_edge_kernel<T><<<grid, NTH, smem, stream>>>(
        static_cast<const T*>(u), static_cast<T*>(y), rows, D);
    return (int)cudaGetLastError();
  }
  // tl: about 32 KB a tile, a multiple of 8 V positions (at least that)
  const int row_bytes = D * (int)sizeof(T);
  int tl = 32768 / row_bytes / (8 * V) * (8 * V);
  if (tl < 8 * V) tl = 8 * V;
  // each pass's blocks fit MAXB a thread (pass B rounds the chunks of a
  // row up to groups of 8)
  const int nc = D / V, gw = nc < 8 ? nc : 8;
  if (tl / V * ((nc + gw - 1) / gw * gw) > Chunk<T>::MAXB * NTH)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (Chunk<T>::RING + 1) * (size_t)tl * row_bytes;
  auto kernel = transpose16_kernel<T>;
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  // one wave of resident blocks, each walking its tiles
  static int per_sm[257];  // by D; the same on every H100
  int dev, sms;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)))
    return err;
  if (per_sm[D] == 0 &&
      (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm[D], kernel, NTH, smem)))
    return err;
  const long long ntiles = (rows + tl - 1) / tl;
  const long long wave = (long long)sms * (per_sm[D] > 0 ? per_sm[D] : 1);
  const unsigned grid = (unsigned)(ntiles < wave ? ntiles : wave);
  kernel<<<grid, NTH, smem, stream>>>(static_cast<const uint4*>(u),
                                      static_cast<uint4*>(y), rows, D, tl);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(NTH) proj_edge_kernel(
    const void* __restrict__ u, int dt, void* __restrict__ y,
    const float* __restrict__ wxp, const float* __restrict__ wdt,
    long long rows, int D, int RN, int R) {
  extern __shared__ float sm[];
  float* uT = sm;                  // [D][TP]
  float* xd = uT + D * TP;         // [RN][TP]
  float* wx = xd + RN * TP;        // [RN][D]
  float* wd = wx + RN * D;         // [D][R]
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * TL;
  const int nr = (int)min((long long)TL, rows - r0);
  const int n = nr * D;
  const long long base = r0 * D;
  for (int i = tid; i < RN * D; i += NTH) wx[i] = wxp[i];
  for (int i = tid; i < D * R; i += NTH) wd[i] = wdt[i];
  load_tile_t(u, dt, base, n, D, uT);
  __syncthreads();
  // xdbl[r][l] = sum_k W_xp[r][k] uT[k][l], rows r = rg + RG j
  {
    const int l = tid % TL, rg = tid / TL;
    float acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
    for (int k = 0; k < D; ++k) {
      const float v = uT[k * TP + l];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = rg + RG * j;
        if (r < RN) acc[j] = fmaf(wx[r * D + k], v, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rg + RG * j;
      if (r < RN) xd[r * TP + l] = acc[j];
    }
  }
  __syncthreads();
  // y[l][d] = sum_{r < R} W_dt[d][r] xdbl[r][l] + 0.5 xdbl[R][l]
  for (int i = tid; i < n; i += NTH) {
    const int l = i / D, d = i % D;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s = fmaf(wd[d * R + r], xd[r * TP + l], s);
    st_act(y, base + i, dt, s + xd[R * TP + l] * 0.5f);
  }
}

// -- the projections on the tensor cores -----------------------------------

// A warp walks warp tiles of PJ_WR rows (PJ_MT m-tiles of 16), PJ_RING of
// them in a cp.async ring of its own; xdbl's rows in PJ_NT n-tiles of 8
// (RN <= 40).
constexpr int PJ_MT = 2;
constexpr int PJ_WR = 16 * PJ_MT;
constexpr int PJ_NT = 5;
constexpr int PJ_RN = 8 * PJ_NT;
constexpr int PJ_RING = 2;
constexpr int PJ_WARPS = 8;

// The first product's fragments of W_xp^T (the B operand, n = xdbl's row):
// bf16 u takes three bf16 parts of each weight (w = p0 + p1 + p2, each
// the rest rounded to bf16: 24 significant bits, all of fp32's), each an
// m16n8k16 product, exact against u's 8-bit values; fp32 u takes split
// TF32 (hi, lo), three m16n8k8 products per k-step of 8.
template <class T>
struct Proj;
template <>
struct Proj<__nv_bfloat16> {
  static constexpr int KS = 16;  // k a step
  // words of a lane's fragments per (k-step, n-tile)
  static constexpr int WORDS = 6;
};
template <>
struct Proj<float> {
  static constexpr int KS = 8;
  static constexpr int WORDS = 4;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// w = p[0] + p[1] + p[2], each the rest so far rounded to bf16 (as floats)
__device__ __forceinline__ void split_bf16x3(float w, float (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = __bfloat162float(__float2bfloat16(w));
    w -= p[i];
  }
}

// The shared layout of proj_mma_kernel: the first product's fragments
// (D / KS k-steps x PJ_NT n-tiles x 32 lanes x WORDS words), the second's
// (D / 8 n-tiles x 32 lanes x 4 words), then each warp's PJ_RING tiles of
// PJ_WR rows, each row D values and 16 bytes of pad (so that the 8 rows of an
// ldmatrix fall on 8 distinct bank groups).
template <class T>
struct ProjSmem {
  int wx, wd, pitch, slot, total_fixed;
  __host__ __device__ ProjSmem(int D) {
    wx = D / Proj<T>::KS * PJ_NT * 32 * Proj<T>::WORDS * 4;
    wd = D / 8 * 32 * 16;
    pitch = D * (int)sizeof(T) + 16;
    slot = PJ_WR * pitch;
    total_fixed = wx + wd;
  }
};

// y = (W_dt xdbl[:R] + 0.5 xdbl[R])^T, xdbl = W_xp u^T, for u, y (rows, D)
// of T, D a multiple of 16, u and y 16-byte aligned, RN <= 40, R < 8.
// Per warp tile: xdbl^T = u W_xp^T on the tensor cores, u as the A
// operand as it lies (ldmatrix from the ring), all PJ_NT n-tiles (every row
// of xdbl, as the TPU probe computes them; rows past RN are zero); then
// the output y = xdbl[:, :8] B', B'[r][d] = W_dt[d][r] (r < R), 0.5 (r =
// R), 0 past, as split TF32 m16n8k8 products whose A fragments are the
// accumulators of xdbl's first n-tile as they lie: the C fragment's
// columns 2t, 2t + 1 stand at k = t, t + 4, and B' is packed in that
// order. y is written over the tile in shared memory and stored in 16-byte
// chunks. The other n-tiles' accumulators reach `sink` when it is given
// (never, in the wrapper), so that nothing drops their products.
template <class T>
__global__ void __launch_bounds__(PJ_WARPS * 32, 1) proj_mma_kernel(
    const T* __restrict__ u, T* __restrict__ y,
    const float* __restrict__ wxp, const float* __restrict__ wdt,
    long long rows, int D, int RN, int R, float* __restrict__ sink) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int KS = Proj<T>::KS, WORDS = Proj<T>::WORDS;
  extern __shared__ __align__(16) unsigned char smp[];
  const ProjSmem<T> L(D);
  uint32_t* wx = reinterpret_cast<uint32_t*>(smp);
  uint4* wd = reinterpret_cast<uint4*>(smp + L.wx);
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  unsigned char* ring = smp + L.total_fixed + warp * PJ_RING * L.slot;
  const int rb = D * (int)sizeof(T);  // bytes a row
  const int cpr = rb / 16;            // 16-byte chunks a row
  const long long ntiles = (rows + PJ_WR - 1) / PJ_WR;
  const long long stride = (long long)gridDim.x * nw;
  long long tile = (long long)blockIdx.x * nw + warp;

  auto load = [&](long long tl, unsigned char* buf) {
    const long long r0 = tl * PJ_WR;
    const int nr = (int)min((long long)PJ_WR, rows - r0);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(u) + r0 * rb;
    int row = lane / cpr, ch = lane - row * cpr;
    const int srow = 32 / cpr, sch = 32 - srow * cpr;
    for (int i = lane; i < nr * cpr; i += 32) {
      mma::cp_async16(buf + row * L.pitch + ch * 16,
                      src + (long long)row * rb + ch * 16);
      row += srow;
      ch += sch;
      if (ch >= cpr) {
        ch -= cpr;
        ++row;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < PJ_RING - 1; ++s) {
    const long long tl = tile + s * stride;
    if (tl < ntiles) load(tl, ring + s * L.slot);
    mma::cp_async_commit();
  }

  // the weights' fragments, split once a block (rows past RN, and k past
  // the output's R + 1 rows, zero)
  const int nfx = D / KS * PJ_NT * 32;
  for (int i = threadIdx.x; i < nfx; i += blockDim.x) {
    const int ln = i % 32, nt = (i / 32) % PJ_NT, ks = i / (32 * PJ_NT);
    const int n = nt * 8 + ln / 4, tt = ln % 4;
    auto W = [&](int k) { return n < RN ? wxp[n * D + k] : 0.f; };
    uint32_t* o = wx + (long long)i * WORDS;
    if constexpr (BF) {
      const int k0 = ks * 16 + 2 * tt;
      float a[3], b[3], c[3], d[3];
      split_bf16x3(W(k0), a);
      split_bf16x3(W(k0 + 1), b);
      split_bf16x3(W(k0 + 8), c);
      split_bf16x3(W(k0 + 9), d);
#pragma unroll
      for (int pt = 0; pt < 3; ++pt) {
        o[2 * pt] = pack_bf16(a[pt], b[pt]);
        o[2 * pt + 1] = pack_bf16(c[pt], d[pt]);
      }
    } else {
      const int k0 = ks * 8 + tt;
      mma::split_tf32(__float_as_uint(W(k0)), o[0], o[2]);
      mma::split_tf32(__float_as_uint(W(k0 + 4)), o[1], o[3]);
    }
  }
  for (int i = threadIdx.x; i < D / 8 * 32; i += blockDim.x) {
    const int ln = i % 32, d = (i / 32) * 8 + ln / 4, tt = ln % 4;
    auto B = [&](int r) {
      return r < R ? wdt[d * R + r] : (r == R ? 0.5f : 0.f);
    };
    uint4 v;
    mma::split_tf32(__float_as_uint(B(2 * tt)), v.x, v.z);
    mma::split_tf32(__float_as_uint(B(2 * tt + 1)), v.y, v.w);
    wd[i] = v;
  }
  __syncthreads();

  float keep = 0.f;
  for (int k = 0; tile < ntiles; tile += stride, ++k) {
    const long long next = tile + (PJ_RING - 1) * stride;
    if (next < ntiles)
      load(next, ring + ((k + PJ_RING - 1) % PJ_RING) * L.slot);
    mma::cp_async_commit();
    cp_async_wait<PJ_RING - 1>();
    __syncwarp();  // every lane's chunks of this tile are in
    unsigned char* buf = ring + (k % PJ_RING) * L.slot;

    float acc[PJ_MT][PJ_NT][4];
#pragma unroll
    for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
      for (int n = 0; n < PJ_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    // xdbl^T = u W_xp^T, a k-step at a time; each product's passes over
    // all PJ_MT x PJ_NT accumulators in turn (the smallest parts first)
    for (int ks = 0; ks < D / KS; ++ks) {
      uint32_t a[PJ_MT][4];
#pragma unroll
      for (int m = 0; m < PJ_MT; ++m)
        mma::ldsm_x4(a[m], buf + (m * 16 + lane % 16) * L.pitch +
                               (ks * KS + (lane / 16) * (KS / 2)) *
                                   (int)sizeof(T));
      const uint32_t* f = wx + (long long)(ks * PJ_NT * 32 + lane) * WORDS;
      if constexpr (BF) {
        uint2 b[PJ_NT][3];
#pragma unroll
        for (int n = 0; n < PJ_NT; ++n)
#pragma unroll
          for (int pt = 0; pt < 3; ++pt)
            b[n][pt] = *reinterpret_cast<const uint2*>(
                f + n * 32 * WORDS + 2 * pt);
#pragma unroll
        for (int pt = 2; pt >= 0; --pt)
#pragma unroll
          for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
            for (int n = 0; n < PJ_NT; ++n)
              mma::mma_bf16(acc[m][n], a[m], b[n][pt].x, b[n][pt].y);
      } else {
        // u cut to TF32 and its rest (three instructions where Veltkamp's
        // split takes five; the rest below 2^-21 of u)
        uint32_t ah[PJ_MT][4], al[PJ_MT][4];
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mma::split_tf32_cut(a[m][e], ah[m][e], al[m][e]);
        uint4 b[PJ_NT];
#pragma unroll
        for (int n = 0; n < PJ_NT; ++n)
          b[n] = *reinterpret_cast<const uint4*>(f + n * 32 * WORDS);
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
          for (int n = 0; n < PJ_NT; ++n)
            mma::mma_tf32(acc[m][n], al[m], b[n].x, b[n].y);
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
          for (int n = 0; n < PJ_NT; ++n)
            mma::mma_tf32(acc[m][n], ah[m], b[n].z, b[n].w);
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
          for (int n = 0; n < PJ_NT; ++n)
            mma::mma_tf32(acc[m][n], ah[m], b[n].x, b[n].y);
      }
    }
#pragma unroll
    for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
      for (int n = 1; n < PJ_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) keep += acc[m][n][e];
    // y = xdbl[:, :8] B': A from xdbl's first n-tile, k = t <- column 2t,
    // k = t + 4 <- column 2t + 1
    uint32_t xh[PJ_MT][4], xl[PJ_MT][4];
#pragma unroll
    for (int m = 0; m < PJ_MT; ++m) {
      const uint32_t x[4] = {
          __float_as_uint(acc[m][0][0]), __float_as_uint(acc[m][0][2]),
          __float_as_uint(acc[m][0][1]), __float_as_uint(acc[m][0][3])};
      mma::split_tf32(x, xh[m], xl[m]);
    }
    __syncwarp();  // every lane's ldmatrix of the tile is done
    for (int j = 0; j < D / 8; j += 2) {
      float o[2][PJ_MT][4];
      uint4 b[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        b[jj] = wd[(j + jj) * 32 + lane];
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[jj][m][e] = 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
          mma::mma_tf32(o[jj][m], xl[m], b[jj].x, b[jj].y);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
          mma::mma_tf32(o[jj][m], xh[m], b[jj].z, b[jj].w);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
          mma::mma_tf32(o[jj][m], xh[m], b[jj].x, b[jj].y);
      // rounded to T, over the tile: rows g and g + 8, channels 2t, 2t + 1
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int m = 0; m < PJ_MT; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            unsigned char* q = buf + (m * 16 + g + 8 * hf) * L.pitch +
                               ((j + jj) * 8 + 2 * t) * (int)sizeof(T);
            if constexpr (BF)
              *reinterpret_cast<uint32_t*>(q) =
                  pack_bf16(o[jj][m][2 * hf], o[jj][m][2 * hf + 1]);
            else
              *reinterpret_cast<float2*>(q) =
                  make_float2(o[jj][m][2 * hf], o[jj][m][2 * hf + 1]);
          }
    }
    __syncwarp();
    // the valid rows, 16-byte streaming stores (nothing here reads y)
    {
      const long long r0 = tile * PJ_WR;
      const int nr = (int)min((long long)PJ_WR, rows - r0);
      unsigned char* dst = reinterpret_cast<unsigned char*>(y) + r0 * rb;
      int row = lane / cpr, ch = lane - row * cpr;
      const int srow = 32 / cpr, sch = 32 - srow * cpr;
      for (int i = lane; i < nr * cpr; i += 32) {
        __stcs(reinterpret_cast<uint4*>(dst + (long long)row * rb + ch * 16),
               *reinterpret_cast<const uint4*>(buf + row * L.pitch +
                                                ch * 16));
        row += srow;
        ch += sch;
        if (ch >= cpr) {
          ch -= cpr;
          ++row;
        }
      }
    }
    __syncwarp();  // the slot is free for the load two tiles on
  }
  if (sink) sink[(long long)blockIdx.x * blockDim.x + threadIdx.x] = keep;
}

// The tensor-core route where it takes the shape (D a multiple of 16, RN
// <= 40, R < 8, u and y 16-byte aligned, a warp's ring in shared memory),
// else the edge path; -1 for a shape the route does not take.
template <class T>
static int proj_mma_launch(const void* u, void* y, const float* wxp,
                           const float* wdt, long long rows, int D, int RN,
                           int R, cudaStream_t stream) {
  if (D % 16 || RN > PJ_RN || R + 1 > 8 ||
      (((uintptr_t)u | (uintptr_t)y) & 15))
    return -1;
  const ProjSmem<T> L(D);
  const int fit = (MAX_SMEM - L.total_fixed) / (PJ_RING * L.slot);
  const int nw = fit < PJ_WARPS ? fit : PJ_WARPS;
  if (nw < 1) return -1;
  const size_t smem = (size_t)L.total_fixed + (size_t)nw * PJ_RING * L.slot;
  auto kernel = proj_mma_kernel<T>;
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  // one wave of resident blocks, each warp walking its tiles
  int dev, sms, per_sm;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, nw * 32, smem)))
    return err;
  const long long ntiles = (rows + PJ_WR - 1) / PJ_WR;
  const long long blocks = (ntiles + nw - 1) / nw;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(blocks < wave ? blocks : wave);
  kernel<<<grid, nw * 32, smem, stream>>>(static_cast<const T*>(u),
                                          static_cast<T*>(y), wxp, wdt, rows,
                                          D, RN, R, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace probe
}  // namespace vmt

extern "C" int vmt_probe_transpose(const void* u, int dt, void* y,
                                   long long rows, int D, void* stream) {
  using namespace vmt::probe;
  if (D < 1 || D > MAX_D || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dt == vmt::DT_BF16
             ? transpose_launch<__nv_bfloat16>(u, y, rows, D, st)
             : transpose_launch<float>(u, y, rows, D, st);
}

extern "C" int vmt_probe_proj(const void* u, int dt, void* y,
                              const float* wxp, const float* wdt,
                              long long rows, int D, int RN, int R,
                              void* stream) {
  using namespace vmt::probe;
  if (D < 1 || D > MAX_D || RN > MAX_RN || R < 0 || R >= RN || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      dt == vmt::DT_BF16
          ? proj_mma_launch<__nv_bfloat16>(u, y, wxp, wdt, rows, D, RN, R, st)
          : proj_mma_launch<float>(u, y, wxp, wdt, rows, D, RN, R, st);
  if (err >= 0) return err;
  // the edge path
  const size_t smem =
      sizeof(float) * ((size_t)D * TP + RN * TP + RN * D + D * R);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int e = vmt::set_smem((const void*)proj_edge_kernel, smem);
  if (e) return e;
  const unsigned grid = (unsigned)((rows + TL - 1) / TL);
  proj_edge_kernel<<<grid, NTH, smem, st>>>(u, dt, y, wxp, wdt, rows, D, RN,
                                            R);
  return (int)cudaGetLastError();
}
