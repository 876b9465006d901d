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
// tile is TL consecutive rows of the flattened (B * L, D) array (64 for
// the projections, the edge path's transpose too).
//
// What bounds them on the H100: the transpose pair its bytes (u read and y
// written once); the projection the bytes as well when only the rows the
// output reads (R + 1) are counted, but it computes every row of xdbl in
// fp32 on the CUDA cores, as the TPU probe prices the full projection of
// a fused kernel: 2 RN D + 2 D R + D flops per position, a little above
// its bytes' time at RN = 38, D = 96, R = 6.
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
// The projection probe (`proj_kernel`) stages its tile through shared
// memory transposed, uT [D][TL + 1] fp32 (the pitch keeps a warp's column
// of channels off one bank), from coalesced loads of the contiguous
// (TL, D) tile, 8 raw loads in flight per thread (ld_raw_n). It keeps W_xp
// and W_dt in shared memory; 4 threads share a position, each computing
// every 4th row of xdbl over D (W_xp broadcast across the warp, uT read
// along the positions), into xdbl [RN][TL + 1]; then each thread forms one
// output element (position, channel) from the R + 1 rows, in the order of
// the coalesced store.
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

__global__ void __launch_bounds__(NTH) proj_kernel(
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
  const size_t smem =
      sizeof(float) * ((size_t)D * TP + RN * TP + RN * D + D * R);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = vmt::set_smem((const void*)proj_kernel, smem);
  if (err) return err;
  const unsigned grid = (unsigned)((rows + TL - 1) / TL);
  proj_kernel<<<grid, NTH, smem, (cudaStream_t)stream>>>(
      u, dt, y, wxp, wdt, rows, D, RN, R);
  return (int)cudaGetLastError();
}
