// K6: the OSS tail of a MamberBlock, forward.
//
// Replaces vmambair_tpu/ops/pallas_effn.py::_oss_tail_kernel (built by
// _oss_tail_pallas). Computes, per pixel,
//   out = LN(y_row + y_colT) * z,  LN over the D channels,
// where y_row and y_col are the two direction pairs of the spatial scans'
// summed output and y_colT is y_col read at its transposed position.
//
// Layout: y (B, 2, D, L) contiguous, L = H * W: pair 0 is row-major
// (l = h * W + w), pair 1 column-major (l = w * H + h); z and out
// (B, D, H, W) contiguous. y and z are each fp32 or bf16; out has z's
// dtype. lnw, lnb (D,) fp32. Rounding follows the TPU kernel: the sum
// y_row + y_colT is rounded to y's dtype before the fp32 statistics, and
// LN(.) is rounded to z's dtype before the gate multiply.
//
// What bounds it on the H100: bytes. Each element of y is read once, z
// once, out written once; the arithmetic is ~10 flops per element.
//
// Design. A block owns a TH x TW pixel tile of one image and a slice of
// its channels; where a tile's blocks would not fill the card, or D is
// wide, the channels are split over a cluster of `split` blocks, which
// add their partial statistics through distributed shared memory
// (ops/cuda_effn.py::k6_split picks it: the width class's least, doubled
// while the grid has fewer blocks than the card has SMs).
// - Tiles by dtype pair (one template instance each, nothing branches on
//   dtype per element): TH = two 16-byte vectors of y, TW = two of the
//   narrower of y and z, so every row-major run of y, z and out and every
//   column-major run of y is at least one whole 32-byte sector; four
//   vectors wide where all D channels of such a tile fit 48 KB (fp32 up
//   to D = 96, bf16 up to 48: the wider runs paid there, and lost where
//   they forced a split). fp32/fp32 8 x 8 or 8 x 16, bf16/bf16 16 x 16 or
//   16 x 32.
// - Merge: a thread takes a V x V block of one channel (V = y's elements
//   in 16 bytes): V row-major and V column-major 16-byte loads, all in
//   flight together, the column block transposed in registers, the sum
//   rounded to y's dtype. Neighbouring threads take the neighbouring
//   blocks, so each warp load covers whole sectors of both pairs. The
//   merged tile stays in shared memory in y's dtype (exact: the sum is
//   rounded there anyway), [channel][16-byte chunk], the chunk index
//   XOR-swizzled by the block so that the eight threads of a quarter-warp
//   store to eight distinct bank groups.
// - Statistics on every thread: NTH / (TH TW) channel groups a pixel (or
//   TH TW / NTH pixels a thread), group g summing channels g, g + G, ...
//   of the block's slice in order, the groups added in order, the
//   cluster's blocks in rank order; the mean first, then the centred
//   squares (rounded, then added), as JAX takes them (:455-456). A
//   pixel's shared offsets depend on its channel's parity alone, so they
//   are computed once.
// - Normalise, gate and store along w in 16-byte vectors of z's dtype: a
//   thread keeps one pixel vector of the tile (its mean and rstd read
//   once) and walks the channels.
// - Edges: where H or W is no multiple of the vectors, or a pointer is
//   not 16-byte aligned, the same kernel loads and stores element by
//   element (EDGE); the tiles, the shared layout and the statistics'
//   order are the same, and so are the results.
#include "common.cuh"
#include "mma.cuh"

namespace vmt {
namespace tail {

constexpr int NTH = 256;        // threads of a block
constexpr int MAX_SPLIT = 16;   // blocks of a cluster (16: non-portable)
// The width classes (ops/cuda_effn.py::K6_CLASSES): the largest D of each
// and the least split of its channels, so that a block holds at most 96
// channels of its tile; the wrapper may split further to fill the card.
constexpr int CLASS_D[] = {96, 192, 384, 768};
constexpr int CLASS_SPLIT[] = {1, 2, 4, 8};
constexpr int N_CLASSES = 4;
// A tile four 16-byte vectors wide where all D channels of it fit this
// (one block a tile: the wider runs pay; split, they do not)
constexpr long long WIDE_BYTES = 49152;

// An element type: V of them in 16 bytes, to and from fp32 (round to
// nearest even).
template <class T>
struct El;
template <>
struct El<float> {
  static constexpr int V = 4;
  __device__ static __forceinline__ float f(float v) { return v; }
  __device__ static __forceinline__ float of(float v) { return v; }
};
template <>
struct El<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static __forceinline__ __nv_bfloat16 of(float v) {
    return __float2bfloat16(v);
  }
};

// The tile of a dtype pair: VY, VZ elements a 16-byte vector; RH, RW
// 16-byte vectors of y down a column and of the narrower dtype along a row
// (RH = 2: whole 32-byte sectors; RW = 2, or 4 where all D channels of
// such a tile fit WIDE_BYTES, `wide`); the tile TH x TW; BX x BY blocks of
// VY x VY a channel; CK 16-byte chunks a channel; a block's NTH threads
// over the pixels, G channel groups a pixel or PPT pixels a thread.
template <class TY, class TZ, int RW_>
struct Tile {
  static constexpr int VY = El<TY>::V, VZ = El<TZ>::V;
  static constexpr int RH = 2, RW = RW_;
  static constexpr int TH = RH * VY;
  static constexpr int TW = RW * (VY > VZ ? VY : VZ);
  static constexpr int NPX = TH * TW;
  static constexpr int BX = TW / VY, BY = TH / VY, NB = BX * BY;
  static constexpr int CK = NPX / VY;
  static constexpr int G = NPX < NTH ? NTH / NPX : 1;
  static constexpr int PPT = NPX > NTH ? NPX / NTH : 1;
  static constexpr int NZ = TW / VZ;  // z vectors a tile row
};

// The shared chunk of the merged tile's chunk k = h BX + w / VY (h, w in
// the tile) of channel c: the XOR takes the low three bits only, and the
// chunks of a channel are a multiple of 8.
template <class K>
__device__ __forceinline__ int chunk_at(int c, int h, int k) {
  return c * K::CK + (k ^ ((K::BX * (h / K::VY) + K::NB * c) & 7));
}

// The sum over the cluster's blocks of the float at v's offset, in rank
// order (every block adds the same values in the same order).
__device__ __forceinline__ float cluster_total(const float* v, int split) {
  if (split == 1) return *v;
  float t = mma::ld_cluster(v, 0u);
  for (int r = 1; r < split; ++r) t += mma::ld_cluster(v, (unsigned)r);
  return t;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

template <class TY, class TZ, int RW, bool EDGE>
__global__ void __launch_bounds__(NTH, 3) oss_tail_kernel(
    const TY* __restrict__ y, const TZ* __restrict__ z, TZ* __restrict__ out,
    const float* __restrict__ lnw, const float* __restrict__ lnb, int D,
    int H, int W, int split, float eps) {
  using K = Tile<TY, TZ, RW>;
  constexpr int VY = K::VY, VZ = K::VZ, TH = K::TH, TW = K::TW;
  constexpr int NPX = K::NPX, BX = K::BX, NB = K::NB, G = K::G;
  constexpr int PPT = K::PPT, NP = NPX / PPT;  // pixels at a time
  extern __shared__ uint4 S[];  // [slice channel][CK chunks], swizzled
  __shared__ float s_red[G * NPX];  // the groups' partials, [g][pixel]
  __shared__ float s_sum[NPX], s_sq[NPX];  // the block's, read remotely
  __shared__ __align__(16) float s_mu[NPX];
  __shared__ __align__(16) float s_rs[NPX];

  const int tid = threadIdx.x;
  const int rank = blockIdx.x % split;
  const int h0 = blockIdx.y * TH, w0 = (blockIdx.x / split) * TW;
  const int c0 = rank * D / split, cb = (rank + 1) * D / split - c0;
  const long long L = (long long)H * W;
  const TY* yr = y + ((long long)blockIdx.z * 2 * D + c0) * L;
  const TY* yc = yr + (long long)D * L;
  const long long zo = ((long long)blockIdx.z * D + c0) * L;

  // 1. merge: a VY x VY block of one channel a thread
  for (int i = tid; i < cb * NB; i += NTH) {
    const int bx = i % BX, by = (i / BX) % K::BY, c = i / NB;
    const int hl = by * VY, wl = bx * VY;  // in the tile
    const int hb = h0 + hl, wb = w0 + wl;
    // a block past the image: its pixels are never stored, and no other
    // pixel's statistics read them
    if (hb >= H || wb >= W) continue;
    const TY* pr = yr + c * L;
    const TY* pc = yc + c * L;
    uint4 rw[VY], cl[VY];
    if constexpr (!EDGE) {
      // H and W are multiples of VY: the block lies wholly in the image
#pragma unroll
      for (int e = 0; e < VY; ++e) {
        rw[e] = ldg16(pr + (long long)(hb + e) * W + wb);
        cl[e] = ldg16(pc + (long long)(wb + e) * H + hb);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VY; ++e) {
        TY* r = reinterpret_cast<TY*>(&rw[e]);
        TY* q = reinterpret_cast<TY*>(&cl[e]);
#pragma unroll
        for (int j = 0; j < VY; ++j) {
          r[j] = hb + e < H && wb + j < W
                     ? pr[(long long)(hb + e) * W + wb + j]
                     : El<TY>::of(0.f);
          q[j] = wb + e < W && hb + j < H
                     ? pc[(long long)(wb + e) * H + hb + j]
                     : El<TY>::of(0.f);
        }
      }
    }
    // row e of the block: rw[e][j] + cl[j][e] (the column block
    // transposed), rounded to y's dtype, over rw in place
#pragma unroll
    for (int e = 0; e < VY; ++e) {
      TY* r = reinterpret_cast<TY*>(&rw[e]);
#pragma unroll
      for (int j = 0; j < VY; ++j)
        r[j] = El<TY>::of(El<TY>::f(r[j]) +
                          El<TY>::f(reinterpret_cast<const TY*>(&cl[j])[e]));
      S[chunk_at<K>(c, hl + e, (hl + e) * BX + bx)] = rw[e];
    }
  }
  __syncthreads();

  // 2. statistics: thread (g, p) sums channels g, g + G, .. at pixel p
  // (and, with PPT > 1, at p + NP, p + 2 NP, ..)
  const int g = tid / NP;
  const TY* St = reinterpret_cast<const TY*>(S);
  // pixel p's element of channel c: the swizzle depends on c's parity
  // alone (NB is a multiple of 4)
  auto at = [&](int c, const int (&off)[2]) {
    return El<TY>::f(St[c * K::CK * VY + off[c & 1]]);
  };
  auto offsets = [&](int p, int (&off)[2]) {
    const int ph = p / TW;
    off[0] = chunk_at<K>(0, ph, ph * BX + (p % TW) / VY) * VY + p % VY;
    off[1] = (chunk_at<K>(1, ph, ph * BX + (p % TW) / VY) - K::CK) * VY +
             p % VY;
  };
  // the groups' partials added in order at pixel p, into v[p]
  auto groups = [&](float* v) {
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int p = tid % NP + q * NP;
        float t = s_red[p];
#pragma unroll
        for (int k = 1; k < G; ++k) t += s_red[k * NPX + p];
        v[p] = t;
      }
    }
    if (split > 1) mma::cluster_sync();
  };
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = tid % NP + q * NP;
    int off[2];
    offsets(p, off);
    float part = 0.f;
    for (int c = g; c < cb; c += G) part += at(c, off);
    s_red[g * NPX + p] = part;
  }
  groups(s_sum);
  if (g == 0) {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int p = tid % NP + q * NP;
      s_mu[p] = cluster_total(s_sum + p, split) / (float)D;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = tid % NP + q * NP;
    const float mu = s_mu[p];
    int off[2];
    offsets(p, off);
    float part = 0.f;
    for (int c = g; c < cb; c += G) {
      const float d = at(c, off) - mu;
      part = __fadd_rn(part, __fmul_rn(d, d));
    }
    s_red[g * NPX + p] = part;
  }
  groups(s_sq);
  if (g == 0) {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int p = tid % NP + q * NP;
      s_rs[p] = rsqrtf(cluster_total(s_sq + p, split) / (float)D + eps);
    }
  }
  // no block of the cluster leaves while another reads its statistics
  if (split > 1)
    mma::cluster_sync();
  else
    __syncthreads();

  // 3. normalise, gate, store along w, a VZ-vector of z at a time: a
  // thread keeps one of the tile's PV pixel vectors (its statistics loaded
  // once) and takes every CS-th channel
  constexpr int NCH = VZ > VY ? VZ / VY : 1;  // y chunks a z vector
  constexpr int PV = TH * K::NZ, CS = NTH / PV;
  static_assert(NTH % PV == 0, "a thread's pixel vector is fixed");
  const int wl = (tid % PV % K::NZ) * VZ, hl = tid % PV / K::NZ;
  const int h = h0 + hl, w = w0 + wl;
  if (h >= H || w >= W) return;
  float m[VZ], rs[VZ];
#pragma unroll
  for (int j = 0; j < VZ; j += 4) {
    *reinterpret_cast<float4*>(&m[j]) =
        *reinterpret_cast<const float4*>(&s_mu[hl * TW + wl + j]);
    *reinterpret_cast<float4*>(&rs[j]) =
        *reinterpret_cast<const float4*>(&s_rs[hl * TW + wl + j]);
  }
  const int off = VZ < VY ? wl % VY : 0;  // z's half of the y chunk
  int ck[2][NCH];  // the y chunks by the channel's parity
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    ck[0][j] = chunk_at<K>(0, hl, hl * BX + wl / VY + j);
    ck[1][j] = chunk_at<K>(1, hl, hl * BX + wl / VY + j) - K::CK;
  }
  for (int c = tid / PV; c < cb; c += CS) {
    const long long o = zo + c * L + (long long)h * W + w;
    uint4 zv;
    if constexpr (!EDGE) {
      zv = ldg16(z + o);
    } else {
      TZ* q = reinterpret_cast<TZ*>(&zv);
#pragma unroll
      for (int j = 0; j < VZ; ++j)
        q[j] = w + j < W ? z[o + j] : El<TZ>::of(0.f);
    }
    uint4 ych[NCH];
#pragma unroll
    for (int j = 0; j < NCH; ++j) ych[j] = S[c * K::CK + ck[c & 1][j]];
    const TY* ye = reinterpret_cast<const TY*>(ych);
    const float lw = __ldg(lnw + c0 + c), lb = __ldg(lnb + c0 + c);
    uint4 ov;
    TZ* ot = reinterpret_cast<TZ*>(&ov);
    const TZ* zt = reinterpret_cast<const TZ*>(&zv);
#pragma unroll
    for (int j = 0; j < VZ; ++j) {
      float x;
      if constexpr (VZ < VY)
        x = El<TY>::f(off ? ye[VZ + j] : ye[j]);
      else
        x = El<TY>::f(ye[j]);
      const float zn = fmaf((x - m[j]) * rs[j], lw, lb);
      ot[j] = El<TZ>::of(El<TZ>::f(El<TZ>::of(zn)) * El<TZ>::f(zt[j]));
    }
    if constexpr (!EDGE) {
      __stcs(reinterpret_cast<uint4*>(out + o), ov);
    } else {
#pragma unroll
      for (int j = 0; j < VZ; ++j)
        if (w + j < W) out[o + j] = ot[j];
    }
  }
}

template <class TY, class TZ, int RW, bool EDGE>
static int launch(const void* y, const void* z, void* out, const float* lnw,
                  const float* lnb, int B, int D, int H, int W, int split,
                  float eps, cudaStream_t stream) {
  using K = Tile<TY, TZ, RW>;
  const size_t smem =
      sizeof(uint4) * K::CK * (size_t)((D + split - 1) / split);
  auto kernel = oss_tail_kernel<TY, TZ, RW, EDGE>;
  // set unconditionally: the static statistics count against the 48 KB
  // that needs no opt-in
  int err = (int)cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  if (split > 8 &&
      (err = (int)cudaFuncSetAttribute(
           (const void*)kernel,
           cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + K::TW - 1) / K::TW * split,
                     (H + K::TH - 1) / K::TH, B);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const TY*>(y),
                                static_cast<const TZ*>(z),
                                static_cast<TZ*>(out), lnw, lnb, D, H, W,
                                split, eps);
  if (err) return err;
  return (int)cudaGetLastError();
}

// Whether a tile four vectors wide takes all D channels in one block.
template <class TY, class TZ>
static bool wide(int D) {
  using K = Tile<TY, TZ, 4>;
  return (long long)D * K::NPX * sizeof(TY) <= WIDE_BYTES;
}

// The 16-byte route where H and W are multiples of the vectors and every
// pointer is 16-byte aligned, else the edge path; the tile four vectors
// wide where `wide`.
template <class TY, class TZ>
static int route(const void* y, const void* z, void* out, const float* lnw,
                 const float* lnb, int B, int D, int H, int W, int split,
                 float eps, cudaStream_t stream) {
  constexpr int VY = El<TY>::V, VZ = El<TZ>::V;
  const bool fast = H % VY == 0 && W % VY == 0 && W % VZ == 0 &&
                    (((uintptr_t)y | (uintptr_t)z | (uintptr_t)out) & 15) == 0;
  if (wide<TY, TZ>(D))
    return fast ? launch<TY, TZ, 4, false>(y, z, out, lnw, lnb, B, D, H, W,
                                           split, eps, stream)
                : launch<TY, TZ, 4, true>(y, z, out, lnw, lnb, B, D, H, W,
                                          split, eps, stream);
  return fast ? launch<TY, TZ, 2, false>(y, z, out, lnw, lnb, B, D, H, W,
                                         split, eps, stream)
              : launch<TY, TZ, 2, true>(y, z, out, lnw, lnb, B, D, H, W,
                                        split, eps, stream);
}

}  // namespace tail
}  // namespace vmt

// split: the blocks a tile's channels are split over (ops/cuda_effn.py::
// k6_split), a power of two from the width class's least up to 16.
extern "C" int vmt_oss_tail_fwd(
    const void* y, int dty, const void* z, int dtz, void* out,
    const float* lnw, const float* lnb, int B, int D, int H, int W,
    int split, float eps, void* stream) {
  using namespace vmt::tail;
  int cls = 0;
  while (cls < N_CLASSES && D > CLASS_D[cls]) ++cls;
  if (D < 1 || cls == N_CLASSES || split < CLASS_SPLIT[cls] ||
      split > MAX_SPLIT || (split & (split - 1)) || split > D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (dty == vmt::DT_BF16)
    return dtz == vmt::DT_BF16
               ? route<bf, bf>(y, z, out, lnw, lnb, B, D, H, W, split, eps, st)
               : route<bf, float>(y, z, out, lnw, lnb, B, D, H, W, split, eps,
                                  st);
  return dtz == vmt::DT_BF16
             ? route<float, bf>(y, z, out, lnw, lnb, B, D, H, W, split, eps,
                                st)
             : route<float, float>(y, z, out, lnw, lnb, B, D, H, W, split, eps,
                                   st);
}
