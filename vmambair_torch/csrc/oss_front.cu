// K5: the OSS front of a MamberBlock, forward.
//
// Replaces vmambair_tpu/ops/pallas_effn.py::_oss_front_kernel (built by
// _oss_front_pallas). Computes, per pixel,
//   zn = LN(x) over C (fp32 statistics, rounded to the activation dtype),
//   px = W_x . zn + b_x, set to 0 outside the image after the bias,
//   xs = SiLU(dwconv3x3(px) + b_dw),
//   z  = SiLU(W_z . zn + b_z),
// with one read of x and one write of each of xs and z. W_x, W_z: the
// x-half and z-half rows of the biased 1x1 in_conv. As on the TPU, LN(x),
// the weights and the biases are rounded to the activation dtype, each
// product sums in fp32, and px stays fp32.
//
// What bounds it on the H100: bytes. Per pixel the products are 2 C E
// multiply-adds and the depthwise conv 9 E; x is read once and xs, z
// written once.
//
// Two routes, by the activation dtype:
//
// bf16 (the served forward): `oss_front_mma_kernel`. A block of 8 warps
// owns a TH x TW output tile of one image (8 x 16 at C <= 96, 8 x 8 at
// C <= 192, 4 x 8 up to 704: the width class, a template argument). K2's
// front (mma_front.cuh) stages x's halo and LN's weights by cp.async and
// writes LN(x) over the (TH+2) x (TW+2) halo to shared memory as bf16,
// pixel-major. The block then walks the output channels in tiles of ET
// over that one normalised halo: the next tile's packed weights (the x-
// and z-half rows, the taps and the three biases; the wrapper packs them
// per tile, `ops/cuda_effn.py::pack_front_weights`) are staged by cp.async
// into the other slot of a two-slot ring while this tile computes. Both
// products run on the tensor cores (ldmatrix + mma.sync m16n8k16, bf16 ->
// fp32) with the weight rows as the A operand, so that each accumulator
// holds a channel's pixels: the x-half over the halo into an fp32 px tile
// in shared memory, channel-major, with its bias and the zero outside the
// image (in_conv has a bias, so proj(0) != 0: that zero is the padding the
// plain depthwise conv sees); the z-half only over the TH x TW pixels it
// is stored at (as JAX's zn_mid), its B rows gathered from LN(x)'s centre
// by ldmatrix's per-lane row addresses, then its bias and SiLU into a bf16
// staging tile. The depthwise 3x3 runs on the CUDA cores in fp32, taps in
// (dy, dx) order, a thread per (channel, column) sliding down the tile's
// rows. Both staged tiles go out coalesced, in 16-byte stores when W is a
// multiple of 8. Where the spatial tiles fill at most half the SMs (the
// widest level), blockIdx.y splits the channel tiles across blocks, each
// normalising its halo itself. Any C <= 704, E, H, W.
//
// fp32 (the S1 step with the switch on): `oss_front_kernel`, fp32 FMAs on
// the CUDA cores (ln_halo.cuh): fp32 products, which the tensor cores do
// not give (TF32 keeps 10 bits). A block owns a 4 x 8 output tile: it
// normalises x over the halo into shared memory once, then walks the
// output channels in tiles of ET, projecting LN(x) onto each tile's x- and
// z-channels with W_in staged KC input channels at a time; the x-half is
// set to 0 outside the image after the bias. When the spatial tiles alone
// would not fill the card, blockIdx.y splits the channel tiles across
// blocks.
#include "ln_halo.cuh"
#include "mma_front.cuh"

namespace vmt {

constexpr int FRONT_MAX_SMEM = 232448;  // opt-in shared memory per block

// ---------------------------------------------------------------------------
// The bf16 route: both products on the tensor cores.
// ---------------------------------------------------------------------------
namespace k5 {

// the thread count, the layout policy and the LayerNorm front
// (mma_front.cuh)
using namespace mfront;

constexpr int AUX = 12;  // per channel: 9 taps, b_dw, b_x, b_z (fp32)

// A width class: a TH x TW output tile, ET output channels per tile (MT
// m16 blocks of each half). The x-half's B operand: NBX n8 blocks of halo
// pixels, NX a warp; zn has MP = 8 NBX rows. The z-half's: NBZ n8 blocks
// of output pixels, NZ a warp. px [ET][PXP] fp32 with PXP = TW mod 32, so
// that a warp of the conv pass (TW columns of 32 / TW channels) reads 32
// distinct banks; xs and z are staged [ET][OQP] bf16.
template <int TH_, int TW_, int ET_>
struct Fcls {
  static constexpr int TH = TH_, TW = TW_, ET = ET_, MT = ET / 16;
  static constexpr int PH = TH + 2, PW = TW + 2, P = PH * PW, Q = TH * TW;
  static constexpr int NBX = (P + 7) / 8, NX = (NBX + NWARP - 1) / NWARP;
  static constexpr int MP = 8 * NBX;
  static constexpr int NBZ = Q / 8, NZ = (NBZ + NWARP - 1) / NWARP;
  static constexpr int PXP = (MP - TW + 31) / 32 * 32 + TW;
  static constexpr int OQP = Q + 8;
  // x's halo staged per channel in rows of RW elements, XS apart
  // (mma_front.cuh)
  static constexpr int RW = TW + 4;
  static constexpr int XS = (PH * RW + 47) / 64 * 64 + 16;
  __device__ static __forceinline__ int xi(int p) {
    return (p / PW) * RW + p % PW + 1;
  }
  // the conv pass: ET x TW x RG tasks, each TR rows of one column
  static constexpr int RG = NTH / (ET * TW) > 1 ? NTH / (ET * TW) : 1;
  static constexpr int TR = TH / RG;
  static_assert(ET % 16 == 0 && TW % 8 == 0 && TH % RG == 0, "");
};

// the width classes; ops/cuda_effn.py's K5_CLASSES gives the wrapper each
// one's largest C, tile and ET (32 only at 48 < C <= 96: a tile of 32 would
// leave half its channels idle at E = 48, and more than 32 channels take
// the second block off the SM there)
using Fc0 = Fcls<8, 16, 16>;  // C <= 48
using Fc1 = Fcls<8, 16, 32>;  // C <= 96
using Fc2 = Fcls<8, 8, 16>;   // C <= 192
using Fc3 = Fcls<4, 8, 16>;   // C <= 704

// Byte offsets in dynamic shared memory for C channels (KP: C rounded up
// to 16; ZP = KP + 8 its pitch, so that ldmatrix's eight rows fall in
// eight distinct 16-byte bank groups). zn [MP][ZP] bf16 from 0; from u =
// the end of zn, the front's scratch (x's halo [C][XS] bf16, the
// statistics [2][P] and LN's weight and bias [2][KP] fp32) under the tile
// loop's (px [ET][PXP] fp32 at u, then the staged xs and z [2][ET][OQP]
// bf16 at `out`); the ring's two slots (W_x's and W_z's rows [2 ET][ZP]
// bf16, then the taps and biases [ET][AUX] fp32) follow the tile loop's
// region. Where the front's scratch is the larger (wide C), the ring lies
// over its end and the first tile's weights are staged after the front
// (early false); otherwise while x's halo loads.
struct Plan {
  int stats, ln, out, ring, slot, total;
  bool early;
};

template <class K>
__host__ __device__ inline Plan plan(int C) {
  const int KP = (C + 15) / 16 * 16, ZP = KP + 8;
  const int u = K::MP * ZP * 2;
  Plan p;
  p.stats = u + (C * K::XS * 2 + 15) / 16 * 16;
  p.ln = p.stats + (2 * K::P * 4 + 15) / 16 * 16;
  const int front = p.ln + 2 * KP * 4 - u;
  const int tile = K::ET * K::PXP * 4 + 2 * K::ET * K::OQP * 2;
  p.out = u + K::ET * K::PXP * 4;
  p.ring = u + tile;
  p.slot = 2 * K::ET * ZP * 2 + K::ET * AUX * 4;
  p.early = front <= tile;
  const int end = p.ring + 2 * p.slot;
  p.total = end > u + front ? end : u + front;
  return p;
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + __expf(-v));
}

// cp.async channel tile t's packed weights into a ring slot (16-byte
// chunks; the packed rows are KP bf16 long, the taps and biases AUX fp32).
template <class K>
__device__ __forceinline__ void stage_weights(
    unsigned char* slot, const __nv_bfloat16* __restrict__ win_p,
    const float* __restrict__ aux_p, int KP, int t) {
  const int tid = threadIdx.x, ZP = KP + 8, kc = KP / 8;
  const __nv_bfloat16* gw = win_p + (long long)t * 2 * K::ET * KP;
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(slot);
  for (int i = tid; i < 2 * K::ET * kc; i += NTH) {
    const int r = i / kc, c = i - r * kc;
    mma::cp_async16(sw + r * ZP + c * 8, gw + r * KP + c * 8);
  }
  const float* ga = aux_p + (long long)t * K::ET * AUX;
  float* sa = reinterpret_cast<float*>(slot + 2 * K::ET * ZP * 2);
  for (int i = tid; i < K::ET * AUX / 4; i += NTH)
    mma::cp_async16(sa + 4 * i, ga + 4 * i);
  mma::cp_async_commit();
}

template <class K>
__global__ void __launch_bounds__(NTH, 2) oss_front_mma_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xs,
    __nv_bfloat16* __restrict__ z, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ win_p,
    const float* __restrict__ aux_p, int C, int E, int H, int W,
    int tiles_x, float eps) {
  extern __shared__ __align__(16) unsigned char smk[];
  const int KP = (C + 15) / 16 * 16, ZP = KP + 8;
  const Plan pl = plan<K>(C);
  const int u = K::MP * ZP * 2;
  __nv_bfloat16* zn = reinterpret_cast<__nv_bfloat16*>(smk);
  float* px = reinterpret_cast<float*>(smk + u);
  __nv_bfloat16* xst = reinterpret_cast<__nv_bfloat16*>(smk + pl.out);
  __nv_bfloat16* zst = xst + K::ET * K::OQP;
  float* stats = reinterpret_cast<float*>(smk + pl.stats);

  const int y0 = (blockIdx.x / tiles_x) * K::TH;
  const int x0 = (blockIdx.x % tiles_x) * K::TW;
  const long long HW = (long long)H * W;
  const long long xb = (long long)blockIdx.z * C * HW;
  const long long ob = (long long)blockIdx.z * E * HW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nt = (E + K::ET - 1) / K::ET, t0 = blockIdx.y, dt = gridDim.y;

  if (pl.early)  // the first tile's weights, while x's halo loads
    stage_weights<K>(smk + pl.ring, win_p, aux_p, KP, t0);
  // 1. x's halo and LN's weights by cp.async, the statistics, zn [MP][ZP]
  // = round(LN(x)) (mma_front.cuh)
  ln_front<K, Nchw<K>>(x, lnw, lnb, C, H, W, y0, x0, xb, eps,
                       reinterpret_cast<unsigned short*>(smk + u),
                       reinterpret_cast<float*>(smk + pl.ln), stats,
                       stats + K::P, zn);
  if (!pl.early) {
    __syncthreads();  // the front's readers are done: the ring lies over
                      // its scratch
    stage_weights<K>(smk + pl.ring, win_p, aux_p, KP, t0);
  }

  // the B operand's rows for this warp's n8 blocks (lanes 0-15: pixel
  // lane % 8 of the block, k from (lane / 8) * 8): halo pixels for the
  // x-half; for the z-half the output pixels, each at its halo position.
  // A block past the last (NBX, NBZ) repeats the last, so that the k loop
  // has no branch; its results are not kept
  const int kofs = ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* bxr[K::NX];
  const __nv_bfloat16* bzr[K::NZ];
#pragma unroll
  for (int j = 0; j < K::NX; ++j) {
    const int blk = min(warp * K::NX + j, K::NBX - 1);
    bxr[j] = zn + (blk * 8 + (lane & 7)) * ZP + kofs;
  }
#pragma unroll
  for (int j = 0; j < K::NZ; ++j) {
    const int q = min(warp * K::NZ + j, K::NBZ - 1) * 8 + (lane & 7);
    bzr[j] = zn + ((q / K::TW + 1) * K::PW + q % K::TW + 1) * ZP + kofs;
  }
  const bool w16 = W % 8 == 0;

  for (int i = 0, t = t0; t < nt; ++i, t += dt) {
    mma::cp_async_wait_all();
    __syncthreads();  // tile t's weights and zn are in; the previous
                      // tile's readers of the other slot, px and the
                      // staged tiles are done
    if (t + dt < nt)
      stage_weights<K>(smk + pl.ring + ((i + 1) & 1) * pl.slot, win_p,
                       aux_p, KP, t + dt);
    const unsigned char* slot = smk + pl.ring + (i & 1) * pl.slot;
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(slot);
    const float* au =
        reinterpret_cast<const float*>(slot + 2 * K::ET * ZP * 2);

    // 2. the products: [ET x halo pixels] = W_x . zn^T and [ET x output
    // pixels] = W_z . zn_mid^T, fp32 accumulators
    {
      float ax[K::MT][K::NX][4], az[K::MT][K::NZ][4];
#pragma unroll
      for (int m = 0; m < K::MT; ++m) {
#pragma unroll
        for (int j = 0; j < K::NX; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ax[m][j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < K::NZ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) az[m][j][e] = 0.f;
      }
      const __nv_bfloat16* arow = ws + (lane & 15) * ZP + (lane >> 4) * 8;
      for (int k0 = 0; k0 < KP; k0 += 16) {
        uint32_t fx[K::MT][4], fz[K::MT][4];
#pragma unroll
        for (int m = 0; m < K::MT; ++m) {
          mma::ldsm_x4(fx[m], arow + m * 16 * ZP + k0);
          mma::ldsm_x4(fz[m], arow + (K::ET + m * 16) * ZP + k0);
        }
#pragma unroll
        for (int j = 0; j < K::NX; ++j) {
          uint32_t bb[2];
          mma::ldsm_x2(bb, bxr[j] + k0);
#pragma unroll
          for (int m = 0; m < K::MT; ++m)
            mma::mma_bf16(ax[m][j], fx[m], bb[0], bb[1]);
        }
#pragma unroll
        for (int j = 0; j < K::NZ; ++j) {
          uint32_t bb[2];
          mma::ldsm_x2(bb, bzr[j] + k0);
#pragma unroll
          for (int m = 0; m < K::MT; ++m)
            mma::mma_bf16(az[m][j], fz[m], bb[0], bb[1]);
        }
      }
      // px = the x-half + b_x, 0 outside the image; the z-half's
      // SiLU(. + b_z) staged as bf16. Accumulator e of block (m, j):
      // channel 16 m + g + 8 (e / 2), pixel 8 (block) + 2 t4 + e % 2
#pragma unroll
      for (int j = 0; j < K::NX; ++j) {
        const int blk = warp * K::NX + j;
        if (blk < K::NBX) {
          const int p = blk * 8 + 2 * t4;
          bool in[2];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int gy = y0 - 1 + (p + s) / K::PW;
            const int gx = x0 - 1 + (p + s) % K::PW;
            in[s] = p + s < K::P && gy >= 0 && gy < H && gx >= 0 && gx < W;
          }
#pragma unroll
          for (int m = 0; m < K::MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ch = 16 * m + g + 8 * h;
              const float bias = au[ch * AUX + 10];
              *reinterpret_cast<float2*>(px + ch * K::PXP + p) = make_float2(
                  in[0] ? ax[m][j][2 * h] + bias : 0.f,
                  in[1] ? ax[m][j][2 * h + 1] + bias : 0.f);
            }
        }
      }
#pragma unroll
      for (int j = 0; j < K::NZ; ++j) {
        const int blk = warp * K::NZ + j;
        if (blk < K::NBZ) {
          const int q = blk * 8 + 2 * t4;
#pragma unroll
          for (int m = 0; m < K::MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ch = 16 * m + g + 8 * h;
              const float bias = au[ch * AUX + 11];
              *reinterpret_cast<__nv_bfloat162*>(zst + ch * K::OQP + q) =
                  __floats2bfloat162_rn(silu(az[m][j][2 * h] + bias),
                                        silu(az[m][j][2 * h + 1] + bias));
            }
        }
      }
    }
    __syncthreads();
    // 3. depthwise 3x3 (fp32, taps in (dy, dx) order), + b_dw, SiLU: a
    // thread per (channel j, column qx, row group) slides down its TR
    // rows, each halo row read once
    const int e0 = t * K::ET;
    for (int task = tid; task < K::ET * K::TW * K::RG; task += NTH) {
      const int qx = task % K::TW, rest = task / K::TW;
      const int j = rest % K::ET, r0 = (rest / K::ET) * K::TR;
      if (e0 + j >= E) continue;
      const float* a9 = au + j * AUX;
      float w9[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w9[k] = a9[k];
      float acc[K::TR];
#pragma unroll
      for (int r = 0; r < K::TR; ++r) acc[r] = 0.f;
#pragma unroll
      for (int rr = 0; rr < K::TR + 2; ++rr) {
        const float* hr = px + j * K::PXP + (r0 + rr) * K::PW + qx;
        const float h3[3] = {hr[0], hr[1], hr[2]};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = rr - dy;
          if (r >= 0 && r < K::TR) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) acc[r] += w9[dy * 3 + dx] * h3[dx];
          }
        }
      }
      const float bd = a9[9];
#pragma unroll
      for (int r = 0; r < K::TR; ++r)
        xst[j * K::OQP + (r0 + r) * K::TW + qx] =
            __float2bfloat16(silu(acc[r] + bd));
    }
    __syncthreads();
    // 4. the staged xs and z tiles out, 16-byte stores of 8 pixels where
    // W is a multiple of 8, else element by element
    if (w16) {
      constexpr int CPR = K::TW / 8, NCH = K::ET * K::TH * CPR;
      for (int c = tid; c < 2 * NCH; c += NTH) {
        const int half = c / NCH, r = c - half * NCH;
        const int j = r / (K::TH * CPR), rem = r - j * (K::TH * CPR);
        const int qy = rem / CPR, c8 = rem - qy * CPR;
        const int gy = y0 + qy, gx = x0 + 8 * c8;
        if (e0 + j < E && gy < H && gx < W) {
          const __nv_bfloat16* s =
              (half ? zst : xst) + j * K::OQP + qy * K::TW + 8 * c8;
          __nv_bfloat16* d = (half ? z : xs) + ob + (e0 + j) * HW +
                             (long long)gy * W + gx;
          *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
        }
      }
    } else {
      for (int c = tid; c < 2 * K::ET * K::Q; c += NTH) {
        const int half = c / (K::ET * K::Q), r = c - half * K::ET * K::Q;
        const int j = r / K::Q, q = r - j * K::Q;
        const int gy = y0 + q / K::TW, gx = x0 + q % K::TW;
        if (e0 + j < E && gy < H && gx < W)
          (half ? z : xs)[ob + (e0 + j) * HW + (long long)gy * W + gx] =
              (half ? zst : xst)[j * K::OQP + q];
      }
    }
  }
}

template <class K>
static int launch(const void* x, void* xs, void* z, const float* lnw,
                  const float* lnb, const void* win_p, const float* aux_p,
                  int B, int C, int E, int H, int W, float eps,
                  cudaStream_t stream) {
  const Plan pl = plan<K>(C);
  if (pl.total > FRONT_MAX_SMEM || C < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)oss_front_mma_kernel<K>, pl.total);
  if (err) return err;
  const int tiles_x = (W + K::TW - 1) / K::TW;
  const int tiles = tiles_x * ((H + K::TH - 1) / K::TH);
  const int nt = (E + K::ET - 1) / K::ET;
  // where the spatial tiles fill at most half of the H100's 132 SMs, split
  // the channel tiles into groups of blocks, about two blocks an SM
  int groups = 1;
  if (2 * tiles * B <= 132) {
    groups = 264 / (tiles * B);
    if (groups > nt) groups = nt;
  }
  dim3 grid(tiles, groups, B);
  oss_front_mma_kernel<K><<<grid, NTH, pl.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(xs),
      static_cast<__nv_bfloat16*>(z), lnw, lnb,
      static_cast<const __nv_bfloat16*>(win_p), aux_p, C, E, H, W, tiles_x,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace k5

// ---------------------------------------------------------------------------
// The fp32 route: fp32 FMAs on the CUDA cores.
// ---------------------------------------------------------------------------
namespace front {

using namespace halo;

constexpr int ET = RT;                   // output channels per tile

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

__global__ void __launch_bounds__(NTH, 2) oss_front_kernel(
    const void* __restrict__ x, int dt, void* __restrict__ xs,
    void* __restrict__ z, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ win_t,
    const float* __restrict__ bin, const float* __restrict__ wdw,
    const float* __restrict__ bdw, int C, int E, int H, int W, int tiles_x,
    float eps) {
  extern __shared__ float sm[];
  float* zn = sm;                 // [C][PP]     LN(x) over the halo
  float* pb = zn + C * PP;        // [2*ET][PP]  projected channel tile
  float* ws = pb + 2 * ET * PP;   // [KC][2*ET]  W_in slice of the tile
  __shared__ float s_mu[PP], s_rs[PP];

  const int b = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const long long HW = (long long)H * W;
  const long long xb = (long long)b * C * HW;
  const long long ob = (long long)b * E * HW;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  // 1-2. LN(x) over the halo (ln_halo.cuh)
  ln_halo(x, dt, xb, lnw, lnb, C, H, W, y0, x0, eps, zn, s_mu, s_rs);

  for (int e0 = blockIdx.y * ET; e0 < E; e0 += gridDim.y * ET) {
    __syncthreads();  // zn ready; the previous tile's pb readers are done
    // 3. project the channel tile over the halo: row r < ET is x-channel
    // e0 + r, row r >= ET is z-channel e0 + r - ET; then the bias, and the
    // x-half set to 0 outside the image
    {
      float pa[ROWS_L][PIX_W];
      project_tile(zn, ws, win_t, C, E, e0, pa);
#pragma unroll
      for (int m = 0; m < ROWS_L; ++m) {
        const int r = lane + 32 * m;
        const int e = e0 + r % ET;
        const float bias = e < E ? bin[(r / ET) * E + e] : 0.f;
#pragma unroll
        for (int j = 0; j < PIX_W; ++j) {
          const int p = warp * PIX_W + j;
          pb[r * PP + p] = (r < ET && !in_image(p, y0, x0, H, W))
                               ? 0.f
                               : pa[m][j] + bias;
        }
      }
    }
    __syncthreads();
    // 4. depthwise 3x3 + bias + SiLU into xs, SiLU of the z-half into z
    for (int i = tid; i < ET * Q; i += NTH) {
      const int j = i / Q, q = i % Q;
      const int e = e0 + j;
      const int qy = q / TW, qx = q % TW;
      const int gy = y0 + qy, gx = x0 + qx;
      if (e < E && gy < H && gx < W) {
        const float* w9 = wdw + (long long)e * 9;
        const float* h = pb + j * PP;
        float a = bdw[e];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            a += w9[dy * 3 + dx] * h[(qy + dy) * PW + qx + dx];
        const long long o = ob + (long long)e * HW + (long long)gy * W + gx;
        st_act(xs, o, dt, silu(a));
        st_act(z, o, dt, silu(pb[(ET + j) * PP + (qy + 1) * PW + qx + 1]));
      }
    }
  }
}

}  // namespace front
}  // namespace vmt

// K5, bf16: x (B, C, H, W), xs and z (B, E, H, W) bf16; lnw, lnb (C,)
// fp32; win_p (nt, 2 ET, KP) bf16, tile t holding the in_conv's x-half
// rows t ET .. t ET + ET - 1, then its z-half rows E + t ET .., zero past E
// and past C (KP: C rounded up to 16); aux_p (nt, ET, 12) fp32, each
// channel's 9 depthwise taps, b_dw, b_x and b_z, zero past E; cls the
// width class (its ET: ops/cuda_effn.py::K5_CLASSES and
// pack_front_weights).
extern "C" int vmt_oss_front_fwd(
    const void* x, void* xs, void* z, const float* lnw, const float* lnb,
    const void* win_p, const float* aux_p, int B, int C, int E, int H, int W,
    int cls, float eps, void* stream) {
  using namespace vmt::k5;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cls) {
    case 0:
      return launch<Fc0>(x, xs, z, lnw, lnb, win_p, aux_p, B, C, E, H, W,
                         eps, st);
    case 1:
      return launch<Fc1>(x, xs, z, lnw, lnb, win_p, aux_p, B, C, E, H, W,
                         eps, st);
    case 2:
      return launch<Fc2>(x, xs, z, lnw, lnb, win_p, aux_p, B, C, E, H, W,
                         eps, st);
    case 3:
      return launch<Fc3>(x, xs, z, lnw, lnb, win_p, aux_p, B, C, E, H, W,
                         eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K5, fp32: x (B, C, H, W), xs and z (B, E, H, W) fp32; lnw, lnb (C,);
// win_t (C, 2E) = the in_conv weight transposed, x-half columns first;
// bin (2E,); wdw (E, 9); bdw (E,); all fp32.
extern "C" int vmt_oss_front_f32_fwd(
    const void* x, void* xs, void* z, const float* lnw, const float* lnb,
    const float* win_t, const float* bin, const float* wdw, const float* bdw,
    int B, int C, int E, int H, int W, float eps, void* stream) {
  using namespace vmt::front;
  const size_t smem =
      sizeof(float) * ((size_t)C * PP + 2 * ET * PP + KC * 2 * ET);
  if (smem + 2 * PP * sizeof(float) > vmt::FRONT_MAX_SMEM || C < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  // set unconditionally: the static statistics arrays count against
  // the 48 KB that needs no opt-in
  int err = (int)cudaFuncSetAttribute(
      (const void*)oss_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = tiles_x * ((H + TH - 1) / TH);
  // split the channel tiles across blocks while the spatial tiles alone
  // give fewer than two blocks per SM of the H100 (132 SMs)
  const int e_tiles = (E + ET - 1) / ET;
  const int want = (264 + tiles * B - 1) / (tiles * B);
  const int e_groups = want < e_tiles ? want : e_tiles;
  dim3 grid(tiles, e_groups, B);
  oss_front_kernel<<<grid, NTH, smem, (cudaStream_t)stream>>>(
      x, vmt::DT_F32, xs, z, lnw, lnb, win_t, bin, wdw, bdw, C, E, H, W,
      tiles_x, eps);
  return (int)cudaGetLastError();
}
