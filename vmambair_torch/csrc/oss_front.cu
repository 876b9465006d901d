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
// fp32 (the S1 step with the switch on): `oss_front_f32_kernel`, the same
// skeleton in fp32 with both halves in split TF32 on the tensor cores, as
// K2's fp32 route (mma.cuh): each fp32 operand a = hi + lo (Veltkamp's
// split to TF32's 11 significant bits for the weights, LN(x) cut to TF32
// by masking, the cheaper split; lo = a - hi cut to TF32) and a . b =
// lo.hi + hi.lo + hi.hi by three mma.sync m16n8k8, fp32 accumulators;
// the dropped terms are below 2^-21 of each product, so the route keeps
// fp32 accuracy (a single TF32 pass keeps about 3 digits). K2's fp32 front
// (mma_front.cuh's `ln_front_f32`) stages x's halo by cp.async straight
// into LN(x)'s fp32 rows and normalises them in place. Each channel
// tile's weights (the x- and z-half rows, then the taps and the three
// biases) are packed once a call by a packing kernel into an image
// (`pack_front_f32_weights` its plain version) and arrive by bulk copies
// (TMA) into a two-slot ring, an mbarrier a slot, one thread issuing the
// next while the block computes; the widest class takes W_in's rows in
// k-slices of 128 input channels, its LN(x) alone filling most of the
// shared memory at C = 704. The weights are the A operand and the halo's
// pixels (the x-half) or the tile's own (the z-half, gathered from LN(x)'s
// centre by ldmatrix's row addresses) the B operand; each warp takes a run
// of the B operand's n8 blocks and runs every k-step's lo.hi, hi.lo and
// hi.hi passes each over all of its accumulators, so that no mma waits on
// the one before, in a k-loop compiled once per warp kind (x blocks, z
// blocks, both) so that no branch picks the half per block. The packing
// kernel lets this one launch early (programmatic dependent launch): x's
// halo loads while the images are written. The x-half gets its bias, then
// 0 outside the image; the depthwise 3x3, its bias and SiLU run on the
// CUDA cores in fp32, taps in (dy, dx) order, writing xs straight out (a
// warp on TW contiguous pixels of each of its channels); z goes out
// straight from the fragments (a quad of lanes on a channel's 8
// contiguous pixels), with no staging tile, so that two blocks share an
// SM at C <= 96. Where the spatial tiles give fewer blocks than the card
// holds at once (the occupancy API's count), blockIdx.y splits the
// channel tiles across blocks. Four width classes (Ff0-Ff3): any C <=
// 704, E, H, W.
#include <type_traits>

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
// The fp32 route: both in_conv halves in split TF32 on the tensor cores.
// ---------------------------------------------------------------------------
namespace k5f {

using mfront::ln_front_f32_load;
using mfront::ln_front_f32_norm;
using mfront::Nchw;

constexpr int AUX = k5::AUX;  // per channel: 9 taps, b_dw, b_x, b_z
constexpr int FRONT_MAX_C = 704;  // ops/cuda_effn.py's FRONT_MAX_C

// A width class of the fp32 route: a TH x TW output tile, ET output
// channels per tile (MT m16 blocks of each half), W_in's rows staged in
// k-slices of at most KS input channels, MINB blocks an SM. The B
// operand's n8 blocks: the halo's pixels (NBX; zn has MP = 8 NBX rows),
// then the tile's output pixels (NBZ); each warp takes a run of NPW of
// them (the one that straddles the halves NPW - 1; a warp past the last
// takes none). px [ET][PXP] fp32, PXP = TW
// mod 32 (the conv pass's warp reads 32 distinct banks). Everything else
// in shared memory is fp32 rows of
// KP + 4 or ks + 4 floats, 4 mod 8, so that ldmatrix's eight 16-byte rows
// fall in distinct bank groups (as K2's fp32 route).
template <int TH_, int TW_, int ET_, int KS_, int MINB_>
struct FCls {
  static constexpr int TH = TH_, TW = TW_, ET = ET_, MT = ET / 16;
  static constexpr int KS = KS_, MINB = MINB_;
  static constexpr int NT = mfront::NTH, NW = mfront::NWARP;
  static constexpr int PH = TH + 2, PW = TW + 2, P = PH * PW, Q = TH * TW;
  static constexpr int NBX = (P + 7) / 8, MP = 8 * NBX, NBZ = Q / 8;
  static constexpr int NPW = (NBX + NBZ + NW - 1) / NW;
  // the warp whose run holds blocks of both halves (it splits both weight
  // tiles) takes NPW - 1 of them, the warps after it start one earlier
  static constexpr bool MIX = NBX % NPW != 0;
  static constexpr int WM = NBX / NPW;
  static constexpr int PXP = (MP - TW + 31) / 32 * 32 + TW;
  // the conv pass: ET x TW x RG tasks, each TR rows of one column
  static constexpr int RG = NT / (ET * TW) > 1 ? NT / (ET * TW) : 1;
  static constexpr int TR = TH / RG;
  static_assert(ET % 16 == 0 && TW % 8 == 0 && KS % 16 == 0 &&
                    TH % RG == 0 && NW * NPW - MIX >= NBX + NBZ,
                "");
};

// the width classes; ops/cuda_effn.py's K5F_CLASSES gives the wrapper each
// one's largest C, tile, ET and KS (the widest takes W_in in k-slices of
// 128: its LN(x) alone is 181 KB at C = 704)
using Ff0 = FCls<8, 16, 16, 48, 2>;   // C <= 48
using Ff1 = FCls<8, 16, 16, 96, 2>;   // C <= 96
using Ff2 = FCls<8, 8, 16, 192, 1>;   // C <= 192
using Ff3 = FCls<4, 8, 16, 128, 1>;   // C <= 704

// The slices of W_in's KP = C rounded up to 16 columns: NS of KS, the last
// of KL (KP - (NS - 1) KS). Channel tile t's image (the wrapper's packing,
// `ops/cuda_effn.py::pack_front_f32_weights`): for each slice its 2 ET rows
// (x-half rows t ET .., then z-half rows E + t ET ..) of ks + 4 floats
// (the slice's columns, then 4 zeros), then, after the last slice, each
// channel's 9 taps, b_dw, b_x and b_z (AUX floats); zero past E and C.
// A slice is one bulk copy, the last with the taps and biases.
struct Slices {
  int KP, NS, KL, tile;  // tile: the floats of a tile's image
};

template <class K>
__host__ __device__ inline Slices slices(int C) {
  Slices s;
  s.KP = (C + 15) / 16 * 16;
  s.NS = (s.KP + K::KS - 1) / K::KS;
  s.KL = s.KP - (s.NS - 1) * K::KS;
  s.tile = 2 * K::ET * (s.KP + 4 * s.NS) + K::ET * AUX;
  return s;
}

// Byte offsets in dynamic shared memory: zn [MP][KP + 4] (x's halo, then
// LN(x) in place) from 0, px, then the ring's two slots, each the largest
// slice's rows and the taps and biases.
struct FPlan {
  int px, ring, slot, total;
};

template <class K>
__host__ __device__ inline FPlan fplan(int C) {
  const Slices sl = slices<K>(C);
  const int ks = sl.NS > 1 ? K::KS : sl.KL;
  FPlan p;
  p.px = K::MP * (sl.KP + 4) * 4;
  p.ring = p.px + K::ET * K::PXP * 4;
  p.slot = (2 * K::ET * (ks + 4) + K::ET * AUX) * 4;
  p.total = p.ring + 2 * p.slot;
  return p;
}

// SiLU by the hardware exp2 and a fast divide: a few ulp of fp32 (0 for
// v below -88, where exp(-v) is inf)
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// A block owns a TH x TW output tile of one image and every gridDim.y-th
// channel tile from blockIdx.y on. Per channel tile, the x-half [ET x MP
// halo pixels] and the z-half [ET x Q output pixels] = W . LN(x)^T in
// split TF32 (mma.cuh: a = hi + lo, each k-step of 8 adds lo.hi, hi.lo,
// then hi.hi to the fp32 accumulator; the three passes of a k-step each
// over all of the warp's accumulators, so that no mma waits on the one
// before it), with the weight rows as the A operand, so that each
// accumulator holds a channel's pixels. x, xs, z NCHW fp32; wimg the
// channel tiles' images (Slices).
template <class K>
__global__ void __launch_bounds__(K::NT, K::MINB) oss_front_f32_kernel(
    const float* __restrict__ x, float* __restrict__ xs,
    float* __restrict__ z, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ wimg, int C,
    int E, int H, int W, int tiles_x, float eps) {
  extern __shared__ __align__(16) unsigned char smk[];
  __shared__ __align__(8) uint64_t s_bar[2];  // the ring slots' barriers
  const Slices sl = slices<K>(C);
  const int ZP = sl.KP + 4;
  const FPlan pl = fplan<K>(C);
  float* zn = reinterpret_cast<float*>(smk);
  float* px = reinterpret_cast<float*>(smk + pl.px);

  const int y0 = (blockIdx.x / tiles_x) * K::TH;
  const int x0 = (blockIdx.x % tiles_x) * K::TW;
  const long long HW = (long long)H * W;
  const long long xb = (long long)blockIdx.z * C * HW;
  const long long ob = (long long)blockIdx.z * E * HW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nt = (E + K::ET - 1) / K::ET, t0 = blockIdx.y, dt = gridDim.y;

  // item i of the ring: slice s of channel tile t, into slot i % 2; one
  // thread issues it, after the barrier that ends every read of the slot
  auto stage = [&](int i, int t, int s) {
    const bool last = s == sl.NS - 1;
    const int ks = last ? sl.KL : K::KS;
    const unsigned bytes =
        (2 * K::ET * (ks + 4) + (last ? K::ET * AUX : 0)) * 4;
    mma::mbar_expect_tx(&s_bar[i & 1], bytes);
    mma::bulk_g2s(smk + pl.ring + (i & 1) * pl.slot,
                  wimg + (long long)t * sl.tile + s * 2 * K::ET * (K::KS + 4),
                  bytes, &s_bar[i & 1]);
  };
  // x's halo in flight, then the first slice; the front's second half
  // syncs before any thread waits on a barrier. The images come from the
  // packing kernel just before this one, which lets this grid launch
  // early (programmatic dependent launch): the front overlaps it, and the
  // thread that copies the images waits for it first.
  ln_front_f32_load<K, Nchw<K>>(x, C, H, W, y0, x0, xb, zn);
  if (tid == 0) {
    mma::mbar_init(&s_bar[0], 1);
    mma::mbar_init(&s_bar[1], 1);
    mma::mbar_init_fence();
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    stage(0, t0, 0);
  }
  ln_front_f32_norm<K, Nchw<K>>(lnw, lnb, C, H, W, y0, x0, eps, zn);

  // this warp's n8 blocks: the B operand's rows (lanes 0-15: pixel lane %
  // 8 of the block, k from (lane / 8) % 2 * 4), halo pixels for an x
  // block, for a z block the output pixels at their halo positions; a
  // slot past the warp's run (j >= nj) is skipped
  const int jb0 = warp * K::NPW - (K::MIX && warp > K::WM ? 1 : 0);
  const int nblk = K::NBX + K::NBZ;
  // this warp's blocks jb0 .. jb0 + nj - 1
  const int nj = min(K::MIX && warp == K::WM ? K::NPW - 1 : K::NPW,
                     nblk - jb0);
  const bool active = nj > 0;
  const bool has_x = jb0 < K::NBX, has_z = jb0 + nj > K::NBX;
  const int kofs = ((lane >> 3) & 1) * 4;
  const float* brow[K::NPW];
#pragma unroll
  for (int j = 0; j < K::NPW; ++j) {
    const int blk = min(jb0 + j, nblk - 1);
    int row;
    if (blk < K::NBX) {
      row = blk * 8 + (lane & 7);
    } else {
      const int q = (blk - K::NBX) * 8 + (lane & 7);
      row = (q / K::TW + 1) * K::PW + q % K::TW + 1;
    }
    brow[j] = zn + row * ZP + kofs;
  }
  const bool w2 = W % 2 == 0;

  int it = 0;
  for (int t = t0; t < nt; t += dt) {
    float acc[K::NPW][K::MT][4];
#pragma unroll
    for (int j = 0; j < K::NPW; ++j)
#pragma unroll
      for (int m = 0; m < K::MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.f;
    for (int s = 0; s < sl.NS; ++s, ++it) {
      mma::mbar_wait(&s_bar[it & 1], (it >> 1) & 1);  // the slot's fill
      __syncthreads();  // the slice and zn are in; the last tile's readers
                        // of the other slot, px and the staged tiles are
                        // done
      if (tid == 0) {
        if (s + 1 < sl.NS)
          stage(it + 1, t, s + 1);
        else if (t + dt < nt)
          stage(it + 1, t + dt, 0);
      }
      if (!active) continue;
      const int ks = s == sl.NS - 1 ? sl.KL : K::KS, SP = ks + 4;
      const float* ws =
          reinterpret_cast<const float*>(smk + pl.ring + (it & 1) * pl.slot);
      const float* arow = ws + (lane & 15) * SP + (lane >> 4) * 4;
      const int kz = s * K::KS;
      // the k-loop in three forms, each free of branches per block: a
      // warp of x blocks, of z blocks, or the one that holds both
      // (mode 3: its first nx blocks are x blocks)
      auto kloop = [&](auto mode, auto njc) {
        constexpr int MODE = decltype(mode)::value;
        constexpr int NJ = decltype(njc)::value;
        const int nx = K::NBX - jb0;
#pragma unroll 2
        for (int k0 = 0; k0 < ks; k0 += 8) {
          uint32_t xh[K::MT][4], xl[K::MT][4], zh[K::MT][4], zl[K::MT][4];
#pragma unroll
          for (int m = 0; m < K::MT; ++m) {
            uint32_t a[4];
            if constexpr ((MODE & 1) != 0) {
              mma::ldsm_x4(a, arow + m * 16 * SP + k0);
              mma::split_tf32(a, xh[m], xl[m]);
            }
            if constexpr ((MODE & 2) != 0) {
              mma::ldsm_x4(a, arow + (K::ET + m * 16) * SP + k0);
              mma::split_tf32(a, zh[m], zl[m]);
            }
          }
          uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            uint32_t bb[2];
            mma::ldsm_x2(bb, brow[j] + kz + k0);
            mma::split_tf32_cut(bb[0], bh[j][0], bl[j][0]);
            mma::split_tf32_cut(bb[1], bh[j][1], bl[j][1]);
          }
          // lo.hi, hi.lo, hi.hi: each pass over every accumulator
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const uint32_t b0 = pass == 1 ? bl[j][0] : bh[j][0];
              const uint32_t b1 = pass == 1 ? bl[j][1] : bh[j][1];
              const bool isx = MODE == 1 || (MODE == 3 && j < nx);
#pragma unroll
              for (int m = 0; m < K::MT; ++m) {
                if (isx) {
                  if (pass == 0)
                    mma::mma_tf32(acc[j][m], xl[m], b0, b1);
                  else
                    mma::mma_tf32(acc[j][m], xh[m], b0, b1);
                } else {
                  if (pass == 0)
                    mma::mma_tf32(acc[j][m], zl[m], b0, b1);
                  else
                    mma::mma_tf32(acc[j][m], zh[m], b0, b1);
                }
              }
            }
        }
      };
      using std::integral_constant;
      if (!has_z)
        kloop(integral_constant<int, 1>(), integral_constant<int, K::NPW>());
      else if (!has_x)
        kloop(integral_constant<int, 2>(), integral_constant<int, K::NPW>());
      else
        kloop(integral_constant<int, 3>(),
              integral_constant<int, K::MIX ? K::NPW - 1 : K::NPW>());
    }
    // the tile's taps and biases, after its last slice's rows
    const float* au = reinterpret_cast<const float*>(
                          smk + pl.ring + ((it - 1) & 1) * pl.slot) +
                      2 * K::ET * (sl.KL + 4);
    // px = the x-half + b_x, 0 outside the image; z = SiLU(the z-half +
    // b_z), stored. Accumulator e of block (j, m): channel 16 m + g + 8
    // (e / 2), pixel 8 (block) + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < K::NPW; ++j) {
      const int blk = jb0 + j;
      if (j >= nj) break;
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
                in[0] ? acc[j][m][2 * h] + bias : 0.f,
                in[1] ? acc[j][m][2 * h + 1] + bias : 0.f);
          }
      } else {
        // z straight from the fragments: a channel's 8 pixels of one tile
        // row are the 4 lanes of a quad, 32 contiguous bytes
        const int q = (blk - K::NBX) * 8 + 2 * t4;
        const int gy = y0 + q / K::TW, gx = x0 + q % K::TW;
#pragma unroll
        for (int m = 0; m < K::MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = t * K::ET + 16 * m + g + 8 * h;
            if (e >= E || gy >= H || gx >= W) continue;
            const float bias = au[(16 * m + g + 8 * h) * AUX + 11];
            const float v0 = silu(acc[j][m][2 * h] + bias);
            const float v1 = silu(acc[j][m][2 * h + 1] + bias);
            float* o = z + ob + e * HW + (long long)gy * W + gx;
            if (w2) {  // gx even, W even: an 8-byte store
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              if (gx + 1 < W) o[1] = v1;
            }
          }
      }
    }
    __syncthreads();
    // the depthwise 3x3 (fp32, taps in (dy, dx) order), + b_dw, SiLU,
    // into xs: a thread per (channel j, column qx, row group) slides down
    // its TR rows, each halo row read once; a warp's stores are TW
    // contiguous pixels of 32 / TW channels
    const int e0 = t * K::ET;
    for (int task = tid; task < K::ET * K::TW * K::RG; task += K::NT) {
      const int qx = task % K::TW, rest = task / K::TW;
      const int j = rest % K::ET, r0 = (rest / K::ET) * K::TR;
      if (e0 + j >= E) continue;
      const float* a9 = au + j * AUX;
      float w9[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w9[k] = a9[k];
      float a[K::TR];
#pragma unroll
      for (int r = 0; r < K::TR; ++r) a[r] = 0.f;
#pragma unroll
      for (int rr = 0; rr < K::TR + 2; ++rr) {
        const float* hr = px + j * K::PXP + (r0 + rr) * K::PW + qx;
        const float h3[3] = {hr[0], hr[1], hr[2]};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = rr - dy;
          if (r >= 0 && r < K::TR) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) a[r] += w9[dy * 3 + dx] * h3[dx];
          }
        }
      }
      const float bd = a9[9];
      const int gx = x0 + qx;
      if (gx >= W) continue;
      float* o = xs + ob + (e0 + j) * HW + gx;
#pragma unroll
      for (int r = 0; r < K::TR; ++r) {
        const int gy = y0 + r0 + r;
        if (gy < H) o[(long long)gy * W] = silu(a[r] + bd);
      }
    }
  }
}

template <class K>
static int launch(const float* x, float* xs, float* z, const float* lnw,
                  const float* lnb, const float* wimg, int B, int C, int E,
                  int H, int W, float eps, cudaStream_t stream) {
  const FPlan pl = fplan<K>(C);
  if (pl.total > FRONT_MAX_SMEM || C < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = oss_front_f32_kernel<K>;
  int err = set_smem((const void*)kernel, pl.total);
  if (err) return err;
  const int tiles_x = (W + K::TW - 1) / K::TW;
  const int tiles = tiles_x * ((H + K::TH - 1) / K::TH);
  const int nt = (E + K::ET - 1) / K::ET;
  // where the spatial tiles give fewer blocks than the card holds at once,
  // split the channel tiles into groups of blocks up to that count (the
  // residency from the occupancy API, by C: the same on every H100)
  static int per_sm[FRONT_MAX_C + 1];
  int dev, sms;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)))
    return err;
  if (per_sm[C] == 0 &&
      (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm[C], kernel, K::NT, pl.total)))
    return err;
  const int resident = sms * (per_sm[C] > 0 ? per_sm[C] : 1);
  int groups = resident / (tiles * B);
  if (groups < 1) groups = 1;
  if (groups > nt) groups = nt;
  // launched as the packing kernel's dependent (the kernel waits for it
  // before it reads wimg)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, groups, B);
  cfg.blockDim = dim3(K::NT);
  cfg.dynamicSmemBytes = pl.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, x, xs, z, lnw, lnb, wimg, C, E,
                                H, W, tiles_x, eps);
  if (err) return err;
  return (int)cudaGetLastError();
}

// The channel tiles' images (Slices; ops/cuda_effn.py::
// pack_front_f32_weights, its plain version) from the weights as the model
// holds them, one launch: w_in (2E, C), b_in (2E,), w_dw (E, 9), b_dw (E,),
// img (ceil(E / ET), tile), all fp32. A block row per tile, its threads
// along the image (the writes coalesced, W_in's reads in runs).
template <class K>
__global__ void __launch_bounds__(256) pack_kernel(
    const float* __restrict__ w_in, const float* __restrict__ b_in,
    const float* __restrict__ w_dw, const float* __restrict__ b_dw,
    float* __restrict__ img, int C, int E) {
  // the fp32 kernel after it may launch now: it waits for this grid's
  // writes before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int t = blockIdx.y;
  const Slices sl = slices<K>(C);
  const int full = 2 * K::ET * (K::KS + 4);  // a full slice's floats
  const int rows = 2 * K::ET * (sl.KP + 4 * sl.NS);
  float* o = img + (long long)t * sl.tile;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < sl.tile;
       i += gridDim.x * blockDim.x) {
    float v = 0.f;
    if (i < rows) {
      const int s = min(i / full, sl.NS - 1);
      const int ks = s == sl.NS - 1 ? sl.KL : K::KS;
      const int r0 = i - s * full, row = r0 / (ks + 4);
      const int k = r0 - row * (ks + 4), c = s * K::KS + k;
      const int e = t * K::ET + row % K::ET;
      if (k < ks && c < C && e < E)
        v = w_in[((long long)(row / K::ET) * E + e) * C + c];
    } else {
      const int a = i - rows, ch = a / AUX, f = a - ch * AUX;
      const int e = t * K::ET + ch;
      if (e < E)
        v = f < 9 ? w_dw[e * 9 + f]
                  : f == 9 ? b_dw[e] : b_in[(f == 10 ? 0 : E) + e];
    }
    o[i] = v;
  }
}

template <class K>
static int pack(const float* w_in, const float* b_in, const float* w_dw,
                const float* b_dw, float* img, int C, int E,
                cudaStream_t stream) {
  if (C < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const int n = slices<K>(C).tile, nt = (E + K::ET - 1) / K::ET;
  pack_kernel<K><<<dim3((n + 255) / 256, nt), 256, 0, stream>>>(
      w_in, b_in, w_dw, b_dw, img, C, E);
  return (int)cudaGetLastError();
}

}  // namespace k5f
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

// K5, fp32: x (B, C, H, W), xs and z (B, E, H, W) fp32; lnw, lnb (C,)
// fp32; wimg (ceil(E / ET), tile) fp32, the channel tiles' images that
// vmt_oss_front_f32_pack writes for the fp32 width class cls (its ET, KS:
// ops/cuda_effn.py::K5F_CLASSES).
extern "C" int vmt_oss_front_f32_fwd(const void* x, void* xs, void* z,
                                     const float* lnw, const float* lnb,
                                     const float* wimg, int B, int C, int E,
                                     int H, int W, int cls, float eps,
                                     void* stream) {
  using namespace vmt::k5f;
  const float* xf = static_cast<const float*>(x);
  float* xo = static_cast<float*>(xs);
  float* zo = static_cast<float*>(z);
  cudaStream_t st = (cudaStream_t)stream;
  switch (cls) {
    case 0:
      return launch<Ff0>(xf, xo, zo, lnw, lnb, wimg, B, C, E, H, W, eps, st);
    case 1:
      return launch<Ff1>(xf, xo, zo, lnw, lnb, wimg, B, C, E, H, W, eps, st);
    case 2:
      return launch<Ff2>(xf, xo, zo, lnw, lnb, wimg, B, C, E, H, W, eps, st);
    case 3:
      return launch<Ff3>(xf, xo, zo, lnw, lnb, wimg, B, C, E, H, W, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K5, fp32: the images wimg of vmt_oss_front_f32_fwd from w_in (2E, C),
// b_in (2E,), w_dw (E, 3, 3), b_dw (E,), fp32, for the fp32 class cls.
extern "C" int vmt_oss_front_f32_pack(const float* w_in, const float* b_in,
                                      const float* w_dw, const float* b_dw,
                                      float* wimg, int C, int E, int cls,
                                      void* stream) {
  using namespace vmt::k5f;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cls) {
    case 0:
      return pack<Ff0>(w_in, b_in, w_dw, b_dw, wimg, C, E, st);
    case 1:
      return pack<Ff1>(w_in, b_in, w_dw, b_dw, wimg, C, E, st);
    case 2:
      return pack<Ff2>(w_in, b_in, w_dw, b_dw, wimg, C, E, st);
    case 3:
      return pack<Ff3>(w_in, b_in, w_dw, b_dw, wimg, C, E, st);
  }
  return (int)cudaErrorInvalidValue;
}
