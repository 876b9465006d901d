// K2: the fused GDFN residual branch of a MamberBlock, forward.
//
// Replaces vmambair_tpu/ops/pallas_effn.py::_gdfn_kernel (built by
// _gdfn_pallas). Computes, per pixel,
//   y = x + W_out . (gelu_erf(x1) * x2),  [x1 | x2] = dwconv3x3(W_in . LN(x))
// with LN over the channels (fp32 statistics), zero padding of the hidden
// map at the image border, and one read of x and one write of y. As on the
// TPU (pallas_effn.py:139-155), LN(x), the weights and the gate are rounded
// to the activation dtype before their matrix products, each product sums
// in fp32, and the hidden map stays fp32.
//
// What bounds it on the H100: operations. Per pixel the two 1x1
// projections are 3 * hid * C multiply-adds (hid = int(2.66 C)) and the
// depthwise conv, the gate and the LayerNorm some 2 * hid * 18 + hid * 20
// fp32 operations; the bytes are only x and y.
//
// Two routes, by the activation dtype:
//
// bf16 (the served forward): `gdfn_mma_kernel`. A block of 8 warps owns a
// TH x TW output tile of one image (8 x 16 at C <= 96, two blocks an SM;
// 8 x 8 at C <= 192; 4 x 8 at C <= 384: the width class, a template
// argument, so that the wide levels still give the card a wave of blocks
// and the out-projection's accumulators fit in registers). x's halo
// ((TH+2) x (TW+2)) and LN's weights arrive by cp.async, all in flight at
// once (NCHW rows of an even W as 4-byte words). LN(x) goes to shared
// memory as bf16, pixel-major with the channels contiguous, its statistics
// taken by every warp (8 pixels x 4 channel groups a warp, shuffles across
// the groups). The block then walks the hidden channels in tiles of HT:
// the W_in rows, W_out columns and depthwise taps of the next hidden tile
// are staged by cp.async into the other slot of a two-slot ring while
// this tile computes (the wrapper packs them per tile,
// `ops/cuda_effn.py::pack_gdfn_weights`); the in-projection
// [halo pixels x C] . [C x 2 HT] runs on the tensor cores (ldmatrix +
// mma.sync m16n8k16, bf16 -> fp32) into an fp32 hidden tile in shared
// memory; the depthwise 3x3 and the exact-erf gate run on the CUDA cores
// in fp32, a thread per (hidden channel, column) sliding down the tile's
// rows, and write the gate as bf16; the out-projection [TH*TW x HT] .
// [HT x C] runs on the tensor cores into fp32 register accumulators that
// persist across the hidden tiles. At the end the residual x tile comes
// in by cp.async while the output tile goes to shared memory, so that the
// stores stay coalesced. The larger tile recomputes less of the halo's
// in-projection (1.41x at 8 x 16, against 1.875x at 4 x 8). Hidden
// channels past hid are zero in the packed weights:
// gelu(0) * 0 = 0, as the TPU's lane padding (pallas_effn.py:163-177). Any
// C <= 384, H, W. What holds it above the bound is the CUDA-core part
// (the depthwise conv and the gate), the re-read of every hidden tile's
// weights by each block, and the latency of its phases, which only the
// second block of an SM hides (PERF.md).
//
// fp32 (the S1 step): `gdfn_f32_kernel`, the same skeleton in fp32 (its
// own width classes Fc0-Fc3: 8 x 16 tiles at C <= 96, 8 x 8 at C <= 192,
// 4 x 8 above), with both projections in split TF32 on the tensor cores:
// each fp32 operand a = hi + lo, hi = a rounded to 11 significant bits
// (TF32) by Veltkamp's split in fp32 adds, lo = a - hi cut to TF32, and
// a . b = lo.hi + hi.lo + hi.hi by three mma.sync m16n8k8 into fp32
// accumulators (mma.cuh). The dropped lo.lo and lo's cut are below 2^-21
// of each product, so the route keeps fp32 accuracy (one TF32 pass keeps
// about 3 decimal digits, which the fp32 reference, with TF32 off, does
// not); the conversion instruction (cvt.rna.tf32) issues at a fraction of
// the fp32 rate and held a first version back. x's halo arrives by
// cp.async straight into LN(x)'s fp32 rows, normalised in place; LN(x),
// the hidden tile and the gate stay fp32 in shared memory, split into hi
// / lo as their fragments are loaded. Each hidden tile's weights arrive by
// one bulk copy (TMA) of the slot's image, which the wrapper packs, into a
// two-slot ring, one thread issuing it while the tile before computes, an
// mbarrier per slot telling the rest. Where the tiles give the card less
// than a wave of blocks (the step's 32 x 32, 16 x 16 and 8 x 8 levels),
// the wrapper launches a cluster of `split` blocks per tile
// (cuda_effn.k2f_split), each taking every split-th hidden tile, and the
// members sum their partial output tiles through distributed shared
// memory in rank order: one launch, no atomics, the same bits every call.
// What is left on the CUDA cores is the depthwise conv, the gate,
// LayerNorm and the splits.
//
// The same kernels, with a tanh gate and channels-last images, are keffn's
// (vmt_gdfn_tanh_nhwc_fwd, below): the gate and the layout are template
// policies, so K2's instantiations are the code above unchanged.
#include "mma_front.cuh"

namespace vmt {

// Gate policies: K2's exact erf GELU; keffn's tanh GELU (jax.nn.gelu with
// approximate=True), by tanhf: tanh.approx.f32's error would show in the
// fp32 parity check.
struct GeluErf {
  __device__ static __forceinline__ float f(float v) {
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  }
};

struct GeluTanh {
  __device__ static __forceinline__ float f(float v) {
    return v * (0.5f * (1.f + tanhf(0.79788456080286536f *
                                    (v + 0.044715f * (v * v * v)))));
  }
};

// ---------------------------------------------------------------------------
// The bf16 route: both projections on the tensor cores.
// ---------------------------------------------------------------------------
namespace k2 {

// the thread count, the layout policies and the LayerNorm front
// (mma_front.cuh)
using namespace mfront;

// A width class. TH x TW: the output tile; HT: hidden channels per tile;
// the in-projection's warps: WM along the halo pixels, NWARP / WM along
// the 2 HT hidden columns; the out-projection's: WMO along the tile's
// pixels, NWARP / WMO along the channels, NI n8 blocks each; MINB: blocks
// per SM the registers are held to.
template <int TH_, int TW_, int HT_, int WM_, int WMO_, int NI_, int MINB_>
struct Cls {
  static constexpr int TH = TH_, TW = TW_, HT = HT_, MINB = MINB_;
  static constexpr int PH = TH + 2, PW = TW + 2, P = PH * PW, Q = TH * TW;
  static constexpr int WM = WM_, WN = NWARP / WM;
  static constexpr int MI = ((P + 15) / 16 + WM - 1) / WM;  // m16 per warp
  static constexpr int MP = 16 * WM * MI;  // halo rows, padded with zeros
  static constexpr int NJ = 2 * HT / (8 * WN);  // n8 per warp (even)
  static constexpr int WMO = WMO_, WNO = NWARP / WMO;
  static constexpr int MIO = Q / (16 * WMO);
  static constexpr int NI = NI_;
  static constexpr int CP = 8 * NI * WNO;  // the largest C it takes
  static constexpr int HP = 2 * HT + 8;    // hidden tile pitch (floats)
  static constexpr int GP = HT + 8;        // gate / W_out pitch (bf16)
  // x's halo staged per channel in rows of RW elements (halo column col
  // at col + 1: the 4-byte words from x0 - 2 to x0 + TW + 1), XS apart
  static constexpr int RW = TW + 4;
  static constexpr int XS = (PH * RW + 47) / 64 * 64 + 16;
  __device__ static __forceinline__ int xi(int p) {
    return (p / PW) * RW + p % PW + 1;
  }
  // the gate pass: HT x TW x RG tasks, each TR rows of one column
  static constexpr int RG = NTH / (HT * TW) > 1 ? NTH / (HT * TW) : 1;
  static constexpr int TR = TH / RG;
  static_assert(NJ % 2 == 0 && MIO * 16 * WMO == Q && TH % RG == 0, "");
};

// the width classes; ops/cuda_effn.py's K2_CLASSES gives the wrapper each
// one's largest C, tile and HT
using Cls0 = Cls<8, 16, 32, 4, 4, 3, 2>;   // C <= 48
using Cls1 = Cls<8, 16, 16, 4, 4, 6, 2>;   // C <= 96
using Cls2 = Cls<8, 8, 32, 4, 4, 12, 1>;   // C <= 192
using Cls3 = Cls<4, 8, 16, 4, 2, 12, 1>;   // C <= 384

// Byte offsets in dynamic shared memory for C channels (KP: C rounded up
// to 16; ZP = KP + 8 its pitch, so that ldmatrix's eight rows fall in
// eight distinct 16-byte bank groups). zn [MP][ZP] bf16, then the region
// u: first x's halo [C][XS] (raw bf16), then the fp32 hidden tile
// [P][HP] and the gate [Q][GP] bf16; the output tile overlays zn and u at
// the end. Then the two ring slots: W_in rows [2 HT][ZP], W_out [CP][GP]
// bf16 and the depthwise taps [2 HT][9] fp32 (at the end the residual
// x tile [C][Q] bf16 lies over them); then LN's weight and bias [2][KP]
// fp32.
struct Plan {
  int u, gate, ring, slot, wout, wdw, ln, total;
};

template <class K>
__host__ __device__ inline Plan plan(int C) {
  const int KP = (C + 15) / 16 * 16, ZP = KP + 8;
  Plan p;
  const int zn = K::MP * ZP * 2;
  int u = K::P * K::HP * 4 + K::Q * K::GP * 2;
  if (C * K::XS * 2 > u) u = C * K::XS * 2;
  const int o1 = K::CP * (K::Q + 4), o2 = K::Q * ((K::CP + 31) / 32 * 32 + 8);
  const int out = 4 * (o1 > o2 ? o1 : o2);
  if (zn + u < out) u = out - zn;
  p.u = zn;
  p.gate = zn + K::P * K::HP * 4;
  p.ring = zn + u;
  p.wout = 2 * K::HT * ZP * 2;
  p.wdw = p.wout + K::CP * K::GP * 2;
  p.slot = p.wdw + 2 * K::HT * 9 * 4;
  // the residual tile [CP][Q] bf16 lies over the ring at the end
  p.ln = p.ring + (2 * p.slot > K::CP * K::Q * 2 ? 2 * p.slot
                                                  : K::CP * K::Q * 2);
  p.total = p.ln + 2 * KP * 4;
  return p;
}

// cp.async hidden tile t's packed weights into ring slot s (16-byte
// chunks; the packed rows are KP and HT bf16 long, the taps 18 HT fp32).
template <class K>
__device__ __forceinline__ void stage_weights(
    unsigned char* slot, const __nv_bfloat16* __restrict__ win_p,
    const __nv_bfloat16* __restrict__ wout_p,
    const float* __restrict__ wdw_p, const Plan& pl, int KP, int t) {
  const int tid = threadIdx.x, ZP = KP + 8;
  const int kc = KP / 8;
  const __nv_bfloat16* gw = win_p + (long long)t * 2 * K::HT * KP;
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(slot);
  for (int i = tid; i < 2 * K::HT * kc; i += NTH) {
    const int r = i / kc, c = i - r * kc;
    mma::cp_async16(sw + r * ZP + c * 8, gw + r * KP + c * 8);
  }
  constexpr int hc = K::HT / 8;
  const __nv_bfloat16* go = wout_p + (long long)t * K::CP * K::HT;
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(slot + pl.wout);
  for (int i = tid; i < K::CP * hc; i += NTH) {
    const int n = i / hc, c = i - n * hc;
    mma::cp_async16(so + n * K::GP + c * 8, go + n * K::HT + c * 8);
  }
  const float* gd = wdw_p + (long long)t * 2 * K::HT * 9;
  float* sd = reinterpret_cast<float*>(slot + pl.wdw);
  for (int i = tid; i < 2 * K::HT * 9 / 4; i += NTH) {
    mma::cp_async16(sd + 4 * i, gd + 4 * i);
  }
  mma::cp_async_commit();
}

template <class K, class Lay, class Gelu>
__global__ void __launch_bounds__(NTH, K::MINB) gdfn_mma_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const __nv_bfloat16* __restrict__ win_p,
    const __nv_bfloat16* __restrict__ wout_p,
    const float* __restrict__ wdw_p, int C, int H, int W, int hp,
    float eps) {
  extern __shared__ __align__(16) unsigned char smk[];
  __shared__ float s_mu[K::P], s_rs[K::P];
  const int KP = (C + 15) / 16 * 16, ZP = KP + 8;
  const Plan pl = plan<K>(C);
  __nv_bfloat16* zn = reinterpret_cast<__nv_bfloat16*>(smk);
  unsigned short* xs = reinterpret_cast<unsigned short*>(smk + pl.u);
  float* hs = reinterpret_cast<float*>(smk + pl.u);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smk + pl.gate);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * K::TH, x0 = blockIdx.x * K::TW;
  const long long xb = (long long)b * C * H * W;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nt = hp / K::HT;

  // the first hidden tile's weights, while x's halo loads
  stage_weights<K>(smk + pl.ring, win_p, wout_p, wdw_p, pl, KP, 0);

  // 1-3. x's halo and LN's weights by cp.async, the statistics, zn [MP][ZP]
  // = round(LN(x)) (mma_front.cuh)
  const unsigned short* xr = reinterpret_cast<const unsigned short*>(x);
  ln_front<K, Lay>(x, lnw, lnb, C, H, W, y0, x0, xb, eps, xs,
                   reinterpret_cast<float*>(smk + pl.ln), s_mu, s_rs, zn);

  // the out-projection's accumulators: this warp's MIO x NI blocks of
  // [Q x CP], over every hidden tile
  const int wmo = warp % K::WMO, wno = warp / K::WMO;
  float acc[K::MIO][K::NI][4];
#pragma unroll
  for (int i = 0; i < K::MIO; ++i)
#pragma unroll
    for (int n = 0; n < K::NI; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  const int wm = warp % K::WM, wn = warp / K::WM;
  for (int t = 0; t < nt; ++t) {
    mma::cp_async_wait_all();
    __syncthreads();  // tile t's weights and zn are in; the previous
                      // tile's readers of the other slot and of gs are done
    if (t + 1 < nt)
      stage_weights<K>(smk + pl.ring + ((t + 1) & 1) * pl.slot, win_p,
                       wout_p, wdw_p, pl, KP, t + 1);
    const unsigned char* slot = smk + pl.ring + (t & 1) * pl.slot;
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(slot);
    const __nv_bfloat16* wo =
        reinterpret_cast<const __nv_bfloat16*>(slot + pl.wout);
    const float* wd = reinterpret_cast<const float*>(slot + pl.wdw);

    // 4. in-projection: hidden [MP x 2 HT] = zn . W_in^T, fp32, rows
    // below P kept in hs
    {
      float h[K::MI][K::NJ][4];
#pragma unroll
      for (int i = 0; i < K::MI; ++i)
#pragma unroll
        for (int n = 0; n < K::NJ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) h[i][n][e] = 0.f;
      const __nv_bfloat16* arow =
          zn + (16 * wm * K::MI + (lane & 15)) * ZP + (lane >> 4) * 8;
      const __nv_bfloat16* brow =
          ws + (8 * wn * K::NJ + (lane & 7) + ((lane >> 4) << 3)) * ZP +
          ((lane >> 3) & 1) * 8;
      for (int k0 = 0; k0 < KP; k0 += 16) {
        uint32_t a[K::MI][4];
#pragma unroll
        for (int i = 0; i < K::MI; ++i)
          mma::ldsm_x4(a[i], arow + i * 16 * ZP + k0);
#pragma unroll
        for (int n2 = 0; n2 < K::NJ / 2; ++n2) {
          uint32_t bb[4];
          mma::ldsm_x4(bb, brow + n2 * 16 * ZP + k0);
#pragma unroll
          for (int i = 0; i < K::MI; ++i) {
            mma::mma_bf16(h[i][2 * n2], a[i], bb[0], bb[1]);
            mma::mma_bf16(h[i][2 * n2 + 1], a[i], bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < K::MI; ++i) {
        const int r0 = 16 * (wm * K::MI + i) + g;
#pragma unroll
        for (int n = 0; n < K::NJ; ++n) {
          const int col = 8 * (wn * K::NJ + n) + 2 * t4;
          if (r0 < K::P)
            *reinterpret_cast<float2*>(hs + r0 * K::HP + col) =
                make_float2(h[i][n][0], h[i][n][1]);
          if (r0 + 8 < K::P)
            *reinterpret_cast<float2*>(hs + (r0 + 8) * K::HP + col) =
                make_float2(h[i][n][2], h[i][n][3]);
        }
      }
    }
    __syncthreads();
    // 5. depthwise 3x3 (fp32, taps in (dy, dx) order) and the gate, a
    // thread per (hidden channel j, column qx, row group): it slides down
    // its TR rows, each halo row read once
    for (int task = tid; task < K::HT * K::TW * K::RG; task += NTH) {
      const int j = task % K::HT, rest = task / K::HT;
      const int qx = rest % K::TW, r0 = (rest / K::TW) * K::TR;
      float w1[9], w2[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        w1[i] = wd[j * 9 + i];
        w2[i] = wd[(K::HT + j) * 9 + i];
      }
      float a1[K::TR], a2[K::TR];
#pragma unroll
      for (int r = 0; r < K::TR; ++r) a1[r] = a2[r] = 0.f;
#pragma unroll
      for (int rr = 0; rr < K::TR + 2; ++rr) {
        const float* hr = hs + ((r0 + rr) * K::PW + qx) * K::HP + j;
        const float h1[3] = {hr[0], hr[K::HP], hr[2 * K::HP]};
        const float h2[3] = {hr[K::HT], hr[K::HP + K::HT],
                             hr[2 * K::HP + K::HT]};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = rr - dy;
          if (r >= 0 && r < K::TR) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              a1[r] += w1[dy * 3 + dx] * h1[dx];
              a2[r] += w2[dy * 3 + dx] * h2[dx];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < K::TR; ++r)
        gs[((r0 + r) * K::TW + qx) * K::GP + j] =
            __float2bfloat16(Gelu::f(a1[r]) * a2[r]);
    }
    __syncthreads();
    // 6. out-projection: acc [Q x CP] += gate . W_out^T
#pragma unroll
    for (int k0 = 0; k0 < K::HT; k0 += 16) {
      uint32_t a[K::MIO][4];
#pragma unroll
      for (int i = 0; i < K::MIO; ++i)
        mma::ldsm_x4(a[i], gs + (16 * (wmo * K::MIO + i) + (lane & 15)) *
                                    K::GP + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < K::NI; ++n) {
        uint32_t bb[2];
        mma::ldsm_x2(bb, wo + (8 * (wno * K::NI + n) + (lane & 7)) * K::GP +
                             k0 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < K::MIO; ++i)
          mma::mma_bf16(acc[i][n], a[i], bb[0], bb[1]);
      }
    }
  }
  __syncthreads();  // every reader of zn, hs, gs and the ring is done
  // 7. the residual x over the output tile -> xres [C][Q] (over the ring)
  // by cp.async where its rows are 4-byte words (NCHW, W even), while the
  // output tile goes to shared memory; then y = x + out, coalesced
  const bool words = Lay::kRows && W % 2 == 0;
  unsigned short* xres = reinterpret_cast<unsigned short*>(smk + pl.ring);
  if (words) {
    constexpr int RW2 = K::TW / 2, QW = K::Q / 2;
    for (int i = tid; i < C * QW; i += NTH) {
      const int c = i / QW, qw = i - c * QW;
      const int gy = y0 + qw / RW2, gx = x0 + 2 * (qw % RW2);
      const bool in = gy < H && gx < W;
      mma::cp_async4(xres + c * K::Q + 2 * qw,
                     in ? xr + xb + Lay::at(c, gy, gx, C, H, W) : xr, in);
    }
    mma::cp_async_commit();
  }
  float* os = reinterpret_cast<float*>(smk);
#pragma unroll
  for (int i = 0; i < K::MIO; ++i) {
    const int q = 16 * (wmo * K::MIO + i) + g;
#pragma unroll
    for (int n = 0; n < K::NI; ++n) {
      const int c = 8 * (wno * K::NI + n) + 2 * t4;
      os[Lay::oix(c, q)] = acc[i][n][0];
      os[Lay::oix(c + 1, q)] = acc[i][n][1];
      os[Lay::oix(c, q + 8)] = acc[i][n][2];
      os[Lay::oix(c + 1, q + 8)] = acc[i][n][3];
    }
  }
  mma::cp_async_wait_all();
  __syncthreads();
  const int n = C * K::Q;
  for (int i0 = tid; i0 < n; i0 += LB * NTH) {
    unsigned short v[LB];
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const int i = i0 + j * NTH;
      int c, q;
      Lay::out(i, C, c, q);
      const int gy = y0 + q / K::TW, gx = x0 + q % K::TW;
      v[j] = 0;
      if (i < n && gy < H && gx < W)
        v[j] = words ? xres[c * K::Q + q]
                     : xr[xb + Lay::at(c, gy, gx, C, H, W)];
    }
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const int i = i0 + j * NTH;
      int c, q;
      Lay::out(i, C, c, q);
      const int gy = y0 + q / K::TW, gx = x0 + q % K::TW;
      if (i < n && gy < H && gx < W)
        y[xb + Lay::at(c, gy, gx, C, H, W)] =
            __float2bfloat16(bf16_bits(v[j]) + os[Lay::oix(c, q)]);
    }
  }
}

template <class K, template <class> class Lay, class Gelu>
static int launch(const void* x, void* y, const float* lnw, const float* lnb,
                  const void* win_p, const void* wout_p, const float* wdw_p,
                  int B, int C, int H, int W, int hp, float eps,
                  cudaStream_t stream) {
  if (C > K::CP || hp % K::HT) return (int)cudaErrorInvalidValue;
  const size_t smem = plan<K>(C).total;
  int err = set_smem((const void*)gdfn_mma_kernel<K, Lay<K>, Gelu>, smem);
  if (err) return err;
  dim3 grid((W + K::TW - 1) / K::TW, (H + K::TH - 1) / K::TH, B);
  gdfn_mma_kernel<K, Lay<K>, Gelu><<<grid, NTH, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      lnw, lnb, static_cast<const __nv_bfloat16*>(win_p),
      static_cast<const __nv_bfloat16*>(wout_p), wdw_p, C, H, W, hp, eps);
  return (int)cudaGetLastError();
}

template <template <class> class Lay, class Gelu>
static int gdfn_fwd(const void* x, void* y, const float* lnw,
                    const float* lnb, const void* win_p, const void* wout_p,
                    const float* wdw_p, int B, int C, int H, int W, int hp,
                    int cls, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (cls) {
    case 0:
      return launch<Cls0, Lay, Gelu>(x, y, lnw, lnb, win_p, wout_p, wdw_p, B,
                                     C, H, W, hp, eps, st);
    case 1:
      return launch<Cls1, Lay, Gelu>(x, y, lnw, lnb, win_p, wout_p, wdw_p, B,
                                     C, H, W, hp, eps, st);
    case 2:
      return launch<Cls2, Lay, Gelu>(x, y, lnw, lnb, win_p, wout_p, wdw_p, B,
                                     C, H, W, hp, eps, st);
    case 3:
      return launch<Cls3, Lay, Gelu>(x, y, lnw, lnb, win_p, wout_p, wdw_p, B,
                                     C, H, W, hp, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace k2

// ---------------------------------------------------------------------------
// The fp32 route: both projections in split TF32 on the tensor cores.
// ---------------------------------------------------------------------------
namespace k2f {

using mfront::Nchw;  // the layout policies
using mfront::Nhwc;
using mfront::ln_front_f32;  // the fp32 front, K5's fp32 route's too

using mma::cluster_sync;  // the cluster barrier, its shared reads
using mma::ld_cluster;

// A width class of the fp32 route, as k2::Cls: TH x TW the output tile, HT
// hidden channels per tile, the in-projection's warps WM along the halo
// pixels, WK along the k-steps and the rest along the 2 HT hidden columns
// (NJ n8 blocks each, one or an even number), the out-projection's WMO
// along the tile's pixels and NW / WMO along the channels (NI n8 blocks
// each), MINB blocks per SM. Everything in shared memory is fp32, rows
// padded to 4 mod 8 floats so that ldmatrix's eight 16-byte rows fall in
// distinct bank groups.
template <int TH_, int TW_, int HT_, int WM_, int WMO_, int NI_, int MINB_,
          int WK_ = 1>
struct FCls {
  static constexpr int TH = TH_, TW = TW_, HT = HT_, MINB = MINB_;
  static constexpr int NW = mfront::NWARP, NT = mfront::NTH;
  static constexpr int PH = TH + 2, PW = TW + 2, P = PH * PW, Q = TH * TW;
  // the in-projection's warps also split the k-steps WK ways (every WK-th
  // from their own), their partial tiles summed in order in hs
  static constexpr int WK = WK_;
  static constexpr int WM = WM_, WN = NW / (WM * WK);
  static constexpr int MI = ((P + 15) / 16 + WM - 1) / WM;  // m16 per warp
  static constexpr int MP = 16 * WM * MI;  // halo rows, padded with zeros
  static constexpr int NJ = 2 * HT / (8 * WN);  // n8 per warp
  static constexpr int WMO = WMO_, WNO = NW / WMO;
  static constexpr int MIO = Q / (16 * WMO);
  static constexpr int NI = NI_;
  static constexpr int CP = 8 * NI * WNO;  // the largest C it takes
  static constexpr int HP = 2 * HT + 8;    // hidden tile pitch (floats)
  static constexpr int GP = HT + 4;        // gate / W_out pitch (floats)
  // the gate pass: HT x TW x RG tasks, each TR rows of one column
  static constexpr int RG = NT / (HT * TW) > 1 ? NT / (HT * TW) : 1;
  static constexpr int TR = TH / RG;
  static_assert(NJ * 8 * WN == 2 * HT && (NJ == 1 || NJ % 2 == 0) &&
                    WM * WN * WK == NW && MIO * 16 * WMO == Q &&
                    TH % RG == 0 && HT % 8 == 0,
                "");
};

// the width classes; ops/cuda_effn.py's K2F_CLASSES gives the wrapper each
// one's largest C, tile, HT, MINB and WK (Fc3's 48 k-steps split 8 ways:
// each warp takes the whole 64 x 16 hidden tile over 6 of them, reusing
// each fragment it splits 2 and 4 times)
using Fc0 = FCls<8, 16, 16, 4, 4, 3, 2>;   // C <= 48
using Fc1 = FCls<8, 16, 16, 4, 4, 6, 1>;   // C <= 96
using Fc2 = FCls<8, 8, 16, 4, 4, 12, 1>;   // C <= 192
using Fc3 = FCls<4, 8, 8, 1, 2, 12, 1, 8>;  // C <= 384

// Byte offsets in dynamic shared memory for C channels (KP: C rounded up
// to 16, ZP = KP + 4 its pitch): zn [MP][ZP] (x's halo, then LN(x) in
// place), the hidden tile hs [P][HP] and the gate gs [Q][GP]; the partial
// output tile overlays them at the end. Then the two ring slots, each a
// hidden tile's weights: W_in rows [2 HT][ZP], W_out [CP][GP] and the
// depthwise taps [2 HT][9] (a multiple of 16 bytes: HT is one of 8).
struct FPlan {
  int hs, gs, ring, slot, wout, wdw, ks, total;
};

template <class K>
__host__ __device__ inline FPlan fplan(int C) {
  const int KP = (C + 15) / 16 * 16, ZP = KP + 4;
  FPlan p;
  const int zn = K::MP * ZP * 4;
  int u = K::P * K::HP * 4 + K::Q * K::GP * 4;
  const int o1 = K::CP * (K::Q + 4), o2 = K::Q * ((K::CP + 31) / 32 * 32 + 8);
  const int out = 4 * (o1 > o2 ? o1 : o2);
  if (zn + u < out) u = out - zn;
  p.hs = zn;
  p.gs = zn + K::P * K::HP * 4;
  p.ring = zn + u;
  p.wout = 2 * K::HT * ZP * 4;
  p.wdw = p.wout + K::CP * K::GP * 4;
  p.slot = p.wdw + 2 * K::HT * 9 * 4;
  p.ks = p.ring + 2 * p.slot;
  p.total = p.ks + (K::WK - 1) * K::P * 2 * K::HT * 4;
  return p;
}

// Hidden tile t's weights into a ring slot by one bulk copy (the wrapper
// packs each tile as the slot's image: cuda_effn.pack_gdfn_f32_weights),
// completing on bar. One thread calls it, after the barrier that ends
// every read of the slot's previous tile.
__device__ __forceinline__ void stage_tile(unsigned char* slot,
                                           const float* __restrict__ wimg,
                                           int bytes, int t, uint64_t* bar) {
  mma::mbar_expect_tx(bar, (unsigned)bytes);
  mma::bulk_g2s(slot, wimg + (long long)t * (bytes / 4), (unsigned)bytes,
                bar);
}

// A block owns a TH x TW output tile of one image and, in a cluster of
// `split` blocks, every split-th hidden tile from its rank on; the cluster's
// members sum their partial output tiles through distributed shared memory
// in rank order at the end. x, y as Lay says; wimg the hidden tiles'
// weights, each the image of a ring slot (pack_gdfn_f32_weights).
template <class K, class Lay, class Gelu>
__global__ void __launch_bounds__(K::NT, K::MINB) gdfn_f32_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const float* __restrict__ wimg, int C, int H, int W, int hp, int split,
    float eps) {
  extern __shared__ __align__(16) unsigned char smk[];
  __shared__ __align__(8) uint64_t s_bar[2];  // the ring slots' barriers
  const int KP = (C + 15) / 16 * 16, ZP = KP + 4;
  const FPlan pl = fplan<K>(C);
  float* zn = reinterpret_cast<float*>(smk);
  float* hs = reinterpret_cast<float*>(smk + pl.hs);
  float* gs = reinterpret_cast<float*>(smk + pl.gs);
  float* ks = reinterpret_cast<float*>(smk + pl.ks);

  const int rank = blockIdx.x % split;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * K::TH, x0 = (blockIdx.x / split) * K::TW;
  const long long xb = (long long)b * C * H * W;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nt = hp / K::HT;

  // the first hidden tile's weights, while x's halo loads (ln_front_f32
  // syncs before any thread waits on a barrier)
  if (tid == 0) {
    mma::mbar_init(&s_bar[0], 1);
    mma::mbar_init(&s_bar[1], 1);
    mma::mbar_init_fence();
    stage_tile(smk + pl.ring, wimg, pl.slot, rank, &s_bar[0]);
  }
  ln_front_f32<K, Lay>(x, lnw, lnb, C, H, W, y0, x0, xb, eps, zn);

  // the out-projection's accumulators: this warp's MIO x NI blocks of
  // [Q x CP], over this block's hidden tiles
  const int wmo = warp % K::WMO, wno = warp / K::WMO;
  float acc[K::MIO][K::NI][4];
#pragma unroll
  for (int i = 0; i < K::MIO; ++i)
#pragma unroll
    for (int n = 0; n < K::NI; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  const int wm = warp % K::WM, wn = (warp / K::WM) % K::WN;
  const int wk = warp / (K::WM * K::WN);
  int it = 0;
  for (int t = rank; t < nt; t += split, ++it) {
    const int s = it & 1;
    mma::mbar_wait(&s_bar[s], (it >> 1) & 1);  // the slot's it/2-th fill
    __syncthreads();  // tile t's weights and zn are in; the previous
                      // tile's readers of the other slot and of gs are done
    if (tid == 0 && t + split < nt)
      stage_tile(smk + pl.ring + (s ^ 1) * pl.slot, wimg, pl.slot,
                 t + split, &s_bar[s ^ 1]);
    const unsigned char* slot = smk + pl.ring + s * pl.slot;
    const float* ws = reinterpret_cast<const float*>(slot);
    const float* wo = reinterpret_cast<const float*>(slot + pl.wout);
    const float* wd = reinterpret_cast<const float*>(slot + pl.wdw);

    // 4. in-projection: hidden [MP x 2 HT] = zn . W_in^T in split TF32
    // (hi.hi in h, the small terms in hl), rows below P kept in hs
    {
      float h[K::MI][K::NJ][4], hl[K::MI][K::NJ][4];
#pragma unroll
      for (int i = 0; i < K::MI; ++i)
#pragma unroll
        for (int n = 0; n < K::NJ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) h[i][n][e] = hl[i][n][e] = 0.f;
      const float* arow =
          zn + (16 * wm * K::MI + (lane & 15)) * ZP + (lane >> 4) * 4;
      const float* brow =
          ws + (8 * wn * K::NJ + (lane & 7) + ((lane >> 4) << 3)) * ZP +
          ((lane >> 3) & 1) * 4;
#pragma unroll 2
      for (int k0 = 8 * wk; k0 < KP; k0 += 8 * K::WK) {
        uint32_t ah[K::MI][4], al[K::MI][4];
#pragma unroll
        for (int i = 0; i < K::MI; ++i) {
          uint32_t a[4];
          mma::ldsm_x4(a, arow + i * 16 * ZP + k0);
          mma::split_tf32(a, ah[i], al[i]);
        }
        if constexpr (K::NJ == 1) {
          uint32_t bb[2], bh[2], bl[2];
          mma::ldsm_x2(bb, ws + (8 * wn + (lane & 7)) * ZP +
                               ((lane >> 3) & 1) * 4 + k0);
          mma::split_tf32(bb, bh, bl);
#pragma unroll
          for (int i = 0; i < K::MI; ++i)
            mma::mma_3xtf32(h[i][0], hl[i][0], ah[i], al[i], bh[0], bh[1],
                            bl[0], bl[1]);
        } else {
#pragma unroll
          for (int n2 = 0; n2 < K::NJ / 2; ++n2) {
            uint32_t bb[4], bh[4], bl[4];
            mma::ldsm_x4(bb, brow + n2 * 16 * ZP + k0);
            mma::split_tf32(bb, bh, bl);
#pragma unroll
            for (int i = 0; i < K::MI; ++i) {
              mma::mma_3xtf32(h[i][2 * n2], hl[i][2 * n2], ah[i], al[i],
                              bh[0], bh[1], bl[0], bl[1]);
              mma::mma_3xtf32(h[i][2 * n2 + 1], hl[i][2 * n2 + 1], ah[i],
                              al[i], bh[2], bh[3], bl[2], bl[3]);
            }
          }
        }
      }
      // k-group 0 into hs, the others into ks (pitch 2 HT)
      float* dst = wk == 0 ? hs : ks + (wk - 1) * K::P * 2 * K::HT;
      const int pitch = wk == 0 ? K::HP : 2 * K::HT;
#pragma unroll
      for (int i = 0; i < K::MI; ++i) {
        const int r0 = 16 * (wm * K::MI + i) + g;
#pragma unroll
        for (int n = 0; n < K::NJ; ++n) {
          const int col = 8 * (wn * K::NJ + n) + 2 * t4;
          if (r0 < K::P)
            *reinterpret_cast<float2*>(dst + r0 * pitch + col) =
                make_float2(h[i][n][0] + hl[i][n][0],
                            h[i][n][1] + hl[i][n][1]);
          if (r0 + 8 < K::P)
            *reinterpret_cast<float2*>(dst + (r0 + 8) * pitch + col) =
                make_float2(h[i][n][2] + hl[i][n][2],
                            h[i][n][3] + hl[i][n][3]);
        }
      }
    }
    if constexpr (K::WK > 1) {
      __syncthreads();  // hs += the other k-groups' tiles, in their order
      for (int i = tid; i < K::P * 2 * K::HT; i += K::NT) {
        const int p = i / (2 * K::HT);
        float* o = hs + p * K::HP + i - p * 2 * K::HT;
        float v = *o;
#pragma unroll
        for (int j = 0; j < K::WK - 1; ++j) v += ks[j * K::P * 2 * K::HT + i];
        *o = v;
      }
    }
    __syncthreads();
    // 5. depthwise 3x3 (fp32, taps in (dy, dx) order) and the gate, a
    // thread per (hidden channel j, column qx, row group): it slides down
    // its TR rows, each halo row read once
    for (int task = tid; task < K::HT * K::TW * K::RG; task += K::NT) {
      const int j = task % K::HT, rest = task / K::HT;
      const int qx = rest % K::TW, r0 = (rest / K::TW) * K::TR;
      float w1[9], w2[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        w1[i] = wd[j * 9 + i];
        w2[i] = wd[(K::HT + j) * 9 + i];
      }
      float a1[K::TR], a2[K::TR];
#pragma unroll
      for (int r = 0; r < K::TR; ++r) a1[r] = a2[r] = 0.f;
#pragma unroll
      for (int rr = 0; rr < K::TR + 2; ++rr) {
        const float* hr = hs + ((r0 + rr) * K::PW + qx) * K::HP + j;
        const float h1[3] = {hr[0], hr[K::HP], hr[2 * K::HP]};
        const float h2[3] = {hr[K::HT], hr[K::HP + K::HT],
                             hr[2 * K::HP + K::HT]};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = rr - dy;
          if (r >= 0 && r < K::TR) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              a1[r] += w1[dy * 3 + dx] * h1[dx];
              a2[r] += w2[dy * 3 + dx] * h2[dx];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < K::TR; ++r)
        gs[((r0 + r) * K::TW + qx) * K::GP + j] = Gelu::f(a1[r]) * a2[r];
    }
    __syncthreads();
    // 6. out-projection: acc [Q x CP] += gate . W_out^T in split TF32
#pragma unroll
    for (int k0 = 0; k0 < K::HT; k0 += 8) {
      uint32_t ah[K::MIO][4], al[K::MIO][4];
#pragma unroll
      for (int i = 0; i < K::MIO; ++i) {
        uint32_t a[4];
        mma::ldsm_x4(a, gs + (16 * (wmo * K::MIO + i) + (lane & 15)) *
                                 K::GP + k0 + (lane >> 4) * 4);
        mma::split_tf32(a, ah[i], al[i]);
      }
#pragma unroll
      for (int n = 0; n < K::NI; ++n) {
        uint32_t bb[2], bh[2], bl[2];
        mma::ldsm_x2(bb, wo + (8 * (wno * K::NI + n) + (lane & 7)) * K::GP +
                             k0 + ((lane >> 3) & 1) * 4);
        mma::split_tf32(bb, bh, bl);
#pragma unroll
        for (int i = 0; i < K::MIO; ++i)
          mma::mma_3xtf32(acc[i][n], ah[i], al[i], bh[0], bh[1], bl[0],
                          bl[1]);
      }
    }
  }
  __syncthreads();  // every reader of zn, hs and gs is done
  // 7. the partial output tile -> os (over zn, hs and gs)
  float* os = reinterpret_cast<float*>(smk);
#pragma unroll
  for (int i = 0; i < K::MIO; ++i) {
    const int q = 16 * (wmo * K::MIO + i) + g;
#pragma unroll
    for (int n = 0; n < K::NI; ++n) {
      const int c = 8 * (wno * K::NI + n) + 2 * t4;
      os[Lay::oix(c, q)] = acc[i][n][0];
      os[Lay::oix(c + 1, q)] = acc[i][n][1];
      os[Lay::oix(c, q + 8)] = acc[i][n][2];
      os[Lay::oix(c + 1, q + 8)] = acc[i][n][3];
    }
  }
  // 8. y = x + the members' partial tiles, summed in rank order (0 + os_0
  // + os_1 + ...: no atomics, the same bits every call); member r stores
  // every split-th run of NT outputs from its r-th on
  if (split > 1)
    cluster_sync();
  else
    __syncthreads();
  // EB outputs a thread at a time, their residual loads in flight together
  constexpr int EB = 8;
  const int n = C * K::Q, step = split * K::NT;
  for (int i0 = rank * K::NT + tid; i0 < n; i0 += EB * step) {
    float xv[EB], sv[EB];
    long long gi[EB];
#pragma unroll
    for (int j = 0; j < EB; ++j) {
      const int i = i0 + j * step;
      int c, q;
      Lay::out(i, C, c, q);
      const int gy = y0 + q / K::TW, gx = x0 + q % K::TW;
      gi[j] = -1;
      if (i < n && gy < H && gx < W) {
        gi[j] = xb + Lay::at(c, gy, gx, C, H, W);
        xv[j] = x[gi[j]];
        const float* o = os + Lay::oix(c, q);
        float sum = 0.f;
        if (split > 1) {
          float v[8];  // every member's partial in flight at once
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (r < split) v[r] = ld_cluster(o, (unsigned)r);
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (r < split) sum += v[r];
        } else {
          sum += *o;
        }
        sv[j] = sum;
      }
    }
#pragma unroll
    for (int j = 0; j < EB; ++j)
      if (gi[j] >= 0) y[gi[j]] = xv[j] + sv[j];
  }
  if (split > 1) cluster_sync();  // no member leaves while others read it
}

template <class K, template <class> class Lay, class Gelu>
static int launch(const float* x, float* y, const float* lnw,
                  const float* lnb, const float* wimg, int B, int C, int H,
                  int W, int hp, int split, float eps, cudaStream_t stream) {
  if (C > K::CP || hp % K::HT || split < 1 || split > 8 ||
      split > hp / K::HT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fplan<K>(C).total;
  auto kernel = gdfn_f32_kernel<K, Lay<K>, Gelu>;
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + K::TW - 1) / K::TW * split,
                     (H + K::TH - 1) / K::TH, B);
  cfg.blockDim = dim3(K::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, x, y, lnw, lnb, wimg, C, H,
                                W, hp, split, eps);
  if (err) return err;
  return (int)cudaGetLastError();
}

// The ring slots' images (ops/cuda_effn.py::pack_gdfn_f32_weights, its
// plain version) from the weights as the model holds them, one launch:
// tile t is W_in's x1 rows t HT .. t HT + HT - 1, then its x2 rows hid +
// t HT .., each C values and KP + 4 - C zeros; then CP rows of W_out, its
// columns t HT .. (zero past C and hid) and 4 zeros; then the 9 taps of
// each of W_in's rows. w_in (2 hid, C), w_dw (2 hid, 9), w_out (C, hid),
// img (hp / HT, slot / 4), all fp32. A block row per tile, its threads
// along the slot (the writes coalesced, W_in's and W_out's reads in runs).
template <class K>
__global__ void __launch_bounds__(256) pack_kernel(
    const float* __restrict__ w_in, const float* __restrict__ w_dw,
    const float* __restrict__ w_out, float* __restrict__ img, int C,
    int hid) {
  const int t = blockIdx.y;
  const int ZP = (C + 15) / 16 * 16 + 4;
  const int a = 2 * K::HT * ZP, b = K::CP * K::GP;
  const int n = a + b + 18 * K::HT;
  float* o = img + (long long)t * n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float v = 0.f;
    if (i < a) {
      const int r = i / ZP, k = i - r * ZP;
      const int j = t * K::HT + r % K::HT;
      if (k < C && j < hid)
        v = w_in[((long long)(r / K::HT) * hid + j) * C + k];
    } else if (i < a + b) {
      const int e = i - a, c = e / K::GP, k = e - c * K::GP;
      const int j = t * K::HT + k;
      if (c < C && k < K::HT && j < hid) v = w_out[(long long)c * hid + j];
    } else {
      const int e = i - a - b, r = e / 9;
      const int j = t * K::HT + r % K::HT;
      if (j < hid) v = w_dw[((long long)(r / K::HT) * hid + j) * 9 + e % 9];
    }
    o[i] = v;
  }
}

template <class K>
static int pack(const float* w_in, const float* w_dw, const float* w_out,
                float* img, int C, int hid, cudaStream_t stream) {
  if (C > K::CP) return (int)cudaErrorInvalidValue;
  const int n = fplan<K>(C).slot / 4, nt = (hid + K::HT - 1) / K::HT;
  pack_kernel<K><<<dim3((n + 255) / 256, nt), 256, 0, stream>>>(
      w_in, w_dw, w_out, img, C, hid);
  return (int)cudaGetLastError();
}

static int gdfn_pack(const float* w_in, const float* w_dw,
                     const float* w_out, float* img, int C, int hid, int cls,
                     cudaStream_t st) {
  switch (cls) {
    case 0:
      return pack<Fc0>(w_in, w_dw, w_out, img, C, hid, st);
    case 1:
      return pack<Fc1>(w_in, w_dw, w_out, img, C, hid, st);
    case 2:
      return pack<Fc2>(w_in, w_dw, w_out, img, C, hid, st);
    case 3:
      return pack<Fc3>(w_in, w_dw, w_out, img, C, hid, st);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `split` blocks (blocks, for 1) of the class's
// kernel for C channels the card holds at once.
template <class K, template <class> class Lay, class Gelu>
static int resident(int C, int split, int* out) {
  const size_t smem = fplan<K>(C).total;
  auto kernel = gdfn_f32_kernel<K, Lay<K>, Gelu>;
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  if (split == 1) {
    int dev, sms, per;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if ((err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, kernel, K::NT, smem)))
      return err;
    *out = per * sms;
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(K::NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

template <template <class> class Lay, class Gelu>
static int gdfn_resident(int cls, int C, int split, int* out) {
  switch (cls) {
    case 0:
      return resident<Fc0, Lay, Gelu>(C, split, out);
    case 1:
      return resident<Fc1, Lay, Gelu>(C, split, out);
    case 2:
      return resident<Fc2, Lay, Gelu>(C, split, out);
    case 3:
      return resident<Fc3, Lay, Gelu>(C, split, out);
  }
  return (int)cudaErrorInvalidValue;
}

template <template <class> class Lay, class Gelu>
static int gdfn_fwd(const void* xv, void* yv, const float* lnw,
                    const float* lnb, const float* wimg, int B, int C, int H,
                    int W, int hp, int cls, int split, float eps,
                    void* stream) {
  const float* x = static_cast<const float*>(xv);
  float* y = static_cast<float*>(yv);
  cudaStream_t st = (cudaStream_t)stream;
  switch (cls) {
    case 0:
      return launch<Fc0, Lay, Gelu>(x, y, lnw, lnb, wimg, B, C, H, W, hp,
                                    split, eps, st);
    case 1:
      return launch<Fc1, Lay, Gelu>(x, y, lnw, lnb, wimg, B, C, H, W, hp,
                                    split, eps, st);
    case 2:
      return launch<Fc2, Lay, Gelu>(x, y, lnw, lnb, wimg, B, C, H, W, hp,
                                    split, eps, st);
    case 3:
      return launch<Fc3, Lay, Gelu>(x, y, lnw, lnb, wimg, B, C, H, W, hp,
                                    split, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace k2f
}  // namespace vmt

// K2, bf16: x, y (B, C, H, W) bf16; win_p (hp / HT, 2 HT, KP) bf16, tile t
// holding W_in's x1 rows t HT .. t HT + HT - 1 then its x2 rows, zero past
// hid and past C (KP: C rounded up to 16); wout_p (hp / HT, CP, HT) bf16,
// W_out's columns of tile t, zero past C and hid; wdw_p (hp / HT, 2 HT, 9)
// fp32, the depthwise taps in W_in's row order; cls the width class (its
// HT and CP: ops/cuda_effn.py::K2_CLASSES and pack_gdfn_weights).
extern "C" int vmt_gdfn_residual_fwd(
    const void* x, void* y, const float* lnw, const float* lnb,
    const void* win_p, const void* wout_p, const float* wdw_p, int B, int C,
    int H, int W, int hp, int cls, float eps, void* stream) {
  return vmt::k2::gdfn_fwd<vmt::mfront::Nchw, vmt::GeluErf>(
      x, y, lnw, lnb, win_p, wout_p, wdw_p, B, C, H, W, hp, cls, eps, stream);
}

// K2, fp32: x, y (B, C, H, W) fp32; wimg (hp / HT, slot) fp32, each
// hidden tile's W_in rows, W_out columns and taps as pack_gdfn_weights
// packs them, padded to the ring slot's pitches (ops/cuda_effn.py::
// pack_gdfn_f32_weights, for the fp32 width class cls: K2F_CLASSES); split
// the blocks of a cluster that share a tile (1, 2, 4 or 8, at most hp /
// HT; cuda_effn.k2f_split).
extern "C" int vmt_gdfn_residual_f32_fwd(
    const void* x, void* y, const float* lnw, const float* lnb,
    const float* wimg, int B, int C, int H, int W, int hp, int cls,
    int split, float eps, void* stream) {
  return vmt::k2f::gdfn_fwd<vmt::mfront::Nchw, vmt::GeluErf>(
      x, y, lnw, lnb, wimg, B, C, H, W, hp, cls, split, eps, stream);
}

// keffn's fused GDFN (replaces tools/keffn.py::_gdfn_kernel, built by
// gdfn_fused): x, y (B, H, W, C) channels-last, the gate gelu_tanh(x1) * x2;
// the weights as K2's, packed the same way (keffn's w_in is W_in
// transposed, its w_out W_out transposed, its w_dw the taps last). Every
// row is computed: the TPU kernel's grid drops the rows past
// (H // 16) * 16 when H > 16 and H is not a multiple of 16, which this port
// does not copy.
extern "C" int vmt_gdfn_tanh_nhwc_fwd(
    const void* x, void* y, const float* lnw, const float* lnb,
    const void* win_p, const void* wout_p, const float* wdw_p, int B, int C,
    int H, int W, int hp, int cls, float eps, void* stream) {
  return vmt::k2::gdfn_fwd<vmt::mfront::Nhwc, vmt::GeluTanh>(
      x, y, lnw, lnb, win_p, wout_p, wdw_p, B, C, H, W, hp, cls, eps, stream);
}

// K2, fp32: the slot images wimg of vmt_gdfn_residual_f32_fwd (and of
// keffn's) from w_in (2 hid, C), w_dw (2 hid, 3, 3), w_out (C, hid), fp32,
// for the fp32 class cls; wimg holds ceil(hid / HT) images.
extern "C" int vmt_gdfn_f32_pack(const float* w_in, const float* w_dw,
                                 const float* w_out, float* wimg, int C,
                                 int hid, int cls, void* stream) {
  return vmt::k2f::gdfn_pack(w_in, w_dw, w_out, wimg, C, hid, cls,
                             (cudaStream_t)stream);
}

// The clusters of `split` blocks of K2's fp32 kernel for C channels of the
// fp32 class cls that the card holds at once (blocks, for split 1): *out;
// nhwc picks keffn's instantiation. The stream is not used.
extern "C" int vmt_gdfn_f32_resident(int cls, int C, int split, int nhwc,
                                     void* out, void* stream) {
  int* n = static_cast<int*>(out);
  return nhwc ? vmt::k2f::gdfn_resident<vmt::mfront::Nhwc, vmt::GeluTanh>(
                    cls, C, split, n)
              : vmt::k2f::gdfn_resident<vmt::mfront::Nchw, vmt::GeluErf>(
                    cls, C, split, n);
}

extern "C" int vmt_gdfn_tanh_nhwc_f32_fwd(
    const void* x, void* y, const float* lnw, const float* lnb,
    const float* wimg, int B, int C, int H, int W, int hp, int cls,
    int split, float eps, void* stream) {
  return vmt::k2f::gdfn_fwd<vmt::mfront::Nhwc, vmt::GeluTanh>(
      x, y, lnw, lnb, wimg, B, C, H, W, hp, cls, split, eps, stream);
}
