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
// in-projection (1.41x at 8 x 16, against 1.875x at the fp32 route's
// 4 x 8). Hidden channels past hid are zero in the packed weights:
// gelu(0) * 0 = 0, as the TPU's lane padding (pallas_effn.py:163-177). Any
// C <= 384, H, W. What holds it above the bound is the CUDA-core part
// (the depthwise conv and the gate), the re-read of every hidden tile's
// weights by each block, and the latency of its phases, which only the
// second block of an SM hides (PERF.md).
//
// fp32 (the S1 step): `gdfn_kernel`, fp32 FMAs on the CUDA cores
// (ln_halo.cuh): fp32 products, which the tensor cores do not give (TF32
// keeps 10 bits), for the fp32 envelope and the exact-fp32 reference.
//
// The same kernels, with a tanh gate and channels-last images, are keffn's
// (vmt_gdfn_tanh_nhwc_fwd, below): the gate and the layout are template
// policies, so K2's instantiations are the code above unchanged.
#include "ln_halo.cuh"
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
// The fp32 route: fp32 FMAs on the CUDA cores.
// ---------------------------------------------------------------------------
namespace f32 {

using namespace halo;  // the tile, its halo and the projection (ln_halo.cuh)

constexpr int HT = RT;                   // hidden channels per tile
constexpr int QG = 4;                    // output: pixels per thread
constexpr int KMAX = 12;                 // output: channels per lane, C <= 384
constexpr int JC = 16;                   // W_out rows staged per step

// A block owns a TH x TW (4 x 8) output tile and walks the hidden
// channels in tiles of HT: for each it projects LN(x) over the halo into
// shared memory (ln_halo.cuh), applies the depthwise 3x3 and the gate,
// and accumulates W_out . gate into per-thread registers. Layout: x, y as
// Lay says; win_t (C, 2*hid) = W_in transposed; wdw (2*hid, 9); wout_t
// (hid, C) = W_out transposed; all fp32. NK: output channels per lane
// (ceil(C / 32) rounded up to 2, 3, 6 or 12), a template argument so that
// no accumulator slot sits idle.
template <int NK, class Lay, class Gelu>
__global__ void __launch_bounds__(NTH, 2) gdfn_kernel(
    const void* __restrict__ x, int dt, void* __restrict__ y,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const float* __restrict__ win_t, const float* __restrict__ wdw,
    const float* __restrict__ wout_t, int C, int H, int W, int hid,
    float eps) {
  extern __shared__ float sm[];
  float* zn = sm;                // [C][PP]  LN(x) over the halo
  float* hb = zn + C * PP;       // [2*HT][PP] projected hidden tile
  float* gb = hb + 2 * HT * PP;  // [HT][Q]  gate
  float* ws = gb + HT * Q;       // [KC][2*HT] W_in slice of the hidden tile
  float* wo = ws + KC * 2 * HT;  // [JC][C]   W_out slice of the hidden tile
  __shared__ float s_mu[PP], s_rs[PP];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const long long xb = (long long)b * C * H * W;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  // 1-2. LN(x) over the halo (ln_halo.cuh)
  ln_halo<Lay>(x, dt, xb, lnw, lnb, C, H, W, y0, x0, eps, zn, s_mu, s_rs);

  // output accumulators: lane owns channels lane + 32k, warp owns pixels
  // warp*QG .. warp*QG + QG - 1
  float acc[QG][NK];
#pragma unroll
  for (int i = 0; i < QG; ++i)
#pragma unroll
    for (int k = 0; k < NK; ++k) acc[i][k] = 0.f;

  for (int h0 = 0; h0 < hid; h0 += HT) {
    __syncthreads();  // zn ready; the previous tile's gb readers are done
    // 3. project the hidden tile over the halo: row r < HT is x1 channel
    // h0 + r, row r >= HT is x2 channel hid + h0 + r - HT
    {
      float pa[ROWS_L][PIX_W];
      project_tile(zn, ws, win_t, C, hid, h0, pa);
#pragma unroll
      for (int m = 0; m < ROWS_L; ++m)
#pragma unroll
        for (int j = 0; j < PIX_W; ++j)
          hb[(lane + 32 * m) * PP + warp * PIX_W + j] = pa[m][j];
    }
    __syncthreads();
    // 4. depthwise 3x3 and the gate
    for (int i = tid; i < HT * Q; i += NTH) {
      const int j = i / Q, q = i % Q;
      const int ch = h0 + j;
      float g = 0.f;
      if (ch < hid) {
        const int qy = q / TW, qx = q % TW;
        const float* w1 = wdw + (long long)ch * 9;
        const float* w2 = wdw + (long long)(hid + ch) * 9;
        const float* h1 = hb + j * PP;
        const float* h2 = hb + (HT + j) * PP;
        float a1 = 0.f, a2 = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int p = (qy + dy) * PW + qx + dx;
            a1 += w1[dy * 3 + dx] * h1[p];
            a2 += w2[dy * 3 + dx] * h2[p];
          }
        g = round_act(Gelu::f(a1) * a2, dt);
      }
      gb[j * Q + q] = g;
    }
    __syncthreads();
    // 5. accumulate W_out . gate, W_out through shared memory JC rows at
    // a time
    const int jmax = min(HT, hid - h0);
    for (int j0 = 0; j0 < jmax; j0 += JC) {
      const int jc = min(JC, jmax - j0);
      __syncthreads();  // gb is written; the previous slice's readers done
      for (int i = tid; i < jc * C; i += NTH) {
        wo[i] = wout_t[(long long)(h0 + j0) * C + i];
      }
      __syncthreads();
      for (int j = 0; j < jc; ++j) {
        const float4 g4 =
            *reinterpret_cast<const float4*>(gb + (j0 + j) * Q + warp * QG);
        const float gv[QG] = {g4.x, g4.y, g4.z, g4.w};
        const float* wr = wo + j * C;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int c = lane + 32 * k;
          const float w = c < C ? wr[c] : 0.f;
#pragma unroll
          for (int i = 0; i < QG; ++i) acc[i][k] += w * gv[i];
        }
      }
    }
  }
  __syncthreads();  // every reader of zn is done: reuse it for the output
  float* out = zn;  // [C][OQ]
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
#pragma unroll
      for (int i = 0; i < QG; ++i)
        out[c * Lay::OQ + warp * QG + i] = acc[i][k];
    }
  }
  __syncthreads();
  for (int i = tid; i < C * Q; i += NTH) {
    int c, q;
    Lay::split(i, C, c, q);
    const int gy = y0 + q / TW, gx = x0 + q % TW;
    if (gy < H && gx < W) {
      const long long o = xb + Lay::at(c, gy, gx, C, H, W);
      st_act(y, o, dt, ld_act(x, o, dt) + out[c * Lay::OQ + q]);
    }
  }
}

template <int NK, class Lay, class Gelu>
static int launch(const void* x, void* y, const float* lnw, const float* lnb,
                  const float* win_t, const float* wdw, const float* wout_t,
                  int B, int C, int H, int W, int hid, float eps, size_t smem,
                  cudaStream_t stream) {
  int err = set_smem((const void*)gdfn_kernel<NK, Lay, Gelu>, smem);
  if (err) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  gdfn_kernel<NK, Lay, Gelu><<<grid, NTH, smem, stream>>>(
      x, DT_F32, y, lnw, lnb, win_t, wdw, wout_t, C, H, W, hid, eps);
  return (int)cudaGetLastError();
}

template <class Lay, class Gelu>
static int gdfn_fwd(const void* x, void* y, const float* lnw,
                    const float* lnb, const float* win_t, const float* wdw,
                    const float* wout_t, int B, int C, int H, int W, int hid,
                    float eps, void* stream) {
  if (C > 32 * KMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)C * PP + 2 * HT * PP + HT * Q + KC * 2 * HT + (size_t)JC * C);
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = (C + 31) / 32;
  if (nk <= 2)
    return launch<2, Lay, Gelu>(x, y, lnw, lnb, win_t, wdw, wout_t, B, C, H,
                                W, hid, eps, smem, st);
  if (nk == 3)
    return launch<3, Lay, Gelu>(x, y, lnw, lnb, win_t, wdw, wout_t, B, C, H,
                                W, hid, eps, smem, st);
  if (nk <= 6)
    return launch<6, Lay, Gelu>(x, y, lnw, lnb, win_t, wdw, wout_t, B, C, H,
                                W, hid, eps, smem, st);
  return launch<12, Lay, Gelu>(x, y, lnw, lnb, win_t, wdw, wout_t, B, C, H,
                               W, hid, eps, smem, st);
}

}  // namespace f32
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

// K2, fp32: x, y (B, C, H, W) fp32; win_t (C, 2*hid) = W_in transposed,
// wdw (2*hid, 9), wout_t (hid, C) = W_out transposed, all fp32.
extern "C" int vmt_gdfn_residual_f32_fwd(
    const void* x, void* y, const float* lnw, const float* lnb,
    const float* win_t, const float* wdw, const float* wout_t, int B, int C,
    int H, int W, int hid, float eps, void* stream) {
  return vmt::f32::gdfn_fwd<vmt::halo::Nchw, vmt::GeluErf>(
      x, y, lnw, lnb, win_t, wdw, wout_t, B, C, H, W, hid, eps, stream);
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

extern "C" int vmt_gdfn_tanh_nhwc_f32_fwd(
    const void* x, void* y, const float* lnw, const float* lnb,
    const float* win_t, const float* wdw, const float* wout_t, int B, int C,
    int H, int W, int hid, float eps, void* stream) {
  return vmt::f32::gdfn_fwd<vmt::halo::Nhwc, vmt::GeluTanh>(
      x, y, lnw, lnb, win_t, wdw, wout_t, B, C, H, W, hid, eps, stream);
}
