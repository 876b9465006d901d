// The front that the tensor-core routes of K2 (gdfn.cu, `gdfn_mma_kernel`)
// and K5 (oss_front.cu, `oss_front_mma_kernel`) share: x's halo in bf16
// staged by cp.async, LayerNorm over the channels with fp32 statistics, and
// LN(x) written to shared memory as bf16, pixel-major with the channels
// contiguous, so that ldmatrix reads it as an mma operand. Their fp32
// routes (`gdfn_f32_kernel`, `oss_front_f32_kernel`) share
// `ln_front_f32`: the same front with LN(x) in fp32.
//
// A block of NTH threads owns a TH x TW output tile of one image; its
// (TH+2) x (TW+2) halo has P pixels. The kernel's tile class K gives the
// shapes: TH, TW, PH, PW, P; MP, the rows of LN(x) (halo pixels, then zero
// rows); RW and XS, the staging of x's halo per channel (rows of RW
// elements, XS apart); xi(p), where halo pixel p lies in a channel's
// staging. The image's layout is a policy (Nchw, the models'; Nhwc,
// keffn's); the output side of the policies is K2's.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace vmt {
namespace mfront {

constexpr int NTH = 256;
constexpr int NWARP = NTH / 32;
constexpr int LB = 16;  // global loads a thread keeps in flight

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float((uint32_t)u << 16);
}

// Layout policies. at(): the offset of channel c of pixel (gy, gx) from the
// image's first element. in(e): the e-th element of the halo staging as
// (channel, halo pixel), in the order that keeps the global reads
// coalesced; out(i): the same for K2's output tile; oix(c, q): where K2's
// output tile keeps channel c of pixel q (fp32), written from the mma
// fragments without bank conflicts and read back in out()'s order.
template <class K>
struct Nchw {
  static constexpr bool kRows = true;  // a channel's row is contiguous
  __device__ static __forceinline__ long long at(int c, int gy, int gx,
                                                 int C, int H, int W) {
    return (long long)c * H * W + (long long)gy * W + gx;
  }
  __device__ static __forceinline__ void in(int e, int C, int& c, int& p) {
    c = e / K::P;
    p = e - c * K::P;
  }
  __device__ static __forceinline__ void out(int i, int C, int& c, int& q) {
    c = i / K::Q;
    q = i - c * K::Q;
  }
  __device__ static __forceinline__ int oix(int c, int q) {
    return c * (K::Q + 4) + q;
  }
};

template <class K>
struct Nhwc {
  static constexpr bool kRows = false;
  static constexpr int OPN = (K::CP + 31) / 32 * 32 + 8;
  __device__ static __forceinline__ long long at(int c, int gy, int gx,
                                                 int C, int H, int W) {
    return ((long long)gy * W + gx) * C + c;
  }
  __device__ static __forceinline__ void in(int e, int C, int& c, int& p) {
    p = e / C;
    c = e - p * C;
  }
  __device__ static __forceinline__ void out(int i, int C, int& c, int& q) {
    q = i / C;
    c = i - q * C;
  }
  __device__ static __forceinline__ int oix(int c, int q) {
    return q * OPN + c;
  }
};

// zn [MP][ZP] <- round_bf16(LN(x)) over the halo of the tile at (y0, x0)
// (ZP = KP + 8, KP = C rounded up to 16), zero outside the image, in the
// rows past P and past C. x's image starts at element xb. Shared scratch:
// xs [C][XS] (x's halo, raw bf16), ln [2][KP] (LN's weight and bias),
// s_mu, s_rs [P]. 1. x's halo and LN's weights arrive all in flight at
// once: NCHW rows of an even W as 4-byte words by cp.async (zero-filled
// outside the image), otherwise LB element loads a thread. The call waits
// for every cp.async group the thread committed, those committed before it
// included. 2. The statistics (fp32, two passes): a warp takes 8 pixels at
// a time, its lanes 4 channel groups of each, summed across by shuffles.
// 3. zn, eight channels per 16-byte store. The caller syncs before
// reading zn.
template <class K, class Lay>
__device__ __forceinline__ void ln_front(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
    const float* __restrict__ lnb, int C, int H, int W, int y0, int x0,
    long long xb, float eps, unsigned short* xs, float* ln, float* s_mu,
    float* s_rs, __nv_bfloat16* zn) {
  const int KP = (C + 15) / 16 * 16, ZP = KP + 8;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned short* xr = reinterpret_cast<const unsigned short*>(x);
  if (Lay::kRows && W % 2 == 0) {
    constexpr int RWW = K::RW / 2, CW = K::PH * RWW;
    for (int i = tid; i < C * CW; i += NTH) {
      const int c = i / CW, rw = i - c * CW;
      const int r = rw / RWW, w = rw - r * RWW;
      const int gy = y0 - 1 + r, gx = x0 - 2 + 2 * w;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      mma::cp_async4(xs + c * K::XS + r * K::RW + 2 * w,
                     in ? xr + xb + Lay::at(c, gy, gx, C, H, W) : xr, in);
    }
  } else {
    const int n = C * K::P;
    for (int e0 = tid; e0 < n; e0 += LB * NTH) {
      unsigned short v[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int e = e0 + j * NTH;
        v[j] = 0;
        if (e < n) {
          int c, p;
          Lay::in(e, C, c, p);
          const int gy = y0 - 1 + p / K::PW, gx = x0 - 1 + p % K::PW;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            v[j] = xr[xb + Lay::at(c, gy, gx, C, H, W)];
        }
      }
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int e = e0 + j * NTH;
        if (e < n) {
          int c, p;
          Lay::in(e, C, c, p);
          xs[c * K::XS + K::xi(p)] = v[j];
        }
      }
    }
  }
  for (int i = tid; i < C; i += NTH) {
    mma::cp_async4(ln + i, lnw + i, true);
    mma::cp_async4(ln + KP + i, lnb + i, true);
  }
  mma::cp_async_commit();
  mma::cp_async_wait_all();
  __syncthreads();
  for (int pb = warp * 8; pb < K::P; pb += NWARP * 8) {
    const int p = pb + (lane & 7), cq = lane >> 3;
    const bool ok = p < K::P;
    const unsigned short* xp = xs + K::xi(p);
    float s = 0.f;
    if (ok)
      for (int c = cq; c < C; c += 4) s += bf16_bits(xp[c * K::XS]);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    const float mu = s / C;
    float v = 0.f;
    if (ok)
      for (int c = cq; c < C; c += 4) {
        const float d = bf16_bits(xp[c * K::XS]) - mu;
        v += d * d;
      }
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (ok && cq == 0) {
      s_mu[p] = mu;
      s_rs[p] = rsqrtf(v / C + eps);
    }
  }
  __syncthreads();
  for (int i = tid; i < K::MP * (KP / 8); i += NTH) {
    const int kg = i / K::MP, p = i - kg * K::MP;
    const int gy = y0 - 1 + p / K::PW, gx = x0 - 1 + p % K::PW;
    uint32_t w4[4] = {0u, 0u, 0u, 0u};
    if (p < K::P && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float mu = s_mu[p], rs = s_rs[p];
      const unsigned short* xp = xs + K::xi(p);
      float z[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kg * 8 + j;
        z[j] = c < C ? (bf16_bits(xp[c * K::XS]) - mu) * rs * ln[c] +
                           ln[KP + c]
                     : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h2 =
            __floats2bfloat162_rn(z[2 * j], z[2 * j + 1]);
        w4[j] = *reinterpret_cast<const uint32_t*>(&h2);
      }
    }
    *reinterpret_cast<uint4*>(zn + p * ZP + kg * 8) =
        make_uint4(w4[0], w4[1], w4[2], w4[3]);
  }
}

// The fp32 routes' front (K2's `gdfn_f32_kernel`, K5's
// `oss_front_f32_kernel`): zn [MP][ZP] <- LN(x) over the halo of the tile
// at (y0, x0), fp32 (ZP = KP + 4), zero outside the image, in the rows
// past P and in the columns past C. K gives NT and NW, the block's
// threads and warps, beside the tile's shapes. x's
// halo arrives by cp.async, 4 bytes an element in Lay::in's order (zero
// filled outside the image), straight into zn's rows; then the fp32
// statistics of each row (two passes) and the row normalised in place.
// The call waits for every cp.async group the thread committed; the
// caller syncs before reading zn. In two halves: `ln_front_f32_load`
// issues the loads and zero-fills the pads, `ln_front_f32_norm` waits for
// them and normalises (K5 issues its first weight copy in between).
template <class K, class Lay>
__device__ __forceinline__ void ln_front_f32_load(
    const float* __restrict__ x, int C, int H, int W, int y0, int x0,
    long long xb, float* zn) {
  const int KP = (C + 15) / 16 * 16, ZP = KP + 4;
  const int tid = threadIdx.x;
  for (int e = tid; e < C * K::P; e += K::NT) {
    int c, p;
    Lay::in(e, C, c, p);
    const int gy = y0 - 1 + p / K::PW, gx = x0 - 1 + p % K::PW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    mma::cp_async4(zn + p * ZP + c,
                   in ? x + xb + Lay::at(c, gy, gx, C, H, W) : x, in);
  }
  mma::cp_async_commit();
  const int kpad = KP - C;
  for (int i = tid; i < K::P * kpad; i += K::NT) {
    const int p = i / kpad;
    zn[p * ZP + C + i - p * kpad] = 0.f;
  }
  for (int i = tid; i < (K::MP - K::P) * KP; i += K::NT) {
    const int r = i / KP;
    zn[(K::P + r) * ZP + i - r * KP] = 0.f;
  }
}

template <class K, class Lay>
__device__ __forceinline__ void ln_front_f32_norm(
    const float* __restrict__ lnw, const float* __restrict__ lnb, int C,
    int H, int W, int y0, int x0, float eps, float* zn) {
  const int KP = (C + 15) / 16 * 16, ZP = KP + 4;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  mma::cp_async_wait_all();
  __syncthreads();
  // a warp takes 8 pixels at a time, its lanes 4 channel groups of each
  // (p * ZP + c falls in 32 distinct banks), summed across by shuffles
  for (int pb = warp * 8; pb < K::P; pb += K::NW * 8) {
    const int p = pb + (lane & 7), cq = lane >> 3;
    const int gy = y0 - 1 + p / K::PW, gx = x0 - 1 + p % K::PW;
    const bool ok = p < K::P && gy >= 0 && gy < H && gx >= 0 && gx < W;
    float* row = zn + p * ZP;
    float s = 0.f;
    if (ok)
      for (int c = cq; c < C; c += 4) s += row[c];
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    const float mu = s / C;
    float v = 0.f;
    if (ok)
      for (int c = cq; c < C; c += 4) {
        const float d = row[c] - mu;
        v += d * d;
      }
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    const float rs = rsqrtf(v / C + eps);
    if (ok)  // outside the image the row stays zero
      for (int c = cq; c < C; c += 4)
        row[c] = (row[c] - mu) * rs * __ldg(lnw + c) + __ldg(lnb + c);
  }
}

template <class K, class Lay>
__device__ __forceinline__ void ln_front_f32(
    const float* __restrict__ x, const float* __restrict__ lnw,
    const float* __restrict__ lnb, int C, int H, int W, int y0, int x0,
    long long xb, float eps, float* zn) {
  ln_front_f32_load<K, Lay>(x, C, H, W, y0, x0, xb, zn);
  ln_front_f32_norm<K, Lay>(lnw, lnb, C, H, W, y0, x0, eps, zn);
}

}  // namespace mfront
}  // namespace vmt
