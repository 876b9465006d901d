// The front of K5's fp32 route (oss_front.cu): LayerNorm over the
// channels of an output tile's halo, then 1x1 projections of it on the
// CUDA cores (the bf16 routes of K2 and K5 share mma_front.cuh; K2's fp32
// route has its own front in gdfn.cu).
//
// A block of NTH threads owns a TH x TW output tile of one image. ln_halo
// normalises x over the (TH+2) x (TW+2) halo into shared memory (fp32
// statistics, rounded to the activation dtype, zero outside the image and
// in the pad slots). project_tile then multiplies it by one tile of a
// (C, 2n) weight (the two halves of a 1x1 conv side by side, transposed):
// RT columns of each half, staged through shared memory KC input channels
// at a time in slices that all warps share, loaded coalesced. The image's
// layout is a policy (Nchw, the model's; Nhwc, keffn's): it only places
// channel c of pixel (gy, gx) relative to the image's first element.
#pragma once

#include "common.cuh"

namespace vmt {
namespace halo {

constexpr int TH = 4, TW = 8;            // output tile
constexpr int PH = TH + 2, PW = TW + 2;  // halo tile
constexpr int P = PH * PW;               // 60 halo pixels
constexpr int PP = 64;                   // halo pitch (slots >= P are zero)
constexpr int Q = TH * TW;               // 32 output pixels
constexpr int RT = 64;                   // columns of each half per tile
constexpr int NTH = 256;                 // threads
constexpr int NWARP = NTH / 32;
constexpr int PIX_W = PP / NWARP;        // projection: pixels per warp (8)
constexpr int ROWS_L = 2 * RT / 32;      // projection: rows per lane (4)
constexpr int KC = 32;                   // weight rows staged per step

// Layout policies. at(): the offset of channel c of pixel (gy, gx) from
// the image's first element (B images of C x H x W elements lie one after
// another in both). The output side stages a [C][OQ] tile in shared memory
// and writes it back in the order split() gives: pixels fastest for NCHW,
// channels fastest for NHWC (coalesced either way; the NHWC pitch OQ = Q+1
// keeps a warp's channel-strided reads off one bank).
struct Nchw {
  static constexpr int OQ = Q;
  __device__ static __forceinline__ long long at(int c, int gy, int gx,
                                                 int C, int H, int W) {
    return (long long)c * H * W + (long long)gy * W + gx;
  }
  __device__ static __forceinline__ void split(int i, int C, int& c,
                                               int& q) {
    c = i / Q;
    q = i % Q;
  }
};

struct Nhwc {
  static constexpr int OQ = Q + 1;
  __device__ static __forceinline__ long long at(int c, int gy, int gx,
                                                 int C, int H, int W) {
    return ((long long)gy * W + gx) * C + c;
  }
  __device__ static __forceinline__ void split(int i, int C, int& c,
                                               int& q) {
    c = i % C;
    q = i / C;
  }
};

// Whether halo slot p of the tile at (y0, x0) lies inside the H x W image.
__device__ __forceinline__ bool in_image(int p, int y0, int x0, int H,
                                         int W) {
  const int gy = y0 - 1 + p / PW, gx = x0 - 1 + p % PW;
  return p < P && gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// zn [C][PP] <- LN(x) over the halo of the tile at (y0, x0); x's image
// starts at element xb and is laid out as Lay says. s_mu, s_rs: [PP]
// shared scratch. The caller syncs before reading zn.
template <class Lay = Nchw>
__device__ __forceinline__ void ln_halo(
    const void* __restrict__ x, int dt, long long xb,
    const float* __restrict__ lnw, const float* __restrict__ lnb, int C,
    int H, int W, int y0, int x0, float eps, float* zn, float* s_mu,
    float* s_rs) {
  const int tid = threadIdx.x;
  for (int i = tid; i < C * PP; i += NTH) {
    const int c = i / PP, p = i % PP;
    zn[i] = in_image(p, y0, x0, H, W)
                ? ld_act(x, xb + Lay::at(c, y0 - 1 + p / PW, x0 - 1 + p % PW,
                                         C, H, W), dt)
                : 0.f;
  }
  __syncthreads();
  if (tid < P) {  // one thread per halo pixel
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += zn[c * PP + tid];
    const float mu = s / C;
    float v = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = zn[c * PP + tid] - mu;
      v += d * d;
    }
    s_mu[tid] = mu;
    s_rs[tid] = rsqrtf(v / C + eps);
  }
  __syncthreads();
  for (int i = tid; i < C * PP; i += NTH) {
    const int c = i / PP, p = i % PP;
    zn[i] = in_image(p, y0, x0, H, W)
                ? round_act((zn[i] - s_mu[p]) * s_rs[p] * lnw[c] + lnb[c], dt)
                : 0.f;
  }
}

// pa[m][j] <- sum_c w_t[c][col] * zn[c][warp * PIX_W + j] for tile row
// r = lane + 32m: row r < RT is column h0 + r of the first half, row
// r >= RT column h0 + r - RT of the second (n columns each; rows past n
// give 0). ws: [KC][2 RT] shared scratch. Every thread must call it.
__device__ __forceinline__ void project_tile(
    const float* zn, float* ws, const float* __restrict__ w_t, int C, int n,
    int h0, float (&pa)[ROWS_L][PIX_W]) {
  const int tid = threadIdx.x;
  const int lane = tid % 32, pbase = (tid / 32) * PIX_W;
#pragma unroll
  for (int m = 0; m < ROWS_L; ++m)
#pragma unroll
    for (int j = 0; j < PIX_W; ++j) pa[m][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += KC) {
    const int kc = min(KC, C - k0);
    __syncthreads();  // the previous slice's readers are done
    for (int i = tid; i < kc * 2 * RT; i += NTH) {
      const int kk = i / (2 * RT), r = i % (2 * RT);
      const int col = h0 + r % RT;
      ws[i] = col < n ? w_t[(long long)(k0 + kk) * 2 * n + (r / RT) * n + col]
                      : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float4* zr =
          reinterpret_cast<const float4*>(zn + (k0 + kk) * PP + pbase);
      const float4 za = zr[0], zb = zr[1];
      const float z[PIX_W] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
      const float* wr = ws + kk * 2 * RT + lane;
#pragma unroll
      for (int m = 0; m < ROWS_L; ++m) {
        const float w = wr[32 * m];
#pragma unroll
        for (int j = 0; j < PIX_W; ++j) pa[m][j] += w * z[j];
      }
    }
  }
}

}  // namespace halo
}  // namespace vmt
