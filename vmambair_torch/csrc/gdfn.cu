// K2: the fused GDFN residual branch of a MamberBlock, forward.
//
// Replaces vmambair_tpu/ops/pallas_effn.py::_gdfn_kernel (built by
// _gdfn_pallas). Computes, per pixel,
//   y = x + W_out . (gelu_erf(x1) * x2),  [x1 | x2] = dwconv3x3(W_in . LN(x))
// with LN over the channels (fp32 statistics), zero padding of the hidden
// map at the image border, and one read of x and one write of y.
//
// Layout: x, y (B, C, H, W) contiguous, fp32 or bf16. lnw, lnb (C,);
// win_t (C, 2*hid) = W_in transposed; wdw (2*hid, 9); wout_t (hid, C) =
// W_out transposed; all fp32 (the wrapper rounds them to the activation
// dtype first, as the model's convolutions use them). As on the TPU, LN(x)
// and the gate are rounded to the activation dtype before their matrix
// products; the hidden map stays fp32.
//
// What bounds it on the H100: the two 1x1 projections, 3 * hid * C
// multiply-adds per pixel (hid = int(2.66 C), odd), done here in fp32 on
// the CUDA cores; bytes moved are only x and y.
//
// Design: the TPU kernel holds a whole hidden row tile (Hb+2, Wp, 2*hp),
// over 3 MB at C = 384, which does not fit in 227 KB of shared memory. So
// a block owns a TH x TW output tile of one image and walks the hidden
// channels in tiles of HT: for each hidden tile it projects LN(x) over the
// (TH+2) x (TW+2) halo into shared memory, applies the depthwise 3x3 and
// the exact-erf gate (erff), and accumulates W_out . gate into per-thread
// registers (their number per lane a template argument, so none idles);
// the residual is added at the end. Both projections read their weights
// through shared memory in slices that all 8 warps share, loaded
// coalesced. Odd hidden widths are handled by masking the last tile; no
// lane padding. C <= 384.
#include "ln_halo.cuh"

namespace vmt {

using namespace halo;  // the tile, its halo and the projection (ln_halo.cuh)

constexpr int HT = RT;                   // hidden channels per tile
constexpr int QG = 4;                    // output: pixels per thread
constexpr int KMAX = 12;                 // output: channels per lane, C <= 384
constexpr int JC = 16;                   // W_out rows staged per step

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// NK: output channels per lane (ceil(C / 32) rounded up to 2, 3, 6 or 12),
// a template argument so that no accumulator slot sits idle
template <int NK>
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
  const long long HW = (long long)H * W;
  const long long xb = (long long)b * C * HW;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  // 1-2. LN(x) over the halo (ln_halo.cuh)
  ln_halo(x, dt, xb, lnw, lnb, C, H, W, y0, x0, eps, zn, s_mu, s_rs);

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
        g = round_act(gelu_erf(a1) * a2, dt);
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
  float* out = zn;  // [C][Q]
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
#pragma unroll
      for (int i = 0; i < QG; ++i) out[c * Q + warp * QG + i] = acc[i][k];
    }
  }
  __syncthreads();
  for (int i = tid; i < C * Q; i += NTH) {
    const int c = i / Q, q = i % Q;
    const int gy = y0 + q / TW, gx = x0 + q % TW;
    if (gy < H && gx < W) {
      const long long o = xb + c * HW + (long long)gy * W + gx;
      st_act(y, o, dt, ld_act(x, o, dt) + out[i]);
    }
  }
}

template <int NK>
static int launch(const void* x, int dt, void* y, const float* lnw,
                  const float* lnb, const float* win_t, const float* wdw,
                  const float* wout_t, int B, int C, int H, int W, int hid,
                  float eps, size_t smem, cudaStream_t stream) {
  int err = set_smem((const void*)gdfn_kernel<NK>, smem);
  if (err) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  gdfn_kernel<NK><<<grid, NTH, smem, stream>>>(
      x, dt, y, lnw, lnb, win_t, wdw, wout_t, C, H, W, hid, eps);
  return (int)cudaGetLastError();
}

}  // namespace vmt

extern "C" int vmt_gdfn_residual_fwd(
    const void* x, int dt, void* y, const float* lnw, const float* lnb,
    const float* win_t, const float* wdw, const float* wout_t, int B, int C,
    int H, int W, int hid, float eps, void* stream) {
  using namespace vmt;
  if (C > 32 * KMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)C * PP + 2 * HT * PP + HT * Q + KC * 2 * HT + (size_t)JC * C);
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = (C + 31) / 32;
  if (nk <= 2) return launch<2>(x, dt, y, lnw, lnb, win_t, wdw, wout_t, B, C,
                                H, W, hid, eps, smem, st);
  if (nk == 3) return launch<3>(x, dt, y, lnw, lnb, win_t, wdw, wout_t, B, C,
                                H, W, hid, eps, smem, st);
  if (nk <= 6) return launch<6>(x, dt, y, lnw, lnb, win_t, wdw, wout_t, B, C,
                                H, W, hid, eps, smem, st);
  return launch<12>(x, dt, y, lnw, lnb, win_t, wdw, wout_t, B, C, H, W, hid,
                    eps, smem, st);
}
