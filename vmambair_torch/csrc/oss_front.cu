// K5: the OSS front of a MamberBlock, forward.
//
// Replaces vmambair_tpu/ops/pallas_effn.py::_oss_front_kernel (built by
// _oss_front_pallas). Computes, per pixel,
//   zn = LN(x) over C (fp32 statistics, rounded to the activation dtype),
//   [px | pz] = W_in . zn + b_in   (the 1x1 in_conv with its bias),
//   z  = SiLU(pz),
//   xs = SiLU(dwconv3x3(px) + b_dw), px taken as 0 outside the image,
// with one read of x and one write of each of xs and z.
//
// Layout: x (B, C, H, W); xs, z (B, E, H, W); all contiguous and of one
// dtype, fp32 or bf16. lnw, lnb (C,); win_t (C, 2E) = the in_conv weight
// transposed, x-half columns first; bin (2E,); wdw (E, 9); bdw (E,); all
// fp32 (the wrapper rounds the in_conv and depthwise weights and biases to
// the activation dtype first, as the model's convolutions use them). As on
// the TPU, LN(x) is rounded to the activation dtype before the product;
// px and pz stay fp32.
//
// What bounds it on the H100: the in_conv product, 2 * C * 2E flops per
// pixel (E = C in every shipped config), done here in fp32 on the CUDA
// cores; bytes moved are x once and xs, z once each.
//
// Design: K2's front (ln_halo.cuh). A block owns a TH x TW output tile of
// one image: it normalises x over the (TH+2) x (TW+2) halo into shared
// memory once, then walks the output channels in tiles of ET. The in_conv
// weight (up to 384 x 768) does not fit in shared memory, so each tile
// projects LN(x) onto its ET x-channels and ET z-channels, W_in staged
// through shared memory KC input channels at a time. The trap of
// this kernel: in_conv has a bias, so proj(0) != 0 and the projected halo
// is set to 0 after the bias wherever it falls outside the image; that is
// the zero padding the plain depthwise conv sees (K2's projection has no
// bias and never needed it). When the spatial tiles alone would not fill
// the card (the latent levels), blockIdx.y splits the channel tiles across
// blocks, each of which normalises the halo itself.
#include "ln_halo.cuh"

namespace vmt {
namespace front {

using namespace halo;

constexpr int ET = RT;                   // output channels per tile
constexpr int MAX_SMEM = 232448;         // opt-in shared memory per block

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

extern "C" int vmt_oss_front_fwd(
    const void* x, int dt, void* xs, void* z, const float* lnw,
    const float* lnb, const float* win_t, const float* bin, const float* wdw,
    const float* bdw, int B, int C, int E, int H, int W, float eps,
    void* stream) {
  using namespace vmt::front;
  const size_t smem =
      sizeof(float) * ((size_t)C * PP + 2 * ET * PP + KC * 2 * ET);
  if (smem + 2 * PP * sizeof(float) > MAX_SMEM || C < 1 || E < 1)
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
      x, dt, xs, z, lnw, lnb, win_t, bin, wdw, bdw, C, E, H, W, tiles_x, eps);
  return (int)cudaGetLastError();
}
