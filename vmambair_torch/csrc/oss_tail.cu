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
// (B, D, H, W) contiguous. y and z are each fp32 or bf16 (own flags); out
// has z's dtype. lnw, lnb (D,) fp32. Rounding follows the TPU kernel: the
// sum y_row + y_colT is rounded to y's dtype before the fp32 statistics,
// and LN(.) is rounded to z's dtype before the gate multiply.
//
// What bounds it on the H100: bytes. Each element of y is read once, z
// once, out written once; the arithmetic is ~10 flops per element.
//
// Design: a block owns a T x T pixel tile of one image and every channel,
// so the statistics need no second pass over device memory. The tile of
// the sum sits in shared memory: the row-major pair is read along w and
// the column-major pair along h (its own contiguous axis), T values in a
// row each way, so both reads use whole 32-byte sectors and y_colT is
// never materialised. Then one thread per pixel takes the statistics, and
// the normalised, gated tile is written along w.
#include "common.cuh"

namespace vmt {
namespace tail {

constexpr int T = 8;          // pixel tile edge
constexpr int NP = T * T;     // 64 pixels
constexpr int NTH = 256;      // threads
constexpr int MAX_SMEM = 232448;

__global__ void __launch_bounds__(NTH) oss_tail_kernel(
    const void* __restrict__ y, int dty, const void* __restrict__ z, int dtz,
    void* __restrict__ out, const float* __restrict__ lnw,
    const float* __restrict__ lnb, int D, int H, int W, float eps) {
  extern __shared__ float s[];  // [D][NP] y_row + y_colT, slot py * T + px
  __shared__ float s_mu[NP], s_rs[NP];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * T, x0 = blockIdx.x * T;
  const long long L = (long long)H * W;
  const long long yb = (long long)b * 2 * D * L;
  const long long zb = (long long)b * D * L;
  const int tid = threadIdx.x;

  // 1. the row-major pair, consecutive threads along w
  for (int i = tid; i < D * NP; i += NTH) {
    const int c = i / NP, p = i % NP;
    const int gy = y0 + p / T, gx = x0 + p % T;
    s[i] = (gy < H && gx < W)
               ? ld_act(y, yb + c * L + (long long)gy * W + gx, dty)
               : 0.f;
  }
  __syncthreads();
  // 2. plus the column-major pair, consecutive threads along h; the sum
  // rounds to y's dtype
  for (int i = tid; i < D * NP; i += NTH) {
    const int c = i / NP, p = i % NP;
    const int px = p / T, py = p % T;
    const int gy = y0 + py, gx = x0 + px;
    if (gy < H && gx < W) {
      float* v = s + c * NP + py * T + px;
      *v = round_act(
          *v + ld_act(y, yb + (D + c) * L + (long long)gx * H + gy, dty),
          dty);
    }
  }
  __syncthreads();
  // 3. LayerNorm statistics, one thread per pixel
  if (tid < NP) {
    float sum = 0.f;
    for (int c = 0; c < D; ++c) sum += s[c * NP + tid];
    const float mu = sum / D;
    float v = 0.f;
    for (int c = 0; c < D; ++c) {
      const float d = s[c * NP + tid] - mu;
      v += d * d;
    }
    s_mu[tid] = mu;
    s_rs[tid] = rsqrtf(v / D + eps);
  }
  __syncthreads();
  // 4. normalise, gate, store along w
  for (int i = tid; i < D * NP; i += NTH) {
    const int c = i / NP, p = i % NP;
    const int gy = y0 + p / T, gx = x0 + p % T;
    if (gy < H && gx < W) {
      const long long o = zb + c * L + (long long)gy * W + gx;
      const float zn = (s[i] - s_mu[p]) * s_rs[p] * lnw[c] + lnb[c];
      st_act(out, o, dtz, round_act(zn, dtz) * ld_act(z, o, dtz));
    }
  }
}

}  // namespace tail
}  // namespace vmt

extern "C" int vmt_oss_tail_fwd(
    const void* y, int dty, const void* z, int dtz, void* out,
    const float* lnw, const float* lnb, int B, int D, int H, int W, float eps,
    void* stream) {
  using namespace vmt::tail;
  const size_t smem = sizeof(float) * (size_t)D * NP;
  if (smem + 2 * NP * sizeof(float) > MAX_SMEM || D < 1)
    return (int)cudaErrorInvalidValue;
  // set unconditionally: the static statistics arrays count against
  // the 48 KB that needs no opt-in
  int err = (int)cudaFuncSetAttribute(
      (const void*)oss_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  oss_tail_kernel<<<grid, NTH, smem, (cudaStream_t)stream>>>(
      y, dty, z, dtz, out, lnw, lnb, D, H, W, eps);
  return (int)cudaGetLastError();
}
