"""On-device degradation ops of the blind-SR synthesis (torch, NCHW).

The port's copy of `vmambair_tpu/ops/degradation.py`: per-sample blur
(`filter2d`), the USM sharpener, the fixed-canvas resizes, Gaussian and
Poisson noise and the JPEG round trip (DiffJPEG's hard-rounding forward).
Images are NCHW float32 in [0, 1] on any device; nothing here reads a
device value back to the host, so the synthesis queues on the card without
a sync.

Each random op takes its draws as arguments (per-image values as device
tensors; the noise samples from a `sampler`, see `TorchSampler`), so that
the same apply can be fed JAX's draws in the tests.

Resize: JAX resamples with `jax.image.scale_and_translate(...,
antialias=True)` on a fixed canvas with a traced scale. torch has no such
op (`F.interpolate` is another function), so `resize_weights` keeps a
copy of its weight computation: the triangle or Keys-cubic kernel,
widened by 1/scale when downsampling, each output's weights normalised,
outputs whose sample falls outside the input zeroed. Each axis is one
dense (out, in) matrix built on the device, and a resize is two products.
The host-side scalars (1/scale, the back-resize's effective scale) are
rounded to fp32 as JAX computes them on its traced fp32 values.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------- filter2D


def filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-sample 2-D filtering (cross-correlation, reflect padding):
    img (B, C, H, W), kernel (B, k, k) -> (B, C, H, W). One grouped
    convolution over the batch folded into the channels."""
    b, c, h, w = img.shape
    k = kernel.shape[-1]
    pad = k // 2
    x = F.pad(img.reshape(1, b * c, h, w), (pad, pad, pad, pad),
              mode="reflect")
    weight = kernel.to(img.dtype)[:, None].expand(b, c, k, k).reshape(
        b * c, 1, k, k)
    return F.conv2d(x, weight, groups=b * c).view(b, c, h, w)


# --------------------------------------------------------------- USM sharp


def usm_kernel(radius: int = 50, device=None) -> torch.Tensor:
    """The USM sharpener's 1-D Gaussian (its 2-D kernel is the outer
    product): size radius + 1 made odd, sigma by cv2's rule
    0.3 * ((k - 1) / 2 - 1) + 0.8, in fp32."""
    ksize = radius + 1 if radius % 2 == 0 else radius
    ksize = max(3, ksize if ksize % 2 == 1 else ksize + 1)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    ax = torch.arange(ksize, device=device) - ksize // 2
    g = torch.exp(-(ax ** 2).float() / float(np.float32(2 * sigma ** 2)))
    return g / g.sum()


def _gauss_blur(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """`filter2d` with the separable kernel outer(g, g), in two 1-D passes
    over the reflect-padded image."""
    b, c, h, w = img.shape
    pad = g.numel() // 2
    x = F.pad(img.reshape(b * c, 1, h, w), (pad, pad, pad, pad),
              mode="reflect")
    x = F.conv2d(x, g.view(1, 1, -1, 1))
    return F.conv2d(x, g.view(1, 1, 1, -1)).view(b, c, h, w)


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
              threshold: float = 10.0) -> torch.Tensor:
    """Unsharp masking (basicsr `USMSharp`): the residual against a
    Gaussian blur, added where it exceeds `threshold` / 255, blended by the
    blurred mask."""
    g = usm_kernel(radius, img.device)
    residual = img - _gauss_blur(img, g)
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = _gauss_blur(mask, g)
    sharp = (img + weight * residual).clamp(0.0, 1.0)
    return soft_mask * sharp + (1 - soft_mask) * img


# ------------------------------------------------------------------ resize

# the interpolation mode index: 0 = area (approximated by antialiased
# linear), 1 = bilinear, 2 = bicubic
_KERNELS = ("linear", "linear", "cubic")
_EPS32 = float(np.finfo(np.float32).eps)


def _kernel(method: str, x: torch.Tensor) -> torch.Tensor:
    if method == "linear":  # triangle
        return torch.clamp(1 - x.abs(), min=0)
    # Keys cubic (a = -0.5)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int, inv_scale: float,
                   method: str, antialias: bool,
                   device=None) -> torch.Tensor:
    """The (out, in) resampling matrix of one axis, fp32: output i samples
    the input at (i + 0.5) * inv_scale - 0.5 (no translation), with
    `method`'s kernel widened by max(inv_scale, 1) when `antialias`.
    `inv_scale` is a host float, already rounded to fp32."""
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample_f[:, None] - src[None, :]).abs() / kernel_scale
    weights = _kernel(method, x)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None], weights, torch.zeros_like(weights))


def _f32(v: float) -> float:
    return float(np.float32(v))


def _resample(img: torch.Tensor, out_hw: Tuple[int, int],
              inv_hw: Tuple[float, float], method: str,
              antialias: bool) -> torch.Tensor:
    """Two products: (out_h, H) @ img @ (out_w, W)^T over every (B, C)."""
    _, _, h, w = img.shape
    wy = resize_weights(h, out_hw[0], inv_hw[0], method, antialias,
                        img.device)
    wx = resize_weights(w, out_hw[1], inv_hw[1], method, antialias,
                        img.device)
    return torch.matmul(wy, torch.matmul(img, wx.t()))


def resize_to(img: torch.Tensor, out_hw: Tuple[int, int],
              method_idx: int) -> torch.Tensor:
    """`jax.image.resize` to a static size: 0 = antialiased linear,
    1 = linear, 2 = cubic (the last two without antialiasing). An axis
    whose size does not change is left as it is."""
    _, _, h, w = img.shape
    method, antialias = (("linear", True), ("linear", False),
                         ("cubic", False))[method_idx]
    out = img
    if out_hw[0] != h:  # JAX's scale is out / in, its inverse in fp64
        out = torch.matmul(resize_weights(
            h, out_hw[0], _f32(1.0 / (out_hw[0] / h)), method, antialias,
            img.device), out)
    if out_hw[1] != w:
        out = torch.matmul(out, resize_weights(
            w, out_hw[1], _f32(1.0 / (out_hw[1] / w)), method, antialias,
            img.device).t())
    return out


def random_resize(img: torch.Tensor, scale: float,
                  method_idx: int) -> torch.Tensor:
    """Resample at factor `scale` onto the same canvas: the content lands
    in the top-left scale-fraction (samples past the input are zero), or,
    above 1, the canvas shows the top-left 1/scale of it. Antialiased for
    every mode."""
    _, _, h, w = img.shape
    inv = float(np.float32(1.0) / np.float32(scale))
    return _resample(img, (h, w), (inv, inv), _KERNELS[method_idx], True)


def random_resize_back(img: torch.Tensor, scale: float, method_idx: int,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of `random_resize`: the top-left (scale H, scale W)
    region resampled to `out_hw`."""
    _, _, h, w = img.shape
    s = np.float32(scale)
    inv = [float(np.float32(1.0) / (np.float32(o) / (s * np.float32(n))))
           for o, n in zip(out_hw, (h, w))]
    return _resample(img, out_hw, tuple(inv), _KERNELS[method_idx], True)


# ------------------------------------------------------------------- noise


class TorchSampler:
    """The noise samples of the synthesis, drawn from `gen` on its device:
    `normal(shape, tag)` and `poisson(rate, tag)`. The tags name the draw
    (a test's sampler returns JAX's draw of the same name)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def normal(self, shape: Sequence[int], tag: str) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.gen.device)

    def poisson(self, rate: torch.Tensor, tag: str) -> torch.Tensor:
        return torch.poisson(rate, generator=self.gen)


def add_gaussian_noise(img, sigma, gray, noise, noise_gray):
    """img + sigma * N(0, 1), per image either in colour (`noise`,
    B x C x H x W) or the same for every channel (`noise_gray`, B x 1 x H
    x W) where `gray`; clipped to [0, 1]. sigma, gray: (B,)."""
    s = sigma[:, None, None, None]
    noise = torch.where(gray[:, None, None, None], noise_gray * s, noise * s)
    return (img + noise).clamp(0.0, 1.0)


def poisson_levels(img_q: torch.Tensor) -> torch.Tensor:
    """Per-image photon levels 2^ceil(log2(#distinct 8-bit values)): one
    histogram of all images, each offset by 256 x its index (a
    `scatter_add_`: `torch.bincount` reads the input's maximum back to the
    host on CUDA). img_q: (B, ...) integers in [0, 255]. Returns (B,)
    fp32."""
    b = img_q.shape[0]
    idx = (img_q.reshape(b, -1).long()
           + 256 * torch.arange(b, device=img_q.device)[:, None]).reshape(-1)
    hist = torch.zeros(b * 256, dtype=torch.int32, device=img_q.device)
    hist.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    nuniq = (hist.view(b, 256) > 0).sum(1).float()
    return torch.exp2(torch.ceil(torch.log2(nuniq)))


_GRAY = (0.299, 0.587, 0.114)  # torchvision rgb_to_grayscale


def add_poisson_noise(img, scale, gray, sampler, tag: str = "poisson"):
    """Shot noise with basicsr's per-image level rule: quantise to 8 bits,
    levels = `poisson_levels`, noise = poisson(q * levels) / levels - q,
    per image in colour or from the grey image where `gray`; img + noise *
    scale clipped to [0, 1]. The samples come from `sampler.poisson` (tags
    `tag` and `tag + "_gray"`)."""
    img_c = torch.clamp((img * 255.0).round(), 0, 255) / 255.0
    vals = poisson_levels(torch.round(img_c * 255.0).to(torch.int32))
    vals = vals[:, None, None, None]
    noise = sampler.poisson(img_c * vals, tag) / vals - img_c

    gray_img = (img[:, :1] * _GRAY[0] + img[:, 1:2] * _GRAY[1]
                + img[:, 2:3] * _GRAY[2])
    gray_img = torch.clamp((gray_img * 255.0).round(), 0, 255) / 255.0
    vals_g = poisson_levels(torch.round(gray_img * 255.0).to(torch.int32))
    vals_g = vals_g[:, None, None, None]
    noise_g = (sampler.poisson(gray_img * vals_g, tag + "_gray") / vals_g
               - gray_img)
    noise = torch.where(gray[:, None, None, None], noise_g.expand_as(noise),
                        noise)
    return (img + noise * scale[:, None, None, None]).clamp(0.0, 1.0)


# -------------------------------------------------------------------- JPEG

_Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_C_TABLE = np.full((8, 8), 99, np.float32)
_C_TABLE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                    [47, 66, 99, 99]]
_RGB2YCC = np.array([[0.299, 0.587, 0.114],
                     [-0.168736, -0.331264, 0.5],
                     [0.5, -0.418688, -0.081312]], np.float32)
_YCC2RGB = np.array([[1.0, 0.0, 1.402],
                     [1.0, -0.344136, -0.714136],
                     [1.0, 1.772, 0.0]], np.float32)
_YCC_OFFSET = np.array([0.0, 128.0 / 255.0, 128.0 / 255.0], np.float32)


def _dct_matrix(n: int = 8) -> np.ndarray:
    k = np.arange(n)
    m = np.sqrt(2.0 / n) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi
                                  / (2 * n))
    m[0] = np.sqrt(1.0 / n)
    return m.astype(np.float32)


_CONSTS = {}


def _consts(device) -> dict:
    """The JPEG constants on `device`, copied there once (from pinned
    memory, without a wait)."""
    key = str(device)
    if key not in _CONSTS:
        host = dict(dct=_dct_matrix(), y=_Y_TABLE, c=_C_TABLE,
                    rgb2ycc=_RGB2YCC, ycc2rgb=_YCC2RGB, offset=_YCC_OFFSET)
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if torch.device(device).type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        _CONSTS[key] = out
    return _CONSTS[key]


def quality_factor(quality: torch.Tensor) -> torch.Tensor:
    """JPEG quality (1-100, (B,)) -> the quantisation tables' scale."""
    quality = quality.float()
    return torch.where(quality < 50, 5000.0 / quality,
                       200.0 - quality * 2.0) / 100.0


def _blockify(x: torch.Tensor) -> torch.Tensor:
    b, h, w = x.shape
    return x.view(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)


def _unblockify(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return x.permute(0, 1, 3, 2, 4).reshape(x.shape[0], h, w)


def jpeg_coefficients(chan: torch.Tensor, table: torch.Tensor,
                      factor: torch.Tensor):
    """One plane's DCT coefficients over its quantisation steps, before
    the round, and the steps. chan (B, H, W) in [0, 255]; factor (B,)."""
    dct = _consts(chan.device)["dct"]
    blocks = _blockify(chan - 128.0)
    coefs = torch.einsum("ij,bhwjk,lk->bhwil", dct, blocks, dct)
    q = torch.clamp(torch.floor(table * factor[:, None, None, None, None]
                                + 0.5), 1, 255)
    return coefs / q, q


def jpeg_decode(quant: torch.Tensor, q: torch.Tensor, h: int,
                w: int) -> torch.Tensor:
    """Dequantise and inverse-DCT the rounded coefficients of one plane."""
    dct = _consts(quant.device)["dct"]
    rec = torch.einsum("ji,bhwjk,kl->bhwil", dct, quant * q, dct) + 128.0
    return _unblockify(rec, h, w)


def jpeg_compress(img: torch.Tensor, quality: torch.Tensor,
                  round_fn=torch.round) -> torch.Tensor:
    """JPEG round trip at per-image quality (B,): YCbCr, 4:2:0 chroma
    (2x2 means), 8x8 DCT, quantisation with the standard tables scaled by
    quality, the inverse, nearest chroma upsampling, RGB, clipped. img
    (B, 3, H, W) in [0, 1], H and W multiples of 16. `round_fn` rounds
    each plane's coefficients (a test passes one that records them)."""
    b, _, h, w = img.shape
    assert h % 16 == 0 and w % 16 == 0, "pad to a multiple of 16 first"
    cs = _consts(img.device)
    factor = quality_factor(quality)
    ycc = (torch.einsum("bchw,dc->bdhw", img, cs["rgb2ycc"])
           + cs["offset"][None, :, None, None]) * 255.0
    y = ycc[:, 0]
    cb = ycc[:, 1].reshape(b, h // 2, 2, w // 2, 2).mean((2, 4))
    cr = ycc[:, 2].reshape(b, h // 2, 2, w // 2, 2).mean((2, 4))
    planes = []
    for name, chan, table in (("y", y, cs["y"]), ("cb", cb, cs["c"]),
                              ("cr", cr, cs["c"])):
        ratio, q = jpeg_coefficients(chan, table, factor)
        planes.append(jpeg_decode(round_fn(ratio), q, *chan.shape[1:]))
    y_r = planes[0]
    cb_u, cr_u = (p[:, :, None, :, None].expand(b, h // 2, 2, w // 2, 2)
                  .reshape(b, h, w) for p in planes[1:])
    ycc_r = torch.stack([y_r, cb_u, cr_u], 1) / 255.0
    out = torch.einsum("bchw,dc->bdhw",
                       ycc_r - cs["offset"][None, :, None, None],
                       cs["ycc2rgb"])
    return out.clamp(0.0, 1.0)


def jpeg_compress_padded(img: torch.Tensor, quality: torch.Tensor,
                         round_fn=torch.round) -> torch.Tensor:
    """`jpeg_compress` of the image edge-padded at the bottom and right to
    multiples of 16, cropped back."""
    _, _, h, w = img.shape
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    x = F.pad(img, (0, pw, 0, ph), mode="replicate") if ph or pw else img
    return jpeg_compress(x, quality, round_fn)[:, :, :h, :w]
