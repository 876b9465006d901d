"""MATLAB's BT.601 colour conversions and bicubic `imresize`.

The port's copy of `vmambair_tpu/utils/matlab.py`: `rgb2ycbcr` /
`bgr2ycbcr` (studio swing, as MATLAB's) and their inverses on numpy
images, and `imresize` on numpy images or tensors on any device (MATLAB's
bicubic, Keys a = -0.5, the kernel widened by 1 / scale on a downscale
with antialiasing, indices clamped at the borders), separable: one gather
and one weighted sum per axis, in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_YCBCR_W = np.array([
    [65.481, -37.797, 112.0],
    [128.553, -74.203, -93.786],
    [24.966, 112.0, -18.214],
])
_YCBCR_B = np.array([16.0, 128.0, 128.0])


def _to_float01(img: np.ndarray):
    """uint8 [0, 255] or float [0, 1] -> float64 [0, 1], and the type."""
    t = img.dtype
    img = img.astype(np.float64)
    if t == np.uint8:
        img /= 255.0
    return img, t


def _from_float01(img: np.ndarray, t) -> np.ndarray:
    if t == np.uint8:
        return (img * 255.0).round().astype(np.uint8)
    return img.astype(np.float32)


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """MATLAB's rgb2ycbcr. img: HWC RGB, uint8 or float in [0, 1]."""
    img01, t = _to_float01(img)
    if y_only:
        out = img01 @ _YCBCR_W[:, 0] + _YCBCR_B[0]
    else:
        out = img01 @ _YCBCR_W + _YCBCR_B
    return _from_float01(out / 255.0, t)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """rgb2ycbcr of a BGR image (cv2's channel order)."""
    return rgb2ycbcr(img[..., ::-1], y_only=y_only)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB's ycbcr2rgb, clipped to [0, 1] (255 for uint8)."""
    img01, t = _to_float01(img)
    inv = np.linalg.inv(_YCBCR_W / 255.0)
    out = (img01 * 255.0 - _YCBCR_B) @ inv / 255.0
    return _from_float01(np.clip(out, 0, 1), t)


def ycbcr2bgr(img: np.ndarray) -> np.ndarray:
    return ycbcr2rgb(img)[..., ::-1]


def _cubic(x):
    """MATLAB's bicubic kernel (Keys, a = -0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2)
            * ((ax > 1) & (ax <= 2)))


def resize_weights(in_len: int, out_len: int, scale: float,
                   antialias: bool):
    """(indices, weights), each (out_len, taps): the input pixels each
    output pixel reads (clamped to the image: MATLAB's replicated border)
    and their normalised cubic weights (float64), taps that no output
    uses dropped."""
    wide = scale < 1 and antialias
    kernel_width = 4.0 / scale if wide else 4.0
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1  # 0-based
    dist = u[:, None] - (idx + 1)
    w = scale * _cubic(dist * scale) if wide else _cubic(dist)
    w = w / w.sum(axis=1, keepdims=True)
    idx = np.clip(idx, 0, in_len - 1).astype(np.int64)
    nz = np.any(w != 0, axis=0)
    return idx[:, nz], w[:, nz]


def _resize_axis(img: torch.Tensor, axis: int, idx: np.ndarray,
                 w: np.ndarray) -> torch.Tensor:
    """One axis of the separable resize: gather every tap's pixels, then
    their weighted sum."""
    out_len, taps = idx.shape
    g = img.index_select(axis, torch.from_numpy(idx.reshape(-1)).to(
        img.device))
    g = g.unflatten(axis, (out_len, taps))
    shape = [1] * g.dim()
    shape[axis], shape[axis + 1] = out_len, taps
    wt = torch.from_numpy(w).to(img.device).reshape(shape)
    return (g * wt).sum(axis + 1)


def imresize(img, scale: float | None = None, out_shape=None,
             antialias: bool = True):
    """MATLAB's bicubic imresize. img: HW or HWC, uint8 or float in [0, 1],
    a numpy array (returns one, as the JAX package does) or a tensor on
    any device (returns one on that device). Give `scale` or
    `out_shape` (h, w)."""
    as_numpy = isinstance(img, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(img)) if as_numpy else img
    is_uint8 = t.dtype == torch.uint8
    x = t.double()
    if is_uint8:
        x = x / 255.0
    in_h, in_w = x.shape[:2]
    if out_shape is not None:
        out_h, out_w = out_shape
        scale_h, scale_w = out_h / in_h, out_w / in_w
    else:
        scale_h = scale_w = float(scale)
        out_h, out_w = math.ceil(in_h * scale_h), math.ceil(in_w * scale_w)
    x = _resize_axis(x, 0, *resize_weights(in_h, out_h, scale_h, antialias))
    x = _resize_axis(x, 1, *resize_weights(in_w, out_w, scale_w, antialias))
    x = x.clamp(0, 1)
    x = (x * 255.0).round().to(torch.uint8) if is_uint8 else x.float()
    return x.numpy() if as_numpy else x
