"""MATLAB's BT.601 Y channel for PSNR/SSIM on Y (numpy).

The port's copy of the part of `vmambair_tpu/utils/matlab.py` that the
metrics need: `rgb2ycbcr` (studio swing, as MATLAB's) and `bgr2ycbcr`.
"""

from __future__ import annotations

import numpy as np

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
