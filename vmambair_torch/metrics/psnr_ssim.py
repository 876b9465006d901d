"""PSNR and SSIM with MATLAB's semantics (numpy).

The port's copy of `vmambair_tpu/metrics/psnr_ssim.py`. Images are HWC
uint8 [0, 255] or float [0, 1] ('CHW' with `input_order`); `crop_border`
pixels go on each side; `test_y_only` (the YAML's `test_y_channel`)
compares the BT.601 Y channel of BGR images.
"""

from __future__ import annotations

import numpy as np

from ..utils.matlab import bgr2ycbcr
from ..utils.registry import METRIC_REGISTRY


def reorder_image(img: np.ndarray, input_order="HWC") -> np.ndarray:
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    if img.ndim == 2:
        img = img[..., None]
    return img


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """BGR [0, 255] -> Y [0, 255], float64, HWC with C = 1."""
    img = img.astype(np.float64) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img.astype(np.float32), y_only=True)[..., None]
    return img.astype(np.float64) * 255.0


def _prepare(img1, img2, crop_border, input_order, test_y_only):
    assert img1.shape == img2.shape, f"{img1.shape} vs {img2.shape}"
    img1 = reorder_image(np.asarray(img1), input_order).astype(np.float64)
    img2 = reorder_image(np.asarray(img2), input_order).astype(np.float64)
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_only:
        img1, img2 = to_y_channel(img1), to_y_channel(img2)
    return img1, img2


@METRIC_REGISTRY.register(name="calculate_psnr")
def calculate_psnr(img1, img2, crop_border=0, input_order="HWC",
                   test_y_only=False, **kwargs):
    test_y_only = test_y_only or kwargs.pop("test_y_channel", False)
    img1, img2 = _prepare(img1, img2, crop_border, input_order, test_y_only)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2_valid(img, kernel):
    """2-D correlation over the 'valid' region (MATLAB's filter2)."""
    kh, kw = kernel.shape
    h, w = img.shape
    windows = np.lib.stride_tricks.as_strided(
        img, (h - kh + 1, w - kw + 1, kh, kw), img.strides[:2] * 2,
        writeable=False)
    return np.einsum("ijkl,kl->ij", windows, kernel)


def _ssim_single(img1, img2):
    """SSIM of one 2-D channel on the uint8 scale, MATLAB's constants."""
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    kernel = _gaussian_kernel(11, 1.5)
    img1 = np.ascontiguousarray(img1, np.float64)
    img2 = np.ascontiguousarray(img2, np.float64)
    mu1, mu2 = _filter2_valid(img1, kernel), _filter2_valid(img2, kernel)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter2_valid(img1 ** 2, kernel) - mu1_sq
    sigma2_sq = _filter2_valid(img2 ** 2, kernel) - mu2_sq
    sigma12 = _filter2_valid(img1 * img2, kernel) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


@METRIC_REGISTRY.register(name="calculate_ssim")
def calculate_ssim(img1, img2, crop_border=0, input_order="HWC",
                   test_y_only=False, **kwargs):
    test_y_only = test_y_only or kwargs.pop("test_y_channel", False)
    img1, img2 = _prepare(img1, img2, crop_border, input_order, test_y_only)
    return float(np.mean([_ssim_single(img1[..., c], img2[..., c])
                          for c in range(img1.shape[2])]))
