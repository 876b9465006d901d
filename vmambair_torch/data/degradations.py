"""Blur-kernel synthesis for blind-SR degradation (host-side numpy).

The port's copy of `vmambair_tpu/data/degradations.py`: isotropic and
anisotropic Gaussian, generalized Gaussian and plateau kernels, the
`random_mixed_kernels` dispatcher, the sinc (circular lowpass) kernel and
`pad_kernel`. `RealESRGANDataset` draws them per sample from a
`np.random.RandomState`, in the JAX package's order, so one seed gives its
kernels bit for bit; the image-space degradation runs on the device
(`ops/degradation.py`).
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence

import numpy as np
from scipy import special


def _mesh_grid(kernel_size: int):
    ax = np.arange(kernel_size) - kernel_size // 2
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], -1).reshape(kernel_size, kernel_size, 2, 1), xx, yy


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0], [0, sig_y**2]])
    u = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )
    return u @ d @ u.T


def _pdf2(sigma_matrix: np.ndarray, grid: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(sigma_matrix)
    g = grid[..., 0]  # (k, k, 2)
    expo = np.einsum("ijk,kl,ijl->ij", g, inv, g)
    return np.exp(-0.5 * expo)


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0,
                       grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    kernel = _pdf2(_sigma_matrix(sig_x, sig_y, theta), grid)
    return kernel / kernel.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0,
                                   beta=1.0, grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    inv = np.linalg.inv(_sigma_matrix(sig_x, sig_y, theta))
    g = grid[..., 0]
    expo = np.einsum("ijk,kl,ijl->ij", g, inv, g)
    kernel = np.exp(-0.5 * np.power(expo, beta))
    return kernel / kernel.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y=None, theta=0.0, beta=1.0,
                      grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    inv = np.linalg.inv(_sigma_matrix(sig_x, sig_y, theta))
    g = grid[..., 0]
    expo = np.einsum("ijk,kl,ijl->ij", g, inv, g)
    kernel = 1.0 / (np.power(expo, beta) + 1)
    return kernel / kernel.sum()


def _rand_range(rng, lo, hi):
    return rng.uniform(lo, hi)


def random_bivariate_gaussian(kernel_size, sigma_x_range, sigma_y_range=None,
                              rotation_range=(-math.pi, math.pi),
                              noise_range=None, isotropic=True, rng=None):
    rng = rng or np.random
    sig_x = _rand_range(rng, *sigma_x_range)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    else:
        sig_y = _rand_range(rng, *sigma_y_range)
        theta = _rand_range(rng, *rotation_range)
    kernel = bivariate_gaussian(kernel_size, sig_x, sig_y, theta,
                                isotropic=isotropic)
    if noise_range is not None:
        kernel = kernel * rng.uniform(noise_range[0], noise_range[1],
                                      kernel.shape)
        kernel = kernel / kernel.sum()
    return kernel


def random_bivariate_generalized_gaussian(
        kernel_size, sigma_x_range, sigma_y_range=None,
        rotation_range=(-math.pi, math.pi), beta_range=(0.5, 4),
        noise_range=None, isotropic=True, rng=None):
    rng = rng or np.random
    sig_x = _rand_range(rng, *sigma_x_range)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    else:
        sig_y = _rand_range(rng, *sigma_y_range)
        theta = _rand_range(rng, *rotation_range)
    # sample beta on either side of 1 (Real-ESRGAN convention)
    if rng.uniform(0, 1) < 0.5:
        beta = _rand_range(rng, beta_range[0], 1.0)
    else:
        beta = _rand_range(rng, 1.0, beta_range[1])
    return bivariate_generalized_gaussian(
        kernel_size, sig_x, sig_y, theta, beta, isotropic=isotropic
    )


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range=None,
                             rotation_range=(-math.pi, math.pi),
                             beta_range=(1, 2), noise_range=None,
                             isotropic=True, rng=None):
    rng = rng or np.random
    sig_x = _rand_range(rng, *sigma_x_range)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    else:
        sig_y = _rand_range(rng, *sigma_y_range)
        theta = _rand_range(rng, *rotation_range)
    if rng.uniform(0, 1) < 0.5:
        beta = _rand_range(rng, beta_range[0], 1.0)
    else:
        beta = _rand_range(rng, 1.0, beta_range[1])
    return bivariate_plateau(
        kernel_size, sig_x, sig_y, theta, beta, isotropic=isotropic
    )


def random_mixed_kernels(kernel_list: Sequence[str],
                         kernel_prob: Sequence[float], kernel_size: int,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi),
                         betag_range=(0.5, 8), betap_range=(0.5, 8),
                         noise_range=None, rng=None) -> np.ndarray:
    """Sample one kernel from the weighted family list (pip-basicsr
    `random_mixed_kernels` semantics)."""
    rng = rng or np.random
    kernel_type = rng.choice(list(kernel_list), p=list(kernel_prob))
    if kernel_type == "iso":
        return random_bivariate_gaussian(
            kernel_size, sigma_x_range, noise_range=noise_range,
            isotropic=True, rng=rng)
    if kernel_type == "aniso":
        return random_bivariate_gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            noise_range=noise_range, isotropic=False, rng=rng)
    if kernel_type == "generalized_iso":
        return random_bivariate_generalized_gaussian(
            kernel_size, sigma_x_range, beta_range=betag_range,
            isotropic=True, rng=rng)
    if kernel_type == "generalized_aniso":
        return random_bivariate_generalized_gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            beta_range=betag_range, isotropic=False, rng=rng)
    if kernel_type == "plateau_iso":
        return random_bivariate_plateau(
            kernel_size, sigma_x_range, beta_range=betap_range,
            isotropic=True, rng=rng)
    if kernel_type == "plateau_aniso":
        return random_bivariate_plateau(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            beta_range=betap_range, isotropic=False, rng=rng)
    raise ValueError(f"unknown kernel type {kernel_type}")


def circular_lowpass_kernel(cutoff: float, kernel_size: int,
                            pad_to: int = 0) -> np.ndarray:
    """2-D sinc filter (ideal circular lowpass), cutoff in (0, pi]."""
    assert kernel_size % 2 == 1
    with np.errstate(invalid="ignore"):  # the centre's 0 / 0, set below
        kernel = np.fromfunction(
            lambda x, y: cutoff
            * special.j1(
                cutoff
                * np.sqrt((x - (kernel_size - 1) / 2) ** 2
                          + (y - (kernel_size - 1) / 2) ** 2)
            )
            / (
                2
                * np.pi
                * np.sqrt((x - (kernel_size - 1) / 2) ** 2
                          + (y - (kernel_size - 1) / 2) ** 2)
            ),
            [kernel_size, kernel_size],
        )
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = (
        cutoff**2 / (4 * np.pi)
    )
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


def pad_kernel(kernel: np.ndarray, pad_to: int = 21) -> np.ndarray:
    k = kernel.shape[0]
    if pad_to > k:
        pad = (pad_to - k) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel
