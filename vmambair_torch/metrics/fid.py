"""FID: the port's copy of `vmambair_tpu/metrics/fid.py`.

`compute_statistics` and `calculate_fid` run on the host in numpy /
scipy as in JAX (the Frechet distance with scipy's `sqrtm`, retried with
eps on the diagonal when it is not finite). The features come from the
device: `extract_inception_features` (InceptionV3 pool3, the published
FID's, from a converted `.npz`; batched) and `extract_vgg_features`
(VGG19's `conv5_4` spatial mean, seeded without `weights_path`: a
deterministic relative metric, not the published one).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..losses.perceptual import init_vgg_params, vgg19_features
from ..utils.registry import METRIC_REGISTRY
from .common import full_fp32, imagenet_norm
from .inception import inception_pool3, load_inception_params


def compute_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """feats: (N, D) activations -> (mu, sigma)."""
    mu = np.mean(feats, axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy's matrix square root, called as JAX calls it (`disp=False`)
    where scipy still takes `disp` (later versions dropped it)."""
    from scipy import linalg

    try:
        return linalg.sqrtm(a, disp=False)[0]
    except TypeError:
        return linalg.sqrtm(a)


@METRIC_REGISTRY.register(name="calculate_fid")
def calculate_fid(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (on the host)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def _nchw(imgs, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(imgs, np.float32)).to(device).permute(
        0, 3, 1, 2)


@torch.no_grad()
def extract_vgg_features(imgs, weights_path: Optional[str] = None,
                         layer: str = "conv5_4", device="cuda") -> np.ndarray:
    """(N, C) spatial means of a VGG19 layer. imgs: (N, H, W, 3) RGB in
    [0, 1]; VGG19 from `weights_path` (a converted `.npz`) or the seeded
    draw."""
    params, _ = init_vgg_params(weights_path)
    params = {k: (w.to(device), b.to(device)) for k, (w, b) in params.items()}
    with full_fp32():
        x = imagenet_norm(_nchw(imgs, device))
        feats = vgg19_features(x, params, [layer], False, False)[layer]
    return feats.mean((2, 3)).cpu().numpy()


def extract_inception_features(imgs, weights_path: str,
                               resize_input: bool = True,
                               normalize_input: bool = False,
                               batch: int = 16, device="cuda") -> np.ndarray:
    """(N, 2048) InceptionV3 pool3 features, `batch` images a forward.
    imgs: (N, H, W, 3) RGB in [0, 1]; `weights_path` a converted `.npz`
    (`scripts/convert_metric_weights.py --inception`)."""
    params = load_inception_params(weights_path, device)
    imgs = np.asarray(imgs, np.float32)
    outs = [inception_pool3(_nchw(imgs[i:i + batch], device), params,
                            resize_input, normalize_input).cpu().numpy()
            for i in range(0, len(imgs), batch)]
    return np.concatenate(outs, axis=0)
