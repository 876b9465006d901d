"""NIQE, the no-reference quality metric, in PyTorch without cv2: the
port's copy of `vmambair_tpu/metrics/niqe.py`.

The image's Y channel (MATLAB's BT.601, as JAX converts it; crop after),
cut to whole 96x96 blocks; at two scales the MSCN map, (x - mu) / (sigma
+ 1), with mu and sigma from the pristine model's 7x7 window with the
border replicated (what `cv2.filter2D(..., BORDER_REPLICATE)` computes
in JAX); the second scale is the exact 2x halving that JAX's
`cv2.resize(img / 255, INTER_LINEAR) * 255` makes of such an image: each
pixel the mean of a 2x2 block, interpolated along the rows first in
cv2's own rounding (`halve`). Per block (the
block count is the same at both scales, the block size halves) the
asymmetric generalized-Gaussian fits of the map and of its four
neighbour products (`torch.roll` within each block), 18 features a scale,
batched over all blocks of a scale: masked means in float32 and an
argmin against the 0.2:0.001:10 gamma table in float64, JAX's dtypes, so
that the argmin ties where JAX's does. A block without negative or
positive values gives NaN features, which the fit drops (`nanmean`, then
the covariance of the rows without NaN, then `pinv`), on the host in
float64 as in JAX. The pristine model is `assets/niqe_pris_params.npz`
(`pris_params_path` or VMAMBAIR_NIQE_PARAMS take its place).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.registry import METRIC_REGISTRY

BLOCK = 96
_SHIFTS = ((0, 1), (1, 0), (1, 1), (1, -1))
_Y_RGB = (65.481, 128.553, 24.966)  # MATLAB's Y row, R G B
_GRAY_BGR = (0.114, 0.587, 0.299)   # cv2's BGR2GRAY


@lru_cache(maxsize=None)
def gamma_table() -> Tuple[np.ndarray, ...]:
    """The fit's table over gamma = 0.2:0.001:10 (float64): gamma, the
    ratio r(gamma) the argmin matches, and per gamma the factors of beta
    (sqrt(G(1/g) / G(3/g))) and of the mean (G(2/g) / G(1/g)), each the
    value JAX's scalar calls give."""
    from scipy.special import gamma

    gam = np.arange(0.2, 10.001, 0.001)
    r_gam = np.square(gamma(2.0 / gam)) / (gamma(1.0 / gam)
                                           * gamma(3.0 / gam))
    beta = np.sqrt(gamma(1 / gam) / gamma(3 / gam))
    mean = gamma(2 / gam) / gamma(1 / gam)
    return gam, r_gam, beta, mean


def _table(device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(t).to(device) for t in gamma_table())


def pris_params(path: Optional[str] = None) -> dict:
    path = (path or os.environ.get("VMAMBAIR_NIQE_PARAMS")
            or os.path.join(os.path.dirname(__file__), "assets",
                            "niqe_pris_params.npz"))
    if not os.path.exists(path):
        raise FileNotFoundError(
            "NIQE needs the pristine-model parameters (niqe_pris_params.npz "
            "with mu_pris_param, cov_pris_param, gaussian_window); the "
            "asset is vendored under vmambair_torch/metrics/assets/. Pass "
            f"pris_params_path=... or set VMAMBAIR_NIQE_PARAMS (not found: "
            f"{path})")
    data = np.load(path)
    return {k: data[k] for k in ("mu_pris_param", "cov_pris_param",
                                 "gaussian_window")}


def to_y(img, crop_border: int = 0, convert_to: str = "y",
         device="cuda") -> torch.Tensor:
    """An HWC BGR image (uint8 [0, 255], or float on that scale) -> its Y
    (or cv2's gray) on the [0, 255] scale as a float32 (H, W) tensor on
    `device`, cropped after the conversion, without rounding (JAX's
    order)."""
    t = torch.as_tensor(np.ascontiguousarray(img) if isinstance(
        img, np.ndarray) else img).to(device).float()
    if t.dim() == 3 and t.shape[2] == 3:
        b, g, r = (t[..., i] / 255.0 for i in range(3))
        if convert_to == "y":
            r, g, b = r.double(), g.double(), b.double()
            y = (r * _Y_RGB[0] + g * _Y_RGB[1] + b * _Y_RGB[2]) + 16.0
            t = (y / 255.0).float() * 255.0
        else:  # cv2's BGR2GRAY: fma(r, cr, fma(b, cb, g * cg)) in float32
            c = [float(np.float32(v)) for v in _GRAY_BGR]
            f32 = torch.float32
            inner = (b.double() * c[0] + (g.double() * c[1]).to(f32)).to(f32)
            t = (r.double() * c[2] + inner).to(f32) * 255.0
    elif t.dim() == 3:
        t = t[..., 0]
    if crop_border:
        t = t[crop_border:-crop_border, crop_border:-crop_border]
    return t


def replicate_filter(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """The (H, W) image correlated with an odd square window, the border
    replicated (`cv2.filter2D(img, -1, window, BORDER_REPLICATE)`)."""
    k = window.shape[0] // 2
    x = F.pad(img[None, None], (k, k, k, k), mode="replicate")
    return F.conv2d(x, window[None, None])[0, 0]


def halve(img: torch.Tensor) -> torch.Tensor:
    """The exact 2x bilinear halving of an even-sized (H, W) image, bit for
    bit as `cv2.resize(INTER_LINEAR)` (its IPP path) rounds it: p + (q -
    p) * 0.5 of each pixel pair along the rows, then down the columns (the
    plain means (a + b) / 2 differ in one float32 ulp at ~9% of pixels)."""
    def lerp(p, q):
        return p + (q - p) * 0.5
    rows = lerp(img[:, 0::2], img[:, 1::2])
    return lerp(rows[0::2], rows[1::2])


def mscn(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    mu = replicate_filter(img, window)
    sigma = torch.sqrt((replicate_filter(img.square(), window)
                        - mu.square()).abs())
    return (img - mu) / (sigma + 1)


def _masked_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row means of v over the mask, NaN where the mask is empty."""
    return (v * mask).sum(1) / mask.sum(1)


def aggd_fit(x: torch.Tensor, table) -> dict:
    """The asymmetric generalized-Gaussian fit of each row of x (float32,
    (N, M)): the gamma table's index (argmin of (r - rhatnorm)^2, the
    first on a tie; 0 where rhatnorm is NaN, as numpy's argmin), rhatnorm
    (float32), alpha and the two betas (float64)."""
    gam, r_gam, beta_f, _ = table
    sq = x.square()
    left = torch.sqrt(_masked_mean(sq, x < 0))
    right = torch.sqrt(_masked_mean(sq, x > 0))
    g = left / right
    rhat = x.abs().mean(1).square() / sq.mean(1)
    g3 = (g.double() ** 3).float()  # correctly rounded, as powf
    rn = (rhat * (g3 + 1) * (g + 1)) / (g.square() + 1).square()
    idx = torch.cat([((r_gam - v[:, None].double()) ** 2).argmin(1)
                     for v in rn.split(512)])
    idx = torch.where(torch.isnan(rn), torch.zeros_like(idx), idx)
    bf = beta_f[idx]
    return dict(idx=idx, rhat=rn, alpha=gam[idx], beta_l=left.double() * bf,
                beta_r=right.double() * bf)


def block_features(img_norm: torch.Tensor, nbh: int, nbw: int,
                   table) -> Tuple[torch.Tensor, list]:
    """The 18 features of each block of an MSCN map (blocks in JAX's order:
    columns outer, rows inner) as an (N, 18) float64 tensor, and the five
    fits of each block."""
    b = img_norm.shape[0] // nbh
    blocks = img_norm.reshape(nbh, b, nbw, b).permute(2, 0, 1, 3).reshape(
        nbh * nbw, b, b)
    mean_f = table[3]
    fits = [aggd_fit(blocks.flatten(1), table)]
    cols = [fits[0]["alpha"], (fits[0]["beta_l"] + fits[0]["beta_r"]) / 2]
    for shift in _SHIFTS:
        prod = blocks * torch.roll(blocks, shift, dims=(1, 2))
        f = aggd_fit(prod.flatten(1), table)
        fits.append(f)
        cols += [f["alpha"], (f["beta_r"] - f["beta_l"]) * mean_f[f["idx"]],
                 f["beta_l"], f["beta_r"]]
    return torch.stack(cols, 1), fits


def niqe_features(img: torch.Tensor,
                  window: np.ndarray) -> Tuple[torch.Tensor, list]:
    """(N, 36) float64 features of the (H, W) float32 image on its device
    (both scales side by side), and the ten fits of each block."""
    table = _table(img.device)
    win = torch.from_numpy(np.asarray(window, np.float32)).to(img.device)
    nbh, nbw = img.shape[0] // BLOCK, img.shape[1] // BLOCK
    img = img[:nbh * BLOCK, :nbw * BLOCK]
    feats, fits = [], []
    for scale in (1, 2):
        f, fs = block_features(mscn(img, win), nbh, nbw, table)
        feats.append(f)
        fits += fs
        if scale == 1:
            img = halve(img / 255.0) * 255.0
    return torch.cat(feats, 1), fits


def niqe_quality(feats: np.ndarray, mu_pris, cov_pris) -> float:
    """The distance of the image's features to the pristine model (numpy,
    float64): NaN rows are left out of the covariance."""
    mu = np.nanmean(feats, axis=0)
    cov = np.cov(feats[~np.isnan(feats).any(axis=1)], rowvar=False)
    invcov = np.linalg.pinv((cov_pris + cov) / 2)
    diff = np.atleast_2d(mu_pris - mu)
    return float(np.sqrt((diff @ invcov @ diff.T)[0, 0]))


def argmin_flips(fits_a: list, fits_b: list, rel: float = 1e-5) -> tuple:
    """Where two runs' gamma argmins differ: (the count, whether every one
    is a tie: neighbouring table entries, with each run's rhatnorm within
    `rel` of their midpoint)."""
    r_gam = gamma_table()[1]
    flips, at_ties = 0, True
    for fa, fb in zip(fits_a, fits_b):
        ia, ib = fa["idx"].cpu().numpy(), fb["idx"].cpu().numpy()
        for k in np.nonzero(ia != ib)[0]:
            flips += 1
            lo, hi = sorted((int(ia[k]), int(ib[k])))
            mid = (r_gam[lo] + r_gam[hi]) / 2
            near = all(abs(float(f["rhat"][k]) - mid) <= rel * abs(mid)
                       for f in (fa, fb))
            at_ties &= hi - lo == 1 and near
    return flips, at_ties


@METRIC_REGISTRY.register(name="calculate_niqe")
def calculate_niqe(img, crop_border: int = 0, input_order: str = "HWC",
                   convert_to: str = "y",
                   pris_params_path: Optional[str] = None, device="cuda",
                   **kwargs) -> float:
    """NIQE of one HWC BGR image (uint8, as the validation loop gives it) on
    `device` (the card unless the caller asks for the CPU); the image
    needs at least two whole 96x96 blocks after `crop_border`. As in JAX,
    `input_order` is taken and not used."""
    params = pris_params(pris_params_path)
    y = to_y(img, crop_border, convert_to, device)
    feats, _ = niqe_features(y, params["gaussian_window"])
    return niqe_quality(feats.cpu().numpy(), params["mu_pris_param"],
                        params["cov_pris_param"])
