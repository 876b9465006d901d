"""DISTS on VGG16 with L2 pooling, PyTorch: the port's copy of
`vmambair_tpu/metrics/dists.py`.

The input and VGG16's five stages (conv1_2 .. conv5_3, `pool="l2"`) in
one pass (JAX runs the backbone once per stage: the same numbers), each
stage's texture (means) and structure (covariance) similarities per
channel, weighted by the published alpha / beta
(`assets/dists_alpha_beta.npz`, loaded even without a backbone, as in
JAX; `alpha` / `beta` of `weights_path` take their place). Images as
LPIPS takes them (`lpips.py`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..losses.perceptual import VGG16_LAYERS, vgg_features
from ..utils.registry import METRIC_REGISTRY
from .common import VGG16Metric, full_fp32

STAGES = ["conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"]
_C1 = 1e-6
_C2 = 1e-6
AB_ASSET = os.path.join(os.path.dirname(__file__), "assets",
                        "dists_alpha_beta.npz")


class DISTS(VGG16Metric):
    def __init__(self, weights_path: Optional[str] = None, seed: int = 0):
        super().__init__(weights_path, seed)
        self.heads_pretrained = False
        data = np.load(weights_path) if weights_path else None
        if data is None or "alpha" not in data:
            data = np.load(AB_ASSET) if os.path.exists(AB_ASSET) else None
        if data is not None:
            self.register_buffer("alpha", torch.from_numpy(data["alpha"]))
            self.register_buffer("beta", torch.from_numpy(data["beta"]))
            self.heads_pretrained = True
        else:
            self.alpha = self.beta = None

    @torch.no_grad()
    def forward(self, img1, img2) -> float:
        with full_fp32():
            x = torch.cat([self.prep(img1), self.prep(img2)])
            feats = vgg_features(x, self.params, STAGES, False, False,
                                 plan=VGG16_LAYERS, pool="l2")
        n = x.shape[0] // 2
        dist1, dist2 = [], []
        for f in [x] + [feats[s] for s in STAGES]:
            a, b = f[:n], f[n:]
            mu_a = a.mean((2, 3), keepdim=True)
            mu_b = b.mean((2, 3), keepdim=True)
            var_a = ((a - mu_a) ** 2).mean((2, 3), keepdim=True)
            var_b = ((b - mu_b) ** 2).mean((2, 3), keepdim=True)
            cov = ((a - mu_a) * (b - mu_b)).mean((2, 3), keepdim=True)
            s_tex = (2 * mu_a * mu_b + _C1) / (mu_a ** 2 + mu_b ** 2 + _C1)
            s_struct = (2 * cov + _C2) / (var_a + var_b + _C2)
            dist1.append(s_tex[:, :, 0, 0])     # (N, C)
            dist2.append(s_struct[:, :, 0, 0])
        ka = [d.shape[-1] for d in dist1]
        if self.alpha is not None:
            w = torch.cat([self.alpha, self.beta], -1)
            w = w / w.sum()
            alpha = torch.split(w[..., :sum(ka)], ka, -1)
            beta = torch.split(w[..., sum(ka):], ka, -1)
            terms = [(al * d1).sum() + (be * d2).sum()
                     for al, be, d1, d2 in zip(alpha, beta, dist1, dist2)]
        else:
            terms = [d1.sum() + d2.sum() for d1, d2 in zip(dist1, dist2)]
        score = sum(torch.stack(terms).tolist())
        if self.alpha is None:
            score /= 2 * sum(ka)
        return float(1.0 - score)


_cache: Dict[tuple, DISTS] = {}


@METRIC_REGISTRY.register(name="calculate_dists")
def calculate_dists(img1, img2, weights_path=None, device="cuda",
                    **kwargs) -> float:
    """DISTS of two images on `device` (the card unless the caller asks for
    the CPU); one model per (weights_path, device), kept."""
    key = (weights_path, str(torch.device(device)))
    if key not in _cache:
        _cache[key] = DISTS(weights_path).to(device)
    return _cache[key](img1, img2)
