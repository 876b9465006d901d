"""LPIPS on VGG16, PyTorch: the port's copy of
`vmambair_tpu/metrics/lpips.py`.

VGG16's relu outputs of the five blocks, unit-normalised over channels,
squared differences, the 1x1 linear heads (`lin{k}/weight` of the
`.npz`), the spatial mean, summed over the layers. Without heads each
layer adds `mean(d) * C / 5`, as in JAX. Images are HWC (or NHWC), RGB as
given (the validation loop passes its BGR uint8 images as they are, as
JAX's does), divided by 255 when their largest value is over 1.5, then
ImageNet-normalised. Without `weights_path` the backbone is the JAX
package's seeded VGG16: deterministic, but not the published metric (the
validation loop reports it as `<name>_uncalibrated`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..losses.perceptual import VGG16_LAYERS, vgg_features
from ..utils.registry import METRIC_REGISTRY
from .common import VGG16Metric, full_fp32

LPIPS_LAYERS = ["conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"]


class LPIPS(VGG16Metric):
    def __init__(self, weights_path: Optional[str] = None, seed: int = 0):
        super().__init__(weights_path, seed)
        self.lin_names = []
        if weights_path:
            data = np.load(weights_path)
            for i, name in enumerate(LPIPS_LAYERS):
                key = f"lin{i}/weight"
                if key in data:
                    self.register_buffer(f"{name}_lin", torch.from_numpy(
                        np.array(data[key], np.float32)))
                    self.lin_names.append(name)

    @torch.no_grad()
    def forward(self, img1, img2) -> float:
        with full_fp32():
            x = torch.cat([self.prep(img1), self.prep(img2)])
            feats = vgg_features(x, self.params, LPIPS_LAYERS, False, False,
                                 plan=VGG16_LAYERS)
        n = x.shape[0] // 2
        terms = []
        for name in LPIPS_LAYERS:
            f = feats[name]
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True)
                     + 1e-10)
            d = (f[:n] - f[n:]).square()
            if name in self.lin_names:
                lin = F.relu(getattr(self, f"{name}_lin"))[:, None, None]
                terms.append((d * lin).sum(1).mean())
            else:
                terms.append(d.mean() * d.shape[1] / len(LPIPS_LAYERS))
        return float(sum(torch.stack(terms).tolist()))


_cache: Dict[tuple, LPIPS] = {}


@METRIC_REGISTRY.register(name="calculate_lpips")
def calculate_lpips(img1, img2, weights_path=None, device="cuda",
                    **kwargs) -> float:
    """LPIPS of two images on `device` (the card unless the caller asks for
    the CPU); one model per (weights_path, device), kept."""
    key = (weights_path, str(torch.device(device)))
    if key not in _cache:
        _cache[key] = LPIPS(weights_path).to(device)
    return _cache[key](img1, img2)
