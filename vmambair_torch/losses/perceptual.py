"""Perceptual (VGG19) loss and the VGG backbones of the learned metrics,
PyTorch, NCHW.

Counterpart of `vmambair_tpu/losses/perceptual.py:26-211` (pip-basicsr's
`PerceptualLoss` / `VGGFeatureExtractor`, YAML `perceptual_opt`). The
VGG19 weights come from `pretrained_path`, an `.npz` with
`conv{i}_{j}/kernel` (HWIO) and `conv{i}_{j}/bias`, the file the JAX
package reads; without it they are the JAX package's seeded draw
(`init_vgg_params`: `RandomState(0)`, he-normal in HWIO order, zero
bias), transposed to OIHW, so the two packages' seeded VGG19 are the same
bits. The weights are buffers: frozen, in no optimizer. The target's
features are computed without a gradient. `VGG16_LAYERS` and `l2_pool`
(`pool="l2"` in `vgg_features`) are LPIPS's and DISTS's backbone
(`vmambair_tpu/losses/perceptual.py:41-50`, `:86-99`).
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import LOSS_REGISTRY

logger = logging.getLogger("vmambair_torch")

# VGG conv plan: (name, out_channels); 'M' = 2x2 max-pool
VGG19_LAYERS = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
]

# VGG16, the backbone of LPIPS (net='vgg') and DISTS
VGG16_LAYERS = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_vgg_params(pretrained_path: Optional[str], seed: int = 0,
                    plan=VGG19_LAYERS):
    """({name: (OIHW weight, bias)} as float32 tensors, pretrained?): read
    from the `.npz`, or drawn as the JAX package draws them (layer by
    layer `rng.normal(0, sqrt(2 / fan_in), (3, 3, in, out))`, no bias
    drawn)."""
    params: Dict[str, tuple] = {}
    convs = [item for item in plan if item != "M"]
    if pretrained_path:
        data = np.load(pretrained_path)
        for name, _ in convs:
            params[name] = (_oihw(data[f"{name}/kernel"]),
                            torch.from_numpy(np.array(data[f"{name}/bias"],
                                                      np.float32)))
        return params, True
    rng = np.random.RandomState(seed)
    in_ch = 3
    for name, out_ch in convs:
        std = math.sqrt(2.0 / (in_ch * 9))
        params[name] = (
            _oihw(rng.normal(0, std, (3, 3, in_ch, out_ch)).astype(
                np.float32)),
            torch.zeros(out_ch))
        in_ch = out_ch
    return params, False


def _oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))


def l2_pool(x: torch.Tensor) -> torch.Tensor:
    """DISTS's antialiased L2 pooling: the square root of x^2 filtered by
    the normalised outer product of the 3-tap Hann window, per channel,
    stride 2, padding 1."""
    w1 = np.hanning(5)[1:-1]
    w2 = np.outer(w1, w1)
    w2 = torch.from_numpy((w2 / w2.sum()).astype(np.float32)).to(x.device)
    c = x.shape[1]
    y = F.conv2d(x.square(), w2.expand(c, 1, 3, 3), stride=2, padding=1,
                 groups=c)
    return torch.sqrt(y.clamp_min(0.0) + 1e-12)


def vgg_features(x, params, layer_names: Sequence[str],
                 use_input_norm=True, range_norm=False, plan=VGG19_LAYERS,
                 pool="max"):
    """x: (B, 3, H, W) in [0, 1] (or [-1, 1] with range_norm); params
    {name: (weight, bias)}. Returns {name: activation} of the requested
    layers (after their ReLU), running the plan only as far as needed.
    pool: "max" (VGG's 2x2) or "l2" (DISTS's `l2_pool`)."""
    if range_norm:
        x = (x + 1.0) / 2.0
    if use_input_norm:
        mean = x.new_tensor(IMAGENET_MEAN)[:, None, None]
        std = x.new_tensor(IMAGENET_STD)[:, None, None]
        x = (x - mean) / std
    feats = {}
    remaining = set(layer_names)
    for item in plan:
        if not remaining:
            break
        if item == "M":
            x = l2_pool(x) if pool == "l2" else F.max_pool2d(x, 2)
            continue
        name, _ = item
        w, b = params[name]
        x = F.relu(F.conv2d(x, w, b, padding=1))
        if name in remaining:
            feats[name] = x
            remaining.discard(name)
    return feats


def vgg19_features(x, params, layer_names: Sequence[str],
                   use_input_norm=True, range_norm=False):
    return vgg_features(x, params, layer_names, use_input_norm, range_norm,
                        plan=VGG19_LAYERS)


class FrozenVGG(nn.Module):
    """A VGG of `plan` held as buffers (frozen, in no optimizer; `.to`
    carries them to the device): `init_vgg_params`' weights."""

    def __init__(self, pretrained_path: Optional[str] = None, seed: int = 0,
                 plan=VGG19_LAYERS):
        super().__init__()
        params, self.is_pretrained = init_vgg_params(pretrained_path, seed,
                                                     plan)
        self.names = list(params)
        for name, (w, b) in params.items():
            self.register_buffer(f"{name}_weight", w)
            self.register_buffer(f"{name}_bias", b)

    @property
    def params(self) -> Dict[str, tuple]:
        return {n: (getattr(self, f"{n}_weight"), getattr(self, f"{n}_bias"))
                for n in self.names}


@LOSS_REGISTRY.register(name="PerceptualLoss")
class PerceptualLoss(FrozenVGG):
    """Returns (l_percep, l_style), each None where its weight is 0."""

    def __init__(
        self,
        layer_weights: Dict[str, float],
        vgg_type: str = "vgg19",
        use_input_norm: bool = True,
        range_norm: bool = False,
        perceptual_weight: float = 1.0,
        style_weight: float = 0.0,
        criterion: str = "l1",
        pretrained_path: Optional[str] = None,
    ):
        super().__init__(pretrained_path)
        assert vgg_type == "vgg19", "only vgg19 is supported"
        self.layer_weights = dict(layer_weights)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion
        if not self.is_pretrained:
            logger.warning(
                "PerceptualLoss has no pretrained_path — using seeded "
                "RANDOM VGG19 features: the loss is a usable structured "
                "training signal but NOT the published VGG19-perceptual "
                "loss (convert torchvision weights via "
                "scripts/convert_metric_weights.py for parity)")

    def _crit(self, a, b):
        if self.criterion == "l1":
            return (a - b).abs().mean()
        if self.criterion in ("l2", "mse"):
            return (a - b).square().mean()
        if self.criterion == "fro":
            return torch.linalg.vector_norm(a - b)
        raise NotImplementedError(self.criterion)

    @staticmethod
    def _gram(x):
        b, c, h, w = x.shape
        f = x.reshape(b, c, h * w)
        return f @ f.transpose(1, 2) / (c * h * w)

    def forward(self, pred, target):
        names = list(self.layer_weights)
        params = self.params
        fp = vgg19_features(pred, params, names, self.use_input_norm,
                            self.range_norm)
        with torch.no_grad():
            ft = vgg19_features(target, params, names, self.use_input_norm,
                                self.range_norm)
        percep = style = None
        if self.perceptual_weight > 0:
            percep = sum(self.layer_weights[n] * self._crit(fp[n], ft[n])
                         for n in names) * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self.layer_weights[n]
                        * self._crit(self._gram(fp[n]), self._gram(ft[n]))
                        for n in names) * self.style_weight
        return percep, style
