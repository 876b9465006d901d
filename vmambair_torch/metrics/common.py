"""What the learned metrics share: images to NCHW tensors on the metric's
device, full-fp32 convolutions, and the frozen VGG16 of LPIPS and DISTS."""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..losses.perceptual import (IMAGENET_MEAN, IMAGENET_STD, VGG16_LAYERS,
                                 FrozenVGG)


def to_nchw(img, device) -> torch.Tensor:
    """An HWC or NHWC image (numpy or tensor, uint8 or float) -> a float32
    NCHW tensor on `device`, divided by 255 where its largest value is over
    1.5 (the JAX package's rule: uint8 images and [0, 1] floats alike)."""
    t = torch.as_tensor(np.ascontiguousarray(img) if isinstance(
        img, np.ndarray) else img).to(device)
    t = t.float()
    if t.dim() == 3:
        t = t[None]
    if t.max() > 1.5:
        t = t / 255.0
    return t.permute(0, 3, 1, 2).contiguous()


def imagenet_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.new_tensor(IMAGENET_MEAN)[:, None, None]
    std = x.new_tensor(IMAGENET_STD)[:, None, None]
    return (x - mean) / std


@contextlib.contextmanager
def full_fp32():
    """fp32 convolutions and matrix products without TF32 inside, whatever
    the caller set: a metric's value does not depend on the setting."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class VGG16Metric(FrozenVGG):
    """A frozen VGG16: read from `weights_path` (an `.npz` with
    `conv{i}_{j}/kernel` HWIO and `/bias`), else the JAX package's seeded
    draw; `prep` takes the metric's images to its device."""

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0):
        super().__init__(weights_path, seed, plan=VGG16_LAYERS)

    @property
    def device(self) -> torch.device:
        return self.conv1_1_weight.device

    def prep(self, img) -> torch.Tensor:
        return imagenet_norm(to_nchw(img, self.device))
