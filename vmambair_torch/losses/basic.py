"""Pixel losses (L1, MSE, Charbonnier, PSNR), PyTorch, NCHW.

Counterpart of `vmambair_tpu/losses/basic.py`: the same functions and the
same YAML names (`pixel_opt: {type: L1Loss, loss_weight, reduction}`). The
JAX package takes NHWC; these take the port's NCHW (only `psnr_loss` with
`toY` reads the channel axis).
"""

from __future__ import annotations

import math

import torch

from ..utils.registry import LOSS_REGISTRY

_REDUCES = {"none": lambda x: x, "mean": torch.mean, "sum": torch.sum}


def l1_loss(pred, target, weight=None, reduction="mean"):
    loss = (pred - target).abs()
    if weight is not None:
        loss = loss * weight
    return _REDUCES[reduction](loss)


def mse_loss(pred, target, weight=None, reduction="mean"):
    loss = (pred - target).square()
    if weight is not None:
        loss = loss * weight
    return _REDUCES[reduction](loss)


def charbonnier_loss(pred, target, weight=None, reduction="mean", eps=1e-12):
    loss = torch.sqrt((pred - target).square() + eps)
    if weight is not None:
        loss = loss * weight
    return _REDUCES[reduction](loss)


def psnr_loss(pred, target, toY=False):
    """Negative PSNR as a loss (scale 10/ln 10, optional Y channel). Inputs
    in [0, 1], NCHW."""
    if toY:
        coef = pred.new_tensor([65.481, 128.553, 24.966])[:, None, None] / 255
        pred = (pred * coef).sum(1, keepdim=True) + 16.0 / 255.0
        target = (target * coef).sum(1, keepdim=True) + 16.0 / 255.0
    mse = (pred - target).square().mean((1, 2, 3))
    return (10.0 / math.log(10.0) * torch.log(mse + 1e-8)).mean()


class _WeightedLoss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction


@LOSS_REGISTRY.register(name="L1Loss")
class L1Loss(_WeightedLoss):
    def __call__(self, pred, target, weight=None):
        return self.loss_weight * l1_loss(pred, target, weight, self.reduction)


@LOSS_REGISTRY.register(name="MSELoss")
class MSELoss(_WeightedLoss):
    def __call__(self, pred, target, weight=None):
        return self.loss_weight * mse_loss(pred, target, weight, self.reduction)


@LOSS_REGISTRY.register(name="CharbonnierLoss")
class CharbonnierLoss(_WeightedLoss):
    def __init__(self, loss_weight=1.0, reduction="mean", eps=1e-12):
        super().__init__(loss_weight, reduction)
        self.eps = eps

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * charbonnier_loss(
            pred, target, weight, self.reduction, self.eps)


@LOSS_REGISTRY.register(name="PSNRLoss")
class PSNRLoss:
    def __init__(self, loss_weight=1.0, reduction="mean", toY=False):
        self.loss_weight = loss_weight
        self.toY = toY

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * psnr_loss(pred, target, self.toY)
