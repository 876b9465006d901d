"""Losses of the port (PyTorch, NCHW); counterpart of
`vmambair_tpu/losses/__init__.py` for the pixel, GAN and VGG19 perceptual
losses; `perceptual.py` also holds the metrics' VGG16 and L2 pooling."""

from ..utils.registry import LOSS_REGISTRY, build_from_cfg
from .basic import (
    CharbonnierLoss,
    L1Loss,
    MSELoss,
    PSNRLoss,
    charbonnier_loss,
    l1_loss,
    mse_loss,
    psnr_loss,
)
from .gan import GANLoss
from .perceptual import PerceptualLoss, vgg19_features, vgg_features


def build_loss(opt: dict):
    """YAML loss block (`{type: L1Loss, ...}`) -> loss object."""
    return build_from_cfg(opt, LOSS_REGISTRY)


__all__ = [
    "L1Loss", "MSELoss", "CharbonnierLoss", "PSNRLoss", "GANLoss",
    "PerceptualLoss", "vgg_features", "vgg19_features", "build_loss",
    "LOSS_REGISTRY", "l1_loss", "mse_loss", "charbonnier_loss", "psnr_loss",
]
