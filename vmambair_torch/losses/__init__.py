"""Losses of the port (PyTorch, NCHW); counterpart of
`vmambair_tpu/losses/__init__.py` for the pixel losses."""

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


def build_loss(opt: dict):
    """YAML loss block (`{type: L1Loss, ...}`) -> loss object."""
    return build_from_cfg(opt, LOSS_REGISTRY)


__all__ = [
    "L1Loss", "MSELoss", "CharbonnierLoss", "PSNRLoss", "build_loss",
    "LOSS_REGISTRY", "l1_loss", "mse_loss", "charbonnier_loss", "psnr_loss",
]
