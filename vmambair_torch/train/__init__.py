"""Training layer of the port: model wrappers, schedules, checkpoints.

Counterpart of `vmambair_tpu/train/__init__.py` for the S1 (pixel and
perceptual loss) and S2 (GAN) stages; `train/pipeline.py` holds
`train_pipeline` and `test_pipeline` (the entry points `train_torch.py`
and `test_torch.py`); `train/realesrgan_model.py` the RealSR stages (the
on-device degradation synthesis, `RealESRNetModel`, `RealESRGANModel`).
"""

from __future__ import annotations

import logging

from ..utils.registry import MODEL_REGISTRY
from . import checkpoint
from .base_model import BaseModel, build_optimizer, ema_update, set_lr
from .schedulers import SCHEDULERS, build_scheduler
from .gan_model import SRGANModel
from .realesrgan_model import RealESRGANModel, RealESRNetModel
from .sr_model import ImageRestorationModel, SRModel

logger = logging.getLogger("vmambair_torch")


def build_model(opt: dict, device="cuda"):
    """YAML `model_type` -> model instance, on `device` (the card unless
    the caller asks for the CPU)."""
    model = MODEL_REGISTRY.get(opt["model_type"])(opt, device=device)
    logger.info("Model [%s] is created.", model.__class__.__name__)
    return model


__all__ = [
    "build_model", "BaseModel", "SRModel", "ImageRestorationModel",
    "SRGANModel", "RealESRNetModel", "RealESRGANModel",
    "build_optimizer", "build_scheduler", "ema_update", "set_lr",
    "SCHEDULERS", "checkpoint", "MODEL_REGISTRY",
]
