"""GAN losses (vanilla, lsgan, wgan, wgan_softplus, hinge), PyTorch.

Counterpart of `vmambair_tpu/losses/gan.py:18-55` (pip-basicsr's
`GANLoss`): the generator's loss keeps `loss_weight`, the
discriminator's does not. vanilla is `binary_cross_entropy_with_logits`,
the same function as `optax.sigmoid_binary_cross_entropy`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.registry import LOSS_REGISTRY


@LOSS_REGISTRY.register(name="GANLoss")
class GANLoss:
    def __init__(self, gan_type="vanilla", real_label_val=1.0,
                 fake_label_val=0.0, loss_weight=1.0):
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target_is_real: bool,
                 is_disc: bool = False) -> torch.Tensor:
        label = self.real_label_val if target_is_real else self.fake_label_val
        if self.gan_type == "vanilla":
            loss = F.binary_cross_entropy_with_logits(
                pred, torch.full_like(pred, label))
        elif self.gan_type == "lsgan":
            loss = (pred - label).square().mean()
        elif self.gan_type == "wgan":
            loss = -pred.mean() if target_is_real else pred.mean()
        elif self.gan_type == "wgan_softplus":
            loss = F.softplus(-pred if target_is_real else pred).mean()
        elif self.gan_type == "hinge":
            if is_disc:
                p = -pred if target_is_real else pred
                loss = F.relu(1.0 + p).mean()
            else:
                loss = -pred.mean()
        else:
            raise NotImplementedError(self.gan_type)
        return loss if is_disc else self.loss_weight * loss
