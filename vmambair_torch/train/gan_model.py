"""SRGANModel: the adversarial fine-tuning stage (S2).

Counterpart of `vmambair_tpu/train/gan_model.py:44-254` (pip-basicsr's
`SRGANModel` and the reference's MambaSISRGAN subclass), on one device,
in JAX's step order. An iteration:

- the G step, when `iter % net_d_iters == 0 and iter > net_d_init_iters`:
  output = G(lq); pixel, perceptual and GAN losses, the GAN loss through
  D with D's weights frozen, D's spectral norms storing their u (the
  first of an iteration's three updates); Adam on G at the schedule's
  lr, then the EMA lerp. Otherwise output = G(lq) without a gradient;
- the D step: D(gt) and D(output.detach()), each storing its u (the
  second from the first's), l_d_real + l_d_fake without loss weight, Adam
  on D at `schedule_d`'s lr. D's gradients are zeroed before it, so none
  comes from the G step.

Under data parallelism G's training forward goes through `train_g` and
D's step through `train_d`, both DDP wrappers (`base_model.data_parallel`);
the G step's pass through D runs the bare, frozen `net_d`, so that D's
DDP sees only the D step (toggling requires_grad under a DDP forward would
leave its reducer waiting for gradients). D's spectral norms' u are
computed from weights that are equal on every rank, and DDP broadcasts
rank 0's buffers before each of D's forwards besides.

On CUDA the generator's scans and GDFNs run through their kernels (the
carry-saving forwards and the scan backward in the G step, the plain
forwards under no-grad); D and VGG19 are cuDNN convolutions.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Any, Dict

import torch

from ..losses import build_loss
from ..models import build_network
from ..parallel import reduce_log_dict
from ..utils.registry import MODEL_REGISTRY
from .base_model import build_optimizer, data_parallel, ema_update, set_lr
from .checkpoint import load_network, save_network
from .sr_model import SRModel


@MODEL_REGISTRY.register(name="SRGANModel")
@MODEL_REGISTRY.register(name="MambaSISRGANModel")
class SRGANModel(SRModel):
    def __init__(self, opt: Dict[str, Any], device="cuda"):
        # D and its optimizer are made in init_training_settings, which
        # SRModel.__init__ calls when training
        super().__init__(opt, device)
        if not self.is_train and opt.get("network_d"):
            self._init_net_d()

    def _init_net_d(self):
        """D from `network_d`, drawn from a generator seeded apart from
        G's."""
        self.net_d = build_network(self.opt["network_d"], device=self.device,
                                   seed=self.seed + 1)

    def init_training_settings(self):
        train_opt = self.opt["train"]
        self.ema_decay = float(train_opt.get("ema_decay", 0))
        if self.ema_decay > 0:
            self.net_g_ema = copy.deepcopy(self.net_g).requires_grad_(False)
        self._init_net_d()
        self._init_losses(train_opt)
        self.cri_gan = build_loss(dict(train_opt["gan_opt"]))
        self.net_d_iters = int(train_opt.get("net_d_iters", 1))
        self.net_d_init_iters = int(train_opt.get("net_d_init_iters", 0))
        self.optimizer = build_optimizer(self.net_g.parameters(),
                                         dict(train_opt["optim_g"]))
        self.optimizer_d = build_optimizer(self.net_d.parameters(),
                                           dict(train_opt["optim_d"]))
        self.schedule = self._make_schedule(train_opt, "optim_g")
        self.schedule_d = self._make_schedule(train_opt, "optim_d")

    def wrap_for_ranks(self):
        """SRModel's `train_g`, and `train_d`: net_d under DDP where a
        process group is initialised (else net_d)."""
        super().wrap_for_ranks()
        self.train_d = data_parallel(self.net_d, self.device)

    def optimize_parameters(self, current_iter: int):
        lr = self.schedule(current_iter)
        log = OrderedDict()
        if (current_iter % self.net_d_iters == 0
                and current_iter > self.net_d_init_iters):
            output, losses = self._g_step(lr)
            log.update(losses)
        else:
            with torch.no_grad():
                output = self.net_g(self.lq)
        log.update(self._d_step(output.detach(),
                                self.schedule_d(current_iter)))
        self.log_dict = reduce_log_dict(log)
        self.log_dict["lr"] = float(lr)

    # whether the G step's pass through D stores its spectral norms' u
    g_step_updates_u = True

    def _g_targets(self):
        """(pixel target, perceptual target) of the G step."""
        return self.gt, self.gt

    def _d_real(self):
        """D's real images."""
        return self.gt

    def _g_step(self, lr):
        set_lr(self.optimizer, lr)
        self.optimizer.zero_grad(set_to_none=True)
        output = self.train_g(self.lq)
        pix_gt, percep_gt = self._g_targets()
        total, losses = self._loss_terms(output, pix_gt, prefix="l_g_",
                                         percep_gt=percep_gt)
        self.net_d.requires_grad_(False)
        try:
            fake_pred = self.net_d(output,
                                   update_stats=self.g_step_updates_u)
        finally:
            self.net_d.requires_grad_(True)
        losses["l_g_gan"] = self.cri_gan(fake_pred, True, is_disc=False)
        (total + losses["l_g_gan"]).backward()
        self.optimizer.step()
        if self.net_g_ema is not None:
            ema_update(self.net_g_ema, self.net_g, self.ema_decay)
        return output, OrderedDict((k, v.detach())
                                   for k, v in losses.items())

    def _d_step(self, fake, lr_d):
        set_lr(self.optimizer_d, lr_d)
        self.optimizer_d.zero_grad(set_to_none=True)
        real_pred = self.train_d(self._d_real(), update_stats=True)
        l_d_real = self.cri_gan(real_pred, True, is_disc=True)
        fake_pred = self.train_d(fake, update_stats=True)
        l_d_fake = self.cri_gan(fake_pred, False, is_disc=True)
        (l_d_real + l_d_fake).backward()
        self.optimizer_d.step()
        return OrderedDict(l_d_real=l_d_real.detach(),
                           l_d_fake=l_d_fake.detach(),
                           out_d_real=real_pred.detach().mean(),
                           out_d_fake=fake_pred.detach().mean())

    def save(self, epoch: int, current_iter: int):
        super().save(epoch, current_iter)
        save_network(self._net_path("net_d", current_iter),
                     self.net_d.state_dict())

    def _training_states(self) -> Dict[str, Any]:
        """SRModel's, plus D's optimizer and D's state dict (its weights
        and its spectral norms' u, v and sigma)."""
        states = super()._training_states()
        states["optimizer_d"] = self.optimizer_d.state_dict()
        states["params_d"] = self.net_d.state_dict()
        return states

    def _load_training_states(self, st: Dict[str, Any]):
        """SRModel's, then D's optimizer and state dict; then
        `pretrain_network_d` over them, as JAX's `resume_training`."""
        super()._load_training_states(st)
        if "optimizer_d" in st:
            self.optimizer_d.load_state_dict(st["optimizer_d"])
        if "params_d" in st:
            self.net_d.load_state_dict(st["params_d"])
        load_path = (self.opt.get("path") or {}).get("pretrain_network_d")
        if load_path:
            load_network(load_path, self.net_d)
