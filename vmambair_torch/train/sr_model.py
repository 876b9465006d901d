"""SRModel / ImageCleanModel: single-network restoration training.

Counterpart of `vmambair_tpu/train/sr_model.py:43-302`, on one device. A
step is forward, the pixel and perceptual losses (`pixel_opt`,
`perceptual_opt`: either or both), backward (through the scan and GDFN
kernels' autograd Functions on CUDA), an optional global-norm clip, the
optimizer step and the EMA lerp. `feed_data` takes the JAX package's
contract: NHWC float32 arrays, which land on the device as NCHW through
`put_batch`, the device prefetcher's hook; tensors already on the device
(what `put_batch` returns) are taken as they are. `test` pads to the
window, or runs chop inference through `RestorationUpscaler` when
`val.tile` is set. Weights come from
`torch.Generator().manual_seed(manual_seed)` (`build_network`); mixup draws
from a host generator seeded the same way.

Under data parallelism (`base_model.data_parallel`) the step forwards
`train_g`, the DDP wrapper of `net_g`, on the rank's rows. Mixup follows
the global-batch rule (`parallel.on_global_batch`): the ranks' rows are
gathered into the global batch, every rank draws the same Beta weight and
permutation over it, as JAX's one controller does
(`vmambair_tpu/train/sr_model.py:171-182`), and each forwards its own
rows; DDP's mean of the gradients is then the global batch's gradient,
and a step at world N is a step at world 1 on the same global batch, up
to the order of the all-reduce's sums. The logged losses are their mean
over the ranks (`parallel.reduce_log_dict`).
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..losses import build_loss
from ..models import build_network
from ..parallel import on_global_batch, reduce_log_dict
from ..utils.registry import MODEL_REGISTRY
from ..utils.upscaler import RestorationUpscaler
from .base_model import (
    BaseModel,
    build_optimizer,
    data_parallel,
    ema_update,
    set_lr,
)
from .checkpoint import (
    load_network,
    load_training_state,
    save_network,
    save_training_state,
)

def mixup_batch(rng: np.random.RandomState, lq, gt, alpha=1.2):
    """Mixup: convex-combine pairs inside the batch with a Beta(alpha,
    alpha) weight drawn from `rng`."""
    lam = float(rng.beta(alpha, alpha))
    perm = torch.as_tensor(rng.permutation(lq.shape[0]), device=lq.device)
    return lam * lq + (1 - lam) * lq[perm], lam * gt + (1 - lam) * gt[perm]


def to_device(v, device, dtype=np.float32) -> torch.Tensor:
    """An array -> a tensor of `dtype` on `device`; to a CUDA device from
    pinned memory without blocking the host (the copy runs on the current
    stream)."""
    t = torch.from_numpy(np.ascontiguousarray(v, dtype))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def to_device_nchw(v, device) -> torch.Tensor:
    """An NHWC float32 array -> an NCHW float32 tensor on `device`, as
    `to_device` copies it."""
    return to_device(v, device).permute(0, 3, 1, 2).contiguous()


def _is_on(t: torch.Tensor, device: torch.device) -> bool:
    """Whether t lies on `device` ("cuda" without an index is the current
    card)."""
    if t.device.type != device.type:
        return False
    if device.type != "cuda":
        return True
    return t.device.index == (torch.cuda.current_device()
                              if device.index is None else device.index)


@MODEL_REGISTRY.register(name="SRModel")
class SRModel(BaseModel):
    """Single-generator restoration model (pixel + optional perceptual)."""

    def __init__(self, opt: Dict[str, Any], device="cuda"):
        super().__init__(opt, device)
        self.net_g = build_network(opt["network_g"], device=self.device,
                                   seed=self.seed)
        self.scale = int(opt.get("scale", 1))
        self.window_size = int((opt.get("val") or {}).get("window_size", 8))
        self.ema_decay = 0.0
        self.net_g_ema: Optional[torch.nn.Module] = None
        self.optimizer = None
        self.output = self.lq = self.gt = None
        if self.is_train:
            self.init_training_settings()
        load_path = (opt.get("path") or {}).get("pretrain_network_g")
        if load_path:
            self.load_net_g(load_path)
        if self.is_train:
            self.wrap_for_ranks()

    def wrap_for_ranks(self):
        """The training forwards' nets: `train_g`, net_g under DDP where a
        process group is initialised (else net_g)."""
        self.train_g = data_parallel(self.net_g, self.device)

    def init_training_settings(self):
        train_opt = self.opt["train"]
        self.ema_decay = float(train_opt.get("ema_decay", 0))
        if self.ema_decay > 0:
            self.net_g_ema = copy.deepcopy(self.net_g).requires_grad_(False)
        mixing = train_opt.get("mixing_augs") or {}
        self.mixup = bool(train_opt.get("mixup", mixing.get("mixup", False)))
        self.mixup_beta = float(mixing.get("mixup_beta", 1.2))
        self.host_rng = np.random.RandomState(self.seed)
        self._init_losses(train_opt)
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError("Both pixel and perceptual losses are None.")
        self.grad_clip = (float(train_opt.get("grad_clip", 0.01))
                          if train_opt.get("use_grad_clip") else None)
        self.optimizer = build_optimizer(self.net_g.parameters(),
                                         dict(train_opt["optim_g"]))
        self.schedule = self._make_schedule(train_opt)

    def _init_losses(self, train_opt):
        """`cri_pix` and `cri_perceptual` from their YAML blocks (None
        where absent); VGG19's buffers go to the model's device."""
        pixel_opt = train_opt.get("pixel_opt")
        self.cri_pix = build_loss(dict(pixel_opt)) if pixel_opt else None
        percep_opt = train_opt.get("perceptual_opt")
        self.cri_perceptual = (build_loss(dict(percep_opt)).to(self.device)
                               if percep_opt else None)

    def _loss_terms(self, output, gt, prefix="l_", percep_gt=None):
        """(total, {name: loss}) of the pixel and perceptual terms, named
        `{prefix}pix`, `{prefix}percep` and `{prefix}style` as in JAX; the
        perceptual terms against `percep_gt` where given, else `gt`."""
        losses = OrderedDict()
        if self.cri_pix is not None:
            losses[prefix + "pix"] = self.cri_pix(output, gt)
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(
                output, gt if percep_gt is None else percep_gt)
            if l_percep is not None:
                losses[prefix + "percep"] = l_percep
            if l_style is not None:
                losses[prefix + "style"] = l_style
        return sum(losses.values()), losses

    def put_batch(self, data: Dict[str, Any],
                  keys=("lq", "gt")) -> Dict[str, Any]:
        """The batch with its `keys` as NCHW float32 tensors on the
        model's device (NHWC arrays are copied; tensors already on the
        device pass through): the hook `data.DevicePrefetcher` calls one
        step ahead, on its side stream."""
        out = dict(data)
        for k in keys:
            v = data.get(k)
            if v is not None and not (torch.is_tensor(v)
                                      and _is_on(v, self.device)):
                out[k] = to_device_nchw(v, self.device)
        return out

    def feed_data(self, data: Dict[str, Any]):
        batch = self.put_batch(data)
        self.lq = batch["lq"]
        self.gt = batch.get("gt")

    def optimize_parameters(self, current_iter: int):
        lr = self.schedule(current_iter)
        set_lr(self.optimizer, lr)
        lq, gt = self.lq, self.gt
        if self.mixup:
            lq, gt = on_global_batch(
                lambda a, b: mixup_batch(self.host_rng, a, b,
                                         self.mixup_beta), lq, gt)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self._loss_terms(self.train_g(lq), gt)
        total.backward()
        if self.grad_clip:
            torch.nn.utils.clip_grad_norm_(self.net_g.parameters(),
                                           self.grad_clip)
        self.optimizer.step()
        if self.net_g_ema is not None:
            ema_update(self.net_g_ema, self.net_g, self.ema_decay)
        # the losses stay device scalars: no wait on the card here
        self.log_dict = reduce_log_dict(OrderedDict(
            (k, v.detach()) for k, v in losses.items()))
        self.log_dict["lr"] = float(lr)

    def eval_net(self) -> torch.nn.Module:
        return self.net_g_ema if self.net_g_ema is not None else self.net_g

    def test(self):
        """Pad to the window (reflect), forward the EMA net, crop back; with
        `val.tile`, chop inference instead (`test_tiled`). `self.output` is
        NCHW on the device."""
        val_opt = self.opt.get("val") or {}
        tile = int(val_opt.get("tile", 0) or 0)
        if tile:
            return self.test_tiled(tile, int(val_opt.get("tile_pad", 0)))
        lq = self.lq
        _, _, h, w = lq.shape
        ws = self.window_size
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            lq = F.pad(lq, (0, pw, 0, ph), mode="reflect")
        with torch.inference_mode():
            out = self.eval_net()(lq)
        self.output = out[:, :, :h * self.scale, :w * self.scale]

    def test_tiled(self, tile: int, tile_pad: int = 0):
        """Fixed-tile chop inference of the EMA net through
        `RestorationUpscaler.tile_process` (JAX's `test_tiled`): tiles of
        one shape with a `tile_pad` halo, in batches of 16."""
        ups = RestorationUpscaler(
            self.scale, self.eval_net(), self.device, tile=tile,
            tile_pad=tile_pad, pre_pad=0, window=self.window_size,
            tile_batch=16)
        lq = self.lq.permute(0, 2, 3, 1).float().cpu().numpy()
        out = np.stack([ups.tile_process(img) for img in lq])
        self.output = torch.from_numpy(out).permute(0, 3, 1, 2).to(
            self.device)

    def save(self, epoch: int, current_iter: int):
        ema = None if self.net_g_ema is None else self.net_g_ema.state_dict()
        save_network(self._net_path("net_g", current_iter),
                     self.net_g.state_dict(), ema)
        if current_iter != -1:
            save_training_state(self._state_path(current_iter),
                                current_iter, epoch,
                                **self._training_states())

    def _training_states(self) -> Dict[str, Any]:
        """What a training state holds besides iter and epoch."""
        states = {"optimizer": self.optimizer.state_dict()}
        if self.net_g_ema is not None:
            states["params_ema"] = self.net_g_ema.state_dict()
        return states

    def load_net_g(self, path: str, param_key: Optional[str] = None):
        path_opt = self.opt.get("path") or {}
        key = param_key or path_opt.get("param_key_g", "params")
        strict = bool(path_opt.get("strict_load_g", True))
        load_network(path, self.net_g, key, strict)
        if self.net_g_ema is not None:
            load_network(path, self.net_g_ema, "params_ema", strict)

    def resume_training(self, state_path: str) -> Dict[str, int]:
        st = load_training_state(state_path)
        self._load_training_states(st)
        return {"iter": int(st["iter"]), "epoch": int(st["epoch"])}

    def _load_training_states(self, st: Dict[str, Any]):
        if "optimizer" in st and self.optimizer is not None:
            self.optimizer.load_state_dict(st["optimizer"])
        if "params_ema" in st and self.net_g_ema is not None:
            self.net_g_ema.load_state_dict(st["params_ema"])


@MODEL_REGISTRY.register(name="MambaSISRModel")
@MODEL_REGISTRY.register(name="MambaSISRModel2")
@MODEL_REGISTRY.register(name="ImageCleanModel")
class ImageRestorationModel(SRModel):
    """Named aliases: the MambaSISR S1 trainer and the deraining
    ImageCleanModel reduce to SRModel here, as in the JAX package."""
