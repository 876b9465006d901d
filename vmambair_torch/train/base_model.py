"""Training-model layer: optimizer, learning rate, EMA and the shared
`BaseModel` (schedule, log, checkpoint paths).

Counterpart of `vmambair_tpu/train/base_model.py:56-166`. The JAX package
builds an optax transform with an injected learning rate and updates in
one jitted step; here the optimizer is a `torch.optim` one whose param
groups get the schedule's learning rate before each step (`set_lr`), a
global-norm clip is `clip_grad_norm_` before the step, and the EMA is an
in-place lerp of a second copy of the network. `BaseModel.validation` is
the per-image evaluation loop with the registry's metrics
(`vmambair_tpu/train/base_model.py:169-227`).
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Any, Dict, Iterable

import numpy as np
import torch

from ..metrics import calculate_metric, metric_report_key
from ..utils.img_util import batch2img, imwrite
from .schedulers import build_scheduler

logger = logging.getLogger("vmambair_torch")


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_opt: dict):
    """YAML `optim_g` block -> torch optimizer. As in JAX: Adam with a
    weight decay is AdamW (decoupled, as `optax.adamw`), eps 1e-8; the
    learning rate is set per step by the schedule."""
    opt = dict(optim_opt)
    otype = opt.pop("type", "Adam").lower()
    lr = float(opt.pop("lr", 0.0))
    betas = tuple(opt.pop("betas", (0.9, 0.999)))
    wd = float(opt.pop("weight_decay", 0.0))
    if otype == "adam" and wd == 0:
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    if otype in ("adam", "adamw"):
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=wd)
    if otype == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise NotImplementedError(f"optimizer {otype}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


@torch.no_grad()
def ema_update(ema: torch.nn.Module, net: torch.nn.Module,
               decay: float) -> None:
    """In place: ema <- decay * ema + (1 - decay) * net, parameter by
    parameter."""
    torch._foreach_lerp_(list(ema.parameters()), list(net.parameters()),
                         1.0 - decay)


class BaseModel:
    """Shared infrastructure: device, schedule, log, checkpoint paths."""

    def __init__(self, opt: Dict[str, Any], device="cuda"):
        self.opt = opt
        self.is_train = opt.get("is_train", False)
        self.device = torch.device(device)
        self.seed = int(opt.get("manual_seed") or 0)
        self.log_dict: Dict[str, Any] = OrderedDict()

    def _make_schedule(self, train_opt, optim_key="optim_g"):
        base_lr = float(train_opt[optim_key].get("lr", 2e-4))
        sched_opt = dict(train_opt.get("scheduler") or {"type": "ConstantLR"})
        return build_scheduler(
            sched_opt, base_lr,
            total_iter=int(train_opt.get("total_iter", 10**6)),
            warmup_iter=int(train_opt.get("warmup_iter", -1)))

    def get_current_learning_rate(self):
        return self.log_dict.get("lr", 0.0)

    def get_current_log(self):
        """The log as floats; the losses stay device scalars until here, so
        a step does not wait for the card."""
        return {k: (v if isinstance(v, (int, float)) else float(v))
                for k, v in self.log_dict.items()}

    def _net_path(self, name: str, current_iter) -> str:
        return os.path.join(self.opt["path"]["models"],
                            f"{name}_{current_iter}.pth")

    def _state_path(self, current_iter) -> str:
        return os.path.join(self.opt["path"]["training_states"],
                            f"{current_iter}.state")

    def validation(self, dataloader, current_iter, tb_logger=None,
                   save_img: bool = False) -> Dict[str, float]:
        """Runs `test` on every image of the loader (batches of 1), writes
        the outputs as PNG when `save_img`, and averages each metric of
        `val.metrics` over the images (on the model's device; NIQE on the
        output alone); logs and returns the averages, a metric on a seeded
        backbone under `<name>_uncalibrated`."""
        dataset_name = getattr(dataloader, "name", None) or "val"
        metric_opts = (self.opt.get("val") or {}).get("metrics") or {}
        report_keys = {k: metric_report_key(k, dict(v))
                       for k, v in metric_opts.items()}
        results = {k: [] for k in metric_opts}
        cnt = 0
        for batch in dataloader:
            path = (batch.get("lq_path") or batch.get("gt_path")
                    or [f"img{cnt}"])[0]
            img_name = os.path.splitext(os.path.basename(path))[0]
            self.feed_data(batch)
            self.test()
            sr_img = batch2img(_hwc(self.output[0]))
            if save_img:
                sub = (os.path.join(img_name, f"{img_name}_{current_iter}.png")
                       if self.opt["is_train"] else
                       os.path.join(dataset_name, f"{img_name}.png"))
                imwrite(sr_img, os.path.join(
                    self.opt["path"]["visualization"], sub))
            if metric_opts and self.gt is not None:
                gt_img = batch2img(_hwc(self.gt[0]))
                for name, mopt in metric_opts.items():
                    results[name].append(
                        calculate_metric(dict(mopt), sr_img, gt_img,
                                         device=self.device))
            cnt += 1
        out = {}
        if metric_opts and cnt:
            for name, vals in results.items():
                avg = float(np.mean(vals))
                key = report_keys[name]
                out[key] = avg
                logger.info("Validation %s\t # %s: %.4f", dataset_name, key,
                            avg)
                if tb_logger is not None:
                    tb_logger.add_scalar(f"metrics/{key}", avg, current_iter)
        return out


def _hwc(t: torch.Tensor) -> np.ndarray:
    """A (C, H, W) tensor -> an HWC float32 numpy array on the host."""
    return t.detach().float().permute(1, 2, 0).cpu().numpy()
