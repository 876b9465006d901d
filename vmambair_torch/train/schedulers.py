"""Learning-rate schedules as pure `step -> lr` functions.

The port's own copy of `vmambair_tpu/train/schedulers.py` (the port imports
nothing of the JAX package). A schedule is a callable `lr(step)`; the
trainer writes its value into the optimizer's param groups before each
step (`base_model.set_lr`). Warmup wrapping is a linear warmup.

The reference configs exercised: MultiStepRestartLR ([50k,70k] gamma 0.5 for
SISR), CosineAnnealingRestartCyclicLR ([144k,288k], eta [3e-4,1e-6] for
deraining), plus LinearLR/VibrateLR/CosineAnnealingRestartLR and RealSR's
manual stepwise decay (MultiStepLR).
"""

from __future__ import annotations

import math
from typing import Sequence


def multi_step_restart_lr(base_lr, milestones: Sequence[int], gamma=0.1,
                          restarts=(0,), restart_weights=(1,)):
    """Stepwise gamma decay at milestones, with optional restarts that reset
    the LR to base_lr * weight."""
    milestones = sorted(milestones)
    restarts = list(restarts)
    restart_weights = list(restart_weights)

    def lr(step):
        step = int(step)
        # find last restart at or before step
        weight, start = 1.0, 0
        for r, w in zip(restarts, restart_weights):
            if step >= r:
                weight, start = w, r
        n_decays = sum(1 for m in milestones if start < m <= step)
        return base_lr * weight * (gamma**n_decays)

    return lr


def linear_lr(base_lr, total_iter):
    def lr(step):
        return base_lr * (1.0 - step / total_iter)

    return lr


def vibrate_lr(base_lr, total_iter):
    """Sawtooth-modulated decaying schedule (reference `VibrateLR`)."""

    def lr(step):
        step = int(step)
        process = step / total_iter
        if process < 3 / 8:
            f = 1 - process * 8 / 3
        elif process < 5 / 8:
            f = 0.2
        else:
            f = 0.1
        T = max(total_iter // 80, 2)
        Th = T // 2
        t = step % T
        f2 = t / Th if t < Th else 2 - t / Th
        weight = f * f2
        if step < Th:
            weight = max(0.1, weight)
        return base_lr * weight

    return lr


def _restart_position(step, cumulative):
    for i, p in enumerate(cumulative):
        if step <= p:
            return i
    return len(cumulative) - 1


def cosine_annealing_restart_lr(base_lr, periods: Sequence[int],
                                restart_weights=(1,), eta_min=0.0):
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]

    def lr(step):
        step = int(step)
        idx = _restart_position(step, cumulative)
        w = restart_weights[idx]
        start = 0 if idx == 0 else cumulative[idx - 1]
        period = periods[idx]
        return eta_min + w * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * (step - start) / period)
        )

    return lr


def cosine_annealing_restart_cyclic_lr(base_lr, periods: Sequence[int],
                                       restart_weights=(1,), eta_mins=(0.0,)):
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]

    def lr(step):
        step = int(step)
        idx = _restart_position(step, cumulative)
        w = restart_weights[idx]
        start = 0 if idx == 0 else cumulative[idx - 1]
        period = periods[idx]
        eta = eta_mins[idx]
        return eta + w * 0.5 * (base_lr - eta) * (
            1 + math.cos(math.pi * (step - start) / period)
        )

    return lr


def multi_step_lr(base_lr, milestones: Sequence[int], gamma=0.5):
    """Plain MultiStepLR (RealSR GAN stage: lr * gamma^(#milestones passed),
    `MambaRealSRGAN_model.py:290-292`)."""
    milestones = sorted(milestones)

    def lr(step):
        n = sum(1 for m in milestones if m <= step)
        return base_lr * gamma**n

    return lr


def constant_lr(base_lr):
    return lambda step: base_lr


def with_warmup(schedule, warmup_iter=-1):
    """Linear warmup from 0 over warmup_iter steps, then the base schedule
    (reference `update_learning_rate`, `base_model.py:183-205`)."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def lr(step):
        if step < warmup_iter:
            return schedule(0) * step / warmup_iter
        return schedule(step)

    return lr


SCHEDULERS = {
    "MultiStepRestartLR": multi_step_restart_lr,
    "MultiStepLR": multi_step_lr,
    "LinearLR": linear_lr,
    "VibrateLR": vibrate_lr,
    "CosineAnnealingRestartLR": cosine_annealing_restart_lr,
    "CosineAnnealingRestartCyclicLR": cosine_annealing_restart_cyclic_lr,
    "ConstantLR": constant_lr,
    "TrueCosineAnnealingLR": lambda base_lr, T_max, eta_min=0.0: (
        lambda step: eta_min
        + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * min(step, T_max) / T_max))
    ),
}


def build_scheduler(opt: dict, base_lr: float, total_iter: int | None = None,
                    warmup_iter: int = -1):
    """Build a schedule from a YAML `scheduler:` block."""
    opt = dict(opt)
    name = opt.pop("type")
    if name in ("LinearLR", "VibrateLR") and "total_iter" not in opt:
        opt["total_iter"] = total_iter
    if name == "TrueCosineAnnealingLR" and "T_max" not in opt:
        opt["T_max"] = total_iter
    # basicsr yaml uses eta_min / eta_mins; tolerate either spelling
    fn = SCHEDULERS[name](base_lr, **opt)
    return with_warmup(fn, warmup_iter)
