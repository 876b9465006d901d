"""Logging: the port's logger, the per-iteration message logger,
TensorBoard, and the environment banner.

The port's counterpart of `vmambair_tpu/utils/logger.py`. The TensorBoard
writer is imported only when a config asks for it, and raises if the
`tensorboard` package is not installed.
"""

from __future__ import annotations

import datetime
import logging
import sys
import time
from typing import Optional

import torch

LOGGER_NAME = "vmambair_torch"
_FMT = "%(asctime)s %(levelname)s: %(message)s"


def get_root_logger(logger_name: str = LOGGER_NAME, log_level=logging.INFO,
                    log_file: Optional[str] = None) -> logging.Logger:
    """The package logger: one stream handler, and a file handler on
    `log_file` that replaces the previous call's file."""
    logger = logging.getLogger(logger_name)
    if not any(getattr(h, "_vmt", None) == "stream" for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FMT))
        sh._vmt = "stream"
        logger.addHandler(sh)
    if log_file is not None:
        for h in [h for h in logger.handlers
                  if getattr(h, "_vmt", None) == "file"]:
            logger.removeHandler(h)
            h.close()
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(logging.Formatter(_FMT))
        fh._vmt = "file"
        logger.addHandler(fh)
    logger.propagate = False
    logger.setLevel(log_level)
    return logger


def init_tb_logger(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "logger.use_tb_logger is set, but the tensorboard package is "
            "not installed; set use_tb_logger: false") from e
    return SummaryWriter(log_dir=log_dir)


def get_env_info() -> str:
    msg = (f"\n\tPyTorch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"Python {sys.version.split()[0]}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            msg += (f"\n\tcuda:{i} {torch.cuda.get_device_name(i)}, "
                    f"capability {torch.cuda.get_device_capability(i)}")
    else:
        msg += "\n\tno CUDA device"
    return msg


class MessageLogger:
    """Formats the per-iteration training log (learning rate, iteration
    and data time, ETA, losses) and forwards scalars to TensorBoard."""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        self.interval = opt["logger"]["print_freq"]
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.use_tb_logger = opt["logger"].get("use_tb_logger", False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: dict):
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch", 0)
        lrs = log_vars.pop("lrs", None)
        if lrs is None:
            lr = log_vars.pop("lr", None)
            lrs = [lr] if lr is not None else []
        msg = (f"[{self.exp_name[:30]}..][epoch:{epoch:3d}, "
               f"iter:{current_iter:8,d}, lr:(")
        msg += ", ".join(f"{lr:.3e}" for lr in lrs) + ")] "
        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time", 0.0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(
                current_iter - self.start_iter + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            msg += (f"[eta: {eta_str}, time (data): {iter_time:.3f} "
                    f"({data_time:.3f})] ")
        for k, v in log_vars.items():
            msg += f"{k}: {v:.4e} "
            if self.tb_logger and self.use_tb_logger:
                key = f"losses/{k}" if k.startswith("l_") else k
                self.tb_logger.add_scalar(key, v, current_iter)
        self.logger.info(msg)
