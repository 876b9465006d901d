"""Seeding, experiment directories, file scans, resume discovery, timers.

The port's copy of `vmambair_tpu/utils/misc.py`. `set_random_seed` also
seeds torch; `check_resume` points the nets at the port's
`net_g_<iter>.pth` / `net_d_<iter>.pth` checkpoints (`train/checkpoint.py`),
not JAX's `.ckpt`, and, as the reference trainer does, over a pretrained
path the options give, from `params` (JAX's copy keeps that path and
key: a resumed GAN run would restart G from its S1 checkpoint).
"""

from __future__ import annotations

import os
import random
import time
from os import path as osp
from typing import Optional

import numpy as np
import torch


def set_random_seed(seed: int):
    """Seeds Python's, numpy's and torch's generators (every device's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str):
    """mkdir; an existing directory is first renamed with a timestamp
    suffix, so an old experiment is never overwritten."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Renaming it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: dict):
    path_opt = dict(opt["path"])
    if opt["is_train"]:
        mkdir_and_rename(path_opt.pop("experiments_root"))
    else:
        mkdir_and_rename(path_opt.pop("results_root"))
    for key, p in path_opt.items():
        if ("strict_load" in key or "pretrain" in key or "resume" in key
                or "param_key" in key or p is None):
            continue
        os.makedirs(p, exist_ok=True)


def scandir(dir_path: str, suffix=None, recursive=False, full_path=False):
    """Yields the files under dir_path (relative paths unless full_path),
    hidden ones skipped, filtered by suffix."""
    root = dir_path
    suffixes = (suffix,) if isinstance(suffix, str) else suffix

    def _scan(d):
        for entry in os.scandir(d):
            if entry.name.startswith("."):
                continue
            if entry.is_file():
                rel = entry.path if full_path else osp.relpath(entry.path,
                                                               root)
                if suffixes is None or rel.endswith(tuple(suffixes)):
                    yield rel
            elif recursive and entry.is_dir():
                yield from _scan(entry.path)

    return _scan(dir_path)


def find_latest_state(state_dir: str) -> Optional[str]:
    """The highest-iteration `<iter>.state` in state_dir, for auto-resume;
    None if there is none."""
    if not osp.isdir(state_dir):
        return None
    iters = sorted(int(f[:-len(".state")]) for f in os.listdir(state_dir)
                   if f.endswith(".state") and f[:-len(".state")].isdigit())
    if not iters:
        return None
    return osp.join(state_dir, f"{iters[-1]}.state")


def check_resume(opt: dict, resume_iter: int):
    """On resume, points `pretrain_network_g` (and `_d`) at the resumed
    iteration's `net_g_<iter>.pth` (`net_d_<iter>.pth`) where it exists,
    over a path the options give (the GAN stage's S1 checkpoint would
    restart G from there), and `param_key_g` from `params_ema` to
    `params`: the weights the resumed optimizer state belongs to. The
    reference trainer's `check_resume` does both."""
    if not opt["path"].get("resume_state"):
        return
    for net in ("network_g", "network_d"):
        name = net.replace("network_", "net_")
        candidate = osp.join(opt["path"]["models"],
                             f"{name}_{resume_iter}.pth")
        if net in opt and osp.exists(candidate):
            opt["path"][f"pretrain_{net}"] = candidate
            key = net.replace("network_", "param_key_")
            if opt["path"].get(key) == "params_ema":
                opt["path"][key] = "params"


class AvgTimer:
    """A running mean of host-clock intervals (over the last `window`):
    `toc` returns the time since the last `tic` or `toc` and restarts."""

    def __init__(self, window: int = 200):
        self.window = window
        self.avg_time = 0.0
        self.count = 0
        self.tic()

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self):
        now = time.perf_counter()
        dt = now - self.start_time
        self.count += 1
        self.avg_time += (dt - self.avg_time) / min(self.count, self.window)
        self.start_time = now
        return dt

    def get_avg_time(self):
        return self.avg_time
