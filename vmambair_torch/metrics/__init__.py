"""Validation metrics, resolved by YAML `val.metrics.<name>.type` strings.

The port's counterpart of `vmambair_tpu/metrics/__init__.py`: PSNR and SSIM
are ported; the learned metrics (`metrics/lpips.py`, `dists.py`, `fid.py`,
`niqe.py`) are not yet and raise when a config asks for one.
"""

from __future__ import annotations

from ..utils.registry import METRIC_REGISTRY
from .psnr_ssim import calculate_psnr, calculate_ssim

_NOT_PORTED = {"calculate_lpips", "calculate_dists", "calculate_fid",
               "calculate_niqe"}


def metric_report_key(name: str, opt: dict) -> str:
    """The key a validation loop reports a metric under: its YAML name
    (the JAX package suffixes learned metrics run on a random backbone,
    which the port does not have)."""
    _check(opt)
    return name


def _check(opt: dict) -> None:
    if opt.get("type") in _NOT_PORTED:
        raise NotImplementedError(
            f"metric {opt['type']}: the learned metrics (metrics/lpips.py, "
            "dists.py, fid.py, niqe.py) are not ported to vmambair_torch "
            "yet")


def calculate_metric(opt: dict, *args):
    """`{type: calculate_psnr, crop_border: 4, ...}` -> the registered
    function called with the remaining keys as keyword arguments."""
    _check(opt)
    opt = dict(opt)
    return METRIC_REGISTRY.get(opt.pop("type"))(*args, **opt)


__all__ = ["calculate_metric", "metric_report_key", "calculate_psnr",
           "calculate_ssim", "METRIC_REGISTRY"]
