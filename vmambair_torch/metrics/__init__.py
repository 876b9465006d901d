"""Validation metrics, resolved by YAML `val.metrics.<name>.type` strings.

The port's counterpart of `vmambair_tpu/metrics/__init__.py`: PSNR and
SSIM (numpy, on the host), LPIPS and DISTS (VGG16), NIQE, and FID
(InceptionV3 or VGG19 features on the device, the distance on the host).
The learned metrics run on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import inspect
import logging

from ..utils.registry import METRIC_REGISTRY
from .dists import calculate_dists
from .fid import calculate_fid, compute_statistics, extract_vgg_features
from .lpips import calculate_lpips
from .niqe import calculate_niqe
from .psnr_ssim import calculate_psnr, calculate_ssim

logger = logging.getLogger("vmambair_torch")

# learned metrics that run on a seeded backbone when no converted weights
# are given: deterministic numbers, not comparable to published ones
_NEEDS_WEIGHTS = {"calculate_lpips", "calculate_dists", "calculate_fid"}
# no-reference metrics: the SR image alone
_NO_REFERENCE = {"calculate_niqe"}
_warned_uncalibrated = set()


def metric_is_calibrated(opt: dict) -> bool:
    """False when this metric config would run on the seeded fallback
    backbone (no `weights_path` / `inception_path` given)."""
    if opt.get("type") not in _NEEDS_WEIGHTS:
        return True
    return bool(opt.get("weights_path") or opt.get("inception_path"))


def metric_report_key(name: str, opt: dict) -> str:
    """The key a validation loop reports a metric under: its YAML name,
    suffixed `_uncalibrated` (with a one-time warning) when it runs on a
    seeded backbone, so that such a number is never logged under the
    published metric's name."""
    if metric_is_calibrated(opt):
        return name
    if name not in _warned_uncalibrated:
        _warned_uncalibrated.add(name)
        logger.warning(
            "metric '%s' (%s) has no pretrained weights configured — it "
            "runs on a seeded RANDOM backbone and is NOT comparable to "
            "published numbers; reporting it as '%s_uncalibrated' "
            "(supply weights_path= a converted .npz, see "
            "scripts/convert_metric_weights.py)",
            name, opt.get("type"), name)
    return f"{name}_uncalibrated"


def calculate_metric(opt: dict, *args, device=None):
    """`{type: calculate_psnr, crop_border: 4, ...}` -> the registered
    function called with the remaining keys as keyword arguments. A
    no-reference metric (NIQE) takes the first image only; `device`,
    where one is given, goes to every metric that takes keywords beyond
    its own (PSNR and SSIM ignore it: they run on the host)."""
    opt = dict(opt)
    metric_type = opt.pop("type")
    fn = METRIC_REGISTRY.get(metric_type)
    if metric_type in _NO_REFERENCE:
        args = args[:1]
    params = inspect.signature(fn).parameters
    if device is not None and ("device" in params or any(
            p.kind is p.VAR_KEYWORD for p in params.values())):
        opt.setdefault("device", device)
    return fn(*args, **opt)


__all__ = ["calculate_metric", "metric_is_calibrated", "metric_report_key",
           "calculate_psnr", "calculate_ssim", "calculate_lpips",
           "calculate_dists", "calculate_niqe", "calculate_fid",
           "compute_statistics", "extract_vgg_features", "METRIC_REGISTRY"]
