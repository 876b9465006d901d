"""InceptionV3's pool3 features (2048-d, the FID network), PyTorch, NCHW:
the port's copy of `vmambair_tpu/metrics/inception.py`.

Built from the same `.npz` the JAX package reads (`<module>/kernel` HWIO
with the BatchNorm folded in, `<module>/bias`; written from the
`pt_inception-2015-12-05` checkpoint by
`scripts/convert_metric_weights.py --inception`). The FID blocks: the
3x3 average pools exclude the padding, Mixed_7c's branch pool is a
padded 3x3 max pool. The input resize to 299x299 is `jax.image.resize`'s
antialiased bilinear, as `ops/degradation.py::resize_to` computes it.
The convolutions are cuDNN's (JAX runs them outside Pallas), in full
fp32. `INCEPTION_SPEC` lists every convolution, and
`seeded_inception_npz` writes a seeded stand-in for the checkpoint (no
weights are downloaded).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.degradation import resize_to
from .common import full_fp32


def _block_a(pre, cin, pool):
    return [(f"{pre}.branch1x1", 64, cin, 1, 1),
            (f"{pre}.branch5x5_1", 48, cin, 1, 1),
            (f"{pre}.branch5x5_2", 64, 48, 5, 5),
            (f"{pre}.branch3x3dbl_1", 64, cin, 1, 1),
            (f"{pre}.branch3x3dbl_2", 96, 64, 3, 3),
            (f"{pre}.branch3x3dbl_3", 96, 96, 3, 3),
            (f"{pre}.branch_pool", pool, cin, 1, 1)]


def _block_c(pre, c7):
    return [(f"{pre}.branch1x1", 192, 768, 1, 1),
            (f"{pre}.branch7x7_1", c7, 768, 1, 1),
            (f"{pre}.branch7x7_2", c7, c7, 1, 7),
            (f"{pre}.branch7x7_3", 192, c7, 7, 1),
            (f"{pre}.branch7x7dbl_1", c7, 768, 1, 1),
            (f"{pre}.branch7x7dbl_2", c7, c7, 7, 1),
            (f"{pre}.branch7x7dbl_3", c7, c7, 1, 7),
            (f"{pre}.branch7x7dbl_4", c7, c7, 7, 1),
            (f"{pre}.branch7x7dbl_5", 192, c7, 1, 7),
            (f"{pre}.branch_pool", 192, 768, 1, 1)]


def _block_e(pre, cin):
    return [(f"{pre}.branch1x1", 320, cin, 1, 1),
            (f"{pre}.branch3x3_1", 384, cin, 1, 1),
            (f"{pre}.branch3x3_2a", 384, 384, 1, 3),
            (f"{pre}.branch3x3_2b", 384, 384, 3, 1),
            (f"{pre}.branch3x3dbl_1", 448, cin, 1, 1),
            (f"{pre}.branch3x3dbl_2", 384, 448, 3, 3),
            (f"{pre}.branch3x3dbl_3a", 384, 384, 1, 3),
            (f"{pre}.branch3x3dbl_3b", 384, 384, 3, 1),
            (f"{pre}.branch_pool", 192, cin, 1, 1)]


# (module, out channels, in channels, kh, kw) of every convolution
INCEPTION_SPEC = (
    [("Conv2d_1a_3x3", 32, 3, 3, 3), ("Conv2d_2a_3x3", 32, 32, 3, 3),
     ("Conv2d_2b_3x3", 64, 32, 3, 3), ("Conv2d_3b_1x1", 80, 64, 1, 1),
     ("Conv2d_4a_3x3", 192, 80, 3, 3)]
    + _block_a("Mixed_5b", 192, 32) + _block_a("Mixed_5c", 256, 64)
    + _block_a("Mixed_5d", 288, 64)
    + [("Mixed_6a.branch3x3", 384, 288, 3, 3),
       ("Mixed_6a.branch3x3dbl_1", 64, 288, 1, 1),
       ("Mixed_6a.branch3x3dbl_2", 96, 64, 3, 3),
       ("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)]
    + _block_c("Mixed_6b", 128) + _block_c("Mixed_6c", 160)
    + _block_c("Mixed_6d", 160) + _block_c("Mixed_6e", 192)
    + [("Mixed_7a.branch3x3_1", 192, 768, 1, 1),
       ("Mixed_7a.branch3x3_2", 320, 192, 3, 3),
       ("Mixed_7a.branch7x7x3_1", 192, 768, 1, 1),
       ("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7),
       ("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1),
       ("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)]
    + _block_e("Mixed_7b", 1280) + _block_e("Mixed_7c", 2048))


def seeded_inception_npz(path: str, seed: int = 0) -> str:
    """Writes an `.npz` in the converted checkpoint's layout with seeded
    weights (`RandomState(seed)`, he-normal HWIO kernels, biases of
    standard deviation 0.05): the network's wiring without its training,
    for tests and smoke runs."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for mod, o, i, kh, kw in INCEPTION_SPEC:
        arrays[f"{mod}/kernel"] = rng.normal(
            0, math.sqrt(2.0 / (i * kh * kw)), (kh, kw, i, o)).astype(
                np.float32)
        arrays[f"{mod}/bias"] = rng.normal(0, 0.05, o).astype(np.float32)
    np.savez(path, **arrays)
    return path


def load_inception_params(weights_path: str, device="cuda") -> Dict[str, tuple]:
    """The `.npz` -> {module: (OIHW weight, bias)} on `device`."""
    data = np.load(weights_path)
    leaves: Dict[str, dict] = {}
    for key in data.files:
        mod, _, leaf = key.rpartition("/")
        if leaf in ("kernel", "bias"):
            leaves.setdefault(mod, {})[leaf] = data[key]
    missing = [m for m, p in leaves.items() if len(p) != 2]
    if missing or "Conv2d_1a_3x3" not in leaves:
        raise KeyError(
            f"not an inception npz (incomplete modules: {missing[:3]})")
    return {m: (torch.from_numpy(np.ascontiguousarray(np.transpose(
        np.asarray(p["kernel"], np.float32), (3, 2, 0, 1)))).to(device),
        torch.from_numpy(np.asarray(p["bias"], np.float32)).to(device))
        for m, p in leaves.items()}


def _conv(params, name, x, stride=1, padding=(0, 0)):
    w, b = params[name]
    return F.relu(F.conv2d(x, w, b, stride=stride, padding=padding))


def _maxpool3(x, stride, pad=0):
    return F.max_pool2d(x, 3, stride, pad)


def _avgpool3_excl(x):
    """3x3 stride-1 pad-1 average pool without the padding in its count
    (the FID blocks' pool)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _inception_a(p, pre, x):
    b1 = _conv(p, f"{pre}.branch1x1", x)
    b5 = _conv(p, f"{pre}.branch5x5_2", _conv(p, f"{pre}.branch5x5_1", x),
               padding=(2, 2))
    b3 = _conv(p, f"{pre}.branch3x3dbl_1", x)
    b3 = _conv(p, f"{pre}.branch3x3dbl_2", b3, padding=(1, 1))
    b3 = _conv(p, f"{pre}.branch3x3dbl_3", b3, padding=(1, 1))
    bp = _conv(p, f"{pre}.branch_pool", _avgpool3_excl(x))
    return torch.cat([b1, b5, b3, bp], 1)


def _inception_b(p, pre, x):
    b3 = _conv(p, f"{pre}.branch3x3", x, stride=2)
    bd = _conv(p, f"{pre}.branch3x3dbl_1", x)
    bd = _conv(p, f"{pre}.branch3x3dbl_2", bd, padding=(1, 1))
    bd = _conv(p, f"{pre}.branch3x3dbl_3", bd, stride=2)
    return torch.cat([b3, bd, _maxpool3(x, 2)], 1)


def _inception_c(p, pre, x):
    b1 = _conv(p, f"{pre}.branch1x1", x)
    b7 = _conv(p, f"{pre}.branch7x7_1", x)
    b7 = _conv(p, f"{pre}.branch7x7_2", b7, padding=(0, 3))
    b7 = _conv(p, f"{pre}.branch7x7_3", b7, padding=(3, 0))
    bd = _conv(p, f"{pre}.branch7x7dbl_1", x)
    bd = _conv(p, f"{pre}.branch7x7dbl_2", bd, padding=(3, 0))
    bd = _conv(p, f"{pre}.branch7x7dbl_3", bd, padding=(0, 3))
    bd = _conv(p, f"{pre}.branch7x7dbl_4", bd, padding=(3, 0))
    bd = _conv(p, f"{pre}.branch7x7dbl_5", bd, padding=(0, 3))
    bp = _conv(p, f"{pre}.branch_pool", _avgpool3_excl(x))
    return torch.cat([b1, b7, bd, bp], 1)


def _inception_d(p, pre, x):
    b3 = _conv(p, f"{pre}.branch3x3_2", _conv(p, f"{pre}.branch3x3_1", x),
               stride=2)
    b7 = _conv(p, f"{pre}.branch7x7x3_1", x)
    b7 = _conv(p, f"{pre}.branch7x7x3_2", b7, padding=(0, 3))
    b7 = _conv(p, f"{pre}.branch7x7x3_3", b7, padding=(3, 0))
    b7 = _conv(p, f"{pre}.branch7x7x3_4", b7, stride=2)
    return torch.cat([b3, b7, _maxpool3(x, 2)], 1)


def _inception_e(p, pre, x, pool: str):
    b1 = _conv(p, f"{pre}.branch1x1", x)
    b3 = _conv(p, f"{pre}.branch3x3_1", x)
    b3 = torch.cat([_conv(p, f"{pre}.branch3x3_2a", b3, padding=(0, 1)),
                    _conv(p, f"{pre}.branch3x3_2b", b3, padding=(1, 0))], 1)
    bd = _conv(p, f"{pre}.branch3x3dbl_1", x)
    bd = _conv(p, f"{pre}.branch3x3dbl_2", bd, padding=(1, 1))
    bd = torch.cat([_conv(p, f"{pre}.branch3x3dbl_3a", bd, padding=(0, 1)),
                    _conv(p, f"{pre}.branch3x3dbl_3b", bd, padding=(1, 0))],
                   1)
    # Mixed_7b (FIDInceptionE_1) pools by the exclude-pad average,
    # Mixed_7c (FIDInceptionE_2) by a padded 3x3 max pool
    pooled = _avgpool3_excl(x) if pool == "avg" else _maxpool3(x, 1, pad=1)
    bp = _conv(p, f"{pre}.branch_pool", pooled)
    return torch.cat([b1, b3, bd, bp], 1)


@torch.no_grad()
def inception_pool3(x: torch.Tensor, params, resize_input=True,
                    normalize_input=False) -> torch.Tensor:
    """x: (N, 3, H, W) RGB float32 in [0, 1] on the params' device ->
    (N, 2048) pool3 features. normalize_input maps [0, 1] to [-1, 1]."""
    with full_fp32():
        if resize_input:
            x = resize_to(x, (299, 299), 0)
        if normalize_input:
            x = 2.0 * x - 1.0
        x = _conv(params, "Conv2d_1a_3x3", x, stride=2)
        x = _conv(params, "Conv2d_2a_3x3", x)
        x = _conv(params, "Conv2d_2b_3x3", x, padding=(1, 1))
        x = _maxpool3(x, 2)
        x = _conv(params, "Conv2d_3b_1x1", x)
        x = _conv(params, "Conv2d_4a_3x3", x)
        x = _maxpool3(x, 2)
        for pre in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _inception_a(params, pre, x)
        x = _inception_b(params, "Mixed_6a", x)
        for pre in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _inception_c(params, pre, x)
        x = _inception_d(params, "Mixed_7a", x)
        x = _inception_e(params, "Mixed_7b", x, pool="avg")
        x = _inception_e(params, "Mixed_7c", x, pool="max")
        return x.mean((2, 3))
