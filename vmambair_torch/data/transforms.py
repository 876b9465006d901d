"""Host-side (numpy) image transforms of the data pipeline.

The port's copy of `vmambair_tpu/data/transforms.py`: mod_crop, the paired
random crop, hflip / vflip / rot90 augmentation and the 8-way
`random_augmentation` of the deraining dataset. The random draws come from
the `random.Random` passed in, so a seed gives the JAX package's crops.
"""

from __future__ import annotations

import random

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def paired_random_crop(img_gts, img_lqs, gt_patch_size: int, scale: int,
                       rng: random.Random | None = None):
    """A random LQ patch and the GT patch scale x over it."""
    rng = rng or random
    single_gt = isinstance(img_gts, np.ndarray)
    single_lq = isinstance(img_lqs, np.ndarray)
    if single_gt:
        img_gts = [img_gts]
    if single_lq:
        img_lqs = [img_lqs]
    h_lq, w_lq = img_lqs[0].shape[:2]
    h_gt, w_gt = img_gts[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(
            f"GT size {h_gt}x{w_gt} is not {scale}x of LQ {h_lq}x{w_lq}")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(
            f"LQ {h_lq}x{w_lq} smaller than patch {lq_patch_size}")
    top = rng.randint(0, h_lq - lq_patch_size)
    left = rng.randint(0, w_lq - lq_patch_size)
    img_lqs = [img[top:top + lq_patch_size, left:left + lq_patch_size, ...]
               for img in img_lqs]
    top_gt, left_gt = top * scale, left * scale
    img_gts = [img[top_gt:top_gt + gt_patch_size,
                   left_gt:left_gt + gt_patch_size, ...] for img in img_gts]
    return (img_gts[0] if single_gt else img_gts,
            img_lqs[0] if single_lq else img_lqs)


def augment(imgs, hflip=True, rotation=True,
            rng: random.Random | None = None):
    """Random hflip, vflip and 90-degree rotation (each p = 0.5), the same
    for every image of the list."""
    rng = rng or random
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = rotation and rng.random() < 0.5
    do_rot90 = rotation and rng.random() < 0.5

    def _aug(img):
        if do_hflip:
            img = img[:, ::-1, ...]
        if do_vflip:
            img = img[::-1, :, ...]
        if do_rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    if isinstance(imgs, np.ndarray):
        return _aug(imgs)
    return [_aug(img) for img in imgs]


def data_augmentation(image: np.ndarray, mode: int) -> np.ndarray:
    """The 8 dihedral transforms, selected by mode 0-7."""
    if mode not in range(8):
        raise ValueError(f"invalid augmentation mode {mode}")
    out = np.rot90(image, k=mode // 2)
    if mode % 2:
        out = np.flipud(out)
    return np.ascontiguousarray(out)


def random_augmentation(*args, rng: random.Random | None = None):
    """One random dihedral transform applied to all given images."""
    rng = rng or random
    mode = rng.randint(0, 7)
    return [data_augmentation(a, mode) for a in args]
