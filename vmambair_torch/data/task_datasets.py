"""The Restormer-lineage task datasets: deblur, Gaussian denoising and
dual-pixel defocus deblurring.

The port's copy of `vmambair_tpu/data/task_datasets.py`, with the port's
PNG codec (`utils/img_util.py`) in place of `cv2` (so that they need no
`cv2`) and numpy's `symmetric` pad in place of
`cv2.copyMakeBorder(..., BORDER_REFLECT)`. The draws come from the
`random.Random` passed to `__getitem__` in the JAX package's order, so a
seed gives its samples:

* `DeblurPairedDataset`: paired blur / sharp images, the mechanics of
  `PairedImageDataset`;
* `Dataset_GaussianDenoising` (also `GaussianDenoisingPairedDataset`):
  GT-only; the LQ is the GT plus Gaussian noise of a constant, random or
  chosen sigma (train) or `sigma_test`; `in_ch` 1 reads the image as
  grayscale;
* `Dataset_DefocusDeblur_DualPixel_16bit`: the 16-bit left and right
  views stacked to 6 channels, a 16-bit GT.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from ..utils.img_util import imfrombytes, imread
from ..utils.registry import DATASET_REGISTRY
from .data_util import paired_paths_from_folders, paths_from_folder
from .file_client import FileClient
from .paired_dataset import PairedImageDataset
from .transforms import random_augmentation


@DATASET_REGISTRY.register(name="DeblurPairedDataset")
class DeblurPairedDataset(PairedImageDataset):
    """Paired blur / sharp training data (the Restormer deblur lineage)."""


@DATASET_REGISTRY.register(name="Dataset_GaussianDenoising")
@DATASET_REGISTRY.register(name="GaussianDenoisingPairedDataset")
class GaussianDenoisingDataset:
    def __init__(self, opt: Dict):
        self.opt = opt
        self.file_client: Optional[FileClient] = None
        self.io_backend_opt = dict(opt.get("io_backend", {"type": "disk"}))
        self.gt_paths = paths_from_folder(opt["dataroot_gt"])
        self.sigma_type = opt.get("sigma_type", "constant")
        self.sigma_range = opt.get("sigma_range", 15)
        self.sigma_test = float(opt.get("sigma_test", 15))
        self.in_ch = int(opt.get("in_ch", 3))
        self.phase = opt.get("phase", "train")

    def __len__(self):
        return len(self.gt_paths)

    def _sigma(self, rng) -> float:
        if self.phase != "train":
            return self.sigma_test
        if self.sigma_type == "constant":
            return float(self.sigma_range)
        if self.sigma_type == "random":
            lo, hi = self.sigma_range
            return float(lo + rng.random() * (hi - lo))
        if self.sigma_type == "choice":
            return float(rng.choice(list(self.sigma_range)))
        raise ValueError(self.sigma_type)

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        rng = rng or random
        if self.file_client is None:
            backend = dict(self.io_backend_opt)
            self.file_client = FileClient(backend.pop("type", "disk"),
                                          **backend)
        gt_path = self.gt_paths[index]
        img = imfrombytes(self.file_client.get(gt_path, "gt"),
                          "color" if self.in_ch == 3 else "grayscale",
                          float32=True)
        if img.ndim == 2:
            img = img[..., None]
        elif self.in_ch == 3:
            img = img[..., ::-1]  # BGR -> RGB

        if self.phase == "train":
            gt_size = int(self.opt.get("gt_size", 128))
            h, w = img.shape[:2]
            if h < gt_size or w < gt_size:
                # cv2.BORDER_REFLECT repeats the edge pixel: `symmetric`
                img = np.pad(img, [(0, max(0, gt_size - h)),
                                   (0, max(0, gt_size - w)), (0, 0)],
                             mode="symmetric")
            h, w = img.shape[:2]
            top = rng.randrange(h - gt_size + 1)
            left = rng.randrange(w - gt_size + 1)
            img = img[top:top + gt_size, left:left + gt_size]
            if self.opt.get("geometric_augs", True):
                img = random_augmentation(img, rng=rng)[0]

        sigma = self._sigma(rng) / 255.0
        np_rng = np.random.RandomState(rng.randrange(2**31))
        noise = np_rng.normal(0, sigma, img.shape).astype(np.float32)
        lq = img + noise
        return {
            "lq": np.ascontiguousarray(lq, np.float32),
            "gt": np.ascontiguousarray(img, np.float32),
            "lq_path": gt_path,
            "gt_path": gt_path,
            "sigma": np.float32(sigma),
        }


@DATASET_REGISTRY.register(name="Dataset_DefocusDeblur_DualPixel_16bit")
class DualPixelDefocusDataset:
    """Dual-pixel defocus deblurring: 16-bit left / right views stacked to
    6 channels (left first, each RGB), a 16-bit GT, all in [0, 1]."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.paths = paired_paths_from_folders(
            [opt["dataroot_lqL"], opt["dataroot_lqR"], opt["dataroot_gt"]],
            ["lqL", "lqR", "gt"],
            opt.get("filename_tmpl", "{}"),
        )
        self.phase = opt.get("phase", "train")

    def __len__(self):
        return len(self.paths)

    @staticmethod
    def _read16(path):
        img = imread(path, "unchanged").astype(np.float32) / 65535.0
        if img.ndim == 2:
            return img[..., None]
        return img[..., ::-1]  # BGR -> RGB

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        rng = rng or random
        entry = self.paths[index]
        lqL = self._read16(entry["lqL_path"])
        lqR = self._read16(entry["lqR_path"])
        gt = self._read16(entry["gt_path"])
        if self.phase == "train":
            gt_size = int(self.opt.get("gt_size", 128))
            h, w = lqL.shape[:2]
            top = rng.randrange(max(1, h - gt_size + 1))
            left = rng.randrange(max(1, w - gt_size + 1))
            sl = np.s_[top:top + gt_size, left:left + gt_size]
            lqL, lqR, gt = lqL[sl], lqR[sl], gt[sl]
            if self.opt.get("geometric_augs", True):
                lqL, lqR, gt = random_augmentation(lqL, lqR, gt, rng=rng)
        lq = np.concatenate([lqL, lqR], axis=-1)
        return {
            "lq": np.ascontiguousarray(lq, np.float32),
            "gt": np.ascontiguousarray(gt, np.float32),
            "lq_path": entry["lqL_path"],
            "gt_path": entry["gt_path"],
        }
