"""Paired LQ/GT image datasets.

The port's copy of `vmambair_tpu/data/paired_dataset.py`: folder and
meta-info modes, the paired random crop (with the deraining pad-to-gt_size
first), hflip / rot or the 8-way `geometric_augs`, mean / std
normalisation. Images are decoded by the port's codec
(`utils/img_util.py`). Samples are numpy dicts: {'lq': HWC float32 RGB in
[0, 1], 'gt': ..., 'lq_path': str, 'gt_path': str}.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from ..utils.img_util import imfrombytes, padding
from ..utils.registry import DATASET_REGISTRY
from .data_util import (
    paired_paths_from_folders,
    paired_paths_from_meta_info_file,
    paths_from_folder,
)
from .file_client import FileClient
from .transforms import augment, paired_random_crop, random_augmentation


def _normalize(img, mean, std):
    if mean is not None:
        img = (img - np.asarray(mean, np.float32)) / np.asarray(
            std, np.float32)
    return img


def _file_client(opt: Dict) -> FileClient:
    backend_opt = dict(opt.get("io_backend", {"type": "disk"}))
    return FileClient(backend_opt.pop("type"), **backend_opt)


@DATASET_REGISTRY.register(name="PairedImageDataset")
@DATASET_REGISTRY.register(name="Dataset_PairedImage")
class PairedImageDataset:
    def __init__(self, opt: Dict):
        self.opt = opt
        self.file_client = _file_client(opt)
        self.mean = opt.get("mean")
        self.std = opt.get("std")
        folders = [opt["dataroot_lq"], opt["dataroot_gt"]]
        tmpl = opt.get("filename_tmpl", "{}")
        if opt.get("meta_info_file"):
            self.paths = paired_paths_from_meta_info_file(
                folders, ["lq", "gt"], opt["meta_info_file"], tmpl)
        else:
            self.paths = paired_paths_from_folders(folders, ["lq", "gt"],
                                                   tmpl)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        rng = rng or random
        scale = self.opt.get("scale", 1)
        gt_path = self.paths[index]["gt_path"]
        lq_path = self.paths[index]["lq_path"]
        img_gt = imfrombytes(self.file_client.get(gt_path, "gt"),
                             float32=True)
        img_lq = imfrombytes(self.file_client.get(lq_path, "lq"),
                             float32=True)

        if self.opt.get("phase") == "train":
            gt_size = self.opt["gt_size"]
            if self.opt.get("pad_to_gt_size", True):
                img_lq, img_gt = padding(img_lq, img_gt, gt_size // scale)
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, gt_size,
                                                scale, rng)
            if self.opt.get("geometric_augs"):
                img_gt, img_lq = random_augmentation(img_gt, img_lq, rng=rng)
            else:
                img_gt, img_lq = augment(
                    [img_gt, img_lq],
                    self.opt.get("use_hflip", self.opt.get("use_flip", True)),
                    self.opt.get("use_rot", True), rng=rng)

        # BGR -> RGB
        img_gt = _normalize(np.ascontiguousarray(img_gt[..., ::-1]),
                            self.mean, self.std)
        img_lq = _normalize(np.ascontiguousarray(img_lq[..., ::-1]),
                            self.mean, self.std)
        if self.opt.get("phase") != "train":
            # the GT cropped to scale x the LQ, as the reference does
            h, w = img_lq.shape[:2]
            img_gt = img_gt[: h * scale, : w * scale]
        return {"lq": img_lq.astype(np.float32),
                "gt": img_gt.astype(np.float32),
                "lq_path": lq_path, "gt_path": gt_path}


@DATASET_REGISTRY.register(name="SingleImageDataset")
class SingleImageDataset:
    """LQ-only dataset for inference without GT."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.file_client = _file_client(opt)
        self.mean = opt.get("mean")
        self.std = opt.get("std")
        self.paths = paths_from_folder(opt["dataroot_lq"])

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index, rng=None):
        lq_path = self.paths[index]
        img_lq = imfrombytes(self.file_client.get(lq_path, "lq"),
                             float32=True)
        img_lq = _normalize(np.ascontiguousarray(img_lq[..., ::-1]),
                            self.mean, self.std)
        return {"lq": img_lq.astype(np.float32), "lq_path": lq_path}
