"""Real-ESRGAN GT-only dataset with per-sample blur-kernel synthesis.

The port's copy of `vmambair_tpu/data/realesrgan_dataset.py`:
`RealESRGANDataset` (registered also as `RealESRGANDataset400`,
`RealESRGANDataset_memory` and `DiffIRGANDataset`) loads a clean GT image,
retries IO errors with a random resample, flips it, pads (reflect-101) or
crops it to the fixed square `crop_pad_size`, and samples two random mixed
blur kernels and a final sinc kernel (or a pulse), each padded to 21x21.
The on-device synthesis (`train/realesrgan_model.py`) consumes them.

The draws keep the JAX package's order: the `random.Random` passed in
gives the flips, the crop, each kernel's size and each kernel's
`np.random.RandomState` seed, so one seed gives its crops and kernels bit
for bit. `np.pad(mode="reflect")` takes the place of cv2's
`BORDER_REFLECT_101`: the same reflection without the edge pixel, and no
cv2 needed.

`RealESRGANPairedDataset` (and `DiffIRGANPairedDataset`) is the paired
lq/gt dataset of validation and paired stage-2 training.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, Optional

import numpy as np

from ..utils.img_util import imfrombytes
from ..utils.registry import DATASET_REGISTRY
from .data_util import paths_from_folder_or_meta
from .degradations import (
    circular_lowpass_kernel,
    pad_kernel,
    random_mixed_kernels,
)
from .file_client import FileClient
from .paired_dataset import PairedImageDataset
from .transforms import augment


@DATASET_REGISTRY.register(name="RealESRGANDataset")
@DATASET_REGISTRY.register(name="RealESRGANDataset400")
@DATASET_REGISTRY.register(name="RealESRGANDataset_memory")
@DATASET_REGISTRY.register(name="DiffIRGANDataset")
class RealESRGANDataset:
    _SINC_PROB_THRESH = 13  # kernels < 13px get pulse-width sinc cutoffs

    def __init__(self, opt: Dict):
        self.opt = opt
        self.file_client: Optional[FileClient] = None
        self.io_backend_opt = dict(opt.get("io_backend", {"type": "disk"}))
        self.gt_folder = opt["dataroot_gt"]
        self.paths = paths_from_folder_or_meta(
            self.gt_folder, opt.get("meta_info"),
            io_type=self.io_backend_opt.get("type", "disk"))
        # crop_pad_size: 400 for the `400` variant, else 600
        default_crop = 400 if "400" in opt.get("type", "") else 600
        self.crop_pad_size = int(opt.get("crop_pad_size", default_crop))

        self.kernel_list = opt["kernel_list"]
        self.kernel_prob = opt["kernel_prob"]
        self.blur_sigma = opt["blur_sigma"]
        self.betag_range = opt["betag_range"]
        self.betap_range = opt["betap_range"]
        self.sinc_prob = opt["sinc_prob"]
        self.kernel_list2 = opt["kernel_list2"]
        self.kernel_prob2 = opt["kernel_prob2"]
        self.blur_sigma2 = opt["blur_sigma2"]
        self.betag_range2 = opt["betag_range2"]
        self.betap_range2 = opt["betap_range2"]
        self.sinc_prob2 = opt["sinc_prob2"]
        self.final_sinc_prob = opt["final_sinc_prob"]
        self.kernel_range = [2 * v + 1 for v in range(3, 11)]  # 7..21
        self.pulse_tensor = np.zeros((21, 21), np.float32)
        self.pulse_tensor[10, 10] = 1.0

    def __len__(self):
        return len(self.paths)

    def _load_gt(self, index: int, rng: random.Random) -> np.ndarray:
        """The GT image as BGR float32 HWC; on an IO error, up to 3 retries
        of another image drawn from `rng`, a second apart."""
        if self.file_client is None:
            opt = dict(self.io_backend_opt)
            self.file_client = FileClient(opt.pop("type", "disk"), **opt)
        gt_path = self.paths[index]
        for _ in range(3):
            try:
                return imfrombytes(self.file_client.get(gt_path, "gt"),
                                   float32=True)
            except Exception:
                gt_path = self.paths[rng.randrange(len(self.paths))]
                time.sleep(1)
        return imfrombytes(self.file_client.get(gt_path, "gt"), float32=True)

    def _sample_kernel(self, rng, kernel_range, sinc_prob, kernel_list,
                       kernel_prob, blur_sigma, betag_range, betap_range):
        np_rng = np.random.RandomState(rng.randrange(2**31))
        kernel_size = rng.choice(kernel_range)
        if np_rng.uniform() < sinc_prob:
            if kernel_size < self._SINC_PROB_THRESH:
                omega_c = np_rng.uniform(np.pi / 3, np.pi)
            else:
                omega_c = np_rng.uniform(np.pi / 5, np.pi)
            kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=0)
        else:
            kernel = random_mixed_kernels(
                kernel_list, kernel_prob, kernel_size,
                blur_sigma, blur_sigma, (-math.pi, math.pi),
                betag_range, betap_range, noise_range=None, rng=np_rng)
        return pad_kernel(kernel, 21).astype(np.float32)

    def __getitem__(self, index: int, rng: Optional[random.Random] = None):
        rng = rng or random
        img_gt = self._load_gt(index, rng)

        # flip, then pad (reflect-101) or crop to the fixed square
        img_gt = augment(img_gt, self.opt.get("use_hflip", True),
                         self.opt.get("use_rot", True), rng=rng)
        h, w = img_gt.shape[:2]
        size = self.crop_pad_size
        if h < size or w < size:
            ph, pw = max(0, size - h), max(0, size - w)
            img_gt = np.pad(img_gt, ((0, ph), (0, pw), (0, 0)),
                            mode="reflect")
        h, w = img_gt.shape[:2]
        if h > size or w > size:
            top = rng.randrange(h - size + 1)
            left = rng.randrange(w - size + 1)
            img_gt = img_gt[top:top + size, left:left + size, ...]

        kernel1 = self._sample_kernel(
            rng, self.kernel_range, self.sinc_prob, self.kernel_list,
            self.kernel_prob, self.blur_sigma, self.betag_range,
            self.betap_range)
        kernel2 = self._sample_kernel(
            rng, self.kernel_range, self.sinc_prob2, self.kernel_list2,
            self.kernel_prob2, self.blur_sigma2, self.betag_range2,
            self.betap_range2)
        np_rng = np.random.RandomState(rng.randrange(2**31))
        if np_rng.uniform() < self.final_sinc_prob:
            kernel_size = rng.choice(self.kernel_range)
            omega_c = np_rng.uniform(np.pi / 3, np.pi)
            sinc = circular_lowpass_kernel(omega_c, kernel_size, pad_to=21)
            sinc = sinc.astype(np.float32)
        else:
            sinc = self.pulse_tensor

        # BGR -> RGB float32 HWC
        gt = np.ascontiguousarray(img_gt[..., ::-1], np.float32)
        return {"gt": gt, "kernel1": kernel1, "kernel2": kernel2,
                "sinc_kernel": sinc, "gt_path": self.paths[index]}


@DATASET_REGISTRY.register(name="RealESRGANPairedDataset")
@DATASET_REGISTRY.register(name="DiffIRGANPairedDataset")
class RealESRGANPairedDataset(PairedImageDataset):
    """Paired lq/gt mode for validation and paired stage-2 training."""
