"""Data layer of the port: registry-built datasets and the loader factory.

Counterpart of `vmambair_tpu/data/__init__.py` for the paired datasets of
S1 training and deraining (`PairedImageDataset`, `SingleImageDataset`),
the RealSR datasets (`RealESRGANDataset`, `RealESRGANPairedDataset`) and
the task datasets (`DeblurPairedDataset`, `Dataset_GaussianDenoising`,
`Dataset_DefocusDeblur_DualPixel_16bit`); the video datasets follow their
slice.
"""

from __future__ import annotations

import logging

from ..utils.registry import DATASET_REGISTRY, build_from_cfg
from .loader import (DataLoader, DevicePrefetcher, EnlargedSampler,
                     InfinitePrefetcher)
from .paired_dataset import PairedImageDataset, SingleImageDataset
from .realesrgan_dataset import RealESRGANDataset, RealESRGANPairedDataset
from .task_datasets import (DeblurPairedDataset, DualPixelDefocusDataset,
                            GaussianDenoisingDataset)

logger = logging.getLogger("vmambair_torch")


def build_dataset(dataset_opt: dict):
    dataset = build_from_cfg(
        {"type": dataset_opt["type"], "opt": dict(dataset_opt)},
        DATASET_REGISTRY)
    logger.info("Dataset [%s] - %s is built.", dataset.__class__.__name__,
                dataset_opt.get("name"))
    return dataset


def build_dataloader(dataset, dataset_opt: dict, num_replicas: int = 1,
                     rank: int = 0, seed: int = 0, sampler=None):
    """Phase-aware loader factory: a train loader draws this rank's part
    of each global batch (batch_size_per_gpu x num_gpu) from an
    EnlargedSampler padded to a multiple of the global batch and sliced
    per replica (`num_replicas` ranks, this one `rank`), its augmentation
    seeded `seed + rank`; other phases read one image at a time, in
    order."""
    phase = dataset_opt.get("phase", "train")
    if phase == "train":
        batch = int(dataset_opt.get("batch_size_per_gpu", 1)) * max(
            1, int(dataset_opt.get("num_gpu", 1)))
        if batch % num_replicas:
            raise ValueError(f"global batch {batch} does not divide over "
                             f"{num_replicas} ranks")
        if sampler is None:
            sampler = EnlargedSampler(
                len(dataset), num_replicas, rank,
                dataset_opt.get("dataset_enlarge_ratio", 1), seed=seed,
                round_multiple=batch)
        loader = DataLoader(
            dataset, batch_size=batch // num_replicas, sampler=sampler,
            num_workers=int(dataset_opt.get("num_worker_per_gpu", 4)),
            drop_last=True, seed=seed + rank)
    else:
        loader = DataLoader(dataset, batch_size=1, shuffle=False,
                            num_workers=1, drop_last=False)
    loader.name = dataset_opt.get("name", phase)
    return loader, sampler


__all__ = ["build_dataset", "build_dataloader", "DataLoader",
           "EnlargedSampler", "InfinitePrefetcher", "DevicePrefetcher",
           "PairedImageDataset", "SingleImageDataset", "RealESRGANDataset",
           "RealESRGANPairedDataset", "DeblurPairedDataset",
           "GaussianDenoisingDataset", "DualPixelDefocusDataset",
           "DATASET_REGISTRY"]
