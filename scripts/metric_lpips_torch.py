#!/usr/bin/env python
"""Folder-vs-folder LPIPS with the PyTorch port (`vmambair_torch`): the
arguments, pairing and output of `scripts/metric_lpips.py`, on the card
unless `--device cpu`, PNG read by the port's own codec. Pass --weights
for converted lpips-vgg weights (.npz).

    python scripts/metric_lpips_torch.py --gt <gt_dir> --sr <sr_dir> \
        [--weights lpips_vgg.npz] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from vmambair_torch.utils.img_util import imread
from vmambair_torch.utils.misc import scandir


def folder_metric(metric_cls, label: str, argv=None):
    """Each GT image against the first SR file whose name starts with its
    stem, both RGB float in [0, 1] and cut to their common size; one line
    per pair, then the average."""
    p = argparse.ArgumentParser()
    p.add_argument("--gt", required=True)
    p.add_argument("--sr", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    metric = metric_cls(args.weights).to(args.device)
    if not metric.is_pretrained:
        print("WARNING: no pretrained weights — scores are relative-only")
    vals = []
    for name in sorted(scandir(args.gt, suffix=("png", "jpg", "bmp"))):
        base, ext = os.path.splitext(name)
        cands = [f for f in os.listdir(args.sr) if f.startswith(base)]
        if not cands:
            continue
        gt = imread(os.path.join(args.gt, name), float32=True)[..., ::-1]
        sr = imread(os.path.join(args.sr, sorted(cands)[0]),
                    float32=True)[..., ::-1]
        h = min(gt.shape[0], sr.shape[0])
        w = min(gt.shape[1], sr.shape[1])
        v = metric(sr[:h, :w], gt[:h, :w])
        vals.append(v)
        print(f"{name}: {label} {v:.4f}")
    if vals:
        print(f"Average: {label} {np.mean(vals):.4f} ({len(vals)} images)")


def main(argv=None):
    from vmambair_torch.metrics.lpips import LPIPS

    folder_metric(LPIPS, "LPIPS", argv)


if __name__ == "__main__":
    main()
