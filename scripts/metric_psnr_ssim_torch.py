#!/usr/bin/env python
"""Folder-vs-folder PSNR/SSIM with the PyTorch port (`vmambair_torch`):
the arguments, pairing and output of `scripts/metric_psnr_ssim.py`, with
PNG read by the port's own codec (no JAX, no cv2 for PNG).

    python scripts/metric_psnr_ssim_torch.py --gt <gt_dir> --sr <sr_dir> \
        [--crop_border 4] [--no_y] [--suffix _x4]

PSNR and SSIM run on the host (numpy, MATLAB's semantics), so unlike the
LPIPS and DISTS CLIs this one takes no `--device`.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from vmambair_torch.metrics import calculate_psnr, calculate_ssim
from vmambair_torch.utils.img_util import imread
from vmambair_torch.utils.misc import scandir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt", required=True)
    p.add_argument("--sr", required=True)
    p.add_argument("--crop_border", type=int, default=4)
    p.add_argument("--test_y_channel", action="store_true", default=True)
    p.add_argument("--no_y", dest="test_y_channel", action="store_false")
    p.add_argument("--suffix", default="")
    args = p.parse_args(argv)

    gt_names = sorted(scandir(args.gt, suffix=("png", "jpg", "jpeg", "bmp")))
    psnrs, ssims = [], []
    for name in gt_names:
        base, ext = os.path.splitext(name)
        sr_path = os.path.join(args.sr, base + args.suffix + ext)
        if not os.path.exists(sr_path):
            cands = [f for f in os.listdir(args.sr) if f.startswith(base)]
            if not cands:
                print(f"skip {name}: no SR match")
                continue
            sr_path = os.path.join(args.sr, sorted(cands)[0])
        gt = imread(os.path.join(args.gt, name))
        sr = imread(sr_path)
        h = min(gt.shape[0], sr.shape[0])
        w = min(gt.shape[1], sr.shape[1])
        gt, sr = gt[:h, :w], sr[:h, :w]
        psnr = calculate_psnr(sr, gt, crop_border=args.crop_border,
                              test_y_only=args.test_y_channel)
        ssim = calculate_ssim(sr, gt, crop_border=args.crop_border,
                              test_y_only=args.test_y_channel)
        psnrs.append(psnr)
        ssims.append(ssim)
        print(f"{name}: PSNR {psnr:.4f} dB  SSIM {ssim:.4f}")
    if psnrs:
        print(f"Average: PSNR {np.mean(psnrs):.4f} dB  "
              f"SSIM {np.mean(ssims):.4f}  ({len(psnrs)} images)")


if __name__ == "__main__":
    main()
