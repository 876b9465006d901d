#!/usr/bin/env python
"""Training CLI of the PyTorch port (see `vmambair_torch/train/pipeline.py`).

    python train_torch.py -opt options/MambaSISR15_x4.yml [--auto_resume] \
        [--force_yml train:total_iter=1000] [--device cuda|cpu]

The same options and flags as `train.py`, plus `--device` (default cuda).
"""

import os.path as osp

from vmambair_torch.train.pipeline import train_pipeline

if __name__ == "__main__":
    train_pipeline(osp.abspath(osp.dirname(__file__)))
