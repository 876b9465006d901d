#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port (see `vmambair_torch/train/pipeline.py`).

    python test_torch.py -opt options/<test config>.yml [--device cuda|cpu]

The same options as `test.py`, plus `--device` (default cuda).
"""

import os.path as osp

from vmambair_torch.train.pipeline import test_pipeline

if __name__ == "__main__":
    test_pipeline(osp.abspath(osp.dirname(__file__)))
