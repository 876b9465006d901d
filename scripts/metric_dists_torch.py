#!/usr/bin/env python
"""Folder-vs-folder DISTS with the PyTorch port (`vmambair_torch`): the
arguments, pairing and output of `scripts/metric_dists.py`, on the card
unless `--device cpu`, PNG read by the port's own codec. Pass --weights
for converted DISTS weights (.npz; alpha / beta default to the published
ones shipped with the port).

    python scripts/metric_dists_torch.py --gt <gt_dir> --sr <sr_dir> \
        [--weights dists.npz] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from metric_lpips_torch import folder_metric


def main(argv=None):
    from vmambair_torch.metrics.dists import DISTS

    folder_metric(DISTS, "DISTS", argv)


if __name__ == "__main__":
    main()
