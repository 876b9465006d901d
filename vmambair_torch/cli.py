"""Console entry points of the port (`pyproject.toml`'s
`vmambair-torch-train`, `-test` and `-inference`; JAX's `cli.py`): the
same surface as `train_torch.py`, `test_torch.py` and `inference_torch.py`,
from any working directory, which is the pipelines' root.

    python -m vmambair_torch.train -opt options/MambaSISR15_x4.yml \
        [--launcher pytorch] [--device cuda|cpu]
"""

import os


def train_main(argv=None):
    from .train.pipeline import train_pipeline

    return train_pipeline(os.getcwd(), argv=argv)


def test_main(argv=None):
    from .train.pipeline import test_pipeline

    return test_pipeline(os.getcwd(), argv=argv)


def inference_main(argv=None):
    from .inference import main

    main(argv)
