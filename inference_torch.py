#!/usr/bin/env python
"""Inference CLI of the PyTorch port (see `vmambair_torch/inference.py`).

    python inference_torch.py --model_path net_g.pth --arch MambaSISR6 \
        -i inputs/ -o results/ --scale 4 --tile 128 --device cuda
"""

from vmambair_torch.inference import main

if __name__ == "__main__":
    main()
