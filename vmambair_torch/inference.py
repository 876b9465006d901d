#!/usr/bin/env python
"""Single-image / folder inference CLI of the PyTorch port.

Counterpart of `vmambair_tpu/inference.py`, with the same flags plus
`--device` (default `cuda`; there is no silent CPU fallback). It builds the
net, loads a torch state dict (`scripts/convert_jax_to_torch.py` writes one
from a JAX `.ckpt`) and runs `RestorationUpscaler`: tiled when `--tile` is
given, else the whole image padded to the window. Images are read and
written by the port's own codec (`utils/img_util.py`: PNG without `cv2`;
other formats through `cv2` where it is installed).

    python inference_torch.py --model_path net_g.pth --arch MambaSISR6 \
        --input inputs/ --output results/ --scale 4 [--tile 128]

`--sp` runs the spatial scans sequence-parallel (`scan_impl: "sp"`): under
torchrun every rank forwards every image and shards each spatial scan's L
over the group of all ranks (`parallel/sp_scan.py`); rank 0 writes the
images. Without torchrun's environment it raises.

    torchrun --nproc_per_node 4 inference_torch.py --sp ... --device cuda
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from .models import build_network
from .parallel import (
    destroy_distributed,
    init_distributed,
    is_main_process,
    use_sp_group,
)
from .utils.convert import load_network
from .utils.img_util import imread, imwrite
from .utils.upscaler import RestorationUpscaler


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--arch", type=str, default="MambaSISR6")
    parser.add_argument("-i", "--input", type=str, default="inputs")
    parser.add_argument("-o", "--output", type=str, default="results")
    parser.add_argument("-s", "--scale", type=int, default=4)
    parser.add_argument("--tile", type=int, default=0,
                        help="fixed-tile chop inference (0 = whole image)")
    parser.add_argument("--tile_pad", type=int, default=0)
    parser.add_argument("--window", type=int, default=0,
                        help="pad-to-multiple window; default 32/16/8 by "
                        "scale")
    parser.add_argument("--network_opt", type=str, default=None,
                        help="JSON kwargs for the arch")
    parser.add_argument("--sp", action="store_true",
                        help="sequence-parallel spatial scans over all "
                        "ranks of torchrun")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device, e.g. cuda, cuda:1 or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device")
    if not args.sp:
        process(args, build_upscaler(args, device))
        return
    device = init_distributed("pytorch", args.device)
    try:
        with use_sp_group(torch.distributed.group.WORLD):
            process(args, build_upscaler(args, device))
    finally:
        destroy_distributed()


def build_upscaler(args, device) -> RestorationUpscaler:
    """The net of `args` (`scan_impl: "sp"` with --sp) with its weights,
    behind a `RestorationUpscaler` on `device`."""
    window = args.window or {1: 32, 2: 16, 4: 8}.get(args.scale, 8)
    network_g = {"type": args.arch, "scale": args.scale}
    if args.sp:
        network_g["scan_impl"] = "sp"
    if args.network_opt:
        network_g.update(json.loads(args.network_opt))
    net = build_network(network_g, device="cpu")
    net.load_state_dict(load_network(args.model_path))
    return RestorationUpscaler(
        args.scale, net, device, tile=args.tile, tile_pad=args.tile_pad,
        pre_pad=0, window=window, tile_batch=16)


def process(args, ups: RestorationUpscaler):
    """Every image of `args.input` through `ups`; rank 0 writes them."""
    main_rank = is_main_process()
    if main_rank:
        os.makedirs(args.output, exist_ok=True)
    paths = ([args.input] if os.path.isfile(args.input)
             else sorted(glob.glob(os.path.join(args.input, "*"))))
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        if main_rank:
            print(f"Processing {name} ...")
        out, _ = ups.enhance(imread(path, "color"))
        if main_rank:
            imwrite(out, os.path.join(args.output, f"{name}_out.png"))


if __name__ == "__main__":
    main()
