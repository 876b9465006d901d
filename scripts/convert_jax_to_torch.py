#!/usr/bin/env python
"""Convert a JAX checkpoint (flax msgpack `.ckpt`) to a torch `.pth` for
the PyTorch port (`vmambair_torch`).

Reads the `{"params", "params_ema"}` payload that
`vmambair_tpu/train/checkpoint.py::save_network` writes, with msgpack alone
(no flax, no JAX: `vmambair_torch/utils/convert.py::read_flax_checkpoint`),
and stores the same keys as torch state dicts in the reference arch's
naming: G (`net_g_<iter>.ckpt`, an OSSNet) through `jax_to_torch`, D
(`net_d_<iter>.ckpt`, the GAN stage's UNetDiscriminatorSN) through
`jax_disc_to_torch`. `--net` names which; by default the payload's keys
decide. The port's loaders read a `.ckpt` themselves; this script is for
a machine without msgpack, or to keep a `.pth`.

    python scripts/convert_jax_to_torch.py --ckpt net_g_300000.ckpt \
        --output net_g_300000.pth
    python scripts/convert_jax_to_torch.py --ckpt net_d_300000.ckpt \
        --output net_d_300000.pth --net d
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--net", choices=("g", "d"), default=None,
                   help="the network the checkpoint holds (default: by "
                        "its keys)")
    args = p.parse_args(argv)

    import torch

    from vmambair_torch.utils.convert import (flax_to_state_dict,
                                              read_flax_checkpoint)

    payload = read_flax_checkpoint(args.ckpt)
    out = {k: flax_to_state_dict(v, args.net) for k, v in payload.items()
           if k in ("params", "params_ema")}
    if not out:
        raise SystemExit(f"{args.ckpt}: no params / params_ema entry")
    torch.save(out, args.output)
    for k, sd in out.items():
        print(f"{k}: {len(sd)} tensors")
    print("wrote", args.output)


if __name__ == "__main__":
    main()
