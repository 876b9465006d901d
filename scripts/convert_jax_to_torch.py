#!/usr/bin/env python
"""Convert a JAX OSSNet checkpoint (flax msgpack `.ckpt`) to a torch `.pth`
for the PyTorch port (`vmambair_torch`).

Runs where JAX/flax are installed: it reads the `{"params", "params_ema"}`
payload that `vmambair_tpu/train/checkpoint.py::save_network` writes and
stores the same keys as torch state dicts in the reference arch's naming
(`vmambair_torch/utils/convert.py::jax_to_torch`).

    python scripts/convert_jax_to_torch.py --ckpt net_g_300000.ckpt \
        --output net_g_300000.pth
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    import torch
    from flax import serialization

    from vmambair_torch.utils.convert import jax_to_torch

    with open(args.ckpt, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    out = {k: jax_to_torch(v) for k, v in payload.items()
           if k in ("params", "params_ema")}
    if not out:
        raise SystemExit(f"{args.ckpt}: no params / params_ema entry")
    torch.save(out, args.output)
    for k, sd in out.items():
        print(f"{k}: {len(sd)} tensors")
    print("wrote", args.output)


if __name__ == "__main__":
    main()
