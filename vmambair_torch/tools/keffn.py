"""The fused GDFN probe on an NVIDIA GPU: the counterpart of the TPU probe
`tools/keffn.py`, which asks whether one kernel for the whole residual
branch `x + W_out (gelu_tanh(x1) x2)`, `[x1 | x2] = dw3x3(W_in LN(x))`,
beats the composite of LayerNorm and three convolutions, at every level
width of MambaSISR6 (48-384 channels).

    python -m vmambair_torch.tools.keffn [--device cuda|cpu]

The kernel (`ops/cuda_probes.gdfn_tanh_nhwc`, csrc/gdfn.cu) is K2's with a
tanh gate and channels-last images. At each of the TPU probe's five shapes
(bf16, its `make_params` recipe) it is first held against its plain
version (`gdfn_tanh_ref`, the TPU kernel's rounding) within the bf16
envelope, then, on `cuda`, raced against the cuDNN composite
(`gdfn_tanh_composite`, the TPU probe's `gdfn_xla`) and against K2 on an
NCHW copy (K2's erf gate makes that a timing comparison only): CUDA-event
medians, the three calls interleaved, inputs rotated (`tools.race`). One
JSON row per shape with the TPU probe's keys where they carry over
(`{H}x{W}x{C}_relerr`, `_fused_ms`) and `_composite_ms`, `_k2_ms`,
`_bound_ms`. On `cpu` the TPU probe's interpret shape (2, 16, 16, 48)
runs, parity only.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops.cuda_effn import gdfn_residual_fwd
from ..ops.cuda_probes import (gdfn_tanh_composite, gdfn_tanh_nhwc,
                               gdfn_tanh_ref)
from . import (BF16_TC_FLOPS, FP32_FLOPS, HBM_BPS, check_envelope, device_of,
               max_err, race)

# the TPU probe's shapes (tools/keffn.py:211-212), (B, H, W, C), and its
# interpret shape
SHAPES = [(8, 128, 128, 48), (8, 128, 128, 96), (8, 64, 64, 96),
          (8, 32, 32, 192), (8, 16, 16, 384)]
CPU_SHAPES = [(2, 16, 16, 48)]
REPEATS = 9
POOL = 3
RACE = ("fused", "composite", "k2")


def make_params(seed: int, C: int, device) -> dict:
    """The TPU probe's `make_params` (tools/keffn.py:163), drawn by a
    torch.Generator: fp32 weights in its layouts, hid = int(2.66 C)."""
    hid = int(C * 2.66)
    g = torch.Generator().manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g)

    p = dict(ln_w=1.0 + 0.1 * randn(C), ln_b=0.1 * randn(C),
             w_in=0.1 * randn(C, 2 * hid), w_dw=0.3 * randn(3, 3, 2 * hid),
             w_out=0.1 * randn(hid, C))
    return {k: v.to(device) for k, v in p.items()}


def make_x(shape, dtype, seed: int, device) -> torch.Tensor:
    """The TPU probe's input: N(0, 1) in `dtype`, times 0.5."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=device).to(dtype) * 0.5


def k2_args(params: dict) -> tuple:
    """K2's weights from keffn's: its convolution layouts, NCHW."""
    return (params["ln_w"], params["ln_b"], params["w_in"].t(),
            params["w_dw"].permute(2, 0, 1), params["w_out"].t())


def work(shape, dtype, hid: int = None) -> tuple[int, float, float]:
    """(bytes, fp32 operations, bf16 tensor-core operations) of one call of
    a GDFN residual at (B, H, W, C) (K2's and keffn's; hid defaults to
    int(2.66 C)): x read and y written once, the fp32 weights read once;
    the two projections' 2 (2h C + h C) flops per pixel on the tensor cores
    for bf16 (on the CUDA cores for fp32), the depthwise conv, the gate and
    the LayerNorm (2h 18 + h 20 + 10 C) on the CUDA cores."""
    b, h, w, c = shape
    hid = hid or int(c * 2.66)
    px = b * h * w
    mma = 2 * px * (2 * hid * c + hid * c)
    other = px * (2 * hid * 18 + hid * 20 + 10 * c)
    by = 2 * px * c * torch.finfo(dtype).bits // 8 + 4 * (
        2 * c + 3 * hid * c + 18 * hid)
    if dtype == torch.bfloat16:
        return by, other, mma
    return by, other + mma, 0


def bound_ms(shape, dtype) -> tuple[float, str]:
    """The least time the card could take: bytes over HBM or operations
    over their peaks, the larger; and which."""
    by, fp32_ops, mma = work(shape, dtype)
    t_b = by / HBM_BPS * 1e3
    t_o = (fp32_ops / FP32_FLOPS + mma / BF16_TC_FLOPS) * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def parity(x, params, tag: str) -> tuple[float, float]:
    """The kernel against its plain version; raises when off the bf16
    envelope. Returns (max abs err, relerr: over max |ref|)."""
    return check_envelope(f"keffn {tag}:", gdfn_tanh_nhwc(x, **params),
                          gdfn_tanh_ref(x, **params))


def run(device, shapes=None, dtype=torch.bfloat16) -> list:
    """Parity, then (on CUDA) the race; one row per shape. A row's
    `launches` counts the kernel's launches it made (parity and race)."""
    cpu = device.type == "cpu"
    shapes = shapes or (CPU_SHAPES if cpu else SHAPES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for shape in shapes:
        B, H, W, C = shape
        key = f"{H}x{W}x{C}"
        params = make_params(C + H, C, device)
        x = make_x(shape, dtype, 1, device)
        err, rel = parity(x, params, key)
        _, comp_rel = max_err(gdfn_tanh_composite(x, **params),
                              gdfn_tanh_ref(x, **params))
        row = {"shape": list(shape), "dtype": str(dtype)[6:],
               key + "_relerr": rel, key + "_max_abs_err": err,
               key + "_composite_relerr": comp_rel}
        del x
        if not cpu:
            pool = []
            for seed in range(2, POOL + 2):
                xs = make_x(shape, dtype, seed, device)
                pool.append((xs, xs.permute(0, 3, 1, 2).contiguous()))
            k2w = k2_args(params)
            times = race({
                "fused": lambda i: gdfn_tanh_nhwc(i[0], **params),
                "composite": lambda i: gdfn_tanh_composite(i[0], **params),
                "k2": lambda i: gdfn_residual_fwd(i[1], *k2w)}, pool,
                REPEATS)
            del pool
            for name in RACE:
                row[f"{key}_{name}_ms"] = statistics.median(times[name])
            bnd, by = bound_ms(shape, dtype)
            row.update({key + "_bound_ms": bnd, key + "_bound_by": by,
                        "launches": 2 + REPEATS,
                        "k2_launches": 1 + REPEATS})
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(device_of(args.device)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
