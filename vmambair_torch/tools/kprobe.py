"""The in-kernel relayout probes on an NVIDIA GPU: the counterpart of the
TPU probe `tools/kprobe.py`, which prices the building blocks of a fused
projection + scan kernel that reads (B, L, D) chunks as they lie: an
in-kernel (chunk, D) -> (D, chunk) transpose and back, and the small
projections xdbl = W_xp u^T, delta = W_dt xdbl[:R], at MambaSISR6's
full-resolution scan shape (B = 8 tiles of 128x128, L = 16384, D = 96).

    python -m vmambair_torch.tools.kprobe [probes] [--device cuda|cpu]

The kernels are `ops/cuda_probes.probe_transpose` and `probe_proj`
(csrc/probe_io.cu). Each is first held against its plain version: the
transpose pair bit-equal (it changes no value but by the probe's scale),
the projections within the bf16 envelope. On `cuda` they are then timed
(CUDA-event medians, inputs rotated, `tools.race`), the transpose pair
beside the one PyTorch call that computes its function, `u * 1.000001`
on the bf16 tensor (checked bit-equal to it first). One JSON row per
probe under the TPU probe's names, {"probe": "transpose_pair_in_kernel"
| "proj_in_kernel", "ms_per_call": ...}, with the parity, `bound_ms` and,
for the transpose, `library_ms`; for the projections also
`rows38_ops_ms`, the fp32 operations of all 38 rows of xdbl that the
probe computes over the card's fp32 rate (7 of them reach y, and the
bound counts those). On `cpu` the shape shrinks to B = 2, L = 2048 (the
plain versions; parity only).
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops.cuda_probes import (PROBE_SCALE, probe_proj, probe_proj_ref,
                               probe_transpose, probe_transpose_ref)
from . import FP32_FLOPS, HBM_BPS, check_envelope, device_of, max_err, race

SHAPE = dict(B=8, L=16384, D=96)   # the TPU probe's (tools/kprobe.py:14)
CPU_SHAPE = dict(B=2, L=2048, D=96)
RN, R = 38, 6                      # R + 2N at the hot shape; dt rank
REPEATS = 9
POOL = 3
PROBES = ("transpose_pair_in_kernel", "proj_in_kernel")


def make_inputs(shape: dict, seed: int, device) -> dict:
    """u (B, L, D) bf16, W_xp (RN, D) and W_dt (D, R) fp32, all N(0, 1) as
    the TPU probe draws them (its three draws share one key; these are
    drawn one after another from a torch.Generator)."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(shape["B"], shape["L"], shape["D"], generator=g,
                    device=device).to(torch.bfloat16)
    return dict(u=u,
                wxp=torch.randn(RN, shape["D"], generator=g, device=device),
                wdt=torch.randn(shape["D"], R, generator=g, device=device))


def calls(name: str) -> tuple:
    """(kernel, plain version) of a probe, each taking the inputs."""
    if name == "transpose_pair_in_kernel":
        return (lambda i: probe_transpose(i["u"]),
                lambda i: probe_transpose_ref(i["u"]))
    return (lambda i: probe_proj(i["u"], i["wxp"], i["wdt"]),
            lambda i: probe_proj_ref(i["u"], i["wxp"], i["wdt"]))


def library(i: dict) -> torch.Tensor:
    """The one PyTorch call that computes the transpose pair's function."""
    return i["u"] * PROBE_SCALE


def work(name: str, shape: dict, dtype=torch.bfloat16) -> tuple[int, float]:
    """(bytes, fp32 operations) of one call's function: u read and y
    written once (and the fp32 weights); the transpose's one multiply per
    element; for the projections, what y needs per position: xdbl's first
    R + 1 rows (2 (R + 1) D flops), W_dt xdbl[:R] (2 D R) and the 0.5
    xdbl[R] added to each output (D). The other RN - R - 1 rows of xdbl
    reach no output: the kernel computes them only because the TPU probe
    does (their cost is in `proj_rows_ops_ms`)."""
    el = shape["B"] * shape["L"] * shape["D"]
    by = 2 * el * torch.finfo(dtype).bits // 8
    if name == "transpose_pair_in_kernel":
        return by, el
    rows = shape["B"] * shape["L"]
    D = shape["D"]
    return (by + 4 * (RN * D + D * R),
            rows * (2 * (R + 1) * D + 2 * D * R + D))


def proj_rows_ops_ms(shape: dict) -> float:
    """The fp32 operations of all RN rows of xdbl, as the TPU probe and the
    kernel compute them, over the card's fp32 rate (ms): a figure beside
    the bound, not the bound."""
    rows = shape["B"] * shape["L"]
    D = shape["D"]
    return rows * (2 * RN * D + 2 * D * R + D) / FP32_FLOPS * 1e3


def bound_ms(name: str, shape: dict) -> tuple[float, str]:
    by, ops = work(name, shape)
    t_b, t_o = by / HBM_BPS * 1e3, ops / FP32_FLOPS * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def parity(name: str, inp: dict) -> tuple[float, float]:
    """The kernel against its plain version: bit-equal for the transpose
    pair, the bf16 envelope for the projections; raises when off."""
    kern, plain = calls(name)
    got, ref = kern(inp), plain(inp)
    if name == "transpose_pair_in_kernel":
        if not torch.equal(got, ref):
            raise RuntimeError(f"kprobe {name}: not bit-equal to its plain "
                               "version")
        return max_err(got, ref)
    return check_envelope(f"kprobe {name}:", got, ref)


def run(names: list, device, shape: dict = None) -> list:
    """Parity, then (on CUDA) the race; one row per probe. A row's
    `launches` counts the kernel's launches it made."""
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        raise ValueError(f"kprobe: unknown probes {unknown}; known: "
                         f"{list(PROBES)}")
    cpu = device.type == "cpu"
    shape = shape or (CPU_SHAPE if cpu else SHAPE)
    inp = make_inputs(shape, 0, device)
    rows = []
    for name in names:
        err, rel = parity(name, inp)
        row = dict(probe=name, max_abs_err=err, rel_err=rel,
                   shape=[shape["B"], shape["L"], shape["D"]])
        if name == "transpose_pair_in_kernel":
            # the library call stands beside the kernel only if it computes
            # the same bits
            row["library_bit_equal"] = torch.equal(
                library(inp), probe_transpose_ref(inp["u"]))
        rows.append(row)
    if cpu:
        return rows
    pool = [make_inputs(shape, seed, device) for seed in range(1, POOL + 1)]
    fns = {n: calls(n)[0] for n in names}
    if any(row.get("library_bit_equal") for row in rows):
        fns["library"] = library
    times = race(fns, pool, REPEATS)
    for row in rows:
        name = row["probe"]
        bnd, by = bound_ms(name, shape)
        row.update(ms_per_call=statistics.median(times[name]),
                   all_ms=times[name], bound_ms=bnd, bound_by=by,
                   launches=2 + REPEATS)
        if name == "proj_in_kernel":
            row["rows38_ops_ms"] = proj_rows_ops_ms(shape)
        if name == "transpose_pair_in_kernel":
            row["library_ms"] = (statistics.median(times["library"])
                                 if "library" in times else None)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(PROBES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.names, device_of(args.device)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
