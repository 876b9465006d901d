"""Primitive throughput on an NVIDIA GPU: the counterpart of the TPU probe
`tools/kpeak.py` (fp32 and bf16 FMA chains, exp, lane roll, lane shift),
the roofline terms of the scan kernels.

Each probe (csrc/peak.cu) computes kpeak's function on a (GRID, ROWS,
LANES) = (16, 1024, 1024) array. It is first held against its plain
version at kpeak's REP = 64 (fp32 within a relative 1e-5, the bf16 FMA
within the bf16 envelope). Its rate is then timed at a REP large enough
that moving the array in and out takes under 5% of the run (at 64 the
128 MB of fp32 I/O would dominate): REP doubles from 256 until it does.
Rates are kpeak's T-ops/s (elements x REP x its ops per rep over the
time), beside the data-sheet peak where one exists: only the fp32 FMA has
one (67 TFLOP/s); the SFU's exp rate, the bf16 rate outside the tensor
cores and the shuffle rate are on no data sheet, which is why they are
measured. The exp probe's rate is the ex2 rate of the scans' bounds.

    python -m vmambair_torch.tools.kpeak [probes] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops.cuda_probes import PEAK_PROBES, PEAK_REP, peak_ref
from . import FP32_FLOPS, HBM_BPS, check_envelope, device_of, race

GRID, ROWS, LANES = 16, 1024, 1024
CPU_SHAPE = (2, 8, 128)
REPEATS = 5
POOL = 2
RATE_REP0, RATE_REP_MAX = 256, 1 << 16
BYTES_SHARE = 0.05
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (3e-2, 5e-2)}
DATASHEET = {"fma_fp32": FP32_FLOPS / 1e12}


def make_x(shape, dtype, seed: int, device) -> torch.Tensor:
    """kpeak's input: uniform in [0.5, 0.6), in the probe's dtype."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand(*shape, generator=g, device=device) * 0.1 + 0.5).to(
        dtype)


def parity(name: str, shape, device) -> tuple[float, float]:
    """The probe at REP = 64 against its plain version; raises when off.
    The roll and shift chains end near 1e-11 (x 1e-30): the bar is
    relative for fp32."""
    fn, probe, dtype, _ = PEAK_PROBES[name]
    x = make_x(shape, dtype, 0, device)
    got, ref = fn(x, PEAK_REP).float(), peak_ref(probe, x, PEAK_REP).float()
    e = check_envelope(f"kpeak {name}:", got, ref, TOL[dtype])[0]
    return e, ((got - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()


def rate(name: str, device) -> dict:
    """Times the probe at REP = 256, 512, ... until the bytes' time is
    under BYTES_SHARE of the run; returns the row's numbers and the
    launches made."""
    fn, _, dtype, ops_per_rep = PEAK_PROBES[name]
    pool = [make_x((GRID, ROWS, LANES), dtype, s, device)
            for s in range(1, POOL + 1)]
    bytes_ms = 2 * pool[0].numel() * pool[0].element_size() / HBM_BPS * 1e3
    rep, calls = RATE_REP0, 0
    while True:
        times = race({name: lambda x, r=rep: fn(x, r)}, pool, REPEATS)[name]
        calls += 1 + REPEATS
        ms = statistics.median(times)
        if bytes_ms / ms < BYTES_SHARE or rep >= RATE_REP_MAX:
            break
        rep *= 2
    elems = GRID * ROWS * LANES
    return dict(rep=rep, ms=ms, us_per_block=1e3 * ms / GRID,
                t_ops_per_s=elems * rep * ops_per_rep / ms / 1e9,
                datasheet_t_ops_per_s=DATASHEET.get(name),
                bytes_share=bytes_ms / ms, launches=calls)


def run(names: list, device) -> list:
    unknown = [n for n in names if n not in PEAK_PROBES]
    if unknown:
        raise ValueError(f"kpeak: unknown probes {unknown}; known: "
                         f"{list(PEAK_PROBES)}")
    cpu = device.type == "cpu"
    rows = []
    for name in names:
        err, rel = parity(name, CPU_SHAPE if cpu else (GRID, ROWS, LANES),
                          device)
        row = dict(probe=name, max_abs_err=err, rel_err=rel)
        if not cpu:
            row.update(rate(name, device))
            row["launches"] += 1  # the parity check
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(PEAK_PROBES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.names, device_of(args.device)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
