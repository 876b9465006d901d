"""Sequential-over-L scan probe on an NVIDIA GPU: the counterpart of the TPU
probe `tools/kseq.py` (v20/v21 family).

The TPU probe put channels on lanes, the batch (B = 8 exactly) on
sublanes and the 16 states in a register array walked along L; Mosaic
spilled that state to VMEM every step and the design was rejected
(tools/kseq.py:28-41). On the H100 one thread holds its 16 fp32 states in
registers: csrc/scan_seq.cu, one thread per (b, channel, segment of L),
inputs staged through shared memory in windows of `win` positions, the
segments joined by a combine over their end states.

It runs kseq's own layout: u, delta, y (G, L, 8, Dg) bf16, B and C
(G, L, N, 8, 1) bf16, at the hot level-1 decoder shape (B = 8, L = 16384,
G = 2, Dg = 96, N = 16), and times each variant twice, interleaved: on
inputs already in that layout, and with the relayout from the model's
(B, L, G, Dg) / (B, L, G, N) layout included (tools/kseq.py:247-265).

    seq           windows of 1 (kernel_seq)
    seq_win8      windows of 8 (kernel_seq_win)
    seq_win16     windows of 16
    seq_rev, seq_win8_rev   the same, scanning L back to front

    python -m vmambair_torch.tools.kseq [names] [--device cuda|cpu]

Parity: each variant on the first 2048 positions of a seeded input set
against the plain chunked scan, within the bf16 envelope, before timing.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops import cuda_probes
from ..ops.cuda_scan import scan_views_ref
from . import check_envelope, device_of, race

B, L, D, G, N = 8, 16384, 96, 2, 16  # hot level-1 decoder shape
DIM = G * D
CPU_L = 512                          # the TPU probe's interpret size
PARITY_L = 2048
REPEATS = 5
POOL = 3
BF16 = torch.bfloat16

VARIANTS = {  # name -> (win, reverse)
    "seq": (1, False),
    "seq_win8": (8, False),
    "seq_win16": (16, False),
    "seq_rev": (1, True),
    "seq_win8_rev": (8, True),
}


def make_inputs_seq(seed: int, device, seq: int, model: bool = False) -> dict:
    """kseq's `make_inputs_seq` (tools/kseq.py:200-213), drawn by a
    torch.Generator: u, delta (G, L, 8, Dg) bf16; Bm, Cm (G, L, N, 8, 1)
    bf16; A (DIM, N), Dv ones, bias (DIM,) fp32. With `model`, also the
    model's layout: u_m, delta_m (8, L, G, Dg), B_m, C_m (8, L, G, N)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g, device=device)

    inp = dict(u=randn(G, seq, 8, D).to(BF16),
               delta=randn(G, seq, 8, D).to(BF16).abs() * 0.5,
               Bm=randn(G, seq, N, 8, 1).to(BF16),
               Cm=randn(G, seq, N, 8, 1).to(BF16),
               A=-torch.exp(randn(DIM, N) * 0.5),
               Dv=torch.ones(DIM, device=device),
               bias=randn(DIM) * 0.01)
    if model:
        for k in ("u", "delta"):
            inp[k + "_m"] = inp[k].permute(2, 1, 0, 3).contiguous()
        for k in ("Bm", "Cm"):
            inp[k[0] + "_m"] = inp[k][..., 0].permute(3, 1, 0, 2).contiguous()
    return inp


def views(u, delta, Bm, Cm, y):
    """kseq's layout -> the (b, g, l, d) / (b, g, l, n) views scan_seq
    takes."""
    def act(t):
        return t.permute(2, 0, 1, 3)

    def bc(t):
        return t[..., 0].permute(3, 0, 1, 2)

    return act(u), act(delta), bc(Bm), bc(Cm), act(y)


def run_seq(inp, win, reverse):
    y = torch.empty_like(inp["u"])
    u, d, bm, cm, yv = views(inp["u"], inp["delta"], inp["Bm"], inp["Cm"], y)
    cuda_probes.scan_seq(u, d, inp["A"], bm, cm, inp["Dv"], inp["bias"], yv,
                         reverse=reverse, win=win)
    return y


def run_seq_relayout(inp, win, reverse):
    """The model's layout -> kseq's, then the kernel (tools/kseq.py:
    250-255)."""
    lay = dict(inp, u=inp["u_m"].permute(2, 1, 0, 3).contiguous(),
               delta=inp["delta_m"].permute(2, 1, 0, 3).contiguous(),
               Bm=inp["B_m"].permute(2, 1, 3, 0).contiguous()[..., None],
               Cm=inp["C_m"].permute(2, 1, 3, 0).contiguous()[..., None])
    return run_seq(lay, win, reverse)


def parity(names: list, device, seq: int) -> dict:
    """Each variant against the plain chunked scan on `seq` positions;
    raises outside the bf16 envelope. Returns name -> (abs err, rel err)."""
    inp = make_inputs_seq(42, device, seq)
    out = {}
    refs = {}
    for name in names:
        win, rev = VARIANTS[name]
        if rev not in refs:
            y = torch.empty_like(inp["u"])
            u, d, bm, cm, _ = views(inp["u"], inp["delta"], inp["Bm"],
                                    inp["Cm"], y)
            refs[rev] = scan_views_ref(u, d, inp["A"], bm, cm, inp["Dv"],
                                       inp["bias"], True, rev)
        ref = refs[rev]
        got = views(inp["u"], inp["delta"], inp["Bm"], inp["Cm"],
                    run_seq(inp, win, rev))[4]
        out[name] = check_envelope(f"kseq {name}:", got, ref)
    return out


# kernel launches `run` makes for each variant: the parity check, and a
# warm-up and the timed calls with and without the relayout
LAUNCHES_PER_VARIANT = 1 + 2 * (1 + REPEATS)


def run(names: list, device) -> list:
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"kseq: unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    cpu = device.type == "cpu"
    seq = CPU_L if cpu else L
    errs = parity(names, device, min(PARITY_L, seq))
    rows = [dict(variant=n, max_abs_err=errs[n][0], rel_err=errs[n][1])
            for n in names]
    if cpu:
        return rows
    pool = [make_inputs_seq(s, device, seq, model=True)
            for s in range(1, POOL + 1)]
    calls = {}
    for n in names:
        win, rev = VARIANTS[n]
        calls[n] = lambda i, w=win, r=rev: run_seq(i, w, r)
        calls[n + "+relayout"] = (
            lambda i, w=win, r=rev: run_seq_relayout(i, w, r))
    times = race(calls, pool, REPEATS)
    del pool
    for row in rows:
        n = row["variant"]
        ms = statistics.median(times[n])
        row.update(ms=ms, gelem_per_s=B * seq * DIM * N / ms / 1e6,
                   ms_with_relayout=statistics.median(times[n + "+relayout"]),
                   launches=LAUNCHES_PER_VARIANT)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.names, device_of(args.device)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
