"""The channels-last fused scan on an NVIDIA GPU: the counterpart of the
TPU probe `tools/kldio.py`, which asks whether the projection-fused
spatial scan (K1) should read u and write y in the model's (B, L, G, D)
order instead of transposing them to (B, G, D, L) around the kernel. At
MambaSISR6's full-resolution scan shape (B = 8 tiles of 128x128, L =
16384, G = 2 groups of D = 96 channels, N = 16, R = 6), bf16.

    python -m vmambair_torch.tools.kldio [--device cuda|cpu]

The kernel is `ops/cuda_probes.ld_fused`: K1 with its Ld layout policy
(csrc/oss_scan_fused.cu), which computes K1's function on a (B, G, L, D)
u. `check_parity` holds it, forward and reverse, against the production
op from the (B, L, G, D) layout (K1 between two copies) at the TPU
probe's bar: 3e-2 of the reference's largest magnitude. On `cuda` (the
default) `race` then times, CUDA-event medians over rotated inputs
(`tools.race`):

    fused_prod_BLGD  K1 from (B, L, G, D), the two `permute().contiguous()`
                     copies included (the TPU probe timed XLA's transposes);
    fused_ld_BGLD    the Ld kernel from (B, G, L, D), with speedup_vs_prod;
    k1_BGDL          K1 alone on a (B, G, D, L) copy (not a TPU row: it
                     splits the production row into kernel and copies);
    bound            the least time of the scan's work on the card.

One JSON row each, with `bound_share` (the bound over the row's time),
the kernel the row launches and the launches of it the tool made. On
`cpu` the shape shrinks to B = 2, L = 2048 (the TPU probe's interpret
size) and the parity runs on the plain version.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops.cuda_probes import ld_fused
from ..ops.cuda_scan import oss_scan_fused_fwd
from . import FP32_FLOPS, HBM_BPS, SFU_NOMINAL, device_of, race

B, L, G, D, N, R = 8, 16384, 2, 96, 16, 6   # the TPU probe's (kldio.py:51)
SMALL_B, SMALL_L = 2, 2048                  # its make_inputs_small
PARITY_BAR = 3e-2
REPEATS = 9
POOL = 3


def make_inputs(seed: int, device, small: bool = False) -> tuple:
    """(u2 (B, L, G, D) bf16, xw, dw, db, A, Ds) with the TPU probe's
    recipe (kldio.py:161): u ~ N(0, 1), x_proj and dt_proj 0.2 N(0, 1),
    the dt bias 0.1 N(0, 1), A = -0.5 - exp(0.5 N(0, 1)), Ds ~ N(0, 1);
    drawn one after another from a seeded torch.Generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, l = (SMALL_B, SMALL_L) if small else (B, L)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    u2 = randn(b, l, G, D).to(torch.bfloat16)
    xw = randn(G, R + 2 * N, D) * 0.2
    dw = randn(G, D, R) * 0.2
    db = 0.1 * randn(G, D)
    A = -0.5 - torch.exp(randn(G, D, N) * 0.5)
    Ds = randn(G, D)
    return u2, xw, dw, db, A, Ds


def make_inputs_small(seed: int, device) -> tuple:
    return make_inputs(seed, device, small=True)


def prod(u2, *w, reverse=False):
    """The production op from the model's (B, L, G, D) layout: K1 between a
    copy to (B, G, D, L) and one back."""
    y = oss_scan_fused_fwd(u2.permute(0, 2, 3, 1).contiguous(), *w,
                           softplus=True, reverse=reverse)
    return y.permute(0, 3, 1, 2).contiguous()


def ld(u_gld, *w, reverse=False):
    return ld_fused(u_gld, *w, softplus=True, reverse=reverse)


def check_parity(reverse: bool, device) -> float:
    """The Ld kernel against the production op on the same inputs, y in
    (B, L, G, D); raises past the TPU probe's bar. Returns the relative
    error (max |diff| over max |reference|)."""
    u2, *w = make_inputs(0, device, small=device.type == "cpu")
    y_ref = prod(u2, *w, reverse=reverse)
    y_ld = ld(u2.movedim(2, 1).contiguous(), *w, reverse=reverse)
    y_ld = y_ld.movedim(1, 2)
    num = (y_ld.float() - y_ref.float()).abs().max().item()
    den = y_ref.float().abs().max().item() + 1e-9
    if not num / den < PARITY_BAR:
        raise RuntimeError(f"kldio: LD-fused mismatch, reverse={reverse}: "
                           f"rel err {num / den:.3e}")
    return num / den


def work(b: int = B, l: int = L, dtype=torch.bfloat16) -> tuple:
    """(bytes, fp32 operations, exp2s) of one call: u read and y written
    once (and the fp32 weights); per (b, g, l) the projections (R + 2N
    rows over D, then D rows over R: 2 D (2R + 2N) flops) and, per state,
    K1's 10 scan operations and one exp2 (`chip_smoke.py`'s K1 count)."""
    el = b * G * l * D
    by = 2 * el * torch.finfo(dtype).bits // 8 + 4 * G * D * (
        2 * R + 3 * N + 2)
    return by, 10 * el * N + 2 * el * (2 * R + 2 * N), el * N


def bound_ms(b: int = B, l: int = L, dtype=torch.bfloat16,
             ex2_rate: float = SFU_NOMINAL) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and the operations over their
    rate (fp32, or the exp2s over `ex2_rate`)."""
    by, ops, ex2 = work(b, l, dtype)
    t_b = by / HBM_BPS * 1e3
    t_o = max(ops / FP32_FLOPS, ex2 / ex2_rate) * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def run(device, ex2_rate: float = SFU_NOMINAL) -> list:
    """Parity forward and reverse, then (on CUDA) the race; one row each.
    A race row's `launches` counts the launches of its `kernel` the tool
    made for it, parity included."""
    rows = [dict(piece=f"parity_reverse={rev}",
                 rel_err=check_parity(rev, device)) for rev in (False, True)]
    if device.type == "cpu":
        return rows
    pool = []
    for seed in range(1, POOL + 1):
        u2, *w = make_inputs(seed, device)
        pool.append((u2, u2.movedim(2, 1).contiguous(), w,
                     u2.permute(0, 2, 3, 1).contiguous()))
    calls = {"fused_prod_BLGD": lambda i: prod(i[0], *i[2]),
             "fused_ld_BGLD": lambda i: ld(i[1], *i[2]),
             "k1_BGDL": lambda i: oss_scan_fused_fwd(i[3], *i[2],
                                                     softplus=True)}
    kernels = {"fused_prod_BLGD": "oss_scan_fused", "fused_ld_BGLD":
               "ld_fused", "k1_BGDL": "oss_scan_fused"}
    times = race(calls, pool, REPEATS)
    bnd, by = bound_ms(ex2_rate=ex2_rate)
    ms = {k: statistics.median(v) for k, v in times.items()}
    for name in calls:
        parity = 0 if name == "k1_BGDL" else 2
        rows.append(dict(piece=name, ms=ms[name], all_ms=times[name],
                         bound_share=bnd / ms[name], kernel=kernels[name],
                         launches=parity + 1 + REPEATS))
    rows[-2]["speedup_vs_prod"] = ms["fused_prod_BLGD"] / ms["fused_ld_BGLD"]
    rows.append(dict(piece="bound", ms=bnd, bound_by=by,
                     shape=[B, G, L, D], N=N, R=R, dtype="bfloat16"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(device_of(args.device)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
