"""Scan-kernel variant race on an NVIDIA GPU: the counterpart of the TPU
race `tools/kvariants.py`.

Every variant is the grouped selective-scan forward (softplus delta, D
skip, fp32 state, bf16 output) at MambaSISR6's full-resolution
decoder/refinement scan: B = 8 tiles of 128x128, L = 16384, G = 2 groups
x 96 channels, N = 16. Inputs in the TPU race's DL layout (B, DIM, L), B
and C (B, G, N, L), bf16; the channels-last variants read (B, L, DIM)
copies made with the inputs (the relayout is not timed).

    k4            production K4 (`cuda_scan.selective_scan_fwd`) on DL
    k4_ld         K4 on the channels-last copies (it takes strides)
    seq           csrc/scan_seq.cu on DL, windows of 1 (kseq's kernel_seq)
    seq_win8      ... windows of 8 (kseq's kernel_seq_win)
    seq_win16     ... windows of 16
    seq_ld        K7 (`cuda_scan.selective_scan_ld_fwd`, scan_seq.cu in
                  windows of 8) on build_ld's channels-last layout (v12_ld)
    lpar_256      csrc/scan_lpar.cu on DL, segments of 256 positions (the
    lpar_1024     exact Hillis-Steele and log-domain families v0, v1, v6,
    lpar_4096     v8, v8s, v9, v11, v13, v14, v15, v15b, v19)
    lpar_ld_1024  scan_lpar.cu on the channels-last copies
    v16_combined_128
                  scan_lpar.cu's combined pass (`cuda_probes.scan_combined`):
                  y and a reverse scan restarted every chunk, y2
    v3            csrc/scan_stack_bf16.cu, the (a, b) stack in bf16 over
                  each chunk, fp32 carry (`scan_stack_ab`)
    v10_128       ... the b stack in bf16 over sub-chunks of 128
                  (`scan_stack_b`)

The chunk is the TPU race's grid chunk, part of the function of v3 and of
v16's y2: 1024 at the race's size, 256 at the interpret size of `--device
cpu` (the TPU race's interpret CHUNK).

    v22_dual_128_128 ... v26_midopt_128_32, v4_128
                  the TPU race's separated-exponent scans under its own 15
                  names (`SEPARATED`): csrc/scan_dual.cu, one warp per
                  channel walking L in windows of `sub` positions
                  (`cuda_probes.scan_dual_v22` / `_v24` / `_v26`,
                  `scan_cumsum`), each held to its own plain version
                  (`cuda_probes.scan_dual_v22_ref`, ...). v4 overflows fp32
                  where |A| sum delta passes ~88.7 nats over a window (the
                  default recipe): its parity compares the elements where
                  the kernel and the plain version are both finite, and
                  its row gives both non-finite shares.

    python -m vmambair_torch.tools.kvariants [names] [--device cuda|cpu]
        [--delta default|real]

`--delta real` (or VMAMBAIR_KV_DELTA=real, as for the TPU race) draws the
model-realistic recipe: post-softplus delta log-uniform in [1e-3, 0.1],
A = -n. Parity: each variant against its plain version on the first 2048
positions, within the bf16 envelope (rtol 3e-2, atol 5e-2), before any
timing; a variant off it raises. The plain version is the plain chunked
scan; for v16 also the plain reverse scan of each chunk (y2); for the bf16
stacks v3 and v10 `cuda_probes.scan_stack_bf16_ref`, which rounds where
the TPU kernels round; for the separated-exponent scans their own
transcriptions of the TPU bodies. The distance of the stacks and of the
separated-exponent scans from the exact scan is a finding, not a gate,
and their rows report it: under the default recipe (post-softplus delta
near 0.9) the stacks leave the exact scan's envelope, as the TPU's
kernels do in interpret mode, since their rounding error is a bf16 ulp of
states several times larger than y; the separated exponents pass their
clamp of 120 bits there (v4 overflows). On the card k4 and lpar_1024 are
raced whatever the names, and each row gives its time over theirs: v16
under twice lpar_1024's time is the test the TPU kernel_v16's docstring
sets for a combined pass to be able to win.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics

import torch

from ..ops import cuda_probes, cuda_scan
from . import check_envelope, device_of, max_err, outside, race

# hot level-1 decoder shape, with the TPU race's grid chunk
SHAPE = dict(B=8, L=16384, D=96, G=2, N=16, chunk=1024)
CPU_SHAPE = dict(SHAPE, B=2, L=512, chunk=256)  # the TPU race's interpret size
PARITY_L = 2048
REPEATS = 5
POOL = 3
BF16 = torch.bfloat16

V10_SUB = 128
# TPU variant families by number: not carried, or carried by the
# L-parallel and channels-last variants here
NOT_CARRIED = set()
EXACT = {0, 1, 6, 8, 9, 11, 12, 13, 14, 15, 19}
# the TPU race's separated-exponent names (tools/kvariants.py:1033-1070):
# name -> (form of csrc/scan_dual.cu, sub, blk, options); v4 is the cumsum
# form, whose block is its window
SEPARATED = {
    "v22_dual_128_128": ("v22", 128, 128, {}),
    "v22_dual_128_64": ("v22", 128, 64, {}),
    "v22_dual_128_32": ("v22", 128, 32, {}),
    "v22_dual_128_16": ("v22", 128, 16, {}),
    "v22_dual_256_32": ("v22", 256, 32, {}),
    "v23_dualbf16_128_32": ("v22", 128, 32, {"zdt": torch.bfloat16}),
    "v24_mmfix_128_32": ("v24", 128, 32, {}),
    "v24_mmfix_128_16": ("v24", 128, 16, {}),
    "v25_mid_128_64": ("v24", 128, 64, {"mid": True}),
    "v25_mid_256_64": ("v24", 256, 64, {"mid": True}),
    "v25_mid_256_128": ("v24", 256, 128, {"mid": True}),
    "v25_mid_128_32": ("v24", 128, 32, {"mid": True}),
    "v26_midopt_128_64": ("v26", 128, 64, {}),
    "v26_midopt_128_32": ("v26", 128, 32, {}),
    "v4_128": ("v4", 128, 128, {}),
}
# the variants whose output may overflow: parity where both are finite
MAY_OVERFLOW = {"v4_128"}
BASES = ("k4", "lpar_1024")


@dataclasses.dataclass(frozen=True)
class Shape:
    B: int
    L: int
    D: int
    G: int
    N: int
    chunk: int  # v3's stack and v16's reverse span it

    @property
    def dim(self) -> int:
        return self.G * self.D


def make_inputs(shape: Shape, seed: int, device,
                delta: str = "default") -> dict:
    """The TPU race's `make_inputs` (tools/kvariants.py:1169-1195), drawn by
    a torch.Generator: u, delta (B, DIM, L) bf16; Bm, Cm (B, G, N, L) bf16;
    A (DIM, N), Dv (DIM,) ones, bias (DIM,) fp32; and the channels-last
    copies u_ld, delta_ld (B, L, DIM)."""
    B, L, G, N, dim = shape.B, shape.L, shape.G, shape.N, shape.dim
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g, device=device)

    inp = {"u": randn(B, dim, L).to(BF16)}
    if delta == "real":
        lo, hi = math.log(1e-3), math.log(0.1)
        tgt = torch.exp(torch.rand(B, dim, L, generator=g, device=device)
                        * (hi - lo) + lo)
        inp["delta"] = torch.log(torch.expm1(tgt)).to(BF16)
        inp["A"] = -torch.arange(1, N + 1, dtype=torch.float32,
                                 device=device).expand(dim, N).contiguous()
    else:
        inp["delta"] = (randn(B, dim, L).to(BF16).abs() * 0.5)
        inp["A"] = -torch.exp(randn(dim, N) * 0.5)
    inp["Bm"] = randn(B, G, N, L).to(BF16)
    inp["Cm"] = randn(B, G, N, L).to(BF16)
    inp["Dv"] = torch.ones(dim, device=device)
    inp["bias"] = randn(dim) * 0.01
    inp["u_ld"] = inp["u"].transpose(1, 2).contiguous()
    inp["delta_ld"] = inp["delta"].transpose(1, 2).contiguous()
    return inp


def sliced(inp: dict, L: int) -> dict:
    """The inputs' first L positions (views)."""
    out = dict(inp)
    for k in ("u", "delta", "Bm", "Cm"):
        out[k] = inp[k][..., :L]
    for k in ("u_ld", "delta_ld"):
        out[k] = inp[k][:, :L]
    return out


def gdl(t: torch.Tensor, G: int) -> torch.Tensor:
    """(B, G*D, L) -> its (b, g, l, d) view."""
    b, dim, L = t.shape
    return t.view(b, G, dim // G, L).permute(0, 1, 3, 2)


def gld(t: torch.Tensor, G: int) -> torch.Tensor:
    """(B, L, G*D) -> its (b, g, l, d) view."""
    b, L, dim = t.shape
    return t.view(b, L, G, dim // G).permute(0, 2, 1, 3)


def _bln(t: torch.Tensor) -> torch.Tensor:
    """B or C (B, G, N, L) -> the (B, L, G, N) view K4 and K7 take."""
    return t.permute(0, 3, 1, 2)


def params(inp):
    """A, B and C as K4 and K7 take them, D, bias."""
    return inp["A"], _bln(inp["Bm"]), _bln(inp["Cm"]), inp["Dv"], inp["bias"]


# each runner returns y as (B, DIM, L) (a view for the channels-last ones),
# in the inputs' dtype


def run_k4(inp, reverse=False, ld=False):
    u, d = (inp["u_ld"], inp["delta_ld"]) if ld else (
        inp["u"].transpose(1, 2), inp["delta"].transpose(1, 2))
    y = cuda_scan.selective_scan_fwd(u, d, *params(inp), True, reverse,
                                     u.dtype)
    return y.transpose(1, 2)


def run_seq_ld(inp, reverse=False):
    u = inp["u_ld"]
    y = cuda_scan.selective_scan_ld_fwd(u, inp["delta_ld"], *params(inp),
                                        True, reverse, u.dtype)
    return y.transpose(1, 2)


def views(inp, y, ld):
    """The (b, g, l, d) / (b, g, l, n) views of the inputs and of y (DL:
    (B, DIM, L); channels-last: (B, L, DIM))."""
    G = inp["Bm"].shape[1]
    to = gld if ld else gdl
    u, d = (inp["u_ld"], inp["delta_ld"]) if ld else (inp["u"], inp["delta"])
    return (to(u, G), to(d, G), inp["A"], inp["Bm"].permute(0, 1, 3, 2),
            inp["Cm"].permute(0, 1, 3, 2), inp["Dv"], inp["bias"], to(y, G))


def run_seq(inp, reverse=False, win=1, seg=None):
    y = torch.empty_like(inp["u"])
    cuda_probes.scan_seq(*views(inp, y, False), reverse=reverse, win=win,
                         seg=seg)
    return y


def run_lpar(inp, reverse=False, seg=1024, ld=False):
    y = torch.empty_like(inp["u_ld"] if ld else inp["u"])
    cuda_probes.scan_lpar(*views(inp, y, ld), reverse=reverse, seg=seg)
    return y.transpose(1, 2) if ld else y


def run_combined(inp, chunk):
    """v16: (y, y2), y2 the reverse scan restarted every `chunk`
    positions, both (B, DIM, L)."""
    y, y2 = torch.empty_like(inp["u"]), torch.empty_like(inp["u"])
    v = views(inp, y, False)
    cuda_probes.scan_combined(*v, gdl(y2, inp["Bm"].shape[1]), chunk=chunk)
    return y, y2


def run_stack(inp, stack, chunk, sub=None, last_bf16=False):
    """v3 (stack "ab": the bf16 stack over each chunk of `chunk`) and v10
    (stack "b": over sub-chunks of `sub`): y (B, DIM, L). `last_bf16` as
    `cuda_probes.scan_stack_ab`'s."""
    y = torch.empty_like(inp["u"])
    fn = cuda_probes.scan_stack_ab if stack == "ab" else \
        cuda_probes.scan_stack_b
    fn(*views(inp, y, False), chunk=chunk, sub=sub, last_bf16=last_bf16)
    return y


def dl_of(t: torch.Tensor) -> torch.Tensor:
    """A (b, g, l, d) view -> (B, G*D, L)."""
    return t.permute(0, 1, 3, 2).reshape(t.shape[0], -1, t.shape[2])


def ref_stack(inp, stack, chunk, sub=None):
    """The plain version of `run_stack` (TPU's rounding points), (B, DIM,
    L)."""
    return dl_of(cuda_probes.scan_stack_bf16_ref(
        *views(inp, inp["u"], False)[:7], stack=stack, sub=sub or chunk))


def ref_combined(inp, chunk):
    """The plain version of `run_combined`: (y, y2)."""
    return run_reference(inp), run_reference_rev_chunks(inp, chunk)


def sep_kernel(name: str) -> str:
    """The wrapper (chip_smoke.py's kernel name) that runs a
    separated-exponent variant."""
    form = SEPARATED[name][0]
    return "scan_cumsum" if form == "v4" else f"scan_dual_{form}"


def run_sep(inp, name, reverse=False):
    """A separated-exponent variant (`SEPARATED`) on DL: y (B, DIM, L)."""
    form, sub, blk, opts = SEPARATED[name]
    y = torch.empty_like(inp["u"])
    v = views(inp, y, False)
    if form == "v4":
        cuda_probes.scan_cumsum(*v, sub=sub, reverse=reverse)
    else:
        cuda_probes.scan_dual(*v, form=form, sub=sub, blk=blk,
                              reverse=reverse, **opts)
    return y


def ref_sep(inp, name, reverse=False):
    """The plain version of `run_sep`, (B, DIM, L)."""
    form, sub, blk, opts = SEPARATED[name]
    v = views(inp, inp["u"], False)[:7]
    if form == "v4":
        y = cuda_probes.scan_cumsum_v4_ref(*v, sub=sub, reverse=reverse)
    else:
        y = cuda_probes.DUAL_REFS[form](*v, sub=sub, blk=blk,
                                        reverse=reverse, **opts)
    return dl_of(y)


# name -> (call(inputs, chunk) -> y as (B, DIM, L), the kernel it launches
# by chip_smoke.py's names, its plain version (call(inputs, chunk)) where
# that is not the plain chunked scan)
VARIANTS = {
    "k4": (lambda i, chunk: run_k4(i), "selective_scan", None),
    "k4_ld": (lambda i, chunk: run_k4(i, ld=True), "selective_scan", None),
    "seq": (lambda i, chunk: run_seq(i, win=1), "scan_seq", None),
    "seq_win8": (lambda i, chunk: run_seq(i, win=8), "scan_seq", None),
    "seq_win16": (lambda i, chunk: run_seq(i, win=16), "scan_seq", None),
    "seq_ld": (lambda i, chunk: run_seq_ld(i), "selective_scan_ld", None),
    "lpar_256": (lambda i, chunk: run_lpar(i, seg=256), "scan_lpar", None),
    "lpar_1024": (lambda i, chunk: run_lpar(i, seg=1024), "scan_lpar",
                  None),
    "lpar_4096": (lambda i, chunk: run_lpar(i, seg=4096), "scan_lpar",
                  None),
    "lpar_ld_1024": (lambda i, chunk: run_lpar(i, seg=1024, ld=True),
                     "scan_lpar", None),
    # the TPU race's own names; v16's call returns (y, y2)
    "v16_combined_128": (run_combined, "scan_combined", ref_combined),
    "v3": (lambda i, chunk: run_stack(i, "ab", chunk), "scan_stack_ab",
           lambda i, chunk: ref_stack(i, "ab", chunk)),
    "v10_128": (lambda i, chunk: run_stack(i, "b", chunk, V10_SUB),
                "scan_stack_b",
                lambda i, chunk: ref_stack(i, "b", chunk, V10_SUB)),
}
VARIANTS.update({
    name: (lambda i, chunk, n=name: run_sep(i, n), sep_kernel(name),
           lambda i, chunk, n=name: ref_sep(i, n))
    for name in SEPARATED})


def check_names(names: list) -> None:
    """Raises for a name this race does not carry, naming where the TPU
    variant stands."""
    for name in names:
        if name in VARIANTS:
            continue
        m = re.match(r"v(\d+)", name)
        fam = int(m.group(1)) if m else None
        if fam in NOT_CARRIED:
            raise ValueError(f"{name}: the TPU's family v{fam} is not "
                             "carried")
        if fam in (4, 22, 23, 24, 25, 26):
            raise ValueError(
                f"{name}: an unsupported (sub, blk) of the TPU's "
                "separated-exponent families; the race carries "
                f"{list(SEPARATED)} (csrc/scan_dual.cu takes sub in "
                f"{cuda_probes.DUAL_SUBS}, blk in {cuda_probes.DUAL_BLKS})")
        if fam in EXACT:
            raise ValueError(
                f"{name}: the TPU's exact families are carried by lpar_256, "
                "lpar_1024, lpar_4096 (DL) and seq_ld, lpar_ld_1024 "
                "(channels last)")
        raise ValueError(f"{name}: unknown variant; known: {list(VARIANTS)}")


def off_envelope(got, ref) -> float:
    """The share of elements of got outside ref's bf16 envelope."""
    return outside(got, ref).float().mean().item()


def _check(name, what, got, ref):
    return check_envelope(f"kvariants {name}: {what}", got, ref)


def parity(names: list, shape: Shape, device, delta: str) -> dict:
    """Each variant on the first PARITY_L positions of a seeded input set
    against its plain version (`VARIANTS`); raises outside the bf16
    envelope. Returns name -> (max abs err, relative err) of y; for v16
    name + ":y2" -> y2's; for the bf16 stacks and the separated-exponent
    scans name + ":exact" -> (max abs err, share of elements off the
    envelope) of y against the exact scan. A variant that may overflow
    (`MAY_OVERFLOW`) is compared where it and its plain version are both
    finite (the max abs err against the exact scan too; a non-finite
    element counts as off the envelope), and name + ":nonfinite" gives the
    kernel's and the plain version's shares of non-finite elements."""
    inp = sliced(make_inputs(shape, 42, device, delta),
                 min(PARITY_L, shape.L))
    exact = run_reference(inp)
    out = {}
    for name in names:
        call, _, plain = VARIANTS[name]
        got = call(inp, shape.chunk)
        ref = plain(inp, shape.chunk) if plain else exact
        if isinstance(got, tuple):
            (got, y2), (ref, ref2) = got, ref
            out[name + ":y2"] = _check(name, "y2", y2, ref2)
        elif name in MAY_OVERFLOW:
            fin, fin_ref = torch.isfinite(got), torch.isfinite(ref)
            out[name + ":nonfinite"] = (1 - fin.float().mean().item(),
                                        1 - fin_ref.float().mean().item())
            both = fin & fin_ref
            if not both.any():
                raise RuntimeError(f"kvariants {name}: no element where "
                                   "it and its plain version are finite")
            out[name + ":exact"] = (max_err(got[both], exact[both])[0],
                                    off_envelope(got, exact))
            got, ref = got[both], ref[both]
        elif plain:
            out[name + ":exact"] = (max_err(got, exact)[0],
                                    off_envelope(got, exact))
        out[name] = _check(name, "y", got, ref)
    return out


def run_reference(inp, reverse=False):
    """The plain chunked scan on DL inputs, as (B, DIM, L) in their
    dtype."""
    u, d = inp["u"].transpose(1, 2), inp["delta"].transpose(1, 2)
    return cuda_scan.selective_scan_ref(u, d, *params(inp), True, reverse,
                                        u.dtype).transpose(1, 2)


def run_reference_rev_chunks(inp, chunk):
    """The plain reverse scan of each chunk of `chunk` positions on its
    own (v16's y2), as (B, DIM, L)."""
    parts = []
    for c0 in range(0, inp["u"].shape[2], chunk):
        part = dict(inp)
        for k in ("u", "delta", "Bm", "Cm"):
            part[k] = inp[k][..., c0:c0 + chunk]
        parts.append(run_reference(part, True))
    return torch.cat(parts, 2)


# kernel launches `run` makes for each variant: the parity check, the
# warm-up and the timed calls
LAUNCHES_PER_VARIANT = 2 + REPEATS


def run(names: list, device, shape: Shape = None,
        delta: str = "default") -> list:
    """Parity, then (on CUDA) the interleaved race; one row per variant. On
    CUDA the race takes k4 and lpar_1024 whatever the names (each row's
    time over theirs)."""
    check_names(names)
    cpu = device.type == "cpu"
    if not cpu:
        names = list(names) + [b for b in BASES if b not in names]
    shape = shape or Shape(**(CPU_SHAPE if cpu else SHAPE))
    errs = parity(names, shape, device, delta)
    rows = [dict(variant=n, max_abs_err=errs[n][0], rel_err=errs[n][1])
            for n in names]
    for row in rows:
        name = row["variant"]
        if name + ":y2" in errs:
            row["y2_max_abs_err"], row["y2_rel_err"] = errs[name + ":y2"]
        if name + ":exact" in errs:
            row["exact_max_abs_err"], row["exact_off_envelope"] = errs[
                name + ":exact"]
        if name + ":nonfinite" in errs:
            row["nonfinite_share"], row["plain_nonfinite_share"] = errs[
                name + ":nonfinite"]
    if cpu:
        return rows
    pool = [make_inputs(shape, seed, device, delta)
            for seed in range(1, POOL + 1)]
    times = race({n: (lambda i, n=n: VARIANTS[n][0](i, shape.chunk))
                  for n in names}, pool, REPEATS)
    del pool
    elems = shape.B * shape.L * shape.dim * shape.N
    base = {b: statistics.median(times[b]) for b in BASES}
    for row in rows:
        ms = statistics.median(times[row["variant"]])
        row.update(ms=ms, gelem_per_s=elems / ms / 1e6,
                   all_ms=times[row["variant"]],
                   kernel=VARIANTS[row["variant"]][1],
                   launches=LAUNCHES_PER_VARIANT)
        for b, t in base.items():
            row[f"ms_over_{b}"] = ms / t
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--delta", choices=("default", "real"),
                    default=os.environ.get("VMAMBAIR_KV_DELTA") or "default")
    args = ap.parse_args(argv)
    for row in run(args.names, device_of(args.device), delta=args.delta):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
