"""Kernels of the scan-design probes (`vmambair_torch/tools/`), their plain
versions, and their launch counts.

Counterparts of the TPU probes `tools/kseq.py`, `tools/kvariants.py` and
`tools/kpeak.py`:

- `scan_seq` (csrc/scan_seq.cu): the sequential-over-L register scan, one
  thread per (b, channel), inputs staged in windows of `win` positions
  (kseq's `kernel_seq` at win 1, `kernel_seq_win` at 8 and 16, kvariants'
  `kernel_v12_ld` on channels-last views).
- `scan_lpar` (csrc/scan_lpar.cu): the L-parallel segmented scan, segments
  of `seg` positions (kvariants' exact Hillis-Steele and log-domain
  families); one call is `SCAN_LPAR_GRIDS` grid launches (segments,
  combine, segments again) and counts one.
- `peak_fma_fp32`, `peak_fma_bf16`, `peak_exp`, `peak_roll`, `peak_shift`
  (csrc/peak.cu): kpeak's primitive chains on a (GRID, ROWS, LANES) array.

The scans take (b, g, l, d) views of u, delta and y and (b, g, l, n) views
of B and C, of any strides, and write y in place: the caller chooses every
layout (DL (B, D, L), LD (B, L, D), kseq's (G, L, 8, Dg)) by the views it
passes. A tensor on the CPU goes to the plain version; a CUDA tensor to the
kernel, or the call raises. No wrapper has a backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .._build import no_grad_needed, on_cpu
from .cuda_scan import (MAX_SEQ_WIN, launch_views, scan_views_ref,
                        view_shapes)

PEAK_REP = 64                    # kpeak's REP: its parity point
PEAK_LANES = (128, 256, 512, 1024)  # rows the roll and shift probes take
SCAN_LPAR_GRIDS = 3              # grids one scan_lpar call launches


# -- the scans -----------------------------------------------------------------

def scan_seq(u, delta, A, B, C, D, delta_bias, y, *, delta_softplus=True,
             reverse=False, win=1):
    """The sequential register scan into the view y (see the module's
    docstring for the views); N <= 16, 1 <= win <= 16. Returns y."""
    args = (u, delta, A, B, C, D, delta_bias, y)
    if on_cpu(*args):
        view_shapes("scan_seq", u, delta, A, B, C, y)
        return y.copy_(scan_views_ref(*args[:7], delta_softplus, reverse))
    no_grad_needed("scan_seq", *args)
    if not 1 <= win <= MAX_SEQ_WIN:
        raise ValueError(f"scan_seq: win={win} outside 1..{MAX_SEQ_WIN}")
    launch_views("vmt_scan_seq_fwd", *args, delta_softplus, reverse, win)
    scan_seq.launches += 1
    return y


def scan_lpar(u, delta, A, B, C, D, delta_bias, y, *, delta_softplus=True,
              reverse=False, seg=1024):
    """The L-parallel segmented scan into the view y, segments of `seg`
    positions; N <= 16. Returns y."""
    args = (u, delta, A, B, C, D, delta_bias, y)
    if on_cpu(*args):
        view_shapes("scan_lpar", u, delta, A, B, C, y)
        return y.copy_(scan_views_ref(*args[:7], delta_softplus, reverse))
    no_grad_needed("scan_lpar", *args)
    if seg < 1:
        raise ValueError(f"scan_lpar: seg={seg}")
    bsz, G, L, dg, N = view_shapes("scan_lpar", u, delta, A, B, C, y)
    nseg = -(-L // seg)
    hend = torch.empty(bsz, G * dg, nseg, N, device=u.device)
    hin = torch.empty_like(hend)
    sdel = torch.empty(bsz, G * dg, nseg, device=u.device)
    launch_views("vmt_scan_lpar_fwd", *args, delta_softplus, reverse, seg,
                 scratch=(hend, sdel, hin))
    scan_lpar.launches += 1
    return y


scan_seq.launches = 0
scan_lpar.launches = 0


# -- kpeak's probes --------------------------------------------------------------

_PEAK_CODE = {"fma": 0, "exp": 1, "roll": 2, "shift": 3}


def peak_ref(probe: str, x: torch.Tensor, rep: int = PEAK_REP):
    """Plain version of kpeak's kernels (tools/kpeak.py:56-89) on a
    (GRID, ROWS, LANES) array, in x's dtype."""
    v = x
    if probe == "fma":
        a = v * 0.999
        chains = [v * (1.0 + 0.01 * i) for i in range(8)]
        for _ in range(rep // 8):
            chains = [a * c + 0.001 for c in chains]
        out = chains[0]
        for c in chains[1:]:
            out = out + c
        return out
    if probe == "exp":
        for _ in range(rep):
            v = torch.exp(v * -0.5)
        return v
    for i in range(rep):
        if probe == "roll":
            v = v + torch.roll(v, 1 + i % 8, dims=-1)
        else:
            k = 1 << (i % 7)
            v = v + F.pad(v[..., :-k], (k, 0))
    return v * 1e-30


def _peak_wrapper(probe: str, dtype: torch.dtype):
    def fn(x: torch.Tensor, rep: int = PEAK_REP) -> torch.Tensor:
        if x.dtype != dtype or x.dim() != 3:
            raise ValueError(f"{fn.__name__}: takes a 3-D {dtype} array, "
                             f"got {tuple(x.shape)} {x.dtype}")
        if on_cpu(x):
            return peak_ref(probe, x, rep)
        no_grad_needed(fn.__name__, x)
        lanes = x.shape[2]
        if probe in ("roll", "shift") and lanes not in PEAK_LANES:
            raise ValueError(f"{fn.__name__}: LANES={lanes} not in "
                             f"{PEAK_LANES}")
        if not x.is_contiguous() or x.numel() % 2 or rep < 0:
            raise ValueError(f"{fn.__name__}: needs a contiguous array of "
                             "an even size and rep >= 0")
        y = torch.empty_like(x)
        _build.launch("vmt_peak", x.device, _PEAK_CODE[probe], x.data_ptr(),
                      _build.dtype_code(x, "x"), y.data_ptr(),
                      x.shape[0] * x.shape[1], lanes, rep)
        fn.launches += 1
        return y

    fn.__name__ = f"peak_{probe}_{str(dtype)[6:]}"
    fn.launches = 0
    return fn


peak_fma_fp32 = _peak_wrapper("fma", torch.float32)
peak_fma_bf16 = _peak_wrapper("fma", torch.bfloat16)
peak_exp = _peak_wrapper("exp", torch.float32)
peak_roll = _peak_wrapper("roll", torch.float32)
peak_shift = _peak_wrapper("shift", torch.float32)
# kpeak's tags, in its order; each probe's operations per element and rep
# (kpeak's `ops_per_rep`)
PEAK_PROBES = {
    "fma_fp32": (peak_fma_fp32, "fma", torch.float32, 2),
    "fma_bf16": (peak_fma_bf16, "fma", torch.bfloat16, 2),
    "exp_fp32": (peak_exp, "exp", torch.float32, 1),
    "roll+add_fp32": (peak_roll, "roll", torch.float32, 2),
    "concatshift+add_fp32": (peak_shift, "shift", torch.float32, 2),
}
