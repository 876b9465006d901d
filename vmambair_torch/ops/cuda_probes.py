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
- `scan_combined` (csrc/scan_lpar.cu with its second output): kvariants'
  `kernel_v16`, the forward scan and, from the same pass, a reverse scan
  restarted from zero at every chunk; one call is `SCAN_LPAR_GRIDS` grids.
- `scan_stack_ab`, `scan_stack_b` (csrc/scan_stack_bf16.cu): kvariants'
  `kernel_v3` (the (a, b) stack in bf16 over each chunk) and `kernel_v10`
  (the b stack in bf16 over sub-chunks of 128), each with an fp32 carry;
  one call is `SCAN_LPAR_GRIDS` grids.
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
from .cuda_scan import (MAX_SEQ_WIN, _gld, bl_flat, launch_views,
                        scan_views_ref, view_shapes)
from .selective_scan import _hillis_scan, _prep, selective_scan_chunked

PEAK_REP = 64                    # kpeak's REP: its parity point
PEAK_LANES = (128, 256, 512, 1024)  # rows the roll and shift probes take
SCAN_LPAR_GRIDS = 3              # grids one scan_lpar call launches
# positions of a window of the segmented scans (csrc/scan_seg.cuh: 32 lanes
# x 8 consecutive positions): v16's reverse keeps one total per window, and
# a bf16 stack spans a power of two of at least one lane's 8 positions
LPAR_WIN = 256
STACK_MIN_SUB = 8


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
    launch_views("vmt_scan_seq_fwd", *args, delta_softplus, reverse, (win,))
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
    hin, aend = torch.empty_like(hend), torch.empty_like(hend)
    launch_views("vmt_scan_lpar_fwd", *args, delta_softplus, reverse, (seg,),
                 buffers=(hend, aend, hin))
    scan_lpar.launches += 1
    return y


scan_seq.launches = 0
scan_lpar.launches = 0


# -- v16: the forward scan and a chunk-local reverse scan in one pass ----------

def _flat_prep(u, delta, A, B, C, D, delta_bias, softplus):
    """The views flattened and prepared as the plain scans take them: u
    and the post-softplus delta (b, l, dim) fp32, B and C (b, l, g, n)
    fp32, A and D fp32."""
    return _prep(bl_flat(u), bl_flat(delta), A, B.permute(0, 2, 1, 3),
                 C.permute(0, 2, 1, 3), D, delta_bias, softplus)[:6]


def _pad_l(t, Lp):
    """Zero-pads dim 1 (L) of a (b, L, ...) tensor to Lp."""
    pad = [0, 0] * (t.dim() - 2) + [0, Lp - t.shape[1]]
    return F.pad(t, pad)


def scan_combined_ref(u, delta, A, B, C, D, delta_bias, *, chunk,
                      delta_softplus=True):
    """Plain version of `scan_combined` (kvariants' kernel_v16,
    tools/kvariants.py:710): y, the forward scan, and y2 = D u + C h_rev,
    where h_rev is the reverse scan (h_t = exp(delta_t A) h_{t+1} +
    delta_t B_t u_t, the decay of position t as in the forward) restarted
    from zero at the end of every chunk of `chunk` positions. Views as
    `scan_views_ref`'s; returns (y, y2) in u's dtype."""
    bsz, G, L, dg = u.shape
    y = scan_views_ref(u, delta, A, B, C, D, delta_bias, delta_softplus,
                       False)
    # each chunk a row of its own; past L, delta = 0 and u = B = C = 0
    # leave the reverse state at 0
    nch = -(-L // chunk)
    Lp = nch * chunk

    def rows(t):
        t = _pad_l(t, Lp)
        return t.reshape(bsz * nch, chunk, *t.shape[2:])

    uf, df, _, Bf, Cf, _ = _flat_prep(u, delta, A, B, C, D, delta_bias,
                                      delta_softplus)
    y2 = selective_scan_chunked(rows(uf), rows(df), A, rows(Bf), rows(Cf),
                                D, None, False, reverse=True)
    y2 = y2.reshape(bsz, Lp, G * dg)[:, :L].to(u.dtype)
    return y, _gld(y2, G)


def scan_combined(u, delta, A, B, C, D, delta_bias, y, y2, *,
                  delta_softplus=True, chunk=1024):
    """The forward scan into the view y and the chunk-local reverse scan
    (restarted every `chunk` positions) into y2, which has y's shape,
    dtype and strides; N <= 16. Returns (y, y2)."""
    args = (u, delta, A, B, C, D, delta_bias, y)
    if on_cpu(*args, y2):
        view_shapes("scan_combined", u, delta, A, B, C, y)
        r, r2 = scan_combined_ref(*args[:7], chunk=chunk,
                                  delta_softplus=delta_softplus)
        return y.copy_(r), y2.copy_(r2)
    no_grad_needed("scan_combined", *args)
    if chunk < 1:
        raise ValueError(f"scan_combined: chunk={chunk}")
    if (y2.shape, y2.stride(), y2.dtype) != (y.shape, y.stride(), y.dtype):
        raise ValueError("scan_combined: y2 needs y's shape, strides and "
                         "dtype")
    bsz, G, L, dg, N = view_shapes("scan_combined", u, delta, A, B, C, y)
    nseg, nwin = -(-L // chunk), -(-chunk // LPAR_WIN)
    hend = torch.empty(bsz, G * dg, nseg, N, device=u.device)
    hin, aend = torch.empty_like(hend), torch.empty_like(hend)
    rtot = torch.empty(bsz, G * dg, nseg, nwin, N, device=u.device)
    rdec = torch.empty_like(rtot)
    launch_views("vmt_scan_combined_fwd", *args, delta_softplus, False,
                 (chunk,), buffers=(y2, hend, aend, hin, rtot, rdec))
    scan_combined.launches += 1
    return y, y2


scan_combined.launches = 0


# -- v3, v10: bf16 stacks ------------------------------------------------------

def _shift(t, k, dim):
    """t shifted by k along `dim`, zeros in front (the TPU kernels'
    concatenate of a zero block and t[..., :-k])."""
    n = t.shape[dim]
    z = torch.zeros_like(t.narrow(dim, 0, min(k, n)))
    return torch.cat([z, t.narrow(dim, 0, n - k)], dim) if k < n else z


def scan_stack_bf16_ref(u, delta, A, B, C, D, delta_bias, *, stack, sub,
                        delta_softplus=True):
    """Plain version of `scan_stack_ab` / `scan_stack_b`, rounding where
    the TPU kernels round. Within each sub-chunk of `sub` positions:

    - stack "ab" (kernel_v3, tools/kvariants.py:122, with sub = its chunk):
      a = exp(delta A) and b = delta u B rounded to bf16, the (a, b) pairs
      scanned in bf16 by Hillis-Steele;
    - stack "b" (kernel_v10, :326): b = delta u B in bf16, scanned by the
      log-domain Hillis-Steele: at step k, b_t += e_t b_{t-k} in bf16 with
      e_t = exp(A sd_t) rounded to bf16, sd_t the fp32 sum of the k
      deltas ending at t; then a = exp(A sd) over the whole prefix, fp32.

    Across sub-chunks the state is fp32: h = a h0 + b. y = C h + D u in
    fp32. Views as `scan_views_ref`'s; returns y in u's dtype."""
    if stack not in ("ab", "b"):
        raise ValueError(f"scan_stack_bf16_ref: stack={stack!r}")
    bsz, G, L, dg = u.shape
    N = A.shape[1]
    dim = G * dg
    nsub = -(-L // sub)
    Lp = nsub * sub
    # (b, nsub, sub, ...) blocks; past L, delta = 0 and u = B = C = 0 are
    # the identity (a = 1, b = 0)
    uf, df, Af, Bf, Cf, Df = _flat_prep(u, delta, A, B, C, D, delta_bias,
                                        delta_softplus)
    uf, df, Bf, Cf = (_pad_l(t, Lp) for t in (uf, df, Bf, Cf))

    def blk(t):
        return t.reshape(bsz, nsub, sub, *t.shape[2:])

    du = (df * uf).view(bsz, Lp, G, dg)
    b = blk((du[..., None] * Bf[:, :, :, None, :]).reshape(
        bsz, Lp, dim, N).to(torch.bfloat16))
    if stack == "ab":
        a = blk(torch.exp(df[..., None] * Af).to(torch.bfloat16))
        a, b = _hillis_scan(a, b, dim=2)
        a = a.float()
    else:
        sd = blk(df)                                      # (b, s, sub, dim)
        k = 1
        while k < sub:
            e = torch.exp(Af * sd[..., None]).to(torch.bfloat16)
            b = e * _shift(b, k, 2) + b
            sd = sd + _shift(sd, k, 2)
            k *= 2
        a = torch.exp(Af * sd[..., None])
    b = b.float()
    # the fp32 state entering each sub-chunk, then every position's
    h0 = torch.zeros(bsz, dim, N, device=u.device)
    hs = []
    for i in range(nsub):
        hs.append(h0)
        h0 = a[:, i, -1] * h0 + b[:, i, -1]
    h = a * torch.stack(hs, 1)[:, :, None] + b           # (b, s, sub, dim, n)
    h = h.reshape(bsz, Lp, G, dg, N)[:, :L]
    y = torch.einsum("blgn,blgdn->blgd", Cf[:, :L], h).reshape(bsz, L, dim)
    if Df is not None:
        y = y + uf[:, :L] * Df
    return _gld(y.to(u.dtype), G)


def _stack_wrapper(stack: str):
    def fn(u, delta, A, B, C, D, delta_bias, y, *, chunk=1024, sub=None,
           last_bf16=False, delta_softplus=True):
        """The bf16-stack scan into the view y: the stack restarts every
        `sub` positions (default `chunk`), the fp32 state carries across;
        the kernel cuts L into segments of `chunk`, a multiple of `sub`,
        a power of two of at least 8. N <= 16. `last_bf16`: the kernel
        composes each position's last step in bf16, where the TPU's last
        Hillis-Steele step rounds, instead of applying it in fp32 (the
        plain version, which follows the TPU's rounding, serves both).
        Returns y."""
        sub = sub or chunk
        args = (u, delta, A, B, C, D, delta_bias, y)
        if on_cpu(*args):
            view_shapes(fn.__name__, u, delta, A, B, C, y)
            return y.copy_(scan_stack_bf16_ref(
                *args[:7], stack=stack, sub=sub,
                delta_softplus=delta_softplus))
        no_grad_needed(fn.__name__, *args)
        if sub < STACK_MIN_SUB or sub & (sub - 1) or chunk % sub:
            raise ValueError(f"{fn.__name__}: sub={sub} must be a power of "
                             f"two >= {STACK_MIN_SUB} that divides "
                             f"chunk={chunk}")
        bsz, G, L, dg, N = view_shapes(fn.__name__, u, delta, A, B, C, y)
        hend = torch.empty(bsz, G * dg, -(-L // chunk), N, device=u.device)
        aend, hin = torch.empty_like(hend), torch.empty_like(hend)
        launch_views("vmt_scan_stack_fwd", *args, delta_softplus, False,
                     (chunk, sub, int(stack == "ab"), int(bool(last_bf16))),
                     buffers=(hend, aend, hin))
        fn.launches += 1
        return y

    fn.__name__ = f"scan_stack_{stack}"
    fn.launches = 0
    return fn


scan_stack_ab = _stack_wrapper("ab")   # kvariants' v3
scan_stack_b = _stack_wrapper("b")     # kvariants' v10


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
