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
- `gdfn_tanh_nhwc` (csrc/gdfn.cu, K2's kernel with a tanh gate and the
  NHWC layout as policies): keffn's `_gdfn_kernel`, the fused GDFN
  residual `x + W_out (gelu_tanh(x1) x2)`, `[x1 | x2] = dw3x3(W_in LN(x))`;
  `gdfn_tanh_composite` is keffn's `gdfn_xla`, its race partner.
- `probe_transpose`, `probe_proj` (csrc/probe_io.cu): kprobe's in-kernel
  transpose pair and in-kernel projections on (B, L, D) chunks.
- `ld_fused` (csrc/oss_scan_fused.cu, K1 with the Ld layout policy):
  kldio's `_ld_kernel`, the projection-fused scan read and written
  channels-last, (B, G, L, D).

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
from .._build import dtype_code, f32, no_grad_needed, on_cpu
from .cuda_effn import MAX_C
from .cuda_scan import (MAX_SEQ_WIN, _gld, bl_flat, k1_sizes, launch_views,
                        oss_scan_fused_ref, scan_views_ref, view_shapes)
from .selective_scan import _hillis_scan, _prep, selective_scan_chunked

PROBE_MAX_D = 256                # kprobe: the tile in shared memory
PROBE_MAX_RN = 64                # kprobe: rows of W_xp (csrc/probe_io.cu)
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


# -- keffn: the fused GDFN, channels-last, tanh gate -----------------------------

def _gdfn_shapes(name, x, ln_w, ln_b, w_in, w_dw, w_out):
    b, h, w, c = x.shape
    hid = w_out.shape[0]
    if w_in.shape != (c, 2 * hid) or w_dw.shape != (3, 3, 2 * hid) \
            or w_out.shape != (hid, c) or ln_w.shape != (c,) \
            or ln_b.shape != (c,):
        raise ValueError(f"{name}: weight shapes do not agree with x "
                         f"{tuple(x.shape)}: w_in {tuple(w_in.shape)}, "
                         f"w_dw {tuple(w_dw.shape)}, w_out "
                         f"{tuple(w_out.shape)}")
    return b, h, w, c, hid


def gdfn_tanh_ref(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5):
    """Plain version of keffn's `_gdfn_kernel` (tools/keffn.py:46), in its
    layouts: x (B, H, W, C); ln_w, ln_b (C,); w_in (C, 2h); w_dw (3, 3,
    2h); w_out (h, C). Rounds where the TPU kernel rounds: LN(x) (fp32
    statistics) and the weights to x's dtype; the hidden map and the
    depthwise conv (zero padding, taps summed row by row) in fp32; the gate
    gelu_tanh(x1) * x2 to x's dtype; the residual added in fp32. Every row
    is computed (the TPU kernel drops rows past (H // 16) * 16)."""
    _, h, w, c, hid = _gdfn_shapes("gdfn_tanh_ref", x, ln_w, ln_b, w_in,
                                   w_dw, w_out)
    cdt = x.dtype
    zn = F.layer_norm(x.float(), (c,), ln_w.float(), ln_b.float(),
                      eps).to(cdt).float()
    y1 = F.pad(zn @ w_in.to(cdt).float(), (0, 0, 1, 1, 1, 1))
    wdw = w_dw.to(cdt).float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = y1[:, dy:dy + h, dx:dx + w] * wdw[dy, dx]
            acc = term if acc is None else acc + term
    g = (F.gelu(acc[..., :hid], approximate="tanh") * acc[..., hid:]).to(cdt)
    return (x.float() + g.float() @ w_out.to(cdt).float()).to(cdt)


def gdfn_tanh_composite(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5):
    """keffn's `gdfn_xla` (tools/keffn.py:141), its race partner:
    LayerNorm, then the three convolutions on channels-last tensors
    (cuDNN), each rounding its output to x's dtype as XLA's do, the gate
    and the residual in x's dtype. Arguments as `gdfn_tanh_ref`."""
    *_, c, hid = _gdfn_shapes("gdfn_tanh_composite", x, ln_w, ln_b, w_in,
                              w_dw, w_out)
    cdt = x.dtype
    cl = torch.channels_last
    # NCHW views of channels-last memory: no copy
    zn = F.layer_norm(x.float(), (c,), ln_w.float(), ln_b.float(),
                      eps).to(cdt).permute(0, 3, 1, 2)
    y = F.conv2d(zn, w_in.to(cdt).t()[:, :, None, None].contiguous(
        memory_format=cl))
    y = F.conv2d(y, w_dw.to(cdt).permute(2, 0, 1)[:, None].contiguous(
        memory_format=cl), padding=1, groups=2 * hid)
    g = (F.gelu(y[:, :hid], approximate="tanh") * y[:, hid:]).contiguous(
        memory_format=cl)
    out = F.conv2d(g, w_out.to(cdt).t()[:, :, None, None].contiguous(
        memory_format=cl))
    return x + out.permute(0, 2, 3, 1)


def gdfn_tanh_nhwc(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5):
    """keffn's fused GDFN residual in one kernel (csrc/gdfn.cu,
    `vmt_gdfn_tanh_nhwc_fwd`); arguments as `gdfn_tanh_ref`, C <= 384, any
    H and W. Returns (B, H, W, C) in x's dtype."""
    args = (x, ln_w, ln_b, w_in, w_dw, w_out)
    if on_cpu(*args):
        return gdfn_tanh_ref(*args, eps=eps)
    no_grad_needed("gdfn_tanh_nhwc", *args)
    b, h, w, c, hid = _gdfn_shapes("gdfn_tanh_nhwc", *args)
    if c > MAX_C:
        raise ValueError(f"gdfn_tanh_nhwc: C={c} > {MAX_C}")
    x = x.contiguous()
    y = torch.empty_like(x)
    # weights rounded to the activation dtype, as the TPU kernel takes
    # them; K2's argument layouts: w_in is win_t as it stands, w_out is
    # wout_t, w_dw goes to (2h, 9)
    cdt = x.dtype
    win_t = f32(w_in.to(cdt))
    wdw = f32(w_dw.to(cdt).reshape(9, 2 * hid).t())
    wout_t = f32(w_out.to(cdt))
    lnw, lnb = f32(ln_w), f32(ln_b)
    _build.launch(
        "vmt_gdfn_tanh_nhwc_fwd", x.device,
        x.data_ptr(), dtype_code(x, "x"), y.data_ptr(), lnw.data_ptr(),
        lnb.data_ptr(), win_t.data_ptr(), wdw.data_ptr(), wout_t.data_ptr(),
        b, c, h, w, hid, float(eps),
    )
    gdfn_tanh_nhwc.launches += 1
    return y


gdfn_tanh_nhwc.launches = 0


# -- kprobe: the in-kernel transpose pair and projections ------------------------

PROBE_SCALE = 1.000001           # probe_transpose's op (tools/kprobe.py:48)


def probe_transpose_ref(u):
    """Plain version of kprobe's `probe_transpose` kernel (tools/kprobe.py:
    45): y = u * 1.000001 in fp32, rounded to u's dtype (the transposes
    around it change no value)."""
    return (u.float() * PROBE_SCALE).to(u.dtype)


def probe_proj_ref(u, wxp, wdt):
    """Plain version of kprobe's `probe_proj` kernel (tools/kprobe.py:79),
    per position of u (..., D): xdbl = W_xp u (RN,), fp32; y = W_dt
    xdbl[:R] + 0.5 xdbl[R], rounded to u's dtype. wxp (RN, D), wdt (D, R),
    fp32."""
    R = wdt.shape[1]
    xdbl = u.float() @ wxp.float().t()
    return (xdbl[..., :R] @ wdt.float().t()
            + 0.5 * xdbl[..., R:R + 1]).to(u.dtype)


def _probe_rows(name, u):
    D = u.shape[-1]
    if not 1 <= D <= PROBE_MAX_D or u.numel() == 0:
        raise ValueError(f"{name}: D={D} outside 1..{PROBE_MAX_D} or an "
                         "empty u")
    return u.numel() // D, D


def probe_transpose(u):
    """kprobe's transpose pair (csrc/probe_io.cu): u (..., D), D <= 256,
    staged per tile of positions through shared memory as (D, positions)
    and back. Returns y of u's shape and dtype."""
    if on_cpu(u):
        return probe_transpose_ref(u)
    no_grad_needed("probe_transpose", u)
    rows, D = _probe_rows("probe_transpose", u)
    u = u.contiguous()
    y = torch.empty_like(u)
    _build.launch("vmt_probe_transpose", u.device, u.data_ptr(),
                  dtype_code(u, "u"), y.data_ptr(), rows, D)
    probe_transpose.launches += 1
    return y


def probe_proj(u, wxp, wdt):
    """kprobe's in-kernel projections (csrc/probe_io.cu): u (..., D), D <=
    256; wxp (RN, D), RN <= 64; wdt (D, R), R < RN; every row of xdbl in
    fp32 on the CUDA cores. Returns y of u's shape and dtype."""
    if on_cpu(u, wxp, wdt):
        return probe_proj_ref(u, wxp, wdt)
    no_grad_needed("probe_proj", u, wxp, wdt)
    rows, D = _probe_rows("probe_proj", u)
    RN, R = wxp.shape[0], wdt.shape[1]
    if wxp.shape != (RN, D) or wdt.shape != (D, R) or not 0 <= R < RN \
            or RN > PROBE_MAX_RN:
        raise ValueError(f"probe_proj: wxp {tuple(wxp.shape)}, wdt "
                         f"{tuple(wdt.shape)} with D={D}: needs (RN, D), "
                         f"(D, R), R < RN <= {PROBE_MAX_RN}")
    u = u.contiguous()
    y = torch.empty_like(u)
    wx, wd = f32(wxp), f32(wdt)
    _build.launch("vmt_probe_proj", u.device, u.data_ptr(),
                  dtype_code(u, "u"), y.data_ptr(), wx.data_ptr(),
                  wd.data_ptr(), rows, D, RN, R)
    probe_proj.launches += 1
    return y


probe_transpose.launches = 0
probe_proj.launches = 0


# -- kldio: the fused scan, channels-last ----------------------------------------

def ld_fused_plain(u_gld, xw, dw, db, A, Ds, *, softplus=True, reverse=False):
    """Plain version of `ld_fused`: the plain `oss_scan_fused` on u moved
    to (B, G, D, L), and y moved back."""
    y = oss_scan_fused_ref(u_gld.movedim(2, 3), xw, dw, db, A, Ds,
                           softplus=softplus, reverse=reverse)
    return y.movedim(3, 2).contiguous()


def ld_fused(u_gld, xw, dw, db, A, Ds, *, softplus=True, reverse=False):
    """kldio's fused scan (tools/kldio.py:143): u_gld (B, G, L, D) -> y
    (B, G, L, D) in u's dtype, D <= 256; weights as `oss_scan_fused`: xw
    (G, R+2N, D), dw (G, D, R), db (G, D), A (G, D, N) (already
    -exp(A_log)), Ds (G, D). On CUDA: K1 with the Ld layout policy
    (csrc/oss_scan_fused.cu), which reads u and writes y in this layout."""
    args = (u_gld, xw, dw, db, A, Ds)
    if on_cpu(*args):
        return ld_fused_plain(*args, softplus=softplus, reverse=reverse)
    no_grad_needed("ld_fused", *args)
    b, g, l, d = u_gld.shape
    N, R = k1_sizes("ld_fused", u_gld, g, d, xw, dw, db, A, Ds)
    u = u_gld.contiguous()
    y = torch.empty_like(u)
    ws = [f32(t) for t in (xw, dw, db, A, Ds)]
    _build.launch(
        "vmt_oss_scan_fused_ld_fwd", u.device,
        u.data_ptr(), dtype_code(u, "u_gld"), y.data_ptr(),
        *(w.data_ptr() for w in ws),
        b, g, d, l, N, R, int(bool(reverse)), int(bool(softplus)),
    )
    ld_fused.launches += 1
    return y


ld_fused.launches = 0
