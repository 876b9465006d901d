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
  channels-last, (B, G, L, D); one call is `K1_GRIDS` grids, as K1's.
- `scan_dual_v22`, `scan_dual_v24`, `scan_dual_v26` (`scan_dual(form=)`
  dispatches to them) and `scan_cumsum` (csrc/scan_dual.cu): kvariants'
  separated-exponent scans, the matmul dual `kernel_v22` (v23: Z in
  bf16), `kernel_v24` (v25: mid-referenced), `kernel_v26` and the cumsum
  form `kernel_v4`, each with its plain version (`scan_dual_v22_ref`,
  ...), a transcription of the TPU body.

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
from .cuda_effn import MAX_C, launch_gdfn
from .cuda_scan import (MAX_SEQ_WIN, _gld, bl_flat, k1_sizes, launch_k1,
                        launch_views, oss_scan_fused_ref, scan_views_ref,
                        view_shapes)
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


# -- v22-v26, v4: the separated-exponent scans ---------------------------------
#
# Within each window of `sub` positions these scans split the decay from t
# back to p, exp2(s_t - s_p), into exp2(s_t) and exp2(-s_p), with s = A
# log2(e) sigma and sigma a cumulative sum of delta: Z_p = exp2(-s_p) b_p,
# H = Z T (T the block-triangular 0/1 matrix), h_t = exp2(s_t) H_t. The
# plain versions are literal transcriptions of the TPU bodies (the same
# clamps, the same rounding points, `torch.matmul` with T in fp32 for each
# product), one window after another, the state entering a window folded
# into its first b. They lay the state out as the TPU kernels do, (b, dim,
# N, L), L last. Reverse runs the forward body on inputs flipped along L
# and flips y back: that flips causality (T[p, t] = p >= t), the block-end
# and mid lanes (the first lane and lane blk/2 of a block), the carry's
# edge and the window order, as `_scan_block_dual` does
# (vmambair_tpu/ops/pallas_scan.py:311-323, 362-373). Subnormals are
# flushed to zero where a later factor up to 2^120 would make them count:
# every exp and exp2, Z, H and the mid-scaled block states c. The TPU has
# no subnormals and XLA on the CPU flushes them; the kernel flushes at the
# same points (its exp2 is ex2.approx.ftz). A subnormal kept there changes
# h by O(1).

LOG2E = 1.4426950408889634    # tools/kvariants.py:451
DUAL_CLAMP = 120.0            # the separated exponents' clamp, in bits
DUAL_SUBS = (128, 256)        # windows csrc/scan_dual.cu takes
DUAL_BLKS = (16, 32, 64, 128)  # blocks it takes (at most the window)
FP32_TINY = torch.finfo(torch.float32).tiny


def _ftz(t):
    """t with its subnormal entries flushed to zero."""
    return torch.where(t.abs() < FP32_TINY, torch.zeros_like(t), t)


def _exp2(t):
    return _ftz(torch.exp2(t))


def _sep_prologue(u, delta, A, B, C, D, delta_bias, softplus, reverse):
    """kvariants' `_prologue` (tools/kvariants.py:42) on the views: the
    post-softplus delta d, du = d u and y0 = D u as (b, dim, L) fp32, B and
    C per channel as (b, dim, N, L) fp32, A fp32; flipped along L when
    reverse."""
    bsz, G, L, dg = u.shape

    def chan(t):  # (b, g, l, x) -> (b, g x, l)
        return t.float().permute(0, 1, 3, 2).reshape(bsz, -1, L)

    d = chan(delta)
    if delta_bias is not None:
        d = d + delta_bias.float()[:, None]
    if softplus:
        d = torch.where(d > 20.0, d,
                        torch.log1p(torch.exp(torch.clamp(d, max=20.0))))
    uf = chan(u)
    du = d * uf
    y0 = torch.zeros_like(uf) if D is None else D.float()[:, None] * uf
    gi = torch.arange(G * dg, device=u.device) // dg
    Bx = B.float().permute(0, 1, 3, 2)[:, gi]
    Cx = C.float().permute(0, 1, 3, 2)[:, gi]
    out = (d, du, y0, Bx, Cx)
    if reverse:
        out = tuple(t.flip(-1) for t in out)
    return (*out, A.float())


def _sep_epilogue(y0, Cx, h, u, reverse):
    """y = y0 + sum_n C h, flipped back when reverse, as a (b, g, l, d)
    view in u's dtype."""
    y = y0 + (Cx * h).sum(2)
    if reverse:
        y = y.flip(-1)
    bsz, G, L, dg = u.shape
    return y.to(u.dtype).view(bsz, G, dg, L).permute(0, 1, 3, 2)


def _sep_sizes(name, sub, blk, L):
    if sub < 2 or sub & (sub - 1) or blk < 2 or sub % blk or L % sub:
        raise ValueError(f"{name}: sub={sub} must be a power of two that "
                         f"blk={blk} divides and that divides L={L}")


def _tril_blocks(sub, blk, device):
    """The TPU kernels' T: T[p, t] = 1 where p <= t within one block of
    blk positions, fp32."""
    i = torch.arange(sub, device=device)
    return ((i[:, None] <= i[None, :]) &
            (i[:, None] // blk == i[None, :] // blk)).float()


def _pickers(sub, blk, device):
    """Pend (sub, m): each block's last lane; Pmid (sub, m): its lane
    blk/2 - 1; S (m, sub): each block's lanes (tools/kvariants.py:889-894)."""
    li = torch.arange(sub, device=device)[:, None]
    bi = torch.arange(sub // blk, device=device)[None, :]
    return ((li == bi * blk + blk - 1).float(),
            (li == bi * blk + blk // 2 - 1).float(),
            (li // blk == bi).float().t())


def _fold(b_win, sd, A2, carry):
    """The window's b with the entering state folded into its first
    position: b_0 + exp2(A2 d_0) carry."""
    b = b_win.clone()
    b[..., :1] = b_win[..., :1] + _exp2(A2 * sd[:, :, None, :1]) * carry
    return b


def _sep_scan(name, u, delta, A, B, C, D, delta_bias, softplus, reverse, sub,
              blk, window):
    """The window walk the separated-exponent plain versions share:
    `window(sd, b_win, carry)` -> h of one window (b, dim, N, sub), sd its
    delta (b, dim, sub), b_win its du B, carry the state entering it."""
    d, du, y0, Bx, Cx, Af = _sep_prologue(u, delta, A, B, C, D, delta_bias,
                                          softplus, reverse)
    L = d.shape[-1]
    _sep_sizes(name, sub, blk, L)
    b_full = du[:, :, None] * Bx
    carry = torch.zeros_like(b_full[..., :1])
    hs = []
    for lo in range(0, L, sub):
        h = window(d[..., lo:lo + sub], b_full[..., lo:lo + sub], carry,
                   Af)
        carry = h[..., -1:]
        hs.append(h)
    return _sep_epilogue(y0, Cx, torch.cat(hs, -1), u, reverse)


def scan_dual_v22_ref(u, delta, A, B, C, D, delta_bias, *, sub, blk,
                      zdt=torch.float32, reverse=False, delta_softplus=True):
    """Plain version of `scan_dual_v22` (kvariants' kernel_v22,
    tools/kvariants.py:784): the matmul dual referenced at each block's
    start. s = A log2(e) sigma, sigma = delta's block-local inclusive
    cumsum (sd @ T); E = exp2(s); Z = exp2(min(-s, 120)) b, rounded to
    `zdt` (bfloat16: v23); H = Z @ T; the blocks chained one after another,
    h = E (H + h at the previous block's end). Views as `scan_views_ref`'s;
    returns y in u's dtype."""
    T = _tril_blocks(sub, blk, u.device)
    m = sub // blk

    def window(sd, b_win, carry, Af):
        A2 = (Af * LOG2E)[:, :, None]
        s = A2 * (sd @ T)[:, :, None]
        b = _fold(b_win, sd, A2, carry)
        E = _exp2(s)
        Z = _ftz(_exp2(torch.clamp(-s, max=DUAL_CLAMP)) * b)
        H = _ftz(Z.to(zdt).float() @ T)
        if m == 1:
            return E * H
        pieces, hprev = [], None
        for j in range(m):
            Hj = H[..., j * blk:(j + 1) * blk]
            if j:
                Hj = Hj + hprev
            hj = E[..., j * blk:(j + 1) * blk] * Hj
            hprev = hj[..., blk - 1:blk]
            pieces.append(hj)
        return torch.cat(pieces, -1)

    return _sep_scan("scan_dual_v22_ref", u, delta, A, B, C, D, delta_bias,
                     delta_softplus, reverse, sub, blk, window)


def _chain(ends_h, dec, m):
    """The blocks' entering states: c_0 = 0, c_1 = ends_h_0, c_j = ends_h_
    {j-1} + dec_{j-1} c_{j-1} (tools/kvariants.py:932-937)."""
    cs = [torch.zeros_like(ends_h[..., :1]), ends_h[..., 0:1]]
    for j in range(2, m):
        cs.append(ends_h[..., j - 1:j] + dec[..., j - 1:j] * cs[-1])
    return torch.cat(cs, -1)


def scan_dual_v24_ref(u, delta, A, B, C, D, delta_bias, *, sub, blk,
                      mid=False, reverse=False, delta_softplus=True):
    """Plain version of `scan_dual_v24` (kvariants' kernel_v24,
    tools/kvariants.py:863): v22's function with both exponents clamped,
    E = exp2(min(s, 120)), and the block fix-ups from block-end pickers:
    h = E H, then h + E (c @ S) with c the chained block-end states. mid
    (v25): sigma referenced at each block's lane blk/2 - 1, the block-end
    decays E_end exp2(A2 sigma_mid), c scaled by exp2(A2 sigma_mid). Views
    as `scan_views_ref`'s; returns y in u's dtype."""
    T = _tril_blocks(sub, blk, u.device)
    Pend, Pmid, S = _pickers(sub, blk, u.device)
    m = sub // blk

    def window(sd, b_win, carry, Af):
        A2 = (Af * LOG2E)[:, :, None]
        sig = sd @ T
        b = _fold(b_win, sd, A2, carry)
        if mid:
            mids = sig @ Pmid
            sig = sig - mids @ S
            Emid = _exp2(A2 * mids[:, :, None])
        s = A2 * sig[:, :, None]
        E = _exp2(torch.clamp(s, max=DUAL_CLAMP))
        Z = _ftz(_exp2(torch.clamp(-s, max=DUAL_CLAMP)) * b)
        h = E * _ftz(Z @ T)
        if m > 1:
            ends_E = E @ Pend
            cvec = _chain(h @ Pend, ends_E * Emid if mid else ends_E, m)
            if mid:
                cvec = _ftz(cvec * Emid)
            h = h + E * (cvec @ S)
        return h

    return _sep_scan("scan_dual_v24_ref", u, delta, A, B, C, D, delta_bias,
                     delta_softplus, reverse, sub, blk, window)


def scan_dual_v26_ref(u, delta, A, B, C, D, delta_bias, *, sub, blk,
                      reverse=False, delta_softplus=True):
    """Plain version of `scan_dual_v26` (kvariants' kernel_v26,
    tools/kvariants.py:955): v25 with the block-end decays recomputed
    unclamped from sigma's block ends, exp2(A2 sigma_end), and one h = E (H
    + c @ S). The TPU's production dual (`_scan_block_dual`) computes this
    function. Views as `scan_views_ref`'s; returns y in u's dtype."""
    T = _tril_blocks(sub, blk, u.device)
    Pend, Pmid, S = _pickers(sub, blk, u.device)
    m = sub // blk

    def window(sd, b_win, carry, Af):
        A2 = (Af * LOG2E)[:, :, None]
        sig = sd @ T
        b = _fold(b_win, sd, A2, carry)
        mids = sig @ Pmid
        sig_ends = sig @ Pend
        sig = sig - mids @ S
        Emid = _exp2(A2 * mids[:, :, None])
        s = A2 * sig[:, :, None]
        E = _exp2(torch.clamp(s, max=DUAL_CLAMP))
        Z = _ftz(_exp2(torch.clamp(-s, max=DUAL_CLAMP)) * b)
        H = _ftz(Z @ T)
        if m == 1:
            return E * H
        E_ends = _exp2(A2 * (sig_ends - mids)[:, :, None])
        cvec = _ftz(_chain(E_ends * (H @ Pend),
                           _exp2(A2 * sig_ends[:, :, None]), m) * Emid)
        return E * (H + cvec @ S)

    return _sep_scan("scan_dual_v26_ref", u, delta, A, B, C, D, delta_bias,
                     delta_softplus, reverse, sub, blk, window)


def scan_cumsum_v4_ref(u, delta, A, B, C, D, delta_bias, *, sub,
                       reverse=False, delta_softplus=True):
    """Plain version of `scan_cumsum` (kvariants' kernel_v4,
    tools/kvariants.py:151): in each window, sd = delta's inclusive cumsum
    and w = the inclusive cumsum of du B exp(-A sd), both by Hillis-Steele
    in fp32; h = exp(A sd) (w + carry). Natural exp, no clamp: where |A|
    sum delta passes ~88.7 nats over a window exp(-A sd) overflows fp32 and
    h is not finite. Views as `scan_views_ref`'s; returns y in u's dtype."""
    def cumsum(t):
        k = 1
        while k < sub:
            t = t + _shift(t, k, t.dim() - 1)
            k *= 2
        return t

    def window(sd, b_win, carry, Af):
        E = Af[:, :, None] * cumsum(sd)[:, :, None]
        return _ftz(torch.exp(E)) * (cumsum(b_win * torch.exp(-E)) + carry)

    return _sep_scan("scan_cumsum_v4_ref", u, delta, A, B, C, D, delta_bias,
                     delta_softplus, reverse, sub, sub, window)


DUAL_REFS = {"v22": scan_dual_v22_ref, "v24": scan_dual_v24_ref,
             "v26": scan_dual_v26_ref}


def _launch_sep(name, args, softplus, reverse, sub, blk, form, mid=False,
                zbf16=False):
    """Launches csrc/scan_dual.cu's `vmt_scan_dual_fwd` (form 22, 24, 26
    or 4) on CUDA views; raises for what the kernel does not take."""
    no_grad_needed(name, *args)
    u, _, A, B, C, *_, y = args
    bsz, G, L, dg, N = view_shapes(name, u, args[1], A, B, C, y)
    if sub not in DUAL_SUBS or blk not in DUAL_BLKS or blk > sub or L % sub:
        raise ValueError(f"{name}: (sub, blk) = ({sub}, {blk}) with L={L} "
                         f"not taken: sub in {DUAL_SUBS}, blk in "
                         f"{DUAL_BLKS} at most sub, L a multiple of sub")
    launch_views("vmt_scan_dual_fwd", *args, softplus, reverse,
                 (sub, blk, form, int(bool(mid)), int(bool(zbf16))))


def scan_dual_v22(u, delta, A, B, C, D, delta_bias, y, *, sub, blk,
                  zdt=torch.float32, reverse=False, delta_softplus=True):
    """kvariants' kernel_v22 (zdt bfloat16: v23) into the view y
    (csrc/scan_dual.cu); N <= 16, L a multiple of sub. Returns y."""
    args = (u, delta, A, B, C, D, delta_bias, y)
    if on_cpu(*args):
        view_shapes("scan_dual_v22", u, delta, A, B, C, y)
        return y.copy_(scan_dual_v22_ref(
            *args[:7], sub=sub, blk=blk, zdt=zdt, reverse=reverse,
            delta_softplus=delta_softplus))
    if zdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scan_dual_v22: zdt={zdt}")
    _launch_sep("scan_dual_v22", args, delta_softplus, reverse, sub, blk, 22,
                zbf16=zdt == torch.bfloat16)
    scan_dual_v22.launches += 1
    return y


def scan_dual_v24(u, delta, A, B, C, D, delta_bias, y, *, sub, blk,
                  mid=False, reverse=False, delta_softplus=True):
    """kvariants' kernel_v24 (mid: v25) into the view y
    (csrc/scan_dual.cu); N <= 16, L a multiple of sub. Returns y."""
    args = (u, delta, A, B, C, D, delta_bias, y)
    if on_cpu(*args):
        view_shapes("scan_dual_v24", u, delta, A, B, C, y)
        return y.copy_(scan_dual_v24_ref(
            *args[:7], sub=sub, blk=blk, mid=mid, reverse=reverse,
            delta_softplus=delta_softplus))
    _launch_sep("scan_dual_v24", args, delta_softplus, reverse, sub, blk, 24,
                mid=mid)
    scan_dual_v24.launches += 1
    return y


def scan_dual_v26(u, delta, A, B, C, D, delta_bias, y, *, sub, blk,
                  reverse=False, delta_softplus=True):
    """kvariants' kernel_v26 into the view y (csrc/scan_dual.cu); N <= 16,
    L a multiple of sub. Returns y."""
    args = (u, delta, A, B, C, D, delta_bias, y)
    if on_cpu(*args):
        view_shapes("scan_dual_v26", u, delta, A, B, C, y)
        return y.copy_(scan_dual_v26_ref(
            *args[:7], sub=sub, blk=blk, reverse=reverse,
            delta_softplus=delta_softplus))
    _launch_sep("scan_dual_v26", args, delta_softplus, reverse, sub, blk, 26)
    scan_dual_v26.launches += 1
    return y


def scan_cumsum(u, delta, A, B, C, D, delta_bias, y, *, sub=128,
                reverse=False, delta_softplus=True):
    """kvariants' kernel_v4 into the view y (csrc/scan_dual.cu, its cumsum
    form: natural exp, no clamp); N <= 16, L a multiple of sub. Returns
    y."""
    args = (u, delta, A, B, C, D, delta_bias, y)
    if on_cpu(*args):
        view_shapes("scan_cumsum", u, delta, A, B, C, y)
        return y.copy_(scan_cumsum_v4_ref(
            *args[:7], sub=sub, reverse=reverse,
            delta_softplus=delta_softplus))
    _launch_sep("scan_cumsum", args, delta_softplus, reverse, sub, sub, 4)
    scan_cumsum.launches += 1
    return y


scan_dual_v22.launches = 0
scan_dual_v24.launches = 0
scan_dual_v26.launches = 0
scan_cumsum.launches = 0
DUAL_WRAPPERS = {"v22": scan_dual_v22, "v24": scan_dual_v24,
                 "v26": scan_dual_v26}


def scan_dual(u, delta, A, B, C, D, delta_bias, y, *, form, sub, blk,
              reverse=False, delta_softplus=True, **opts):
    """The matmul-dual scan of kvariants' form `form` into the view y:
    'v22' (option zdt), 'v24' (option mid) or 'v26'; the launch is counted
    by that form's wrapper (`scan_dual_v22`, ...). Returns y."""
    if form not in DUAL_WRAPPERS:
        raise ValueError(f"scan_dual: form={form!r} not in "
                         f"{list(DUAL_WRAPPERS)}")
    return DUAL_WRAPPERS[form](u, delta, A, B, C, D, delta_bias, y, sub=sub,
                               blk=blk, reverse=reverse,
                               delta_softplus=delta_softplus, **opts)


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
    # weights rounded to the activation dtype, as the TPU kernel takes
    # them, in K2's layouts: w_in and w_out transposed, the taps first
    y = launch_gdfn("vmt_gdfn_tanh_nhwc", x, (b, c, h, w), ln_w, ln_b,
                    w_in.t(), w_dw.permute(2, 0, 1), w_out.t(), eps)
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
    256; wxp (RN, D), RN <= 64; wdt (D, R), R < RN; every row of xdbl on
    the tensor cores (bf16 u against three bf16 parts of W_xp, fp32 u in
    split TF32; the output from xdbl's accumulators by a split-TF32
    product) where D is a multiple of 16, RN <= 40, R < 8 and u is 16-byte
    aligned, else in fp32 on the CUDA cores. Returns y of u's shape and
    dtype."""
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
    launch_k1("vmt_oss_scan_fused_ld_fwd", u, y, ws, (), (b, g, d, l, N, R),
              reverse, softplus)
    ld_fused.launches += 1
    return y


ld_fused.launches = 0
