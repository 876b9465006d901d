"""Selective scan (Mamba S6 recurrence), plain PyTorch version.

Counterpart of `vmambair_tpu/ops/selective_scan.py`. The recurrence (per
batch b, channel d, state n, over sequence position t):

    delta = softplus(delta_raw + delta_bias)            (optional)
    h_t   = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t
    y_t   = sum_n C_t[n] * h_t[n] + D * u_t             (D skip optional)

Layouts as in the JAX package (channels last):

    u, delta   : (batch, L, D)
    A          : (D, N)      fp32, negative (A = -exp(A_log))
    B, C       : (batch, L, G, N), D % G == 0
    D, delta_bias : (D,)

``selective_scan_chunked`` keeps the state in fp32 whatever the input
dtype (in fp64 for fp64 inputs, an oracle); it is sequential over chunks of L, with a Hillis-Steele scan over
(decay, input) pairs inside each chunk, and can return the state entering
each chunk, start from an entering state ``h0`` and return its last
state (the sequence-parallel scan's two passes, `parallel/sp_scan.py`).
``selective_scan_bwd_ref`` is its gradient. These are the plain
versions the CUDA kernels (forward, carry-saving forward, backward) are
held against on the card, at full L; the tests hold them against the JAX
package's sequential reference and its backward.

The kernels themselves are in `cuda_scan.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _prep(u, delta, A, B, C, D, delta_bias, delta_softplus):
    batch, L, dim = u.shape
    if A.shape[0] != dim:
        raise ValueError(f"A dim {A.shape[0]} != u dim {dim}")
    if B.dim() != 4 or C.dim() != 4:
        raise ValueError("B and C must be (batch, L, G, N)")
    G = B.shape[2]
    if dim % G != 0:
        raise ValueError(f"dim {dim} not divisible by groups {G}")
    wt = _work_dtype(u)
    df = delta.to(wt)
    if delta_bias is not None:
        df = df + delta_bias.to(wt)
    if delta_softplus:
        df = F.softplus(df)  # linear above 20, like the TPU kernel
    return (u.to(wt), df, A.to(wt), B.to(wt), C.to(wt),
            None if D is None else D.to(wt), G)


def _work_dtype(u):
    """fp32, the kernels' arithmetic; fp64 for fp64 inputs (an oracle)."""
    return torch.float64 if u.dtype == torch.float64 else torch.float32


def _hillis_scan(a, b, dim=1):
    """Inclusive scan of (a, b) pairs under (aL, bL),(aR, bR) ->
    (aL aR, aR bL + bR) by Hillis-Steele doubling along `dim`."""
    n = a.shape[dim]
    k = 1
    while k < n:
        a_prev = a.narrow(dim, 0, n - k)
        b_prev = b.narrow(dim, 0, n - k)
        a_tail = a.narrow(dim, k, n - k)
        b_tail = b.narrow(dim, k, n - k)
        b = torch.cat([b.narrow(dim, 0, k), a_tail * b_prev + b_tail], dim)
        a = torch.cat([a.narrow(dim, 0, k), a_tail * a_prev], dim)
        k *= 2
    return a, b


def selective_scan_chunked(u, delta, A, B, C, D=None, delta_bias=None,
                           delta_softplus=False, chunk_size: int = 64,
                           reverse: bool = False,
                           return_carries: bool = False, h0=None,
                           return_last_state: bool = False):
    """Chunked version: a loop over chunks of L carries the fp32 state; each
    chunk is one vectorised Hillis-Steele scan.

    reverse=True scans L right to left: the chunks (cut at the same
    positions as for the forward scan, so a ragged chunk stays at the end
    of L) are walked back to front, each scanned back to front.
    return_carries=True also returns the fp32 state entering each chunk,
    (batch, D, n_chunks, N), indexed by the chunk's position in L: the
    plain side of the carry-saving kernels, whose backward recomputes each
    chunk from it.
    h0: the state (batch, D, N) entering the scan (at position 0, or at
    position L - 1 when reverse), zeros where None; return_last_state=True
    also returns the state after the scan's last position, in the working
    type (JAX's `selective_scan_xla(h0=, return_last_state=)`). The
    outputs: y, then the carries, then the last state, each where asked."""
    uf, df, Af, Bf, Cf, Df, G = _prep(
        u, delta, A, B, C, D, delta_bias, delta_softplus)
    batch, L, dim = uf.shape
    N = Af.shape[1]
    dg = dim // G
    h = (torch.zeros(batch, dim, N, device=u.device, dtype=uf.dtype)
         if h0 is None else h0.to(uf.dtype))
    if h.shape != (batch, dim, N):
        raise ValueError(f"h0 {tuple(h.shape)} != {(batch, dim, N)}")
    n_chunks = -(-L // chunk_size)
    ys, carries = [None] * n_chunks, [None] * n_chunks
    for k in (range(n_chunks - 1, -1, -1) if reverse else range(n_chunks)):
        t0 = k * chunk_size
        t1 = min(L, t0 + chunk_size)
        carries[k] = h

        def part(t):
            return t[:, t0:t1].flip(1) if reverse else t[:, t0:t1]

        d_c, u_c = part(df), part(uf)
        ck = t1 - t0
        da = torch.exp(d_c[..., None] * Af)                 # (b, ck, D, N)
        x = (d_c * u_c).view(batch, ck, G, dg)
        bb = (part(Bf)[:, :, :, None, :] * x[..., None]).reshape(
            batch, ck, dim, N)
        aa, bb = _hillis_scan(da, bb, dim=1)
        h_all = aa * h[:, None] + bb
        y_c = torch.einsum(
            "blgn,blgdn->blgd", part(Cf),
            h_all.view(batch, ck, G, dg, N)).reshape(batch, ck, dim)
        ys[k] = y_c.flip(1) if reverse else y_c
        h = h_all[:, -1]
    y = torch.cat(ys, 1)
    if Df is not None:
        y = y + uf * Df
    y = y.to(u.dtype)
    out = (y,)
    if return_carries:
        out += (torch.stack(carries, 2),)
    if return_last_state:
        out += (h,)
    return out if len(out) > 1 else y


def selective_scan_bwd_ref(u, delta, A, B, C, D, delta_bias, dy, *,
                           delta_softplus=False, reverse=False):
    """Plain version of the scan backward: the gradients of
    `sum(y * dy)` for y = selective_scan(u, delta, A, B, C, D, delta_bias),
    by autograd through the chunked scan in fp32. Returns (du, ddelta, dA,
    dB, dC, dD, dbias) in fp32, shaped as the inputs; ddelta is the
    gradient of the raw delta (before bias and softplus); dD and dbias are
    None where D and delta_bias are. fp64 inputs give an fp64 oracle of
    the same gradients."""
    wt = _work_dtype(u)
    with torch.enable_grad():
        ins = [None if t is None else t.detach().to(wt).requires_grad_()
               for t in (u, delta, A, B, C, D, delta_bias)]
        y = selective_scan_chunked(*ins, delta_softplus=delta_softplus,
                                   reverse=reverse)
        given = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(y, given, dy.to(wt)))
    return tuple(None if t is None else next(grads) for t in ins)
