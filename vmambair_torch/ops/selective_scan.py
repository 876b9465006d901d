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
dtype; it is sequential over chunks of L, with a Hillis-Steele scan over
(decay, input) pairs inside each chunk. This is the plain version the CUDA
kernels are held against on the card, at full L; the tests hold it against
the JAX package's sequential reference.

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
    df = delta.float()
    if delta_bias is not None:
        df = df + delta_bias.float()
    if delta_softplus:
        df = F.softplus(df)  # linear above 20, like the TPU kernel
    return (u.float(), df, A.float(), B.float(), C.float(),
            None if D is None else D.float(), G)


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
                           delta_softplus=False, chunk_size: int = 64):
    """Chunked version: a loop over chunks of L carries the fp32 state; each
    chunk is one vectorised Hillis-Steele scan."""
    uf, df, Af, Bf, Cf, Df, G = _prep(
        u, delta, A, B, C, D, delta_bias, delta_softplus)
    batch, L, dim = uf.shape
    N = Af.shape[1]
    dg = dim // G
    h = torch.zeros(batch, dim, N, device=u.device)
    ys = []
    for t0 in range(0, L, chunk_size):
        t1 = min(L, t0 + chunk_size)
        d_c, u_c = df[:, t0:t1], uf[:, t0:t1]
        ck = t1 - t0
        da = torch.exp(d_c[..., None] * Af)                 # (b, ck, D, N)
        x = (d_c * u_c).view(batch, ck, G, dg)
        bb = (Bf[:, t0:t1, :, None, :] * x[..., None]).reshape(
            batch, ck, dim, N)
        aa, bb = _hillis_scan(da, bb, dim=1)
        h_all = aa * h[:, None] + bb
        ys.append(torch.einsum(
            "blgn,blgdn->blgd", Cf[:, t0:t1],
            h_all.view(batch, ck, G, dg, N)).reshape(batch, ck, dim))
        h = h_all[:, -1]
    y = torch.cat(ys, 1)
    if Df is not None:
        y = y + uf * Df
    return y.to(u.dtype)
