"""K3's order of operations (`vmambair_torch/csrc/selective_scan_bwd.cu`)
in torch ops, for the study of its distance from the exact gradients on a
growing state (ROADMAP F2).

`k3_order_bwd` recomputes each chunk of CH = 32 positions from its carry
and runs the adjoint as K3 does: a Hillis-Steele tree over the chunk's
affine pairs, the carry folded into the first pair (recompute) or the last
(adjoint), FMAs where K3 has them (an fp64 product and sum rounded once to
fp32), w = dh (a h_prev), and the sums over states and channels in fp64.
It runs on the device of its inputs, with that device's exp: on the card
it reproduces K3's distance from the fp64 oracle, on the CPU it gives the
distance of the same order under the CPU's exp. It takes the F2 recipe
only: no D skip, no bias, no softplus, a forward scan.
"""

import torch

CH = 32


def _fma(x, y, z):
    return (x.double() * y.double() + z.double()).float()


def _tree(a, b, reverse):
    """Inclusive Hillis-Steele scan of (a, b) pairs along dim 1: b_t <- a_t
    b_{t-k} + b_t, a_t <- a_t a_{t-k} (from the far end when reverse)."""
    n, k = a.shape[1], 1
    while k < n:
        na, nb = a.clone(), b.clone()
        if reverse:
            nb[:, :-k] = _fma(a[:, :-k], b[:, k:], b[:, :-k])
            na[:, :-k] = a[:, :-k] * a[:, k:]
        else:
            nb[:, k:] = _fma(a[:, k:], b[:, :-k], b[:, k:])
            na[:, k:] = a[:, k:] * a[:, :-k]
        a, b, k = na, nb, 2 * k
    return b


def k3_order_bwd(u, delta, A, B, C, dy, carries):
    """(du, ddelta, dA, dB, dC) of sum(y * dy) for the forward scan of u,
    delta (B, L, D), A (D, N), B, C (B, L, G, N), from `carries` (B, D,
    n_chunks, N), in K3's order."""
    bsz, L, D = u.shape
    N, G = A.shape[1], B.shape[2]
    gi = (torch.arange(D) // (D // G)).to(u.device)
    Bx, Cx = B[:, :, gi], C[:, :, gi]
    H = torch.zeros(bsz, L, D, N, device=u.device)
    W, DH = torch.zeros_like(H), torch.zeros_like(H)
    dA = torch.zeros(bsz, D, N, device=u.device)
    dhc = torch.zeros_like(dA)
    nch = -(-L // CH)
    for ck in range(nch - 1, -1, -1):
        t0, t1 = ck * CH, min(L, ck * CH + CH)
        d = delta[:, t0:t1, :, None]
        a = torch.exp(d * A)
        h0 = carries[:, :, ck]
        b = (d[..., 0] * u[:, t0:t1])[..., None] * Bx[:, t0:t1]
        b[:, 0] = _fma(a[:, 0], h0, b[:, 0])
        h = _tree(a, b, False)
        ah = a * torch.cat([h0[:, None], h[:, :-1]], 1)
        alpha = torch.ones_like(a)
        alpha[:, :-1] = a[:, 1:]
        beta = Cx[:, t0:t1] * dy[:, t0:t1, :, None]
        beta[:, -1] = _fma(Cx[:, t1 - 1], dy[:, t1 - 1, :, None], dhc)
        dh = _tree(alpha, beta, True)
        w = dh * ah
        H[:, t0:t1], DH[:, t0:t1], W[:, t0:t1] = h, dh, w
        dhc = a[:, 0] * dh[:, 0]
        dA = dA + (d * w).sum(1)
    sB = (Bx.double() * DH).sum(-1)
    du = (delta * sB).float()
    ddelta = (u * sB + (A.double() * W).sum(-1)).float()
    dB = torch.zeros_like(B)
    dC = torch.zeros_like(C)
    for g in range(G):
        sl = slice(g * (D // G), (g + 1) * (D // G))
        dB[:, :, g] = ((delta * u)[:, :, sl, None].double()
                       * DH[:, :, sl]).sum(2).float()
        dC[:, :, g] = (dy[:, :, sl, None].double() * H[:, :, sl]).sum(2) \
            .float()
    return du, ddelta, dA.sum(0), dB, dC
