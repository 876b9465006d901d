"""An order-independent bound on the fp32 error of the scan backward
(ROADMAP F2), for K3 and for the plain fp32 backward on the growing
recipe.

Without D, bias and softplus the forward is h_t = a_t h_{t-1} + x_t, a_t =
exp(delta_t A_n), x_t = delta_t u_t B_t, y_t = sum_n C_t h_t, and every
gradient of sum(y dy) is a sum of terms, each a product of the inputs and
of decays:

    g_t      = C_t dy_t + a_{t+1} g_{t+1}           (the adjoint state)
    du_t     = sum_n g_t delta_t B_t
    ddelta_t = sum_n (g_t h_{t-1} a_t A_n + g_t B_t u_t)
    dA       = sum_{b, t} g_t h_{t-1} a_t delta_t
    dB_t     = sum_{d in the group} g_t delta_t u_t
    dC_t     = sum_{d in the group} dy_t h_t

In any order of evaluation without division (K3's Hillis-Steele trees and
fp64 sums, autograd through the plain version's trees), the computed
gradient is sum_k T_k (1 + theta_k), each term T_k perturbed by the
roundings along its own path and by the errors of its decays, so

    |computed - exact| <= max_k |theta_k| * kappa,   kappa = sum_k |T_k|,

the condition of the sums: the same gradients evaluated on the magnitudes
of their terms (`kappa`), in fp64. Per position of a term's chain (at most
n = L positions: each state depends on the L positions before it, the
longest dependent sum), theta gathers at most one rounding of the decay's
product, one in each of the two recurrences and the one in the final sum
over t (4 u); the decay's own error, a rounding of delta A amplified by
|delta A| and 2 ulp of exp, at most (|delta A| + 4) u (|delta A| <= 10 on
this recipe: 14 u); and the term's remaining factors (at most 5) and its
sums over the N <= 16 states, the group's channels or the batch, spread
over the L = 40 positions (2 u). That is 20 u per position, below
C_BOUND = 32 (fixed before any run on the card), so

    |computed - exact| <= C_BOUND * n * u32 * kappa,   u32 = 2^-24.

A bound on every order: unlike the ratio to the fp32 plain version's own
distance (F2_FACTOR), it does not move with which fp32 order is compared.
"""

import torch

U32 = 2.0 ** -24
C_BOUND = 32
MAX_DELTA_A = 10.0  # the bound's reach: |delta A| of every decay


def kappa(u, delta, A, B, C, dy):
    """The gradients (du, ddelta, dA, dB, dC) of sum(y dy) for the forward
    scan of u, delta (b, L, D), A (D, N), B, C (b, L, G, N), without D,
    bias or softplus, evaluated on the magnitudes of their terms, fp64."""
    u, delta, A, B, C, dy = (t.detach().double().cpu()
                             for t in (u, delta, A, B, C, dy))
    bsz, L, D = u.shape
    gi = torch.arange(D) // (D // B.shape[2])
    Bx, Cx = B[:, :, gi].abs(), C[:, :, gi].abs()      # (b, L, D, N)
    a = torch.exp(delta[..., None] * A)
    x = (delta * u).abs()[..., None] * Bx
    h = torch.zeros_like(a[:, 0])
    H = []
    for t in range(L):
        h = a[:, t] * h + x[:, t]
        H.append(h)
    g = torch.zeros_like(h)
    Gs = [None] * L
    for t in range(L - 1, -1, -1):
        g = Cx[:, t] * dy[:, t, :, None].abs() + (
            a[:, t + 1] * g if t + 1 < L else 0)
        Gs[t] = g
    H, Gs = torch.stack(H, 1), torch.stack(Gs, 1)     # (b, L, D, N)
    Hprev = torch.cat([torch.zeros_like(H[:, :1]), H[:, :-1]], 1)
    w = Gs * Hprev * a
    G_ = B.shape[2]

    def groups(t):  # (b, L, D, N) summed over each group's channels
        return t.view(bsz, L, G_, D // G_, -1).sum(3)

    kdu = (Gs * delta.abs()[..., None] * Bx).sum(-1)
    kddelta = (w * A.abs() + Gs * Bx * u.abs()[..., None]).sum(-1)
    kdA = (w * delta.abs()[..., None]).sum((0, 1))
    kdB = groups(Gs * (delta * u).abs()[..., None])
    kdC = groups(H * dy.abs()[..., None])
    return kdu, kddelta, kdA, kdB, kdC


def bound_ratios(got, exact, args, dy):
    """Per gradient (du, ddelta, dA, dB, dC): the largest |got - exact| over
    the bound C_BOUND n u32 kappa (at most 1: inside), n = L. Checks first
    that kappa is a bound of the exact gradients' magnitudes, and that the
    recipe is within the bound's reach."""
    u, delta, A = args[:3]
    reach = (delta.detach().double()[..., None] * A.detach().double()
             ).abs().max().item()
    assert reach <= MAX_DELTA_A, reach
    ks = kappa(*args[:5], dy)
    n = u.shape[1]
    out = []
    for a, b, k in zip(got, exact, ks):
        b = b.detach().double().cpu()
        assert (b.abs() <= k * (1 + 1e-9) + 1e-300).all()
        err = (a.detach().double().cpu() - b).abs()
        out.append((err / (C_BOUND * n * U32 * k + 1e-300)).max().item())
    return out
