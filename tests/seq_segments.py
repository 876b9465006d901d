"""The arithmetic of `vmambair_torch/csrc/scan_seq.cu` (K7 and the
sequential probes) in torch ops, on the CPU, for the tests to hold against
JAX's kernels and the port's plain version.

The model follows the kernel: the launch plan (the segment of
`cuda_scan.seq_segment` at the H100's residency, or the caller's; one
warp for each channel tile of 32, segment, group and batch row); each
lane's walk of its segment from a
zero state in scan order (back to front when reverse), with delta =
softplus(delta_raw + bias), h = exp2(delta A log2(e)) h + (delta u) B, and
the sum of delta in walk order; the combine, the segments in scan order,
each one's entering state the chain h = exp2(A log2(e) sum) h + end state
so far; and the replay of each segment from its entering state (from zero
within one segment), y = D u + C h, the states summed in passes of 16
(`SEQ_NS`), each pass in four chains (state j into chain j % 4), the
chains added (0 + 1) + (2 + 3), each pass starting from the sum so far.
Inputs are read in their dtype and widened to fp32; y is rounded to y's
dtype once. Each fp32 operation is one torch fp32 operation; the card's
fused multiply-adds and its approximate exp2 differ from them by a few
ulp, inside the tests' tolerances. All segments of a call walk together,
one position of each a step, as the card's warps do: the last segment is
padded with delta = u = 0, whose steps leave h and the sum as they are.
"""

import torch

from vmambair_torch.ops import cuda_scan

SEQ_TC = 32    # channels to a warp (scan_seq.cu's SEQ_TC)
SEQ_NS = 16    # states a register pass holds (SEQ_NS)
LOG2E = 1.4426950408889634
# the warps of a walk that the H100 (132 SMs) holds at once, by (N,
# window): the occupancy API's counts (`cuda_scan.seq_resident`), as
# `chip_smoke.py` prints them in phase 3
H100_RESIDENT = {(8, 8): 2640, (16, 1): 2112, (16, 8): 2112,
                 (16, 16): 2112, (32, 8): 2112, (64, 8): 1848,
                 (256, 8): 528}


def plan(b: int, G: int, Dg: int, L: int, seg=None,
         resident=H100_RESIDENT[(16, 8)]) -> dict:
    """The launch of one call: the segment (the caller's, or the rule's at
    `resident` warps), the segments, the channel tiles, the warps a walk's
    grid holds (one to a block) and the grids launched (the walk alone
    within one segment; else both walks and the combine)."""
    if seg is None:
        seg = cuda_scan.seq_segment(b, G, Dg, L, resident)
    nseg = -(-L // seg)
    ntile = -(-Dg // SEQ_TC)
    return dict(seg=seg, nseg=nseg, ntile=ntile,
                warps=b * G * ntile * nseg, grids=1 if nseg == 1 else 3)


def _softplus20(x):
    return torch.where(x > 20, x, torch.log1p(torch.exp(x)))


def scan_seq_model(u, delta, A, Bm, Cm, D, bias, *, seg=None, reverse=False,
                   softplus=True, out_dtype=None, internals=False):
    """y of one call on (b, g, l, d) views u, delta and (b, g, l, n) views
    Bm, Cm (any dtype, fp32 or bf16), A (G*Dg, N), D and bias (G*Dg,) or
    None; y as a contiguous (b, g, l, d) in `out_dtype` (default u's).
    With `internals`, also the segments' end states and sums of delta
    (pass 1) and their entering states (the combine), each (b, nseg, G,
    Dg, N) / (b, nseg, G, Dg), as the scratch holds them."""
    b, G, L, Dg = u.shape
    N = A.shape[1]
    p = plan(b, G, Dg, L, seg)
    seg, nseg = p["seg"], p["nseg"]
    Lp = nseg * seg

    def seg_major(t):  # (b, g, L, x) -> (b, nseg, g, seg, x), L padded
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, Lp - L))
        return t.view(b, G, nseg, seg, t.shape[-1]).transpose(1, 2)

    raw = delta.float() + (0 if bias is None else
                           bias.float().view(G, 1, Dg))
    dl = _softplus20(raw) if softplus else raw
    dl = seg_major(dl)
    uu = seg_major(u)
    Bs, Cs = seg_major(Bm), seg_major(Cm)
    a2 = A.float().view(G, Dg, N) * LOG2E
    Dv = torch.zeros(G, Dg) if D is None else D.float().view(G, Dg)
    order = range(seg - 1, -1, -1) if reverse else range(seg)

    def step(h, i):
        dv = dl[:, :, :, i, :, None]                      # (b, s, g, d, 1)
        du = dv * uu[:, :, :, i, :, None]
        return torch.exp2(dv * a2) * h + du * Bs[:, :, :, i, None, :]

    zeros = torch.zeros(b, nseg, G, Dg, N)
    hin = zeros
    hend = dsum = None
    if nseg > 1:
        # pass 1: every segment from zero, its end state and sum of delta
        h, dsum = zeros, torch.zeros(b, nseg, G, Dg)
        for i in order:
            h = step(h, i)
            dsum = dsum + dl[:, :, :, i]
        hend = h
        # pass 2: the chain over the segments, in scan order
        hin = torch.empty_like(hend)
        h = torch.zeros(b, G, Dg, N)
        for s in (range(nseg - 1, -1, -1) if reverse else range(nseg)):
            hin[:, s] = h
            h = torch.exp2(a2 * dsum[:, s, :, :, None]) * h + hend[:, s]
    # pass 3: every segment from its entering state, y in passes of 16
    y = torch.empty(b, nseg, G, seg, Dg)
    h = hin
    for i in order:
        h = step(h, i)
        yv = Dv * uu[:, :, :, i]
        for n0 in range(0, N, SEQ_NS):
            acc = [yv] + [torch.zeros_like(yv)] * 3
            for j in range(min(SEQ_NS, N - n0)):
                acc[j % 4] = acc[j % 4] + Cs[:, :, :, i, None, n0 + j] * \
                    h[..., n0 + j]
            yv = (acc[0] + acc[1]) + (acc[2] + acc[3])
        y[:, :, :, i] = yv
    y = y.transpose(1, 2).reshape(b, G, Lp, Dg)[:, :, :L]
    y = y.to(out_dtype or u.dtype).contiguous()
    if internals:
        return y, dict(hend=hend, dsum=dsum, hin=hin, plan=p)
    return y
