"""The range study of the matmul-dual scan, on the port's model: the
counterpart of `tools/kdualnum.py`.

The dual formulation (kvariants' v22-v26, the TPU's `_scan_block_dual`)
splits each pairwise decay exp(s_t - s_p), s_t = A cumsum(delta), into two
factors whose exponents span r = |A| sum_window(delta); fp32 overflows
past about 88 nats, so the dual is exact to rounding only while r stays
well under about 80 inside its matmul window. This tool measures r per
(b, window, d, n) over the scans of one forward of MambaSISR6 at full
width (dim 48, d_state 16, the preset's depth; seeded init, a seeded
uniform input), for windows of 32, 64 and 128 positions, and prints the
TPU tool's rows:

    python -m vmambair_torch.tools.kdualnum [--device cuda|cpu]

(`KDUALNUM_HW`, default 48, sets the input's height and width.)

Capture: the scans' entries in `models/oss.py` are watched for the one
forward (`collect`). A spatial direction pair on the card runs through K1,
which never writes delta out, so the watcher computes delta =
softplus(W_dt (W_xp u)[:R] + bias) in fp32 from the u and the weights the
call receives; a scan given delta (the channel scans, the spatial pairs
wider than K1 takes) adds the bias and the softplus to it. The forward
itself runs on the kernels as always. A call is kept, as the TPU tool
keeps it, when its sequence is at least 64 long: the spatial scans of 64
positions or more and the channel scans of C >= 64 channels (the TPU
tool's comment calls them spatial scans only; `oss.py`'s channel scans
reach the same entry with L = C). A line before the rows counts the kept
calls by kind and L.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os

import numpy as np
import torch

from ..models import build_network
from ..models import oss as oss_mod
from . import device_of

WINDOWS = (32, 64, 128)
MIN_L = 64   # the TPU tool's rule (kdualnum.py:47)


@contextlib.contextmanager
def _watch(stats: list):
    """Wraps the scan entries of `models.oss` (and the OSS methods, to name
    each call's kind) for the block inside."""
    kind = ["spatial"]
    saved = dict(fused=oss_mod.oss_scan_fused, scan=oss_mod.selective_scan,
                 sp=oss_mod.OSS.spatial_scan, ch=oss_mod.OSS.channel_scan)

    def keep(delta, A, L, softplus=True):
        """delta (B, L, D) before the softplus, fp32; A (D, N)."""
        if L < MIN_L:
            return
        d = delta.detach().float().cpu().numpy()
        if softplus:
            d = np.logaddexp(0.0, d)
        stats.append(dict(kind=kind[0], L=L, delta=d,
                          absA=A.detach().float().abs().cpu().numpy()))

    def fused(u2, xpw, dtw, bias, A, Ds, **kw):
        b, g, d, L = u2.shape
        R = dtw.shape[2]
        with torch.no_grad():
            xr = torch.einsum("bgdl,grd->bgrl", u2.float(),
                              xpw[:, :R].float())
            dl = torch.einsum("bgrl,gdr->bgdl", xr, dtw.float()) \
                + bias.float()[None, :, :, None]
        keep(dl.permute(0, 3, 1, 2).reshape(b, L, g * d),
             A.reshape(g * d, -1), L)
        return saved["fused"](u2, xpw, dtw, bias, A, Ds, **kw)

    def scan(u, delta, A, B, C, D=None, delta_bias=None,
             delta_softplus=False, **kw):
        dl = delta.detach().float()
        if delta_bias is not None:
            dl = dl + delta_bias.detach().float()
        keep(dl, A, u.shape[1], delta_softplus)
        return saved["scan"](u, delta, A, B, C, D=D, delta_bias=delta_bias,
                             delta_softplus=delta_softplus, **kw)

    def named(method, name):
        def run(self, *a, **k):
            kind[0] = name
            return method(self, *a, **k)
        return run

    oss_mod.oss_scan_fused, oss_mod.selective_scan = fused, scan
    oss_mod.OSS.spatial_scan = named(saved["sp"], "spatial")
    oss_mod.OSS.channel_scan = named(saved["ch"], "channel")
    try:
        yield
    finally:
        oss_mod.oss_scan_fused = saved["fused"]
        oss_mod.selective_scan = saved["scan"]
        oss_mod.OSS.spatial_scan = saved["sp"]
        oss_mod.OSS.channel_scan = saved["ch"]


def collect(net, x) -> list:
    """One forward of `net` on `x` (NCHW) under the watcher. Returns the
    kept calls in call order: dict(kind, L, delta (B, L, D) post-softplus
    fp32, absA (D, N)), numpy arrays."""
    stats = []
    with _watch(stats), torch.no_grad():
        net(x)
    return stats


def capture_line(stats: list) -> str:
    """The kept calls by kind and L."""
    parts = []
    for kind in ("spatial", "channel"):
        ls = collections.Counter(s["L"] for s in stats if s["kind"] == kind)
        parts.append(f"{kind} {sum(ls.values())} ("
                     + ", ".join(f"L={L} x{n}" for L, n in sorted(ls.items()))
                     + ")")
    return "captured by kind: " + "; ".join(parts)


def summarize(stats: list) -> list:
    """The TPU tool's rows (kdualnum.py:64-86), as it formats them: per
    window q the percentiles of r = |A| sum_window(delta) over every
    (b, window, d, n) and the shares above 60 and 80 nats; then delta's."""
    lines = []
    for q in WINDOWS:
        rs = []
        for s in stats:
            d, absA = s["delta"], s["absA"]
            Bb, L, Dd = d.shape
            n_w = L // q
            if n_w == 0:
                continue
            wsum = d[:, : n_w * q].reshape(Bb, n_w, q, Dd).sum(2)
            rs.append((wsum[..., None] * absA[None, None]).reshape(-1))
        r = np.concatenate(rs)
        qq = np.percentile(r, [50, 90, 99, 99.9, 99.99, 100])
        lines.append(
            f"q={q:4d}: r median {qq[0]:.2f} p90 {qq[1]:.2f} p99 {qq[2]:.2f}"
            f" p99.9 {qq[3]:.2f} p99.99 {qq[4]:.2f} max {qq[5]:.2f}"
            f"  frac>60 {np.mean(r > 60):.2e} frac>80 {np.mean(r > 80):.2e}")
    alld = np.concatenate([s["delta"].reshape(-1) for s in stats])
    lines.append("delta post-softplus: median %.4f p99 %.4f max %.4f"
                 % tuple(np.percentile(alld, [50, 99, 100])))
    return lines


def make_net_and_input(device, hw: int, seed: int = 0):
    """MambaSISR6 at its preset size with the port's init from `seed`, and a
    uniform (1, 3, hw, hw) input from the same seed."""
    net = build_network(dict(type="MambaSISR6"), device=device,
                        seed=seed).eval()
    x = torch.rand(1, 3, hw, hw, generator=torch.Generator().manual_seed(
        seed)).to(device)
    return net, x


def run(device, hw: int) -> list:
    """The printed lines of one study: the capture counts, the TPU tool's
    capture line, its rows."""
    net, x = make_net_and_input(device, hw)
    stats = collect(net, x)
    return ([capture_line(stats),
             f"captured {len(stats)} spatial scan calls (input {hw}x{hw})"]
            + summarize(stats))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for line in run(device_of(args.device),
                    int(os.environ.get("KDUALNUM_HW", "48"))):
        print(line, flush=True)


if __name__ == "__main__":
    main()
