"""K2's tensor-core route (`vmambair_torch/csrc/gdfn.cu`, `gdfn_mma_kernel`)
in torch ops, for the CPU tests: its tiles, its hidden tiles and its
rounding points.

`k2_tiles_fwd` walks the image in the width class's TH x TW output tiles.
For each it normalises x over the (TH+2) x (TW+2) halo (fp32 statistics,
LN(x) rounded to x's dtype, zero outside the image), then walks the
hidden channels in tiles of HT over the zero-padded hp, with the weights
as `ops/cuda_effn.py::pack_gdfn_weights` packs them (rounded to x's
dtype): the in-projection summed in fp32 in k-steps of 16 (the mma's
depth), the depthwise 3x3 in fp32 with its taps in (dy, dx) order, the
exact-erf (or tanh) gate rounded to x's dtype, and the out-projection in
k-steps of 16 into fp32 accumulators over every hidden tile; the residual
is added in fp32 and rounded once. Within an mma's 16 products the card's
order of the sum is its own, so this is the kernel's arithmetic up to the
order of fp32 sums, not its bits. `unpack_gdfn_weights` inverts the
packing, for the test of the wrapper's side.
"""

import torch
import torch.nn.functional as F

from vmambair_torch.ops.cuda_effn import K2_CLASSES, pack_gdfn_weights

KSTEP = 16


def ksum(a, b):
    """a (..., K) @ b (K, N) in fp32, summed k-step by k-step."""
    out = None
    for k0 in range(0, a.shape[-1], KSTEP):
        part = a[..., k0:k0 + KSTEP] @ b[k0:k0 + KSTEP]
        out = part if out is None else out + part
    return out


def k2_tiles_fwd(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5, cls=0,
                 gate="none"):
    """x (B, C, H, W), fp32 or bf16; weights in K2's layouts (w_in
    (2 hid, C), w_dw (2 hid, 3, 3), w_out (C, hid)); `cls` the width class
    whose tile and HT to walk (any class whose largest C is at least C);
    `gate` F.gelu's `approximate`. Returns y in x's dtype."""
    dt = x.dtype
    b, c, h, w = x.shape
    cp, th, tw, ht = K2_CLASSES[cls]
    assert c <= cp
    win_p, wout_p, wdw_p = pack_gdfn_weights(w_in, w_dw, w_out, cls,
                                             dtype=dt)
    win_p, wout_p = win_p.float(), wout_p.float()
    kp = win_p.shape[2]
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    var = (xf - mu).square().mean(1, keepdim=True)
    zn = ((xf - mu) * torch.rsqrt(var + eps) * ln_w.float()[:, None, None]
          + ln_b.float()[:, None, None]).to(dt).float()
    # zero outside the image (one pad), and past C (to KP)
    zp = F.pad(zn, (1, 1 + tw, 1, 1 + th))
    zp = F.pad(zp.permute(0, 2, 3, 1), (0, kp - c))   # (B, H+.., W+.., KP)
    y = torch.empty_like(x)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            halo = zp[:, y0:y0 + th + 2, x0:x0 + tw + 2]  # (B, ., ., KP)
            acc = torch.zeros(b, th, tw, cp)
            for t in range(win_p.shape[0]):
                hid_t = ksum(halo, win_p[t].t())           # (B, .., .., 2 HT)
                wd = wdw_p[t]                              # (2 HT, 9)
                a = None
                for dy in range(3):
                    for dx in range(3):
                        term = wd[:, 3 * dy + dx] * hid_t[:, dy:dy + th,
                                                          dx:dx + tw]
                        a = term if a is None else a + term
                g = (F.gelu(a[..., :ht], approximate=gate)
                     * a[..., ht:]).to(dt).float()
                acc = acc + ksum(g, wout_p[t].t())
            ye, xe = min(h, y0 + th), min(w, x0 + tw)
            out = acc[:, :ye - y0, :xe - x0, :c].permute(0, 3, 1, 2)
            y[:, :, y0:ye, x0:xe] = (xf[:, :, y0:ye, x0:xe] + out).to(dt)
    return y


def unpack_gdfn_weights(win_p, wout_p, wdw_p, c: int, hid: int):
    """`pack_gdfn_weights`' inverse: (w_in (2 hid, C), w_dw (2 hid, 3, 3),
    w_out (C, hid)) in the packed dtypes, and the pad (every packed entry
    past hid, C or CP) as one flat tensor."""
    nt, ht2, kp = win_p.shape
    ht = ht2 // 2
    win = win_p.view(nt, 2, ht, kp).permute(1, 0, 2, 3).reshape(2, -1, kp)
    wdw = wdw_p.view(nt, 2, ht, 9).permute(1, 0, 2, 3).reshape(2, -1, 9)
    wout = wout_p.permute(1, 0, 2).reshape(wout_p.shape[1], -1)
    pad = torch.cat([win[:, hid:].flatten(), win[:, :hid, c:].flatten(),
                     wdw[:, hid:].flatten(), wout[c:].flatten(),
                     wout[:c, hid:].flatten()])
    return (win[:, :hid, :c].reshape(2 * hid, c),
            wdw[:, :hid].reshape(2 * hid, 3, 3), wout[:c, :hid], pad)
