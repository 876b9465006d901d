"""K5's tensor-core route (`vmambair_torch/csrc/oss_front.cu`,
`oss_front_mma_kernel`) in torch ops, for the CPU tests: its tiles, its
channel tiles and its rounding points.

`k5_tiles_fwd` walks the image in the width class's TH x TW output tiles.
For each it normalises x over the (TH+2) x (TW+2) halo (fp32 statistics,
LN(x) rounded to x's dtype, zero outside the image), then walks the
output channels in tiles of ET over the zero-padded E, with the weights
and biases as `ops/cuda_effn.py::pack_front_weights` packs them (rounded
to x's dtype): the x-half projected over the whole halo, summed in fp32
in k-steps of 16 (the mma's depth), plus b_x, then set to 0 outside the
image; the depthwise 3x3 in fp32 with its taps in (dy, dx) order, then
b_dw and SiLU; the z-half projected only over the tile's own pixels (the
halo's centre), plus b_z and SiLU; each output rounded once. Within an
mma's 16 products the card's order of the sum is its own, so this is the
kernel's arithmetic up to the order of fp32 sums, not its bits.
`unpack_front_weights` inverts the packing, for the test of the wrapper's
side.
"""

import torch
import torch.nn.functional as F
from k2_tiles import ksum

from vmambair_torch.ops.cuda_effn import K5_CLASSES, pack_front_weights


def _silu(v):
    """The kernel's form, v / (1 + exp(-v))."""
    return v / (1 + torch.exp(-v))


def k5_tiles_fwd(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, *, eps=1e-5,
                 cls=0):
    """x (B, C, H, W), fp32 or bf16; weights in K5's layouts (w_in (2E, C),
    b_in (2E,), w_dw (E, 3, 3), b_dw (E,)); `cls` the width class whose
    tile and ET to walk (any class whose largest C is at least C). Returns
    (xs, z), each (B, E, H, W) in x's dtype."""
    dt = x.dtype
    b, c, h, w = x.shape
    cmax, th, tw, et = K5_CLASSES[cls]
    assert c <= cmax
    e = w_dw.shape[0]
    win_p, aux_p = pack_front_weights(w_in, b_in, w_dw, b_dw, cls, dtype=dt)
    win_p = win_p.float()
    kp = win_p.shape[2]
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    var = (xf - mu).square().mean(1, keepdim=True)
    zn = ((xf - mu) * torch.rsqrt(var + eps) * ln_w.float()[:, None, None]
          + ln_b.float()[:, None, None]).to(dt).float()
    # zero outside the image (one pad), and past C (to KP)
    zp = F.pad(zn, (1, 1 + tw, 1, 1 + th))
    zp = F.pad(zp.permute(0, 2, 3, 1), (0, kp - c))   # (B, H+.., W+.., KP)
    xs = torch.empty(b, e, h, w, dtype=dt)
    z = torch.empty_like(xs)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            halo = zp[:, y0:y0 + th + 2, x0:x0 + tw + 2]  # (B, ., ., KP)
            rows = torch.arange(y0 - 1, y0 + th + 1)
            cols = torch.arange(x0 - 1, x0 + tw + 1)
            inside = (((rows >= 0) & (rows < h))[:, None]
                      & ((cols >= 0) & (cols < w))[None, :])[..., None]
            mid = halo[:, 1:th + 1, 1:tw + 1]
            ye, xe = min(h, y0 + th), min(w, x0 + tw)
            for t in range(win_p.shape[0]):
                au = aux_p[t]                              # (ET, 12)
                px = ksum(halo, win_p[t, :et].t()) + au[:, 10]
                px = torch.where(inside, px, torch.zeros(()))
                a = None
                for dy in range(3):
                    for dx in range(3):
                        term = au[:, 3 * dy + dx] * px[:, dy:dy + th,
                                                       dx:dx + tw]
                        a = term if a is None else a + term
                xo = _silu(a + au[:, 9]).to(dt)
                zo = _silu(ksum(mid, win_p[t, et:].t()) + au[:, 11]).to(dt)
                e0, e1 = t * et, min(e, t * et + et)
                for out, v in ((xs, xo), (z, zo)):
                    out[:, e0:e1, y0:ye, x0:xe] = v[
                        :, :ye - y0, :xe - x0, :e1 - e0].permute(0, 3, 1, 2)
    return xs, z


def unpack_front_weights(win_p, aux_p, c: int, e: int):
    """`pack_front_weights`' inverse: (w_in (2E, C), b_in (2E,), w_dw
    (E, 3, 3), b_dw (E,)) in the packed dtypes, and the pad (every packed
    entry past E or C) as one flat tensor."""
    nt, et2, kp = win_p.shape
    et = et2 // 2
    win = win_p.view(nt, 2, et, kp).permute(1, 0, 2, 3).reshape(2, -1, kp)
    aux = aux_p.reshape(-1, aux_p.shape[2])
    pad = torch.cat([win[:, e:].flatten(), win[:, :e, c:].flatten(),
                     aux[e:].flatten()])
    return (win[:, :e, :c].reshape(2 * e, c),
            aux[:e, 10:12].t().reshape(2 * e), aux[:e, :9].reshape(e, 3, 3),
            aux[:e, 9], pad)
