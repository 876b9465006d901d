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

`k5f_tiles_fwd` does the same for the fp32 route (`oss_front_f32_kernel`):
the fp32 width class's tiles (`K5F_CLASSES`), LN(x) in fp32, the weights
read from the channel tiles' images as `pack_front_f32_weights` packs
them (`unpack_front_f32_image`), and both halves in split TF32 with the
weights as the first operand (`k2_tiles.ksum3`: the weights split by
Veltkamp's split, LN(x) cut (`split_cut`); per k-step of 8, lo.hi, hi.lo,
then hi.hi into one fp32 accumulator; the k-slices the widest class
stages change nothing in that order). `single_tf32_front` is the
control that misses the fp32 bar: the plain version with the in_conv's
operands cut to TF32.
"""

import torch
import torch.nn.functional as F
from k2_tiles import ksum, ksum3, split_cut, tf32

from vmambair_torch.ops.cuda_effn import (K5_AUX, K5_CLASSES, K5F_CLASSES,
                                          k5f_class, k5f_slices,
                                          pack_front_f32_weights,
                                          pack_front_weights)


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


def unpack_front_f32_image(img, c: int, cls: int):
    """`pack_front_f32_weights`' images -> (win_p (nt, 2 ET, KP), aux_p
    (nt, ET, 12)) as `pack_front_weights` gives them for the fp32 class
    `cls`, and the pitch pad (the 4 floats after each row of each k-slice)
    as one flat tensor."""
    et = K5F_CLASSES[cls][3]
    nt = img.shape[0]
    rows, pad, k0 = [], [], 0
    for w in k5f_slices(c, cls):
        part = img[:, k0:k0 + 2 * et * (w + 4)].reshape(nt, 2 * et, w + 4)
        rows.append(part[..., :w])
        pad.append(part[..., w:].flatten())
        k0 += 2 * et * (w + 4)
    assert img.shape[1] == k0 + K5_AUX * et
    return (torch.cat(rows, 2), img[:, k0:].reshape(nt, et, K5_AUX),
            torch.cat(pad))


def _silu_f32(v):
    return v / (1 + torch.exp(-v))


def k5f_tiles_fwd(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, *, eps=1e-5,
                  cls=None):
    """x (B, C, H, W) fp32; weights as `k5_tiles_fwd`; `cls` the fp32
    width class (default C's own, `k5f_class`). Returns (xs, z), each
    (B, E, H, W) fp32."""
    b, c, h, w = x.shape
    cls = k5f_class(c) if cls is None else cls
    cmax, th, tw, et, _ = K5F_CLASSES[cls]
    assert c <= cmax and x.dtype == torch.float32
    e = w_dw.shape[0]
    img = pack_front_f32_weights(w_in, b_in, w_dw, b_dw, cls)
    win_p, aux_p, _ = unpack_front_f32_image(img, c, cls)
    kp = win_p.shape[2]
    nty, ntx = -(-h // th), -(-w // tw)
    mu = x.mean(1, keepdim=True)
    var = (x - mu).square().mean(1, keepdim=True)
    zn = ((x - mu) * torch.rsqrt(var + eps) * ln_w.float()[:, None, None]
          + ln_b.float()[:, None, None])
    # zero outside the image and past C (to KP); every tile's halo at once:
    # (B, nty, ntx, TH + 2, TW + 2, KP)
    zp = F.pad(zn, (1, ntx * tw + 1 - w, 1, nty * th + 1 - h))
    zp = F.pad(zp.permute(0, 2, 3, 1), (0, kp - c))
    halo = zp.unfold(1, th + 2, th).unfold(2, tw + 2, tw).permute(
        0, 1, 2, 4, 5, 3)
    mid = halo[:, :, :, 1:th + 1, 1:tw + 1]
    rows = torch.arange(nty * th + 2).view(nty * th + 2, 1) - 1
    cols = torch.arange(ntx * tw + 2).view(1, ntx * tw + 2) - 1
    inside = ((rows >= 0) & (rows < h) & (cols >= 0) & (cols < w))
    inside = inside.unfold(0, th + 2, th).unfold(1, tw + 2, tw)[..., None]
    xs = torch.empty(b, win_p.shape[0] * et, nty * th, ntx * tw)
    z = torch.empty_like(xs)
    for t in range(win_p.shape[0]):
        au = aux_p[t]                                    # (ET, 12)
        # [ET x pixels] = W . LN(x)^T, the weights the first operand
        px = ksum3(win_p[t, :et], halo.reshape(-1, kp).t(),
                   split_b=split_cut).t().reshape(
            *halo.shape[:-1], et) + au[:, 10]
        px = torch.where(inside, px, torch.zeros(()))  # 0 outside
        a = None
        for dy in range(3):
            for dx in range(3):
                term = au[:, 3 * dy + dx] * px[:, :, :, dy:dy + th,
                                               dx:dx + tw]
                a = term if a is None else a + term
        xo = _silu_f32(a + au[:, 9])
        zo = _silu_f32(ksum3(win_p[t, et:], mid.reshape(-1, kp).t(),
                             split_b=split_cut).t()
                       .reshape(*mid.shape[:-1], et) + au[:, 11])
        for out, v in ((xs, xo), (z, zo)):
            # (B, nty, ntx, TH, TW, ET) -> (B, ET, H.., W..)
            out[:, t * et:(t + 1) * et] = v.permute(0, 5, 1, 3, 2, 4).reshape(
                b, et, nty * th, ntx * tw)
    return xs[:, :e, :h, :w].contiguous(), z[:, :e, :h, :w].contiguous()


def single_tf32_front(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, *, eps=1e-5,
                      cut=tf32):
    """The control for the fp32 route's 1e-5 bar: the plain version with
    the in_conv's operands (LN(x) and W_in) cut to TF32 by `cut` and the
    products summed in fp32, what a single-pass TF32 kernel gives (`tf32`:
    the tensor core reading raw fp32) or a split-TF32 one that drops the
    lo terms (the split's hi). Returns (xs, z), fp32."""
    e = w_dw.shape[0]
    mu = x.mean(1, keepdim=True)
    var = (x - mu).square().mean(1, keepdim=True)
    zn = ((x - mu) * torch.rsqrt(var + eps) * ln_w[:, None, None]
          + ln_b[:, None, None])
    pxz = F.conv2d(cut(zn), cut(w_in)[:, :, None, None], b_in)
    xs = F.conv2d(pxz[:, :e], w_dw[:, None], b_dw, padding=1, groups=e)
    return F.silu(xs), F.silu(pxz[:, e:])
