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

`k2f_tiles_fwd` does the same for the fp32 route (`gdfn_f32_kernel`): the
fp32 width class's tiles (`K2F_CLASSES`), LN(x) in fp32, the weights
packed in fp32, both projections in split TF32 (`split_tf32`: hi by
Veltkamp's split to 11 significant bits, lo = a - hi cut to TF32; each
k-step of 8 adds lo.hi, hi.lo, then hi.hi to the fp32 accumulator; the
in-projection keeps the small terms in an accumulator of their own, and
where the class splits its k-steps WK ways, each group's tile is summed
apart and the groups added in order), and a cluster of
`split` blocks per tile: member r takes hidden tiles r, r + split, ...,
and the members' partial output tiles are summed in rank order from 0.
"""

import torch
import torch.nn.functional as F

from vmambair_torch.ops.cuda_effn import (K2_CLASSES, K2F_CLASSES,
                                          k2f_split, pack_gdfn_weights)

KSTEP = 16
# the clusters of 2, 4 and 8 blocks of K2's fp32 kernel that an H100 80GB
# HBM3 holds at once, by width class: the occupancy API's counts, which
# chip_smoke.py's phase 3 prints (`cuda_effn._resident`)
H100_CLUSTERS = ({2: 132, 4: 62, 8: 30}, {2: 66, 4: 30, 8: 15},
                 {2: 66, 4: 30, 8: 15}, {2: 66, 4: 30, 8: 15})


def h100_resident(cls: int):
    """`k2f_split`'s `resident` for class cls on an H100."""
    return H100_CLUSTERS[cls].__getitem__
TF32_KSTEP = 8


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


def tf32(t):
    """fp32 -> the TF32 value the tensor core reads from its bits: the low
    13 mantissa bits dropped (toward zero)."""
    i = t.float().contiguous().view(torch.int32)
    return (i & -0x2000).view(torch.float32)


def split_tf32(t):
    """(hi, lo) as the kernel splits an fp32 operand (`csrc/mma.cuh::
    split_tf32`): Veltkamp's hi = t8 - (t8 - a), t8 = 8193 a, in fp32
    (11 significant bits, exact in TF32), lo = tf32(a - hi)."""
    a = t.float()
    t8 = a * 8193.0
    hi = t8 - (t8 - a)
    return hi, tf32(a - hi)


def ksum3(a, b, acc=None, lo_apart=False):
    """acc + a (..., K) @ b (K, N) in split TF32, k-step by k-step of 8
    (K a multiple of 8): each step adds lo.hi, then hi.lo, then hi.hi, each
    a sum of 8 products of TF32 values (exact in fp32), in fp32. With
    `lo_apart` (the in-projection's two chains) the small terms go to an
    accumulator of their own, added to the hi.hi one at the end."""
    nk = a.shape[-1] // TF32_KSTEP
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)

    def steps(x, y):  # (nk, ..., N): each k-step's partial product
        return torch.einsum("...sk,skn->s...n",
                            x.reshape(*x.shape[:-1], nk, TF32_KSTEP),
                            y.reshape(nk, TF32_KSTEP, -1))

    lh, hl, hh = steps(al, bh), steps(ah, bl), steps(ah, bh)
    lo = None
    for s in range(nk):
        if lo_apart:
            lo = lh[s] if lo is None else lo + lh[s]
            lo = lo + hl[s]
        else:
            acc = lh[s] if acc is None else acc + lh[s]
            acc = acc + hl[s]
        acc = hh[s] if acc is None else acc + hh[s]
    return acc if lo is None else acc + lo


def k2f_tiles_fwd(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5, cls=None,
                  split=None, gate="none"):
    """x (B, C, H, W) fp32; weights as `k2_tiles_fwd`; `cls` the fp32
    width class (default C's own, `k2f_class`), `split` the blocks of a
    cluster per tile (default the split the wrapper takes on an H100:
    `k2f_split` with its cluster residency, `H100_CLUSTERS`);
    `gate` F.gelu's `approximate`. Returns y (fp32)."""
    from vmambair_torch.ops.cuda_effn import k2f_class
    b, c, h, w = x.shape
    cls = k2f_class(c) if cls is None else cls
    cp, th, tw, ht, _, wk = K2F_CLASSES[cls]
    assert c <= cp and x.dtype == torch.float32
    win_p, wout_p, wdw_p = pack_gdfn_weights(
        w_in, w_dw, w_out, cls, torch.float32, K2F_CLASSES)
    nt, kp = win_p.shape[0], win_p.shape[2]
    nty, ntx = -(-h // th), -(-w // tw)
    if split is None:
        split = k2f_split(b, h, w, cls, nt, h100_resident(cls))
    assert split <= nt  # as the kernel's launch checks
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
    part = [None] * split
    for t in range(nt):
        # the k-groups' tiles (every wk-th k-step of 8), summed in order
        hid_t = None
        for g in range(wk):
            ks = [k for k in range(kp) if (k // 8) % wk == g]
            if not ks:  # a group past the k-steps holds zeros
                continue
            hk = ksum3(halo[..., ks], win_p[t][:, ks].t(), lo_apart=True)
            hid_t = hk if hid_t is None else hid_t + hk
        a = None
        for dy in range(3):
            for dx in range(3):
                term = wdw_p[t][:, 3 * dy + dx] * hid_t[
                    :, :, :, dy:dy + th, dx:dx + tw]
                a = term if a is None else a + term
        g = F.gelu(a[..., :ht], approximate=gate) * a[..., ht:]
        part[t % split] = ksum3(g, wout_p[t].t(), part[t % split])
    out = torch.zeros_like(part[0])
    for p in part:
        out = out + p
    # (B, nty, ntx, TH, TW, CP) -> (B, C, H, W)
    out = out.permute(0, 5, 1, 3, 2, 4).reshape(b, cp, nty * th, ntx * tw)
    return x + out[:, :c, :h, :w]


def single_tf32_fwd(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5,
                    cut=tf32):
    """The control for the fp32 route's 1e-5 bar: the plain version with
    both projections' operands cut to TF32 by `cut` and their products
    summed in fp32, what a single-pass TF32 kernel gives (`tf32`: the
    tensor core reading raw fp32) or a split-TF32 one that drops the lo
    terms (the split's hi). x (B, C, H, W) fp32; returns y (fp32)."""
    hid = w_out.shape[1]
    mu = x.mean(1, keepdim=True)
    var = (x - mu).square().mean(1, keepdim=True)
    zn = ((x - mu) * torch.rsqrt(var + eps) * ln_w[:, None, None]
          + ln_b[:, None, None])
    y = F.conv2d(cut(zn), cut(w_in)[:, :, None, None])
    y = F.conv2d(y, w_dw[:, None], padding=1, groups=2 * hid)
    g = F.gelu(y[:, :hid]) * y[:, hid:]
    return x + F.conv2d(cut(g), cut(w_out)[:, :, None, None])


def unpack_gdfn_f32_image(img, c: int, cls: int):
    """`pack_gdfn_f32_weights`' slot images -> (win_p, wout_p, wdw_p) as
    `pack_gdfn_weights` gives them for the fp32 class `cls`, and the pitch
    pad (4 floats after each W_in row and W_out row) as one flat tensor."""
    cp, _, _, ht, _, _ = K2F_CLASSES[cls]
    kp = -(-c // 16) * 16
    nt = img.shape[0]
    a, b = 2 * ht * (kp + 4), cp * (ht + 4)
    assert img.shape[1] == a + b + 18 * ht
    win = img[:, :a].reshape(nt, 2 * ht, kp + 4)
    wout = img[:, a:a + b].reshape(nt, cp, ht + 4)
    wdw = img[:, a + b:].reshape(nt, 2 * ht, 9)
    pad = torch.cat([win[..., kp:].flatten(), wout[..., ht:].flatten()])
    return win[..., :kp], wout[..., :ht], wdw, pad
