"""Fused MamberBlock kernels: the GDFN residual branch (K2), the OSS front
(K5) and the OSS tail (K6), each with its plain version.

Counterpart of `vmambair_tpu/ops/pallas_effn.py`, in the port's NCHW
layout:
- K2 (`gdfn_residual_fused` :258, custom VJP :240-256): `x +
  project_out(gelu_erf(x1) * x2)` where `[x1 | x2] =
  dwconv3x3(project_in(LayerNorm(x)))`, the whole `x = x + FFN(norm2(x))`
  branch of a MamberBlock with a bias-free FFN.
- K5 (`oss_front_fused` :402, custom VJP :384-399): norm1 + the biased
  1x1 in_conv + split + SiLU(z) + SiLU(dwconv3x3(x-half)), the OSS input
  side.
- K6 (`oss_tail_fused` :517, custom VJP :499-514): `LN(y_row + y_colT) *
  z` after the spatial scans, read straight from the scans' (B, 2, D, L)
  sum.

`*_fwd` are the kernel wrappers: a tensor on the CPU goes to the plain
version (`*_ref`); a CUDA tensor goes to the kernel (`csrc/gdfn.cu`,
`csrc/oss_front.cu`, `csrc/oss_tail.cu`), or the call raises; `.launches`
counts each kernel's launches. K2 and K5 take bf16 activations on the
tensor cores, their weights packed per hidden or channel tile
(`pack_gdfn_weights`, `pack_front_weights`, for the width class
`k2_class` or `k5_class` picks). K2 takes fp32 activations on the tensor
cores too, in split TF32 (weights packed in fp32 for `k2f_class` as the
images of its ring slots, `pack_gdfn_f32_weights`; a cluster of
`k2f_split` blocks per tile where the grid is small); so does K5 (its
fp32 width class `k5f_class`, the weights packed in fp32 as its ring's
images, `pack_front_f32_weights`, W_in's rows in k-slices at the widest).
The wrappers have no backward. `*_fused` are the differentiable entry
points: without a gradient to record, one forward
launch; otherwise an autograd Function whose forward is the same launch
and whose backward recomputes through the plain version, as JAX recomputes
through `_gdfn_xla`, `_oss_front_xla` and `_oss_tail_xla` (JAX has no
backward kernel for any of them, so neither has the port).

K5 and K6 are off by default, as in JAX: `VMAMBAIR_OSS_FRONT=1` and
`VMAMBAIR_OSS_TAIL=1` turn them on, `VMAMBAIR_EFFN_FUSED=0` keeps both off
(`oss_front_supported`, `oss_tail_supported`). JAX's TPU shape gates (W a
multiple of 8, the VMEM budget) are not carried over: the kernels take any
H and W, and a width past their shared memory raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from .. import _build
from .._build import dtype_code, f32, grad_needed, no_grad_needed, on_cpu

MAX_C = 384
FRONT_MAX_C = 704  # K5: LN(x) over the halo in shared memory
TAIL_MAX_C = 768   # K6: the pixel tile of every channel in shared memory
# K2's width classes on the tensor cores (csrc/gdfn.cu, k2::Cls0-3): the
# largest C each takes (its padded output width CP), its output tile TH x
# TW and its hidden tile HT
K2_CLASSES = ((48, 8, 16, 32), (96, 8, 16, 16), (192, 8, 8, 32),
              (384, 4, 8, 16))
# K2's fp32 width classes (csrc/gdfn.cu, k2f::Fc0-3): the largest C, the
# output tile TH x TW, the hidden tile HT, the blocks an SM holds and the
# ways the in-projection's k-steps are split over the warps
K2F_CLASSES = ((48, 8, 16, 16, 2, 1), (96, 8, 16, 16, 1, 1),
               (192, 8, 8, 16, 1, 1), (384, 4, 8, 8, 1, 8))
K2F_MAX_SPLIT = 8  # the portable cluster size
# K5's width classes on the tensor cores (csrc/oss_front.cu, k5::Fc0-3):
# the largest C each takes, its output tile TH x TW and its channel tile ET
K5_CLASSES = ((48, 8, 16, 16), (96, 8, 16, 32), (192, 8, 8, 16),
              (FRONT_MAX_C, 4, 8, 16))
# K5's fp32 width classes (csrc/oss_front.cu, k5f::Ff0-3): the largest C,
# the output tile TH x TW, the channel tile ET and the widest k-slice KS of
# W_in's rows that one bulk copy stages
K5F_CLASSES = ((48, 8, 16, 16, 48), (96, 8, 16, 16, 96), (192, 8, 8, 16, 192),
               (FRONT_MAX_C, 4, 8, 16, 128))
K5_AUX = 12  # per channel: 9 depthwise taps, b_dw, b_x, b_z


def effn_fused_supported(c: int) -> bool:
    """Whether the kernel takes C channels (its accumulators hold 384)."""
    return c <= MAX_C


def k2_class(c: int) -> int:
    """The width class K2's bf16 route takes for C channels: the first
    whose largest C is at least C."""
    return next(i for i, k in enumerate(K2_CLASSES) if c <= k[0])


def k2f_class(c: int) -> int:
    """The width class K2's fp32 route takes for C channels."""
    return next(i for i, k in enumerate(K2F_CLASSES) if c <= k[0])


def k2f_split(b: int, h: int, w: int, cls: int, nt: int, resident) -> int:
    """The blocks of a cluster that share one output tile in K2's fp32
    route, each taking every split-th of the nt hidden tiles: the largest
    power of two up to 8 and nt at which the card still holds the tiles'
    clusters all at once (one wave), 1 where it does not at 2.
    `resident(split)`: the clusters of `split` blocks the card holds at
    once (on the card, the kernel's own count by the occupancy API,
    `_resident`)."""
    _, th, tw, _, _, _ = K2F_CLASSES[cls]
    tiles = b * -(-h // th) * -(-w // tw)
    split = 1
    while (2 * split <= min(K2F_MAX_SPLIT, nt)
           and tiles <= resident(2 * split)):
        split *= 2
    return split


@functools.lru_cache(maxsize=None)
def _resident(device: torch.device, nhwc: bool, cls: int, c: int,
              split: int) -> int:
    """The clusters of `split` blocks of K2's fp32 kernel (class cls, C
    channels; keffn's NHWC one if nhwc) that the card holds at once, by
    the CUDA occupancy API."""
    out = ctypes.c_int(0)
    _build.launch("vmt_gdfn_f32_resident", device, cls, c, split, int(nhwc),
                  ctypes.addressof(out))
    return out.value


def k2f_plan(b: int, c: int, h: int, w: int, hid: int, device,
             nhwc: bool = False) -> tuple[int, int, int]:
    """(class, hidden tiles, split) of K2's fp32 route for a launch on the
    CUDA `device`, split by the card's own cluster residency."""
    cls = k2f_class(c)
    nt = -(-hid // K2F_CLASSES[cls][3])
    dev = torch.device(device)
    return cls, nt, k2f_split(b, h, w, cls, nt,
                              lambda s: _resident(dev, nhwc, cls, c, s))


def pack_gdfn_weights(w_in, w_dw, w_out, cls: int, dtype=torch.bfloat16,
                      classes=K2_CLASSES):
    """K2's weights for its tensor-core routes, per hidden tile of the
    width class `cls` of `classes` (K2_CLASSES for bf16, K2F_CLASSES for
    fp32), rounded to `dtype`. w_in (2 hid, C), w_dw (2 hid, 3, 3),
    w_out (C, hid) as `gdfn_residual_fwd` takes them. With HT the class's
    hidden tile, hp = hid rounded up to HT, KP = C rounded up to 16 and CP
    the class's largest C, returns
    - win_p (hp / HT, 2 HT, KP) `dtype`: tile t is W_in's x1 rows t HT ..
      t HT + HT - 1, then its x2 rows hid + t HT ..;
    - wout_p (hp / HT, CP, HT) `dtype`: W_out's columns t HT .. t HT + HT - 1;
    - wdw_p (hp / HT, 2 HT, 9) fp32 of the `dtype`-rounded taps, in
      win_p's row order;
    zero past hid, past C and past CP (a padded hidden channel gives
    gelu(0) * 0 = 0)."""
    cp, ht = classes[cls][0], classes[cls][3]
    c2, c = w_in.shape
    hid = c2 // 2
    hp, kp = -(-hid // ht) * ht, -(-c // 16) * 16
    nt = hp // ht
    dev = w_in.device
    win = F.pad(w_in.detach().reshape(2, hid, c),
                (0, kp - c, 0, hp - hid)).view(2, nt, ht, kp)
    win_p = torch.empty(nt, 2, ht, kp, dtype=dtype, device=dev)
    win_p.permute(1, 0, 2, 3).copy_(win)
    wout = F.pad(w_out.detach(), (0, hp - hid, 0, cp - c)).view(cp, nt, ht)
    wout_p = torch.empty(nt, cp, ht, dtype=dtype, device=dev)
    wout_p.permute(1, 0, 2).copy_(wout)
    wdw = F.pad(w_dw.detach().reshape(2, hid, 9).to(dtype),
                (0, 0, 0, hp - hid)).view(2, nt, ht, 9)
    wdw_p = torch.empty(nt, 2, ht, 9, dtype=torch.float32, device=dev)
    wdw_p.permute(1, 0, 2, 3).copy_(wdw)
    return (win_p.view(nt, 2 * ht, kp), wout_p, wdw_p.view(nt, 2 * ht, 9))


def k2f_slot(c: int, cls: int) -> int:
    """The floats of one ring slot of K2's fp32 route: 2 HT (KP + 4) + CP
    (HT + 4) + 18 HT, KP = C rounded up to 16."""
    cp, _, _, ht, _, _ = K2F_CLASSES[cls]
    return 2 * ht * (-(-c // 16) * 16 + 4) + cp * (ht + 4) + 18 * ht


def pack_gdfn_f32_weights(w_in, w_dw, w_out, cls: int):
    """K2's weights for its fp32 route: per hidden tile of the fp32 width
    class `cls`, the image of the kernel's ring slot, which one bulk copy
    moves to shared memory. Returns (hp / HT, `k2f_slot`) fp32:
    `pack_gdfn_weights`' three tiles (fp32, K2F_CLASSES), W_in's rows and
    W_out's padded with 4 zeros each, one after another. The plain
    version of the wrapper's packing kernel (`vmt_gdfn_f32_pack`)."""
    win_p, wout_p, wdw_p = pack_gdfn_weights(w_in, w_dw, w_out, cls,
                                             torch.float32, K2F_CLASSES)
    nt = win_p.shape[0]
    return torch.cat([F.pad(win_p, (0, 4)).view(nt, -1),
                      F.pad(wout_p, (0, 4)).view(nt, -1),
                      wdw_p.view(nt, -1)], 1)


def launch_gdfn(entry: str, x, dims, ln_w, ln_b, w_in, w_dw, w_out, eps):
    """Launches K2's kernel `entry` (`vmt_gdfn_residual` for NCHW images,
    `vmt_gdfn_tanh_nhwc` for keffn's) on x, `dims` = (B, C, H, W), with
    the weights packed for C's width class: bf16 activations in bf16
    products, fp32 ones (`_f32_fwd`) in split TF32 with a cluster of
    `k2f_split` blocks per tile. Weights in K2's layouts
    (`gdfn_residual_fwd`), rounded to x's dtype; returns y, shaped as
    x."""
    dtype_code(x, "x")
    b, c, h, w = dims
    hid = w_out.shape[1]
    x = x.contiguous()
    y = torch.empty_like(x)
    lnw, lnb = f32(ln_w), f32(ln_b)
    if x.dtype == torch.bfloat16:
        cls = k2_class(c)
        win_p, wout_p, wdw_p = pack_gdfn_weights(w_in, w_dw, w_out, cls)
        _build.launch(
            entry + "_fwd", x.device, x.data_ptr(), y.data_ptr(),
            lnw.data_ptr(), lnb.data_ptr(), win_p.data_ptr(),
            wout_p.data_ptr(), wdw_p.data_ptr(), b, c, h, w,
            wout_p.shape[0] * wout_p.shape[2], cls, float(eps))
        return y
    # the slot images by one packing kernel (pack_gdfn_f32_weights' layout)
    cls, nt, split = k2f_plan(b, c, h, w, hid, x.device, "nhwc" in entry)
    wimg = torch.empty(nt, k2f_slot(c, cls), dtype=torch.float32,
                       device=x.device)
    # held by name until the launch: a copy freed earlier could be reused
    # by the next one's allocation before the packing kernel reads it
    wi, wd, wo = f32(w_in), f32(w_dw), f32(w_out)
    _build.launch("vmt_gdfn_f32_pack", x.device, wi.data_ptr(),
                  wd.data_ptr(), wo.data_ptr(), wimg.data_ptr(), c, hid, cls)
    _build.launch(
        entry + "_f32_fwd", x.device, x.data_ptr(), y.data_ptr(),
        lnw.data_ptr(), lnb.data_ptr(), wimg.data_ptr(), b, c, h, w,
        nt * K2F_CLASSES[cls][3], cls, split, float(eps))
    return y


def _layer_norm(x, w, b, eps):
    """LayerNorm2d over C with fp32 statistics, in fp32 (as the model's)."""
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    var = (xf - mu).square().mean(1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * w.float()[:, None, None] \
        + b.float()[:, None, None]


def gdfn_residual_ref(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5):
    """Plain version: LayerNorm2d and the three convolutions, in x's dtype
    (JAX's `_gdfn_xla`, :214)."""
    cdt = x.dtype
    zn = _layer_norm(x, ln_w, ln_b, eps).to(cdt)
    hid = w_out.shape[1]
    y = F.conv2d(zn, w_in.to(cdt)[:, :, None, None])
    y = F.conv2d(y, w_dw.to(cdt)[:, None], padding=1, groups=2 * hid)
    g = F.gelu(y[:, :hid], approximate="none") * y[:, hid:]
    return x + F.conv2d(g, w_out.to(cdt)[:, :, None, None])


def gdfn_residual_fwd(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5):
    """K2: `x + GDFN(LayerNorm(x))` in one kernel. x (B, C, H, W); ln_w,
    ln_b (C,); w_in (2*hid, C); w_dw (2*hid, 3, 3); w_out (C, hid): the
    convolution weights of `FeedForward` without their unit dims."""
    args = (x, ln_w, ln_b, w_in, w_dw, w_out)
    if on_cpu(*args):
        return gdfn_residual_ref(*args, eps=eps)
    no_grad_needed("gdfn_residual_fwd", *args)
    b, c, h, w = x.shape
    hid = w_out.shape[1]
    if w_in.shape != (2 * hid, c) or w_dw.shape != (2 * hid, 3, 3) \
            or w_out.shape != (c, hid) or ln_w.shape != (c,) \
            or ln_b.shape != (c,):
        raise ValueError("gdfn_residual_fused: weight shapes do not agree "
                         f"with x {tuple(x.shape)}")
    if not effn_fused_supported(c):
        raise ValueError(f"gdfn_residual_fused: C={c} > {MAX_C}")
    # weights rounded to the activation dtype, as the convolutions use them
    y = launch_gdfn("vmt_gdfn_residual", x, (b, c, h, w), ln_w, ln_b, w_in,
                    w_dw, w_out, eps)
    gdfn_residual_fwd.launches += 1
    return y


gdfn_residual_fwd.launches = 0


class _GdfnResidual(torch.autograd.Function):
    """K2 forward; the backward recomputes the plain version under autograd
    from the saved inputs (JAX's custom VJP through `_gdfn_xla`)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_in, w_dw, w_out, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w_in, w_dw, w_out)
        ctx.eps = eps
        return gdfn_residual_fwd(x, ln_w, ln_b, w_in, w_dw, w_out, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = gdfn_residual_ref(*ins, eps=ctx.eps)
            grads = torch.autograd.grad(y, ins, dy)
        return (*grads, None)


def gdfn_residual_fused(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5):
    """`x + GDFN(LayerNorm(x))`, differentiable; arguments as
    `gdfn_residual_fwd`."""
    args = (x, ln_w, ln_b, w_in, w_dw, w_out)
    if grad_needed(*args):
        return _GdfnResidual.apply(*args, eps)
    return gdfn_residual_fwd(*args, eps=eps)


def _switch(name: str) -> bool:
    return (os.environ.get("VMAMBAIR_EFFN_FUSED", "1") != "0"
            and os.environ.get(name, "0") == "1")


def oss_front_supported() -> bool:
    """Whether the OSS blocks take K5: `VMAMBAIR_OSS_FRONT=1`, default off
    (JAX's `oss_front_supported`, :415)."""
    return _switch("VMAMBAIR_OSS_FRONT")


def oss_tail_supported() -> bool:
    """Whether the OSS blocks take K6: `VMAMBAIR_OSS_TAIL=1`, default off
    (JAX's `oss_tail_supported`, :534)."""
    return _switch("VMAMBAIR_OSS_TAIL")


def k5_class(c: int) -> int:
    """The width class K5's bf16 route takes for C channels: the first
    whose largest C is at least C."""
    return next(i for i, k in enumerate(K5_CLASSES) if c <= k[0])


def k5f_class(c: int) -> int:
    """The width class K5's fp32 route takes for C channels."""
    return next(i for i, k in enumerate(K5F_CLASSES) if c <= k[0])


def k5f_slices(c: int, cls: int) -> list[int]:
    """The widths of the k-slices in which K5's fp32 route stages W_in's
    rows: KP = C rounded up to 16 in slices of the class's KS, the last
    the rest."""
    kp, ks = -(-c // 16) * 16, K5F_CLASSES[cls][4]
    return [min(ks, kp - k) for k in range(0, kp, ks)]


def pack_front_weights(w_in, b_in, w_dw, b_dw, cls: int,
                       dtype=torch.bfloat16, classes=K5_CLASSES):
    """K5's weights for its tensor-core routes, per channel tile of the
    width class `cls` of `classes` (K5_CLASSES for bf16, K5F_CLASSES for
    fp32), rounded to `dtype`. w_in (2E, C), b_in (2E,), w_dw
    (E, 3, 3), b_dw (E,) as `oss_front_fwd` takes them. With ET the
    class's channel tile, ep = E rounded up to ET and KP = C rounded up to
    16, returns
    - win_p (ep / ET, 2 ET, KP) `dtype`: tile t is the in_conv's x-half
      rows t ET .. t ET + ET - 1, then its z-half rows E + t ET ..;
    - aux_p (ep / ET, ET, 12) fp32 of the `dtype`-rounded values: each
      channel's 9 taps in (dy, dx) order, b_dw, b_x and b_z;
    zero past E and past C."""
    et = classes[cls][3]
    c2, c = w_in.shape
    e = c2 // 2
    ep, kp = -(-e // et) * et, -(-c // 16) * 16
    nt = ep // et
    win = F.pad(w_in.detach().reshape(2, e, c),
                (0, kp - c, 0, ep - e)).view(2, nt, et, kp)
    win_p = torch.empty(nt, 2, et, kp, dtype=dtype, device=w_in.device)
    win_p.permute(1, 0, 2, 3).copy_(win)
    aux = torch.cat([w_dw.detach().reshape(e, 9), b_dw.detach()[:, None],
                     b_in.detach().reshape(2, e).t()], 1)
    aux_p = F.pad(aux.to(dtype).float(), (0, 0, 0, ep - e))
    return win_p.view(nt, 2 * et, kp), aux_p.view(nt, et, K5_AUX)


def k5f_tile(c: int, cls: int) -> int:
    """The floats of one channel tile's image in K5's fp32 route: 2 ET
    (KP + 4 NS) + 12 ET, NS the k-slices."""
    et = K5F_CLASSES[cls][3]
    return (2 * et * (-(-c // 16) * 16 + 4 * len(k5f_slices(c, cls)))
            + K5_AUX * et)


def pack_front_f32_weights(w_in, b_in, w_dw, b_dw, cls: int):
    """K5's weights for its fp32 route: per channel tile of the fp32 width
    class `cls`, the image that the kernel's ring takes in bulk copies.
    Returns (ep / ET, tile) fp32: for each k-slice (`k5f_slices`) of
    `pack_front_weights`' rows (fp32, K5F_CLASSES), its 2 ET rows of the
    slice's columns and 4 zeros each, then the taps and biases (ET, 12).
    The plain version of the wrapper's packing kernel
    (`vmt_oss_front_f32_pack`)."""
    win_p, aux_p = pack_front_weights(w_in, b_in, w_dw, b_dw, cls,
                                      torch.float32, K5F_CLASSES)
    nt, parts, k0 = win_p.shape[0], [], 0
    for w in k5f_slices(win_p.shape[2], cls):
        parts.append(F.pad(win_p[:, :, k0:k0 + w], (0, 4)).reshape(nt, -1))
        k0 += w
    return torch.cat(parts + [aux_p.reshape(nt, -1)], 1)


def oss_front_ref(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, *, eps=1e-5):
    """Plain version: LayerNorm2d, the biased in_conv, split, SiLU and the
    depthwise conv, in x's dtype, as the unfused OSS does (JAX's
    `_oss_front_xla`, :362). Returns (xs, z)."""
    cdt = x.dtype
    e = w_dw.shape[0]
    zn = _layer_norm(x, ln_w, ln_b, eps).to(cdt)
    pxz = F.conv2d(zn, w_in.to(cdt)[:, :, None, None], b_in.to(cdt))
    px, pz = pxz[:, :e], pxz[:, e:]
    xs = F.conv2d(px, w_dw.to(cdt)[:, None], b_dw.to(cdt), padding=1,
                  groups=e)
    return F.silu(xs), F.silu(pz)


def oss_front_fwd(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, *, eps=1e-5):
    """K5: the OSS front in one kernel. x (B, C, H, W); ln_w, ln_b (C,);
    w_in (2E, C), b_in (2E,): in_conv without its unit dims, x-half rows
    first; w_dw (E, 3, 3), b_dw (E,): the depthwise conv2d. Returns
    (xs, z), each (B, E, H, W) in x's dtype."""
    args = (x, ln_w, ln_b, w_in, b_in, w_dw, b_dw)
    if on_cpu(*args):
        return oss_front_ref(*args, eps=eps)
    no_grad_needed("oss_front_fwd", *args)
    b, c, h, w = x.shape
    e = w_dw.shape[0]
    if w_in.shape != (2 * e, c) or b_in.shape != (2 * e,) \
            or w_dw.shape != (e, 3, 3) or b_dw.shape != (e,) \
            or ln_w.shape != (c,) or ln_b.shape != (c,):
        raise ValueError("oss_front_fused: weight shapes do not agree with "
                         f"x {tuple(x.shape)}")
    if c > FRONT_MAX_C:
        raise ValueError(f"oss_front_fused: C={c} > {FRONT_MAX_C}")
    dtype_code(x, "x")
    x = x.contiguous()
    xs = torch.empty(b, e, h, w, dtype=x.dtype, device=x.device)
    z = torch.empty_like(xs)
    lnw, lnb = f32(ln_w), f32(ln_b)
    # weights and biases rounded to the activation dtype, as the
    # convolutions use them, packed per channel tile of C's width class:
    # bf16 by torch ops, fp32 by the packing kernel (the layout of
    # pack_front_f32_weights)
    if x.dtype == torch.bfloat16:
        cls = k5_class(c)
        win_p, aux_p = pack_front_weights(w_in, b_in, w_dw, b_dw, cls)
        _build.launch(
            "vmt_oss_front_fwd", x.device, x.data_ptr(), xs.data_ptr(),
            z.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), win_p.data_ptr(),
            aux_p.data_ptr(), b, c, e, h, w, cls, float(eps))
    else:
        cls = k5f_class(c)
        et = K5F_CLASSES[cls][3]
        wimg = torch.empty(-(-e // et), k5f_tile(c, cls),
                           dtype=torch.float32, device=x.device)
        # each operand held by name until the launch: a copy that f32
        # makes would otherwise be freed before the kernel reads it
        wi, bi, wd, bd = (f32(w_in), f32(b_in), f32(w_dw.reshape(e, 9)),
                          f32(b_dw))
        _build.launch("vmt_oss_front_f32_pack", x.device, wi.data_ptr(),
                      bi.data_ptr(), wd.data_ptr(), bd.data_ptr(),
                      wimg.data_ptr(), c, e, cls)
        _build.launch(
            "vmt_oss_front_f32_fwd", x.device, x.data_ptr(), xs.data_ptr(),
            z.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wimg.data_ptr(),
            b, c, e, h, w, cls, float(eps))
    oss_front_fwd.launches += 1
    return xs, z


oss_front_fwd.launches = 0


class _OssFront(torch.autograd.Function):
    """K5 forward; the backward recomputes the plain version under autograd
    (JAX's custom VJP through `_oss_front_xla`)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw)
        ctx.eps = eps
        return oss_front_fwd(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, eps=eps)

    @staticmethod
    def backward(ctx, dxs, dz):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = oss_front_ref(*ins, eps=ctx.eps)
            grads = torch.autograd.grad(outs, ins, (dxs, dz))
        return (*grads, None)


def oss_front_fused(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, *, eps=1e-5):
    """The OSS front, (xs, z), differentiable; arguments as
    `oss_front_fwd`."""
    args = (x, ln_w, ln_b, w_in, b_in, w_dw, b_dw)
    if grad_needed(*args):
        return _OssFront.apply(*args, eps)
    return oss_front_fwd(*args, eps=eps)


def oss_tail_ref(y, z, ln_w, ln_b, *, eps=1e-5):
    """Plain version: the two direction pairs merged (the column-major one
    transposed back), LayerNorm2d in fp32, rounded to z's dtype, times z,
    as the unfused OSS does (JAX's `_oss_tail_xla`, :488)."""
    b, d, h, w = z.shape
    y_row = y[:, 0].reshape(b, d, h, w)
    y_colT = y[:, 1].reshape(b, d, w, h).transpose(2, 3)
    return _layer_norm(y_row + y_colT, ln_w, ln_b, eps).to(z.dtype) * z


def oss_tail_fwd(y, z, ln_w, ln_b, *, eps=1e-5):
    """K6: the OSS tail in one kernel. y (B, 2, D, H*W): the spatial
    scans' summed output, pair 0 row-major, pair 1 column-major; z
    (B, D, H, W) the SiLU gate; ln_w, ln_b (D,): out_norm. Returns
    (B, D, H, W) in z's dtype."""
    args = (y, z, ln_w, ln_b)
    if on_cpu(*args):
        return oss_tail_ref(*args, eps=eps)
    no_grad_needed("oss_tail_fwd", *args)
    b, d, h, w = z.shape
    if y.shape != (b, 2, d, h * w) or ln_w.shape != (d,) \
            or ln_b.shape != (d,):
        raise ValueError("oss_tail_fused: shapes do not agree with z "
                         f"{tuple(z.shape)}: y {tuple(y.shape)}")
    if d > TAIL_MAX_C:
        raise ValueError(f"oss_tail_fused: D={d} > {TAIL_MAX_C}")
    y, z = y.contiguous(), z.contiguous()
    out = torch.empty_like(z)
    lnw, lnb = f32(ln_w), f32(ln_b)
    _build.launch(
        "vmt_oss_tail_fwd", z.device,
        y.data_ptr(), dtype_code(y, "y"), z.data_ptr(), dtype_code(z, "z"),
        out.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), b, d, h, w,
        float(eps),
    )
    oss_tail_fwd.launches += 1
    return out


oss_tail_fwd.launches = 0


class _OssTail(torch.autograd.Function):
    """K6 forward; the backward recomputes the plain version under autograd
    (JAX's custom VJP through `_oss_tail_xla`)."""

    @staticmethod
    def forward(ctx, y, z, ln_w, ln_b, eps):
        ctx.save_for_backward(y, z, ln_w, ln_b)
        ctx.eps = eps
        return oss_tail_fwd(y, z, ln_w, ln_b, eps=eps)

    @staticmethod
    def backward(ctx, dout):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = oss_tail_ref(*ins, eps=ctx.eps)
            grads = torch.autograd.grad(out, ins, dout)
        return (*grads, None)


def oss_tail_fused(y, z, ln_w, ln_b, *, eps=1e-5):
    """`LN(y_row + y_colT) * z`, differentiable; arguments as
    `oss_tail_fwd`."""
    args = (y, z, ln_w, ln_b)
    if grad_needed(*args):
        return _OssTail.apply(*args, eps)
    return oss_tail_fwd(*args, eps=eps)
