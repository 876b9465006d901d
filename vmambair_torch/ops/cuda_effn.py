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
counts each kernel's launches. They have no backward. `*_fused` are the
differentiable entry points: without a gradient to record, one forward
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

import os

import torch
import torch.nn.functional as F

from .. import _build
from .._build import dtype_code, f32, grad_needed, no_grad_needed, on_cpu

MAX_C = 384
FRONT_MAX_C = 704  # K5: LN(x) over the halo in shared memory
TAIL_MAX_C = 768   # K6: the pixel tile of every channel in shared memory


def effn_fused_supported(c: int) -> bool:
    """Whether the kernel takes C channels (its accumulators hold 384)."""
    return c <= MAX_C


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
    x = x.contiguous()
    y = torch.empty_like(x)
    # weights rounded to the activation dtype, as the convolutions use them
    cdt = x.dtype
    win_t = f32(w_in.to(cdt).t())
    wdw = f32(w_dw.to(cdt).reshape(2 * hid, 9))
    wout_t = f32(w_out.to(cdt).t())
    lnw, lnb = f32(ln_w), f32(ln_b)
    _build.launch(
        "vmt_gdfn_residual_fwd", x.device,
        x.data_ptr(), dtype_code(x, "x"), y.data_ptr(), lnw.data_ptr(),
        lnb.data_ptr(), win_t.data_ptr(), wdw.data_ptr(), wout_t.data_ptr(),
        b, c, h, w, hid, float(eps),
    )
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
    x = x.contiguous()
    xs = torch.empty(b, e, h, w, dtype=x.dtype, device=x.device)
    z = torch.empty_like(xs)
    # weights and biases rounded to the activation dtype, as the
    # convolutions use them
    cdt = x.dtype
    win_t = f32(w_in.to(cdt).t())
    bin_, bdw = f32(b_in.to(cdt)), f32(b_dw.to(cdt))
    wdw = f32(w_dw.to(cdt).reshape(e, 9))
    lnw, lnb = f32(ln_w), f32(ln_b)
    _build.launch(
        "vmt_oss_front_fwd", x.device,
        x.data_ptr(), dtype_code(x, "x"), xs.data_ptr(), z.data_ptr(),
        lnw.data_ptr(), lnb.data_ptr(), win_t.data_ptr(), bin_.data_ptr(),
        wdw.data_ptr(), bdw.data_ptr(), b, c, e, h, w, float(eps),
    )
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
