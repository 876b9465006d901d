"""Fused GDFN residual branch: CUDA kernel K2 and its plain version.

Counterpart of `vmambair_tpu/ops/pallas_effn.py` (`gdfn_residual_fused`
:258 with its custom VJP :240-256, `effn_fused_supported` :561), in the
port's NCHW layout. Computes `x + project_out(gelu_erf(x1) * x2)` where
`[x1 | x2] = dwconv3x3(project_in(LayerNorm(x)))`, the whole
`x = x + FFN(norm2(x))` branch of a MamberBlock with a bias-free FFN.

`gdfn_residual_fwd` is the kernel wrapper: a tensor on the CPU goes to the
plain version; a CUDA tensor goes to the kernel (`csrc/gdfn.cu`), or the
call raises; `gdfn_residual_fwd.launches` counts the kernel's launches. It
has no backward. `gdfn_residual_fused` is the differentiable entry point:
without a gradient to record it is one forward launch; otherwise an
autograd Function whose forward is the same launch and whose backward
recomputes through the plain version, as JAX recomputes through
`_gdfn_xla` (JAX has no GDFN backward kernel, so neither has the port).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .._build import dtype_code, f32, grad_needed, no_grad_needed, on_cpu

MAX_C = 384


def effn_fused_supported(c: int) -> bool:
    """Whether the kernel takes C channels (its accumulators hold 384)."""
    return c <= MAX_C


def gdfn_residual_ref(x, ln_w, ln_b, w_in, w_dw, w_out, *, eps=1e-5):
    """Plain version: LayerNorm2d and the three convolutions, in x's dtype
    (JAX's `_gdfn_xla`, :214)."""
    cdt = x.dtype
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    var = (xf - mu).square().mean(1, keepdim=True)
    zn = ((xf - mu) * torch.rsqrt(var + eps) * ln_w.float()[:, None, None]
          + ln_b.float()[:, None, None]).to(cdt)
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
