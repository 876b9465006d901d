"""Selective-scan entry points: CUDA kernels K1 and K4 and their plain
versions.

Counterpart of the dispatch surface of `vmambair_tpu/ops/pallas_scan.py`
(`oss_scan_fused` :1405, `selective_scan` :1428, `fused_scan_supported`
:1237), forward only. A tensor on the CPU goes to the plain version in this
module; a CUDA tensor goes to the kernel (`csrc/oss_scan_fused.cu`,
`csrc/selective_scan.cu`), or the call raises. Each wrapper counts its
launches in its `launches` attribute.

On CUDA every scan goes to a kernel: the JAX thresholds (`min_l=512`, the
`% 8` channel tiling, the channel scan left to XLA) were set by the TPU's
grid overhead and tiling, and eager PyTorch fuses nothing.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import dtype_code, f32, on_cpu
from .selective_scan import selective_scan_chunked

MAX_SCAN_N = 256
MAX_FUSED_D = 256
MAX_FUSED_N = 32


def fused_scan_supported(d: int, N: int) -> bool:
    """Whether a spatial direction pair of width d takes K1 (the rest take
    K4), as `fused_scan_supported` decides it in JAX: the in-kernel
    projection contracts over all d, so d stays at most 256; K1 holds the
    group's x_proj weights in shared memory, so N stays at most 32."""
    return d <= MAX_FUSED_D and N <= MAX_FUSED_N


# -- K4: the plain grouped scan ---------------------------------------------

def selective_scan_ref(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, reverse=False, out_dtype=None):
    """Plain version of `selective_scan` (chunked, fp32 state)."""
    if reverse:
        u, delta, B, C = (t.flip(1) for t in (u, delta, B, C))
    y = selective_scan_chunked(u, delta, A, B, C, D, delta_bias,
                               delta_softplus)
    if reverse:
        y = y.flip(1)
    return y.to(out_dtype or u.dtype)


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus=False, reverse=False, out_dtype=None):
    """Grouped selective scan, forward. u, delta (B, L, D); A (D, N) fp32;
    B, C (B, L, G, N); D, delta_bias (D,). Returns y (B, L, D) in
    `out_dtype` (default: u's dtype). Inputs may be strided views; on CUDA
    the result is a (B, L, D) view of a (B, D, L) buffer."""
    if on_cpu(u, delta, A, B, C, D, delta_bias):
        return selective_scan_ref(u, delta, A, B, C, D, delta_bias,
                                  delta_softplus, reverse, out_dtype)
    bsz, L, dim = u.shape
    G, N = B.shape[2], A.shape[1]
    if delta.shape != u.shape or B.shape != (bsz, L, G, N) or (
            C.shape != B.shape) or A.shape != (dim, N):
        raise ValueError("selective_scan: shapes do not agree: u "
                         f"{tuple(u.shape)} delta {tuple(delta.shape)} A "
                         f"{tuple(A.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)}")
    if dim % G or N > MAX_SCAN_N:
        raise ValueError(f"selective_scan: D={dim} G={G} N={N} not taken "
                         f"by the kernel (D % G == 0, N <= {MAX_SCAN_N})")
    out_dtype = out_dtype or u.dtype
    y = torch.empty(bsz, dim, L, dtype=out_dtype, device=u.device)
    A32 = f32(A)
    D32 = None if D is None else f32(D)
    b32 = None if delta_bias is None else f32(delta_bias)
    _build.launch(
        "vmt_selective_scan_fwd", u.device,
        u.data_ptr(), dtype_code(u, "u"), *u.stride(),
        delta.data_ptr(), dtype_code(delta, "delta"), *delta.stride(),
        A32.data_ptr(),
        B.data_ptr(), dtype_code(B, "B"), *B.stride(),
        C.data_ptr(), dtype_code(C, "C"), *C.stride(),
        None if D32 is None else D32.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        y.data_ptr(), dtype_code(y, "out"), *y.stride(),
        bsz, L, dim, G, N, int(bool(reverse)), int(bool(delta_softplus)),
    )
    selective_scan.launches += 1
    return y.transpose(1, 2)


selective_scan.launches = 0


# -- K1: the projection-fused direction-pair scan -----------------------------

def oss_scan_fused_ref(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, *,
                       softplus=True, reverse=False):
    """Plain version of `oss_scan_fused`: the projection einsums, then the
    chunked scan (JAX's `xla_equiv`, :1287)."""
    b, g, d, l = u2.shape
    N, R = A.shape[2], dt_proj_w.shape[2]
    uf = u2.float()
    x_dbl = torch.einsum("bgdl,gcd->bgcl", uf, x_proj_w.float())
    dts = torch.einsum("bgrl,gdr->bgdl", x_dbl[:, :, :R], dt_proj_w.float())
    u = uf.permute(0, 3, 1, 2).reshape(b, l, g * d)
    delta = dts.permute(0, 3, 1, 2).reshape(b, l, g * d)
    Bs = x_dbl[:, :, R:R + N].permute(0, 3, 1, 2)      # (b, l, g, N)
    Cs = x_dbl[:, :, R + N:].permute(0, 3, 1, 2)
    y = selective_scan_ref(
        u, delta, A.reshape(g * d, N), Bs, Cs, Ds.reshape(-1),
        dt_bias.reshape(-1), delta_softplus=softplus, reverse=reverse)
    return y.reshape(b, l, g, d).permute(0, 2, 3, 1).to(u2.dtype)


def oss_scan_fused(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, *,
                   softplus=True, reverse=False):
    """Projection-fused selective scan of G direction layouts, in the
    kernel's layout (JAX's `dl=True` form). u2 (B, G, D, L); x_proj_w
    (G, R+2N, D); dt_proj_w (G, D, R); dt_bias (G, D); A (G, D, N) (already
    -exp(A_log)); Ds (G, D). Returns y (B, G, D, L) in u2's dtype."""
    if on_cpu(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds):
        return oss_scan_fused_ref(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds,
                                  softplus=softplus, reverse=reverse)
    b, g, d, l = u2.shape
    N, R = A.shape[2], dt_proj_w.shape[2]
    if x_proj_w.shape != (g, R + 2 * N, d) or dt_proj_w.shape != (g, d, R) \
            or dt_bias.shape != (g, d) or A.shape != (g, d, N) \
            or Ds.shape != (g, d):
        raise ValueError("oss_scan_fused: parameter shapes do not agree "
                         f"with u2 {tuple(u2.shape)}")
    if not fused_scan_supported(d, N):
        raise ValueError(f"oss_scan_fused: D={d} N={N} not taken by the "
                         f"kernel (D <= {MAX_FUSED_D}, N <= {MAX_FUSED_N})")
    u2 = u2.contiguous()
    y = torch.empty_like(u2)
    ws = [f32(t) for t in (x_proj_w, dt_proj_w, dt_bias, A, Ds)]
    _build.launch(
        "vmt_oss_scan_fused_fwd", u2.device,
        u2.data_ptr(), dtype_code(u2, "u2"), y.data_ptr(),
        *(w.data_ptr() for w in ws),
        b, g, d, l, N, R, int(bool(reverse)), int(bool(softplus)),
    )
    oss_scan_fused.launches += 1
    return y


oss_scan_fused.launches = 0
