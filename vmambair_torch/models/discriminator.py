"""U-Net discriminator with spectral normalization (Real-ESRGAN style).

Counterpart of `vmambair_tpu/models/discriminator.py:20-120`, NCHW, with
the reference torch arch's parameter names (`conv{k}.weight_orig`,
`conv{k}.weight_u`, `conv{k}.weight_v`, as `torch.nn.utils.spectral_norm`
names them), so that a reference checkpoint loads.

`SNConv2d` follows flax's `nn.SpectralNorm` (`_spectral_normalize`), not
torch's: every call runs one power step from the stored u, whether or
not it stores the result, and flax's normalize is x * rsqrt(sum x^2 +
1e-12). With M the kernel flattened to (K, O) (flax: HWIO as (H*W*I, O);
here OIHW as W.reshape(O, -1).T, the same rows in another order, which
changes neither u nor sigma):

    v = normalize(u M^T);  u = normalize(v M);  sigma = v M u^T

u and v detached, sigma differentiable in W; the call convolves with
W / sigma. `update_stats=True` stores u (`weight_u`, flax's u as (O,)),
v (`weight_v`, in torch's I*H*W order; nothing reads it) and sigma
(`weight_sigma`, which a reference checkpoint lacks and then loads as 1,
flax's initial value).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, bilinear_upsample_x2, uniform_

SN_EPS = 1e-12


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """flax's `_l2_normalize`: x * rsqrt(sum(x^2) + eps)."""
    return x * torch.rsqrt(x.square().sum() + SN_EPS)


class SNConv2d(nn.Module):
    """A bias-free convolution whose kernel is spectrally normalized on
    every call, flax's way (module docstring)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        k = in_ch * kernel_size * kernel_size
        self.weight_orig = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.register_buffer("weight_u", torch.empty(out_ch))
        self.register_buffer("weight_v", torch.empty(k))
        self.register_buffer("weight_sigma", torch.ones(()))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        """torch's default conv init (uniform, bound 1/sqrt(fan_in)) and u
        ~ N(0, 1), as flax draws it, from `gen`; v the power step's."""
        w = self.weight_orig
        uniform_(w, 1.0 / math.sqrt(w[0].numel()), gen)
        self.weight_u.copy_(torch.randn(self.weight_u.shape, generator=gen))
        self.weight_v.copy_(
            l2_normalize(self.weight_u[None] @ w.reshape(w.shape[0], -1))[0])
        self.weight_sigma.fill_(1.0)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        state_dict.setdefault(prefix + "weight_sigma", torch.ones(()))
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight_orig
        wm = w.reshape(w.shape[0], -1)  # (O, K) = M^T
        with torch.no_grad():
            v = l2_normalize(self.weight_u[None] @ wm)  # (1, K)
            u = l2_normalize(v @ wm.t())  # (1, O)
        sigma = (v @ wm.t() @ u.t())[0, 0]
        if update_stats:
            self.weight_u.copy_(u[0])
            self.weight_v.copy_(v[0])
            self.weight_sigma.copy_(sigma.detach())
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x, update_stats: bool = False):
        return F.conv2d(x, self.normalized_weight(update_stats),
                        stride=self.stride, padding=self.padding)


class UNetDiscriminatorSN(nn.Module):
    """conv0 (3x3, bias) -> conv1-3 (4x4 stride 2, SN) -> three bilinear
    x2 ups, each into a 3x3 SN conv (conv4-6) with the skips x4 + x2, x5
    + x1, x6 + x0 -> conv7, conv8 (3x3 SN) -> conv9 (3x3 to 1 channel,
    bias); LeakyReLU 0.2 after every conv but conv9. H and W must be
    multiples of 8."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = Conv2d(num_in_ch, nf, 3)
        self.conv1 = SNConv2d(nf, nf * 2, 4, 2, 1)
        self.conv2 = SNConv2d(nf * 2, nf * 4, 4, 2, 1)
        self.conv3 = SNConv2d(nf * 4, nf * 8, 4, 2, 1)
        self.conv4 = SNConv2d(nf * 8, nf * 4, 3)
        self.conv5 = SNConv2d(nf * 4, nf * 2, 3)
        self.conv6 = SNConv2d(nf * 2, nf, 3)
        self.conv7 = SNConv2d(nf, nf, 3)
        self.conv8 = SNConv2d(nf, nf, 3)
        self.conv9 = Conv2d(nf, 1, 3)

    def sn_convs(self) -> list:
        return [m for m in self.modules() if isinstance(m, SNConv2d)]

    def forward(self, x, update_stats: bool = False):
        def lrelu(v):
            return F.leaky_relu(v, 0.2)

        def sn(conv, v):
            return lrelu(conv(v, update_stats))

        x0 = lrelu(self.conv0(x))
        x1 = sn(self.conv1, x0)
        x2 = sn(self.conv2, x1)
        x3 = sn(self.conv3, x2)
        x4 = sn(self.conv4, bilinear_upsample_x2(x3))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = sn(self.conv5, bilinear_upsample_x2(x4))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = sn(self.conv6, bilinear_upsample_x2(x5))
        if self.skip_connection:
            x6 = x6 + x0
        out = sn(self.conv8, sn(self.conv7, x6))
        return self.conv9(out)
