"""Common model layers (PyTorch, NCHW).

Counterpart of `vmambair_tpu/models/layers.py`. Parameters are named and
shaped as in the reference torch archs (OIHW convolutions,
`norm1.body.weight`, `down1_2.body.0.weight`, ...), so that
`scripts/convert_torch_weights.py::convert` maps them onto the flax tree
and `utils/convert.py::jax_to_torch` maps them back.

Weights are fp32. A module runs in its input's dtype: convolutions cast
their weights to it (bf16 activations with fp32 weights is the serving
posture), LayerNorm takes its statistics in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_effn import gdfn_residual_fused


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in its input's dtype, with padding k//2 and
    torch's default init drawn from an explicit generator."""

    def __init__(self, in_ch, out_ch, kernel_size=3, groups=1, bias=True):
        super().__init__(in_ch, out_ch, kernel_size,
                         padding=kernel_size // 2, groups=groups, bias=bias)

    def reset_parameters(self, gen: torch.Generator | None = None):
        if gen is None:  # the global-RNG init nn.Conv2d.__init__ asks for
            return super().reset_parameters()
        fan_in = self.weight[0].numel()
        uniform_(self.weight, 1.0 / math.sqrt(fan_in), gen)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(fan_in), gen)

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, padding=self.padding, groups=self.groups)


class _LayerNormBody(nn.Module):
    def __init__(self, dim: int, use_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of an NCHW tensor, fp32 statistics, eps 1e-5.
    use_bias=False is the reference's BiasFree_LayerNorm: x / sqrt(var +
    eps) * w, with no mean subtracted in the output."""

    def __init__(self, dim: int, use_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.body = _LayerNormBody(dim, use_bias)
        self.use_bias = use_bias
        self.eps = eps

    def scale_bias(self):
        return self.body.weight, self.body.bias

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(1, keepdim=True)
        var = (xf - mu).square().mean(1, keepdim=True)
        w = self.body.weight[:, None, None]
        if self.use_bias:
            y = (xf - mu) * torch.rsqrt(var + self.eps) * w \
                + self.body.bias[:, None, None]
        else:
            y = xf * torch.rsqrt(var + self.eps) * w
        return y.to(x.dtype)


class FeedForward(nn.Module):
    """Gated-Dconv FFN (Restormer GDFN). `forward` is the composite;
    `fused_residual` is `x + FFN(LayerNorm(x))` through the GDFN kernel."""

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.66,
                 use_bias: bool = False):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = Conv2d(dim, hidden * 2, 1, bias=use_bias)
        self.dwconv = Conv2d(hidden * 2, hidden * 2, 3, groups=hidden * 2,
                             bias=use_bias)
        self.project_out = Conv2d(hidden, dim, 1, bias=use_bias)

    def forward(self, x):
        x = self.dwconv(self.project_in(x))
        x1, x2 = x.chunk(2, dim=1)
        # exact-erf GELU, torch's default and the reference's
        return self.project_out(F.gelu(x1, approximate="none") * x2)

    def fused_residual(self, x, ln_w, ln_b, eps=1e-5):
        """Caller guarantees a bias-free FFN and a WithBias norm."""
        return gdfn_residual_fused(
            x, ln_w, ln_b, self.project_in.weight[:, :, 0, 0],
            self.dwconv.weight[:, 0], self.project_out.weight[:, :, 0, 0],
            eps=eps)


class OverlapPatchEmbed(nn.Module):
    """3x3 conv patch embed."""

    def __init__(self, in_c: int = 3, embed_dim: int = 48,
                 use_bias: bool = False):
        super().__init__()
        self.proj = Conv2d(in_c, embed_dim, 3, bias=use_bias)

    def forward(self, x):
        return self.proj(x)


class Downsample(nn.Module):
    """conv(C -> C/2) + PixelUnshuffle(2): C -> 2C at half resolution."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(n_feat, n_feat // 2, 3, bias=False), nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsample(nn.Module):
    """conv(C -> 2C) + PixelShuffle(2): C -> C/2 at double resolution."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(n_feat, n_feat * 2, 3, bias=False), nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsampler(nn.Sequential):
    """EDSR-style pixel-shuffle chain: scale 2^k is k x (conv 4C,
    PixelShuffle(2)); scale 3 is conv 9C + PixelShuffle(3)."""

    def __init__(self, scale: int, n_feat: int, use_bias: bool = True):
        m = []
        if (scale & (scale - 1)) == 0:
            for _ in range(int(math.log2(scale))):
                m += [Conv2d(n_feat, 4 * n_feat, 3, bias=use_bias),
                      nn.PixelShuffle(2)]
        elif scale == 3:
            m += [Conv2d(n_feat, 9 * n_feat, 3, bias=use_bias),
                  nn.PixelShuffle(3)]
        else:
            raise NotImplementedError(f"scale {scale}")
        super().__init__(*m)


def nearest_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') for an integer scale, NCHW."""
    return x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)


def bilinear_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='bilinear', align_corners=False),
    NCHW: JAX's `jax.image.resize(method="bilinear")` to twice the size."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)
