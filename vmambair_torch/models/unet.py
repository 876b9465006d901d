"""OSS-UNet generator (PyTorch, NCHW).

Counterpart of `vmambair_tpu/models/unet.py`, with the reference torch
arch's attribute names (`MambaSISR6_arch.py`): a 3x3 patch embed; encoder
levels at dims (D, 2D, 4D, 8D) with pixel-unshuffle downsampling; a decoder
with skip concat and 1x1 channel reduce (level 1 runs at 2D with no
reduce); refinement blocks; then the task's tail: the SR tail (a
pixel-shuffle upsampler and a 3x3 conv, plus the nearest-upsampled input)
or the scale-1 restoration tail of the deraining archs
(`mamber3{2,3}_arch.py`): a 3x3 `output` conv plus the input, or, for
dual-pixel defocus deblurring, `skip_conv` (1x1) of the patch embedding
added to the last features before `output`, with no input residual.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import (
    Conv2d,
    Downsample,
    FeedForward,
    LayerNorm2d,
    OverlapPatchEmbed,
    Upsample,
    Upsampler,
    nearest_upsample,
)
from .oss import OSS


class MamberBlock(nn.Module):
    """`x += OSS(LN(x)); x += FFN(LN(x))`. The second branch runs as one
    GDFN kernel when the FFN is bias-free and the norm is WithBias, the
    condition under which JAX takes its fused branch. The width does not
    gate it: on CUDA a width the kernel cannot take raises in the wrapper
    rather than running the plain FFN."""

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.66,
                 use_bias: bool = False, ln_bias: bool = True,
                 channel_version: str = "conv4", channel_attn: str = "mul",
                 sp: bool = False):
        super().__init__()
        self.use_bias = use_bias
        self.ln_bias = ln_bias
        self.norm1 = LayerNorm2d(dim, use_bias=ln_bias)
        self.attn = OSS(dim, channel_version, channel_attn, sp)
        self.norm2 = LayerNorm2d(dim, use_bias=ln_bias)
        self.ffn = FeedForward(dim, ffn_expansion_factor, use_bias)

    def forward(self, x):
        x = x + self.attn(x, norm=self.norm1)
        if not self.use_bias and self.ln_bias:
            w, b = self.norm2.scale_bias()
            return self.ffn.fused_residual(x, w, b, eps=self.norm2.eps)
        return x + self.ffn(self.norm2(x))


class OSSNet(nn.Module):
    """OSS-UNet generator. dtype: the activation dtype (None keeps the
    input's); weights stay fp32. sp: the spatial scans run sequence-
    parallel over the installed sp group (`scan_impl: "sp"`, see
    `OSS.spatial_scan`)."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 scale: int = 4, dim: int = 48,
                 num_blocks: Sequence[int] = (15, 1, 1, 1),
                 num_refinement_blocks: int = 15,
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 ln_bias: bool = True, channel_version: str = "conv4",
                 channel_attn: str = "mul", tail: str = "pixelshuffle",
                 dual_pixel_task: bool = False,
                 dtype: torch.dtype | None = None, sp: bool = False):
        super().__init__()
        if tail not in ("pixelshuffle", "conv_residual"):
            raise ValueError(f"tail {tail!r}: 'pixelshuffle' (SR) or "
                             "'conv_residual' (restoration)")
        self.scale = scale
        self.tail_kind = tail
        self.dual_pixel_task = dual_pixel_task and tail != "pixelshuffle"
        self.dtype = dtype
        nb = tuple(num_blocks)

        def blocks(d, n):
            return nn.Sequential(*[
                MamberBlock(d, ffn_expansion_factor, use_bias, ln_bias,
                            channel_version, channel_attn, sp)
                for _ in range(n)])

        self.patch_embed = OverlapPatchEmbed(inp_channels, dim, use_bias)
        self.encoder_level1 = blocks(dim, nb[0])
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = blocks(dim * 2, nb[1])
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = blocks(dim * 4, nb[2])
        self.down3_4 = Downsample(dim * 4)
        self.latent = blocks(dim * 8, nb[3])
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = Conv2d(dim * 8, dim * 4, 1, bias=use_bias)
        self.decoder_level3 = blocks(dim * 4, nb[2])
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = Conv2d(dim * 4, dim * 2, 1, bias=use_bias)
        self.decoder_level2 = blocks(dim * 2, nb[1])
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = blocks(dim * 2, nb[0])
        self.refinement = blocks(dim * 2, num_refinement_blocks)
        if tail == "pixelshuffle":
            self.tail = nn.Sequential(
                Upsampler(scale, dim * 2),
                Conv2d(dim * 2, out_channels, 3, bias=True))
            return
        if self.dual_pixel_task:
            self.skip_conv = Conv2d(dim, dim * 2, 1, bias=use_bias)
        self.output = Conv2d(dim * 2, out_channels, 3, bias=use_bias)

    def forward(self, inp_img):
        """inp_img: (B, C, H, W) in [0, 1]."""
        x = inp_img if self.dtype is None else inp_img.to(self.dtype)
        x1 = self.patch_embed(x)
        enc1 = self.encoder_level1(x1)
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        latent = self.latent(self.down3_4(enc3))
        d3 = self.reduce_chan_level3(torch.cat([self.up4_3(latent), enc3], 1))
        d3 = self.decoder_level3(d3)
        d2 = self.reduce_chan_level2(torch.cat([self.up3_2(d3), enc2], 1))
        d2 = self.decoder_level2(d2)
        d1 = self.decoder_level1(torch.cat([self.up2_1(d2), enc1], 1))
        d1 = self.refinement(d1)
        if self.tail_kind == "pixelshuffle":
            return self.tail(d1) + nearest_upsample(inp_img, self.scale)
        if self.dual_pixel_task:
            return self.output(d1 + self.skip_conv(x1))
        return self.output(d1) + inp_img
