"""Model architectures and their presets.

Counterpart of `vmambair_tpu/models/__init__.py`. The reference names its
arch in YAML `network_g.type`; the same names work here: `OSSNet`, the
`MambaSISR6` (x4 SISR), `MambaRealSR11` (real-world x4 SR) and `Mamber32`
/ `Mamber33` (scale-1 deraining) presets and the GAN stage's
`UNetDiscriminatorSN`.
"""

from __future__ import annotations

import torch

from ..utils.registry import ARCH_REGISTRY

from .discriminator import SNConv2d, UNetDiscriminatorSN
from .layers import Conv2d, FeedForward, LayerNorm2d
from .oss import OSS
from .unet import MamberBlock, OSSNet

ARCH_REGISTRY.register(OSSNet)
ARCH_REGISTRY.register(UNetDiscriminatorSN)


@ARCH_REGISTRY.register(name="MambaSISR6")
def mamba_sisr6(**kw):
    """x4 SISR generator at its shipped size (`MambaSISR15_x4.yml`): dim 48,
    blocks [15, 1, 1, 1], 15 refinement blocks, conv4 channel scan."""
    cfg = dict(
        scale=4,
        dim=48,
        num_blocks=(15, 1, 1, 1),
        num_refinement_blocks=15,
        channel_version="conv4",
        channel_attn="mul",
        tail="pixelshuffle",
    )
    cfg.update(kw)
    return OSSNet(**_normalize(cfg))


@ARCH_REGISTRY.register(name="MambaRealSR11")
def mamba_realsr11(**kw):
    """Real-world x4 SR generator at its shipped size
    (`options/mambaSR11_x4.yml`): dim 48, blocks [6, 2, 2, 1], 6
    refinement blocks, direct channel scan (one feature per channel)."""
    cfg = dict(
        scale=4,
        dim=48,
        num_blocks=(6, 2, 2, 1),
        num_refinement_blocks=6,
        channel_version="direct",
        channel_attn="mul",
        tail="pixelshuffle",
    )
    cfg.update(kw)
    return OSSNet(**_normalize(cfg))


@ARCH_REGISTRY.register(name="Mamber32")
def mamber32(**kw):
    """Deraining generator with additive channel attention
    (`mamber32_arch.py`): scale 1, dim 48, blocks [3, 5, 7, 9], 2
    refinement blocks, conv4 channel scan, the `output` conv plus the
    input (or the dual-pixel skip with `dual_pixel_task`)."""
    cfg = dict(
        scale=1,
        dim=48,
        num_blocks=(3, 5, 7, 9),
        num_refinement_blocks=2,
        channel_version="conv4",
        channel_attn="add",
        tail="conv_residual",
    )
    cfg.update(kw)
    return OSSNet(**_normalize(cfg))


@ARCH_REGISTRY.register(name="Mamber33")
def mamber33(**kw):
    """Deraining generator of `options/Deraining_mamber33.yml`
    (`mamber33_arch.py`): Mamber32 with multiplicative channel attention
    and the conv2 channel scan (two features per channel)."""
    cfg = dict(
        scale=1,
        dim=48,
        num_blocks=(3, 5, 7, 9),
        num_refinement_blocks=2,
        channel_version="conv2",
        channel_attn="mul",
        tail="conv_residual",
    )
    cfg.update(kw)
    return OSSNet(**_normalize(cfg))


def _normalize(cfg: dict) -> dict:
    """Map reference YAML keys to OSSNet fields and drop vestigial ones."""
    cfg = dict(cfg)
    cfg.pop("heads", None)
    # the JAX package's backend switch: "sp" (sequence-parallel spatial
    # scans) is kept, the other values choose JAX backends
    if cfg.pop("scan_impl", None) == "sp":
        cfg["sp"] = True
    if "LayerNorm_type" in cfg:
        cfg["ln_bias"] = cfg.pop("LayerNorm_type") != "BiasFree"
    if "bias" in cfg:
        cfg["use_bias"] = cfg.pop("bias")
    if "num_blocks" in cfg:
        cfg["num_blocks"] = tuple(cfg["num_blocks"])
    return cfg


def init_weights(model: torch.nn.Module, gen: torch.Generator):
    """Draws every convolution and scan parameter (and every spectral
    norm's u) from `gen`, in module order (torch's default conv init, the
    reference's SSM init)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, OSS, SNConv2d)):
            m.reset_parameters(gen)
    return model


def build_network(opt: dict, device="cuda", seed: int = 0):
    """Builds an arch from a YAML `network_g` block (reference YAML keys
    and the JAX package's `scan_impl` are taken), with weights drawn from
    `torch.Generator().manual_seed(seed)` on the host, on `device` (the
    card unless the caller asks for the CPU)."""
    opt = dict(opt)
    factory = ARCH_REGISTRY.get(opt.pop("type"))
    net = factory(**_normalize(opt))
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(device)


__all__ = [
    "ARCH_REGISTRY",
    "Conv2d",
    "FeedForward",
    "LayerNorm2d",
    "MamberBlock",
    "OSS",
    "OSSNet",
    "SNConv2d",
    "UNetDiscriminatorSN",
    "build_network",
    "init_weights",
]
