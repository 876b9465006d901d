"""Weight transport from the JAX package's flax tree to the port.

`jax_to_torch` is the inverse of `scripts/convert_torch_weights.py::convert`
(reference torch state dict -> flax tree): it maps an OSSNet flax params
tree (nested dicts of numpy arrays, without the top-level "params" key)
onto the port's state dict, whose names and shapes are the reference
arch's; `jax_disc_to_torch` does the same for the GAN stage's
`UNetDiscriminatorSN` (params and its spectral norms' batch_stats).
`load_network` reads a torch `.pth` written by
`scripts/convert_jax_to_torch.py` (or any reference checkpoint).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..models.discriminator import l2_normalize


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))  # a copy: restored arrays are frozen


def _oihw(kernel) -> torch.Tensor:
    """flax HWIO kernel -> torch OIHW (a depthwise (kh, kw, 1, C) kernel
    becomes (C, 1, kh, kw) by the same transpose)."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _conv(sd: dict, name: str, entry: dict):
    """A Conv2d wrapper's {"conv": {kernel[, bias]}} -> name.weight/bias."""
    sd[f"{name}.weight"] = _oihw(entry["conv"]["kernel"])
    if "bias" in entry["conv"]:
        sd[f"{name}.bias"] = _t(entry["conv"]["bias"])


def _norm(sd: dict, name: str, entry: dict):
    sd[f"{name}.body.weight"] = _t(entry["weight"])
    if "bias" in entry:
        sd[f"{name}.body.bias"] = _t(entry["bias"])


def oss_to_torch(sd: dict, a: str, attn: dict):
    """One OSS module's flax tree -> `{a}.*` entries of `sd`."""
    _conv(sd, f"{a}.in_conv", attn["in_conv"])
    _conv(sd, f"{a}.conv2d", attn["conv2d"])
    _conv(sd, f"{a}.out_conv", attn["out_conv"])
    sp = attn["spatial"]
    for k in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias", "A_logs",
              "Ds"):
        sd[f"{a}.{k}"] = _t(sp[k])
    _norm(sd, f"{a}.out_norm", sp["out_norm"])
    ch = attn["channel"]
    for k in ("xc_proj_weight", "dtc_projs_weight", "dtc_projs_bias",
              "Ac_logs", "Dsc"):
        if k in ch:
            sd[f"{a}.{k}"] = _t(ch[k])
    if "conv_cin_weight" in ch:
        sd[f"{a}.conv_cin.weight"] = _t(
            np.asarray(ch["conv_cin_weight"]).reshape(-1, 1, 1, 1))
        sd[f"{a}.conv_cin.bias"] = _t(ch["conv_cin_bias"])
        sd[f"{a}.conv_cout.weight"] = _t(
            np.asarray(ch["conv_cout_weight"]).reshape(1, -1, 1, 1))
        sd[f"{a}.conv_cout.bias"] = _t(ch["conv_cout_bias"])
    if "channel_norm" in ch:
        _norm(sd, f"{a}.channel_norm", ch["channel_norm"])


def block_to_torch(sd: dict, prefix: str, p: dict):
    """One MamberBlock's flax tree -> `{prefix}.*` entries of `sd`."""
    for n in ("norm1", "norm2"):
        if n in p:
            _norm(sd, f"{prefix}.{n}", p[n])
    oss_to_torch(sd, f"{prefix}.attn", p["attn"])
    f, ffn = f"{prefix}.ffn", p["ffn"]
    for k in ("project_in", "dwconv", "project_out"):
        _conv(sd, f"{f}.{k}", ffn[k])


# flax name -> torch name of the stem, resampling and reduce convolutions
_LEVELS = {
    "patch_embed": "patch_embed.proj",
    "down1_2": "down1_2.body.0",
    "down2_3": "down2_3.body.0",
    "down3_4": "down3_4.body.0",
    "up4_3": "up4_3.body.0",
    "up3_2": "up3_2.body.0",
    "up2_1": "up2_1.body.0",
    "reduce_chan_level3": "reduce_chan_level3",
    "reduce_chan_level2": "reduce_chan_level2",
}
_BLOCK = re.compile(
    r"^(encoder_level[123]|latent|decoder_level[123]|refinement)_(\d+)$")


def jax_to_torch(params: dict) -> dict:
    """OSSNet flax params tree -> the port's state dict (torch tensors)."""
    sd: dict = {}
    for fname, entry in params.items():
        m = _BLOCK.match(fname)
        if m:
            block_to_torch(sd, f"{m.group(1)}.{m.group(2)}", entry)
        elif fname in _LEVELS:
            # patch_embed nests its Conv2d under "proj", Down/Upsample
            # under "conv"; the reduce convs are Conv2d wrappers themselves
            if fname == "patch_embed":
                entry = entry["proj"]
            elif fname.startswith(("down", "up")):
                entry = entry["conv"]
            _conv(sd, _LEVELS[fname], entry)
        elif fname == "tail_upsampler":
            # Upsampler convs sit at even indices, PixelShuffles between
            for name, conv in entry.items():
                j = int(name[len("conv"):])
                _conv(sd, f"tail.0.{2 * j}", conv)
        elif fname == "tail_conv":
            _conv(sd, "tail.1", entry)
        else:
            raise KeyError(f"jax_to_torch: no mapping for {fname!r}")
    return sd


_DISC_SN = re.compile(r"^SpectralNorm_(\d+)$")


def jax_disc_to_torch(params: dict, batch_stats: dict) -> dict:
    """UNetDiscriminatorSN's flax `params` and `batch_stats` (numpy trees,
    without their top-level keys) -> the port's state dict: conv0 and
    conv9 (`{conv: {kernel, bias}}`) to `.weight` / `.bias`, conv1-8's
    HWIO kernels to `.weight_orig`, `SpectralNorm_{k}`'s u (1, O) and
    sigma to `conv{k+1}.weight_u` (O,) and `.weight_sigma`, and
    `.weight_v` the v of the power step from that u."""
    sd: dict = {}
    for fname, entry in params.items():
        if fname in ("conv0", "conv9"):
            _conv(sd, fname, entry)
        elif re.fullmatch(r"conv[1-8]", fname):
            sd[f"{fname}.weight_orig"] = _oihw(entry["kernel"])
        else:
            raise KeyError(f"jax_disc_to_torch: no mapping for {fname!r}")
    for sname, entry in batch_stats.items():
        m = _DISC_SN.match(sname)
        if not m:
            raise KeyError(f"jax_disc_to_torch: no mapping for {sname!r}")
        conv = f"conv{int(m.group(1)) + 1}"
        for key, value in entry.items():
            if key == f"{conv}/kernel/u":
                sd[f"{conv}.weight_u"] = _t(np.asarray(value).reshape(-1))
            elif key == f"{conv}/kernel/sigma":
                sd[f"{conv}.weight_sigma"] = _t(np.asarray(value).reshape(()))
            else:
                raise KeyError(f"jax_disc_to_torch: no mapping for "
                               f"{sname}/{key}")
        w = sd[f"{conv}.weight_orig"]
        sd[f"{conv}.weight_v"] = l2_normalize(
            sd[f"{conv}.weight_u"][None] @ w.reshape(w.shape[0], -1))[0]
    return sd


def load_network(path: str) -> dict:
    """A torch `.pth` -> state dict: `params_ema` if the checkpoint has it,
    else `params`, else the checkpoint itself (a bare state dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("params_ema", "params"):
        if key in ckpt:
            return ckpt[key]
    return ckpt
