"""Weight transport from the JAX package's flax tree to the port.

`jax_to_torch` is the inverse of `scripts/convert_torch_weights.py::convert`
(reference torch state dict -> flax tree): it maps an OSSNet flax params
tree (nested dicts of numpy arrays, without the top-level "params" key)
onto the port's state dict, whose names and shapes are the reference
arch's; `jax_disc_to_torch` does the same for the GAN stage's
`UNetDiscriminatorSN` (params and its spectral norms' batch_stats).

`read_flax_checkpoint` reads the JAX package's checkpoints (flax's
msgpack `.ckpt`, `vmambair_tpu/train/checkpoint.py::save_network`)
without flax or JAX: flax's format is msgpack with two extension types,
ext 1 an ndarray packed as (shape, dtype name, bytes) and ext 3 a numpy
scalar the same way, and arrays past 2^30 bytes split into chunks
(`flax.serialization.msgpack_restore`, `_unchunk_array_leaves_in_place`).
`flax_to_state_dict` maps one of its trees to the port's state dict, G's
or D's by its keys; `read_network` takes a `.pth` or a `.ckpt` path by
`resolve_checkpoint`'s rule; `load_network` returns the state dict to
serve.
"""

from __future__ import annotations

import logging
import os
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
    # the restoration tail (Mamber32/33): the output conv and the
    # dual-pixel skip, Conv2d wrappers under the reference's names
    "output": "output",
    "skip_conv": "skip_conv",
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


logger = logging.getLogger("vmambair_torch")

CONVERTER = "scripts/convert_jax_to_torch.py"
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(msgpack, data: bytes) -> np.ndarray:
    """flax's ext payload: msgpack (shape, dtype name, C-order bytes). A
    bfloat16 leaf (numpy has no such dtype) widens to float32 exactly."""
    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """flax's chunked arrays ({_CHUNKED: True, "shape": {"0": ..},
    "chunks": {"0": ..}}) back to arrays, in place."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def read_flax_checkpoint(path: str) -> dict:
    """A flax msgpack checkpoint as nested dicts of numpy arrays, read with
    msgpack alone (no flax, no JAX). Raises ImportError naming the
    converter where msgpack is not installed."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            f"{path} is a flax msgpack checkpoint, and reading it needs the "
            f"msgpack package, which is not installed here; convert it "
            f"where msgpack is: python {CONVERTER} --ckpt {path} "
            f"--output <file>.pth") from e

    def ext_hook(code, data):
        if code == 1:
            return _ndarray(msgpack, data)
        if code == 2:
            real, imag = msgpack.unpackb(data)
            return complex(real, imag)
        if code == 3:
            return _ndarray(msgpack, data)[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def is_disc_tree(tree: dict) -> bool:
    """Whether a flax tree is UNetDiscriminatorSN's: its variables
    (`params` and `batch_stats`) or its params alone (conv0 .. conv9)."""
    return ("params" in tree and "batch_stats" in tree) or "conv0" in tree


def flax_to_state_dict(tree: dict, net: str | None = None) -> dict:
    """One network's flax tree -> the port's state dict, for `net` "g"
    (`jax_to_torch`) or "d" (`jax_disc_to_torch`: D's variables, or its
    params alone without spectral-norm state, which the JAX package keeps
    in the training state); by default the tree's keys decide."""
    if net is None:
        net = "d" if is_disc_tree(tree) else "g"
    if net == "g":
        return jax_to_torch(tree)
    if "batch_stats" in tree:
        return jax_disc_to_torch(tree["params"], tree["batch_stats"])
    return jax_disc_to_torch(tree, {})


def resolve_checkpoint(path: str) -> str:
    """The file to read for `path`: a `.ckpt` that exists (flax msgpack),
    else the `.pth` of the same stem beside it (what the port writes where
    the JAX package wrote the `.ckpt`), said in the log; any other path as
    it is. Raises FileNotFoundError naming both where neither exists."""
    if not path.endswith(".ckpt") or os.path.exists(path):
        return path
    pth = path[:-len(".ckpt")] + ".pth"
    if os.path.exists(pth):
        logger.info("%s does not exist: loading %s, the port's checkpoint "
                    "of the same stem", path, pth)
        return pth
    raise FileNotFoundError(f"neither {path} (a JAX checkpoint) nor {pth} "
                            "(the port's of the same stem) exists")


def read_network(path: str) -> dict:
    """A checkpoint's payload as {key: the port's state dict}: a torch
    file as `torch.load` gives it; a flax `.ckpt` ({"params",
    "params_ema"} trees of the JAX package's `save_network`) converted by
    `flax_to_state_dict`."""
    path = resolve_checkpoint(path)
    if not path.endswith(".ckpt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    return {k: flax_to_state_dict(v)
            for k, v in read_flax_checkpoint(path).items()
            if k in ("params", "params_ema")}


def load_network(path: str) -> dict:
    """A `.pth` or `.ckpt` (`read_network`) -> state dict: `params_ema` if
    the checkpoint has it, else `params`, else the checkpoint itself (a
    bare state dict)."""
    ckpt = read_network(path)
    for key in ("params_ema", "params"):
        if key in ckpt:
            return ckpt[key]
    return ckpt
