"""Checkpoint / resume: the reference's two-artifact scheme, with
`torch.save`.

Counterpart of `vmambair_tpu/train/checkpoint.py`:

    <models>/net_g_<iter>.pth      {"params": state dict, "params_ema": ...}
    <training_states>/<iter>.state {"iter", "epoch", "optimizer", "params_ema"}

Writes are atomic (a temporary file in the same directory, then
`os.replace`), so a preempted run cannot leave a torn checkpoint. Loading
falls back between `params` and `params_ema`, and a non-strict load skips
missing keys and mismatched shapes with a warning, keeping the model's
values there. `load_network` also takes the JAX package's `.ckpt` (flax
msgpack, read without flax; where it is missing, the `.pth` of the same
stem: `utils/convert.py::read_network`).
"""

from __future__ import annotations

import logging
import os
import tempfile

import torch

from ..utils.convert import read_network

logger = logging.getLogger("vmambair_torch")
# UNetDiscriminatorSN's spectral-norm state, which a JAX D checkpoint
# lacks (the JAX package keeps it in the training state; a reference
# torch checkpoint has u and v)
_SN_STATE = (".weight_u", ".weight_v", ".weight_sigma")


def _host(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def atomic_save(obj, path: str) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_network(path: str, params: dict, params_ema: dict | None = None):
    """Writes `params` (and `params_ema`) state dicts to `path`."""
    payload = {"params": _host(params)}
    if params_ema is not None:
        payload["params_ema"] = _host(params_ema)
    atomic_save(payload, path)


def merge_matching(target: dict, loaded: dict) -> dict:
    """`target` with every entry of `loaded` whose key and shape match; the
    rest keep the target's value, with a warning (the non-strict load)."""
    out = dict(target)
    for k, v in target.items():
        if k not in loaded:
            logger.warning("checkpoint missing key %s", k)
        elif tuple(loaded[k].shape) != tuple(v.shape):
            logger.warning("shape mismatch at %s: ckpt %s vs model %s — "
                           "keeping model init", k, tuple(loaded[k].shape),
                           tuple(v.shape))
        else:
            out[k] = loaded[k]
    for k in loaded:
        if k not in target:
            logger.warning("checkpoint extra key %s ignored", k)
    return out


def load_network(path: str, net: torch.nn.Module, param_key: str = "params",
                 strict: bool = True) -> torch.nn.Module:
    """Loads the `param_key` state dict of `path` (a `.pth`, or a `.ckpt`
    by `read_network`'s rule) into `net` (falling back between `params`
    and `params_ema`); non-strict skips what does not match. A JAX D
    checkpoint without spectral-norm state keeps the net's u, v and sigma,
    as JAX keeps its own."""
    payload = read_network(path)
    if param_key not in payload:
        alt = "params_ema" if param_key == "params" else "params"
        if alt not in payload:
            raise KeyError(f"{path} has keys {list(payload)}")
        logger.info("loading %s (requested %s absent)", alt, param_key)
        param_key = alt
    sd = payload[param_key]
    kept = {k: v for k, v in net.state_dict().items()
            if k.endswith(_SN_STATE)
            and k.rsplit(".", 1)[0] + ".weight_orig" in sd
            and k.rsplit(".", 1)[0] + ".weight_u" not in sd}
    if kept:
        logger.info("%s holds no spectral-norm state: keeping the net's "
                    "for %d convolutions", path, len(kept) // 3)
        sd = {**sd, **kept}
    if not strict:
        sd = merge_matching(net.state_dict(), sd)
    net.load_state_dict(sd, strict=True)
    return net


def save_training_state(path: str, iter_: int, epoch: int, **states):
    """Writes iter, epoch and the given state dicts (optimizer, EMA)."""
    payload = {"iter": int(iter_), "epoch": int(epoch)}
    for k, v in states.items():
        payload[k] = v
    atomic_save(payload, path)


def load_training_state(path: str, map_location="cpu") -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)
