"""The port's layers, OSS and MamberBlock against the JAX package on CPU,
with weights carried across by `jax_to_torch` (OSSNet, MambaSISR6, tiled
inference and the weight round trips: `test_torch_port_model_nets.py`).

The JAX side runs its CPU path (`scan_impl="xla"`), as `test_models.py`
does; the port's CPU path is its plain versions. Inputs come from
`numpy.random.RandomState`. Tolerance 2e-4 for the nets (the bar
`test_models.py` uses for the fused-vs-XLA model check), 1e-5 for single
layers.
"""

import jax
import numpy as np
import pytest
import torch

from vmambair_tpu.models.layers import LayerNorm2d as JaxLayerNorm2d
from vmambair_tpu.models.oss import OSS as JaxOSS
from vmambair_tpu.models.unet import MamberBlock as JaxMamberBlock
from vmambair_torch.models import OSS, LayerNorm2d, MamberBlock
from vmambair_torch.utils.convert import block_to_torch, oss_to_torch

torch.set_num_threads(1)

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            scale=4, tail="pixelshuffle")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _perturbed(params, seed):
    """Random, non-default values for every leaf (so norms and D skips
    are exercised away from their ones/zeros init)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)).astype(
            np.float32), params)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("use_bias", [True, False])
def test_layernorm2d_matches_flax(use_bias):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 6, 12).astype(np.float32)
    w = rng.randn(12).astype(np.float32)
    p = {"weight": w}
    if use_bias:
        p["bias"] = rng.randn(12).astype(np.float32)
    ref = JaxLayerNorm2d(12, use_bias=use_bias).apply({"params": p}, x)
    ln = LayerNorm2d(12, use_bias=use_bias)
    ln.body.weight.data = torch.from_numpy(w)
    if use_bias:
        ln.body.bias.data = torch.from_numpy(p["bias"])
    np.testing.assert_allclose(_nhwc(ln(_nchw(x))), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("version,d,hw", [
    ("conv4", 8, (6, 10)),
    ("conv2", 8, (6, 10)),
    ("direct", 8, (6, 10)),
    ("conv4", 264, (2, 3)),   # d > 256: the unfused pair route (K4 on CUDA)
])
def test_oss_matches_flax(version, d, hw):
    rng = np.random.RandomState(d)
    x = (0.5 * rng.randn(2, *hw, d)).astype(np.float32)
    jm = JaxOSS(d_model=d, channel_version=version, scan_impl="xla")
    p = _perturbed(jm.init(jax.random.PRNGKey(1), x)["params"], 2)
    ref = jm.apply({"params": p}, x)
    sd = {}
    oss_to_torch(sd, "attn", p)
    m = OSS(d, channel_version=version)
    m.load_state_dict(_strip(sd, "attn."))
    with torch.inference_mode():
        got = m(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_mamberblock_matches_flax():
    rng = np.random.RandomState(5)
    x = (0.5 * rng.randn(2, 8, 16, 8)).astype(np.float32)
    jm = JaxMamberBlock(dim=8, scan_impl="xla")
    p = _perturbed(jm.init(jax.random.PRNGKey(2), x)["params"], 3)
    ref = jm.apply({"params": p}, x)
    sd = {}
    block_to_torch(sd, "blk", p)
    m = MamberBlock(8)
    m.load_state_dict(_strip(sd, "blk."))
    with torch.inference_mode():
        got = m(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
