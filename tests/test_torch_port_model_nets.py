"""The port's OSSNet, MambaSISR6 and tiled inference against the JAX
package on CPU, with weights carried across by `jax_to_torch`, and the
weight round trips (the layers, OSS and MamberBlock:
`test_torch_port_model.py`; apart so that the scheduler, `--dist
loadfile`, spreads the two over workers).

The JAX side runs its CPU path (`scan_impl="xla"`), as `test_models.py`
does; the port's CPU path is its plain versions. Inputs come from
`numpy.random.RandomState`. Tolerance 2e-4 for the nets (the bar
`test_models.py` uses for the fused-vs-XLA model check), 3e-5 for
MambaSISR6 at its full width on JAX's own init; the weight round trip is
exact.
"""


import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import TINY, _nchw, _nhwc, _perturbed

from vmambair_tpu.models import OSSNet as JaxOSSNet
from vmambair_tpu.models import build_network as jax_build_network
from vmambair_tpu.utils.upscaler import RestorationUpscaler as JaxUpscaler
from vmambair_torch.models import OSSNet
from vmambair_torch.models import build_network
from vmambair_torch.utils.convert import jax_to_torch, load_network
from vmambair_torch.utils.upscaler import RestorationUpscaler

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
from convert_torch_weights import convert  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    """One tiny JAX OSSNet (the TINY of test_models.py), its params and the
    port's net with the same weights."""
    model = JaxOSSNet(scan_impl="xla", **TINY)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16, 16, 3)))["params"]
    params = _perturbed(params, 0)
    net = OSSNet(**TINY)
    net.load_state_dict(jax_to_torch(params))
    return model, params, net.eval()


@pytest.mark.parametrize("hw", [(16, 16), (8, 24)])
def test_ossnet_matches_flax(tiny, hw):
    """Non-square 8x24 catches an H/W swap in the col-major merge."""
    model, params, net = tiny
    x = np.random.RandomState(hw[1]).rand(1, *hw, 3).astype(np.float32)
    ref = jax.jit(model.apply)({"params": params}, x)
    with torch.inference_mode():
        got = net(_nchw(x))
    assert got.shape == (1, 3, 4 * hw[0], 4 * hw[1])
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("net_kw", [
    dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1),
    pytest.param({}, marks=pytest.mark.slow)], ids=["reduced", "full"])
def test_mambasisr6_full_width_matches_flax(net_kw):
    """MambaSISR6 at its full width (dim 48, d_state 16: every level width,
    48, 96, 192 and 384, with the fused and the wide spatial routes) at
    reduced depth (one block per level, one refinement block) and, marked
    slow, at the preset's depth: JAX's weights carried across, the forward
    within 3e-5 in fp32."""
    jm = jax_build_network(dict(type="MambaSISR6", scan_impl="xla",
                                **net_kw))
    x = np.random.RandomState(48).rand(1, 16, 24, 3).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), x)["params"]
    net = build_network(dict(type="MambaSISR6", **net_kw), device="cpu")
    net.load_state_dict(jax_to_torch(params))
    ref = jax.jit(jm.apply)({"params": params}, x)
    with torch.inference_mode():
        got = net.eval()(_nchw(x))
    assert got.shape == (1, 3, 64, 96)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref),
                               rtol=3e-5, atol=3e-5)


def test_tile_process_matches_jax(tiny):
    model, params, net = tiny
    img = np.random.RandomState(9).rand(32, 48, 3).astype(np.float32)
    ref = JaxUpscaler(4, model, {"params": params}, tile=16, tile_pad=0,
                      pre_pad=0, tile_batch=4).tile_process(img)
    got = RestorationUpscaler(4, net, "cpu", tile=16, tile_pad=0,
                              pre_pad=0, tile_batch=4).tile_process(img)
    assert got.shape == (128, 192, 3)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert np.shape(x) == np.shape(y)
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_weight_roundtrip_tiny(tiny):
    _, params, net = tiny
    sd = jax_to_torch(params)
    _assert_trees_equal(convert(sd), params)
    assert set(sd) == set(net.state_dict())


def test_weight_roundtrip_mambasisr6_full_size():
    """Shapes from jax.eval_shape (no compile), filled with random values:
    the round trip is exact, and the port's full-size net takes the state
    dict strictly."""
    shapes = jax.eval_shape(
        jax_build_network(dict(type="MambaSISR6")).init,
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 32, 32, 3),
                                                    jnp.float32))["params"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    sd = jax_to_torch(params)
    _assert_trees_equal(convert(sd), params)
    net = build_network(dict(type="MambaSISR6"), device="cpu")
    net.load_state_dict(sd, strict=True)


def test_convert_jax_to_torch_script(tiny, tmp_path):
    from vmambair_tpu.train.checkpoint import save_network

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "scripts"))
    import convert_jax_to_torch

    _, params, _ = tiny
    ckpt, pth = str(tmp_path / "net.ckpt"), str(tmp_path / "net.pth")
    save_network(ckpt, params, params_ema=params)
    convert_jax_to_torch.main(["--ckpt", ckpt, "--output", pth])
    sd = load_network(pth)
    ref = jax_to_torch(params)
    assert set(sd) == set(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k])
