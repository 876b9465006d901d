"""The port's VGG19 perceptual loss against the JAX package's, on CPU (its
gradient and `SRModel`'s `perceptual_opt`: `test_torch_port_perceptual_
steps.py`).

- The seeded VGG19 (`init_vgg_params`) is bit-equal to JAX's
  `_init_vgg_params` after the HWIO -> OIHW transpose, with no converter.
- Features of every requested layer, `l_percep` and `l_style`
  (`style_weight` > 0) for the criteria l1, l2 and fro, with and without
  the input normalization and `range_norm`, seeded and from an `.npz`
  written from other seeded arrays, against JAX within 1e-5 relative
  (fp32).

Inputs are 2 x 32 x 32 (VGG19 reaches conv5_4 at 2x2), as in
`tests/test_gan_training.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.losses import perceptual as jp
from vmambair_torch.losses import PerceptualLoss, build_loss
from vmambair_torch.losses import perceptual as tp

torch.set_num_threads(1)
LAYER_WEIGHTS = {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                 "conv4_4": 1, "conv5_4": 1}


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _nchw(x):
    return torch.from_numpy(np.array(np.transpose(np.asarray(x),
                                                  (0, 3, 1, 2))))


def _inputs(seed=0, lo=0.0, hi=1.0):
    rng = np.random.RandomState(seed)
    return [(lo + (hi - lo) * rng.rand(2, 32, 32, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """A VGG19 `.npz` in the JAX package's format (HWIO kernels, biases),
    from seeded arrays other than the default draw."""
    rng = np.random.RandomState(7)
    arrays, in_ch = {}, 3
    for item in jp.VGG19_LAYERS:
        if item == "M":
            continue
        name, out_ch = item
        arrays[f"{name}/kernel"] = rng.normal(
            0, np.sqrt(2.0 / (9 * in_ch)), (3, 3, in_ch, out_ch)).astype(
                np.float32)
        arrays[f"{name}/bias"] = rng.normal(0, 0.05, out_ch).astype(
            np.float32)
        in_ch = out_ch
    path = str(tmp_path_factory.mktemp("vgg") / "vgg19.npz")
    np.savez(path, **arrays)
    return path


@pytest.mark.parametrize("source", ["seeded", "npz"])
def test_vgg19_weights_are_jaxs_bits(source, npz):
    path = npz if source == "npz" else None
    ref, ref_pre = jp._init_vgg_params(path)
    got, got_pre = tp.init_vgg_params(path)
    assert got_pre == ref_pre == (source == "npz")
    assert list(got) == list(ref) and len(got) == 16
    for name, (w, b) in got.items():
        kernel = np.transpose(np.asarray(ref[name]["kernel"]), (3, 2, 0, 1))
        assert w.dtype == torch.float32 and b.dtype == torch.float32
        assert np.array_equal(w.numpy(), kernel), name
        assert np.array_equal(b.numpy(), np.asarray(ref[name]["bias"])), name


@pytest.mark.parametrize("use_input_norm,range_norm",
                         [(True, False), (False, False), (True, True)],
                         ids=["norm", "raw", "range_norm"])
def test_vgg19_features_match_jax(use_input_norm, range_norm):
    x, _ = _inputs(1, -1.0 if range_norm else 0.0)
    params, _ = jp._init_vgg_params(None)
    names = ["conv1_1", "conv2_2", "conv3_4", "conv4_4", "conv5_4"]
    ref = jp.vgg19_features(jnp.asarray(x), params, names, use_input_norm,
                            range_norm)
    got = tp.vgg19_features(_nchw(x), tp.init_vgg_params(None)[0], names,
                            use_input_norm, range_norm)
    assert list(got) == names
    for n in names:
        assert _rel(got[n], _nchw(ref[n])) <= 1e-5, n


@pytest.mark.parametrize("source", ["seeded", "npz"])
@pytest.mark.parametrize("criterion", ["l1", "l2", "fro"])
def test_perceptual_and_style_losses_match_jax(criterion, source, npz):
    kw = dict(layer_weights=LAYER_WEIGHTS, perceptual_weight=0.7,
              style_weight=3.0, criterion=criterion,
              pretrained_path=npz if source == "npz" else None)
    x, y = _inputs(2)
    ref = jp.PerceptualLoss(**kw)(jnp.asarray(x), jnp.asarray(y))
    loss = build_loss(dict(type="PerceptualLoss", **kw))
    got = loss(_nchw(x), _nchw(y))
    for r, g in zip(ref, got):
        assert float(g) == pytest.approx(float(r), rel=1e-5)
    assert loss.is_pretrained == (source == "npz")


def test_perceptual_style_only_returns_no_percep():
    loss = PerceptualLoss(LAYER_WEIGHTS, perceptual_weight=0.0,
                          style_weight=1.0)
    x, y = _inputs(4)
    percep, style = loss(_nchw(x), _nchw(y))
    assert percep is None and float(style) > 0
