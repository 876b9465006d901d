"""The port's VGG19 perceptual loss and `SRModel`'s `perceptual_opt`
against the JAX package's, on CPU.

- The seeded VGG19 (`init_vgg_params`) is bit-equal to JAX's
  `_init_vgg_params` after the HWIO -> OIHW transpose, with no converter.
- Features of every requested layer, `l_percep` and `l_style`
  (`style_weight` > 0) for the criteria l1, l2 and fro, with and without
  the input normalization and `range_norm`, seeded and from an `.npz`
  written from other seeded arrays, against JAX within 1e-5 relative
  (fp32); the gradient with respect to the prediction within 1e-4 of its
  largest entry.
- `SRModel` with `pixel_opt` and `perceptual_opt`: 3 steps against JAX's
  `SRModel` from the same weights and batches, losses and final weights
  within 2e-3 relative (the bar of `test_sr_model_steps_match_jax`), the
  channel scans' `conv_cout.bias` (exact gradient 0) within the sum of
  the learning rates of its start on each side; the perceptual loss
  alone trains; no loss at all raises JAX's ValueError.

Inputs are 2 x 32 x 32 (VGG19 reaches conv5_4 at 2x2), as in
`tests/test_gan_training.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.losses import perceptual as jp
from vmambair_tpu.train import build_model as jax_build_model
from vmambair_torch.losses import PerceptualLoss, build_loss
from vmambair_torch.losses import perceptual as tp
from vmambair_torch.train import build_model
from vmambair_torch.utils.convert import jax_to_torch

torch.set_num_threads(1)
LAYER_WEIGHTS = {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                 "conv4_4": 1, "conv5_4": 1}
TINY_G = {"type": "OSSNet", "dim": 8, "num_blocks": [1, 1, 1, 1],
          "num_refinement_blocks": 1, "scale": 4}


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


@pytest.mark.parametrize("style_weight", [0.0, 2.0], ids=["percep", "style"])
def test_perceptual_gradient_matches_jax(style_weight):
    """d (l_percep [+ l_style]) / d pred within 1e-4 of its largest entry;
    the target gets no gradient and VGG19 holds no parameter."""
    kw = dict(layer_weights=LAYER_WEIGHTS, style_weight=style_weight,
              criterion="l1")
    x, y = _inputs(3)
    ref_loss = jp.PerceptualLoss(**kw)

    def total(p):
        a, b = ref_loss(p, jnp.asarray(y))
        return a + (b if b is not None else 0.0)

    ref = _nchw(jax.grad(total)(jnp.asarray(x)))
    loss = PerceptualLoss(**kw)
    pred = _nchw(x).requires_grad_()
    target = _nchw(y).requires_grad_()
    percep, style = loss(pred, target)
    assert (style is None) == (style_weight == 0)
    (percep + (style if style is not None else 0.0)).backward()
    assert target.grad is None
    assert (pred.grad - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert not list(loss.parameters())


def test_perceptual_style_only_returns_no_percep():
    loss = PerceptualLoss(LAYER_WEIGHTS, perceptual_weight=0.0,
                          style_weight=1.0)
    x, y = _inputs(4)
    percep, style = loss(_nchw(x), _nchw(y))
    assert percep is None and float(style) > 0


def _opt(tmp_path, **train):
    t = {"total_iter": 10, "ema_decay": 0.999,
         "optim_g": {"type": "Adam", "lr": 2e-3, "weight_decay": 0,
                     "betas": [0.9, 0.99]},
         "scheduler": {"type": "MultiStepLR", "milestones": [2],
                       "gamma": 0.5},
         "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                       "reduction": "mean"},
         "perceptual_opt": {"type": "PerceptualLoss",
                            "layer_weights": dict(LAYER_WEIGHTS),
                            "perceptual_weight": 0.5, "style_weight": 2.0,
                            "criterion": "l2"}}
    t.update(train)
    return {"name": "t", "model_type": "MambaSISRModel", "is_train": True,
            "scale": 4, "num_gpu": 1, "manual_seed": 0,
            "network_g": dict(TINY_G, scan_impl="xla"),
            "path": {"models": str(tmp_path), "training_states":
                     str(tmp_path)},
            "train": t, "val": {"window_size": 8}}


def test_sr_model_with_perceptual_opt_matches_jax(tmp_path):
    """3 steps of SRModel with the L1 pixel, perceptual (l2) and style
    terms. l2: L1's gradient sign(f_pred - f_gt) flips where a deep
    feature of the two nearly ties, and fp32 rounding decides such a tie
    differently in each framework."""
    opt = _opt(tmp_path)
    jm = jax_build_model(opt)
    m = build_model(opt, device="cpu")
    sd = jax_to_torch(jax.tree_util.tree_map(np.asarray, jm.params["params"]))
    m.net_g.load_state_dict(sd)
    m.net_g_ema.load_state_dict(sd)
    rng = np.random.RandomState(5)
    lr_sum = 0.0
    keys = {"l_pix", "l_percep", "l_style", "lr"}
    for it in range(1, 4):
        batch = {"lq": rng.rand(2, 8, 8, 3).astype(np.float32),
                 "gt": rng.rand(2, 32, 32, 3).astype(np.float32)}
        for model in (jm, m):
            model.feed_data(batch)
            model.optimize_parameters(it)
        lj, lt = jm.get_current_log(), m.get_current_log()
        assert set(lj) == set(lt) == keys
        for k in keys:
            assert abs(lt[k] - lj[k]) <= 2e-3 * abs(lj[k]), (it, k, lt[k],
                                                             lj[k])
        lr_sum += lt["lr"]
    for name, tree, net in (("params", jm.params, m.net_g),
                            ("ema", jm.params_ema, m.net_g_ema)):
        ref = jax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                  tree["params"]))
        for k, v in net.state_dict().items():
            if k.endswith("conv_cout.bias"):
                for w in (v, ref[k]):
                    assert (w - sd[k]).abs().max() <= lr_sum * (1 + 1e-5), k
                continue
            assert _rel(v, ref[k]) <= 2e-3, (name, k, _rel(v, ref[k]))
        assert any(_rel(v, sd[k]) > 1e-4 for k, v in net.state_dict().items())


def test_sr_model_trains_on_the_perceptual_loss_alone(tmp_path):
    """Without `pixel_opt` the step takes the perceptual and style terms
    alone: no l_pix, finite losses, G moves, VGG19 in no optimizer."""
    m = build_model(_opt(tmp_path, pixel_opt=None), device="cpu")
    g0 = {k: v.clone() for k, v in m.net_g.state_dict().items()}
    rng = np.random.RandomState(6)
    m.feed_data({"lq": rng.rand(2, 8, 8, 3).astype(np.float32),
                 "gt": rng.rand(2, 32, 32, 3).astype(np.float32)})
    m.optimize_parameters(1)
    log = m.get_current_log()
    assert set(log) == {"l_percep", "l_style", "lr"}
    assert all(np.isfinite(v) for v in log.values())
    assert any(not torch.equal(v, g0[k])
               for k, v in m.net_g.state_dict().items())
    assert {id(p) for g in m.optimizer.param_groups for p in g["params"]} \
        == {id(p) for p in m.net_g.parameters()}


def test_sr_model_needs_a_loss(tmp_path):
    opt = _opt(tmp_path, pixel_opt=None, perceptual_opt=None)
    with pytest.raises(ValueError, match="Both pixel and perceptual"):
        build_model(opt, device="cpu")
