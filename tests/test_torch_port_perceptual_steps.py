"""The port's VGG19 perceptual loss's gradient and `SRModel`'s
`perceptual_opt` against the JAX package's, on CPU (the weights, features
and losses: `test_torch_port_perceptual.py`; apart so that the
scheduler, `--dist loadfile`, spreads the two over workers).

- The gradient of `l_percep` and `l_style` with respect to the prediction
  within 1e-4 of its largest entry.
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
from test_torch_port_perceptual import LAYER_WEIGHTS, _inputs, _nchw, _rel

from vmambair_tpu.losses import perceptual as jp
from vmambair_tpu.train import build_model as jax_build_model
from vmambair_torch.losses import PerceptualLoss
from vmambair_torch.train import build_model
from vmambair_torch.utils.convert import jax_to_torch

torch.set_num_threads(1)
TINY_G = {"type": "OSSNet", "dim": 8, "num_blocks": [1, 1, 1, 1],
          "num_refinement_blocks": 1, "scale": 4}


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
