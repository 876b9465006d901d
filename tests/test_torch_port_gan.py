"""The port's GAN stage (S2) against the JAX package's, on CPU: the nets
and the losses (`SRGANModel`'s iterations, the gate, save and resume and
`train_torch.py` with the GAN YAML are in `test_torch_port_gan_steps.py`).

- `UNetDiscriminatorSN`: the forward and the spectral norms' stored u
  (and sigma) after `update_stats=True` and `False`, and after three
  updates in a row, against flax's from the same weights (carried by
  `jax_disc_to_torch`), within 1e-5 relative (fp32), at 32x32 and at a
  non-square 24x40;
- `bilinear_upsample_x2` against `jax.image.resize` within 1e-6;
- `GANLoss`: every type x real/fake x is_disc against JAX within 1e-6
  relative.

Tiny nets, as `tests/test_gan_training.py` builds them: OSSNet dim 8,
D num_feat 8. The GAN iteration on the card is in
`tests/test_torch_port_cuda.py` (no JAX there).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.losses.gan import GANLoss as JaxGANLoss
from vmambair_tpu.models.discriminator import UNetDiscriminatorSN as JaxD
from vmambair_tpu.models.layers import bilinear_upsample_x2 as jax_up2
from vmambair_torch.losses import GANLoss
from vmambair_torch.models import build_network
from vmambair_torch.models.layers import bilinear_upsample_x2
from vmambair_torch.utils.convert import jax_disc_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_G = {"type": "OSSNet", "scale": 4, "dim": 8, "num_blocks": [1, 1, 1, 1],
          "num_refinement_blocks": 1}
TINY_D = {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 8}
LAYER_WEIGHTS = {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                 "conv4_4": 1, "conv5_4": 1}

torch.set_num_threads(1)


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _nchw(x):
    return torch.from_numpy(np.array(np.transpose(np.asarray(x),
                                                  (0, 3, 1, 2))))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_d(seed=0, num_feat=8):
    net = JaxD(num_feat=num_feat)
    v = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))
    return net, _np(v["params"]), _np(v["batch_stats"])


def _port_d(params, stats, num_feat=8):
    d = build_network(dict(TINY_D, num_feat=num_feat), device="cpu")
    d.load_state_dict(jax_disc_to_torch(params, stats))
    return d


def _u_of(stats):
    """{conv: u (O,)} of a flax batch_stats tree."""
    out = {}
    for sname, entry in stats.items():
        k = int(sname.rsplit("_", 1)[1]) + 1
        out[f"conv{k}"] = np.asarray(entry[f"conv{k}/kernel/u"])[0]
    return out


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)], ids=["32x32", "24x40"])
@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
def test_discriminator_matches_flax(hw, update):
    net, params, stats = _jax_d()
    d = _port_d(params, stats)
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    ref, new = net.apply({"params": params, "batch_stats": stats}, x,
                         update_stats=update, mutable=["batch_stats"])
    got = d(_nchw(x), update_stats=update)
    assert got.shape == (2, 1, *hw)
    assert _rel(got.detach(), _nchw(ref)) <= 1e-5
    want_u = _u_of(_np(new["batch_stats"]))
    if not update:
        assert all(np.array_equal(want_u[k], v)
                   for k, v in _u_of(stats).items())
    for conv in d.sn_convs():
        name = next(n for n, m in d.named_modules() if m is conv)
        assert _rel(conv.weight_u, want_u[name]) <= 1e-5, name
        sigma = np.asarray(new["batch_stats"][
            f"SpectralNorm_{int(name[4:]) - 1}"][f"{name}/kernel/sigma"])
        assert _rel(conv.weight_sigma, sigma) <= 1e-5, name


def test_discriminator_u_after_three_updates_in_a_row():
    """The GAN iteration's cadence: three update_stats calls (G's fake,
    D's real, D's fake), each power step from the u the last one stored;
    u after each against flax's."""
    net, params, stats = _jax_d(seed=2)
    d = _port_d(params, stats)
    rng = np.random.RandomState(3)
    variables = {"params": params, "batch_stats": stats}
    for i in range(3):
        x = rng.rand(2, 32, 32, 3).astype(np.float32)
        ref, new = net.apply(variables, x, update_stats=True,
                             mutable=["batch_stats"])
        variables = {"params": params, "batch_stats": _np(new["batch_stats"])}
        got = d(_nchw(x), update_stats=True)
        assert _rel(got.detach(), _nchw(ref)) <= 1e-5, i
        want = _u_of(variables["batch_stats"])
        for name, m in d.named_modules():
            if name in want:
                assert _rel(m.weight_u, want[name]) <= 1e-5, (i, name)


def test_discriminator_converter_raises_on_an_unknown_name():
    _, params, stats = _jax_d()
    with pytest.raises(KeyError, match="no mapping"):
        jax_disc_to_torch(dict(params, extra={}), stats)
    with pytest.raises(KeyError, match="no mapping"):
        jax_disc_to_torch(params, dict(stats, Other_0={}))


def test_discriminator_loads_a_checkpoint_without_sigma():
    """A reference checkpoint (torch's spectral_norm: weight_orig, weight_u,
    weight_v) loads strictly; sigma starts at 1, as flax's."""
    d = build_network(TINY_D, device="cpu", seed=3)
    sd = {k: v for k, v in d.state_dict().items()
          if not k.endswith("weight_sigma")}
    d2 = build_network(TINY_D, device="cpu", seed=4)
    d2.load_state_dict(sd)
    assert all(torch.equal(v, d.state_dict()[k])
               for k, v in d2.state_dict().items()
               if not k.endswith("weight_sigma"))
    assert all(float(m.weight_sigma) == 1.0 for m in d2.sn_convs())


@pytest.mark.parametrize("hw", [(3, 5), (4, 4)])
def test_bilinear_upsample_x2_matches_jax(hw):
    x = np.random.RandomState(4).randn(2, *hw, 3).astype(np.float32)
    ref = _nchw(jax_up2(jnp.asarray(x)))
    got = bilinear_upsample_x2(_nchw(x))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


GAN_TYPES = ["vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"]


@pytest.mark.parametrize("is_disc", [False, True], ids=["g", "d"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "fake"])
@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_gan_loss_matches_jax(gan_type, real, is_disc):
    pred = np.random.RandomState(5).randn(2, 6, 5, 1).astype(np.float32)
    kw = dict(gan_type=gan_type, real_label_val=0.9, fake_label_val=0.1,
              loss_weight=0.3)
    ref = float(JaxGANLoss(**kw)(jnp.asarray(pred), real, is_disc=is_disc))
    got = float(GANLoss(**kw)(_nchw(pred), real, is_disc=is_disc))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)
