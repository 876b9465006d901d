"""The port's deraining nets and model against the JAX package's, on the
CPU (the YAMLs' stages and runs: `test_torch_port_derain.py`; apart so
that the scheduler, `--dist loadfile`, spreads the two over workers).

- Mamber33 and Mamber32 (the `conv_residual` tail: the `output` conv plus
  the input; Mamber32 with biases) and the dual-pixel Mamber33 (six
  channels in, `skip_conv` of the patch embedding, no input residual) at dim
  8, depth [1, 1, 1, 1] + 1: JAX's weights carried by `jax_to_torch`, the
  forward within 2e-4 (JAX on its CPU path, `scan_impl="xla"`);
- the weight round trip through `output` and `skip_conv` is exact, and a
  JAX Mamber33 `.ckpt` loads through `read_flax_checkpoint` with flax and
  JAX blocked, its forward JAX's within 2e-4, and converts to the same
  tensors through `scripts/convert_jax_to_torch.py`;
- 4 `ImageCleanModel` steps with the recipe of
  `options/Deraining_mamber33.yml` (AdamW 3e-4, weight decay 1e-4, betas
  (0.9, 0.999), a global-norm clip of 0.01, the cyclic cosine schedule
  with its periods cut to [2, 6] so that the restart falls inside the
  run, L1, no EMA) against JAX's `ImageCleanModel`: losses, learning
  rates and final parameters within 2e-3 relative, as
  `test_torch_port_train.py::test_sr_model_steps_match_jax` holds S1.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_derain import DEPTH, ROOT, _yaml

from vmambair_tpu.models import build_network as jax_build_network
from vmambair_tpu.train import build_model as jax_build_model
from vmambair_tpu.train.checkpoint import save_network as jax_save_network
from vmambair_torch.models import build_network
from vmambair_torch.train import build_model, checkpoint
from vmambair_torch.utils.convert import jax_to_torch

sys.path.insert(0, os.path.join(ROOT, "scripts"))
from convert_torch_weights import convert  # noqa: E402

torch.set_num_threads(1)

# Mamber32 with biases (the output conv's among them), the others as the
# YAML sets them (bias false)
NETS = {
    "Mamber33": dict(type="Mamber33", **DEPTH),
    "Mamber32": dict(type="Mamber32", bias=True, **DEPTH),
    "dual_pixel": dict(type="Mamber33", inp_channels=6,
                       dual_pixel_task=True, **DEPTH),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _jax_net(cfg, seed=0):
    """JAX's net of `cfg` on its CPU path and its params, perturbed away
    from their init (so the norms and biases are not ones and zeros)."""
    jm = jax_build_network(dict(cfg, scan_impl="xla"))
    c = cfg.get("inp_channels", 3)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 16, 16, c)))["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)).astype(
            np.float32), params)
    return jm, params


@pytest.mark.parametrize("name", list(NETS))
def test_derain_nets_match_flax(name):
    """The forward on a non-square batch (an H / W swap would show), and
    the weight round trip (the torch -> flax converter back to JAX's
    tree, exactly)."""
    cfg = NETS[name]
    jm, params = _jax_net(cfg)
    sd = jax_to_torch(params)
    ref_tree = convert(sd)
    assert jax.tree_util.tree_structure(ref_tree) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(ref_tree),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    net = build_network(cfg, device="cpu")
    net.load_state_dict(sd, strict=True)
    assert ("skip_conv.weight" in sd) == cfg.get("dual_pixel_task", False)
    assert ("output.bias" in sd) == cfg.get("bias", False)
    c = cfg.get("inp_channels", 3)
    x = np.random.RandomState(c).rand(2, 8, 24, c).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": params}, x)
    with torch.inference_mode():
        got = net.eval()(_nchw(x))
    assert got.shape == (2, 3, 8, 24)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_port_loads_a_jax_mamber33_ckpt(tmp_path, monkeypatch):
    """JAX's own `save_network` of a Mamber33 (params and params_ema),
    loaded by the port's loader with flax and JAX blocked."""
    jm, params = _jax_net(NETS["Mamber33"], seed=3)
    ema = jax.tree_util.tree_map(lambda v: v * 0.9, params)
    path = str(tmp_path / "net_g_396000.ckpt")
    jax_save_network(path, params, ema)
    x = np.random.RandomState(2).rand(1, 16, 24, 3).astype(np.float32)
    refs = {k: np.asarray(jax.jit(jm.apply)({"params": p}, x))
            for k, p in (("params", params), ("params_ema", ema))}
    for name in ("flax", "flax.serialization", "jax", "jax.numpy",
                 "vmambair_tpu", "vmambair_tpu.train.checkpoint"):
        monkeypatch.setitem(sys.modules, name, None)
    for key, ref in refs.items():
        net = build_network(NETS["Mamber33"], device="cpu", seed=5)
        checkpoint.load_network(path, net, key)
        with torch.inference_mode():
            got = _nhwc(net.eval()(_nchw(x)))
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    # the converter script on the same file, for a machine without msgpack
    import convert_jax_to_torch

    pth = str(tmp_path / "net_g_396000.pth")
    convert_jax_to_torch.main(["--ckpt", path, "--output", pth])
    sd = torch.load(pth)["params"]
    for k, v in jax_to_torch(params).items():
        assert torch.equal(sd[k], v), k
    assert "output.weight" in sd


def _step_opt(tmp_path):
    """The deraining YAML's model and train blocks, the net at the reduced
    depth, the cyclic periods cut to [2, 6]."""
    y = _yaml("Deraining_mamber33.yml")
    train = dict(y["train"])
    train["scheduler"] = dict(train["scheduler"], periods=[2, 6])
    train["total_iter"] = 8
    return {"name": "t_derain", "model_type": y["model_type"],
            "is_train": True, "scale": 1, "num_gpu": 1, "manual_seed": 0,
            "network_g": dict(y["network_g"], scan_impl="xla", **DEPTH),
            "path": {"models": str(tmp_path),
                     "training_states": str(tmp_path)},
            "train": train, "val": dict(y["val"])}


def test_image_clean_model_steps_match_jax(tmp_path):
    """4 steps from the same weights on the same batches (2 x 24x24 pairs
    of rainy and clean crops). The channel scans' conv_cout.bias has an
    exact gradient of 0; AdamW turns its rounding noise into steps of up
    to about lr each way, so it is held to the sum of the learning
    rates."""
    opt = _step_opt(tmp_path)
    jm = jax_build_model(opt)
    m = build_model(opt, device="cpu")
    assert type(m).__name__ == "ImageRestorationModel" and not m.mixup
    assert m.net_g_ema is None and jm.params_ema is None
    assert isinstance(m.optimizer, torch.optim.AdamW)
    sd = jax_to_torch(jax.tree_util.tree_map(np.asarray, jm.params["params"]))
    m.net_g.load_state_dict(sd)
    rng = np.random.RandomState(0)
    lrs, lr_sum = [], 0.0
    for it in range(1, 5):
        gt = rng.rand(2, 24, 24, 3).astype(np.float32)
        lq = np.clip(gt + 0.3 * (rng.rand(*gt.shape) > 0.9), 0, 1).astype(
            np.float32)
        batch = {"lq": lq, "gt": gt}
        jm.feed_data(batch)
        jm.optimize_parameters(it)
        m.feed_data(batch)
        m.optimize_parameters(it)
        lj, lt = float(jm.log_dict["l_pix"]), m.get_current_log()["l_pix"]
        assert abs(lt - lj) <= 2e-3 * abs(lj), (it, lt, lj)
        assert m.log_dict["lr"] == pytest.approx(jm.log_dict["lr"],
                                                 rel=2e-3)
        lrs.append(m.log_dict["lr"])
        lr_sum += m.log_dict["lr"]
    # the schedule restarted at iteration 3 (period 2 at eta_min 3e-4,
    # then a cosine from 3e-4 down to 1e-6)
    assert lrs[0] == pytest.approx(3e-4) and lrs[3] < lrs[2] < 3e-4
    ref = jax_to_torch(jax.tree_util.tree_map(np.asarray,
                                              jm.params["params"]))
    moved = 0
    for k, v in m.net_g.state_dict().items():
        if k.endswith("conv_cout.bias"):
            assert (v - ref[k]).abs().max() <= lr_sum, k
            continue
        assert _rel(v, ref[k]) <= 2e-3, (k, _rel(v, ref[k]))
        moved += _rel(v, sd[k]) > 1e-4
    assert moved  # the comparison is not of the init


