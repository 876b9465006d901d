"""The port's loaders on the JAX package's checkpoints, on the CPU.

The JAX package writes flax msgpack `.ckpt` files
(`vmambair_tpu/train/checkpoint.py::save_network`), and the shipped YAMLs
point `pretrain_network_g` at them. The port reads them without flax or
JAX (`vmambair_torch/utils/convert.py::read_flax_checkpoint`; flax and
JAX blocked in `sys.modules` while it loads), or, where the `.ckpt` is
missing, the `.pth` of the same stem that its own S1 run writes:

- a tiny OSSNet's params / params_ema and a tiny UNetDiscriminatorSN's
  variables written by JAX's own `save_network`: the port's G and D
  loaded from them give JAX's forwards within 1e-5 of the largest output;
  JAX's GAN stage's D checkpoint (params alone) loads its kernels and
  keeps the net's spectral-norm state;
- `train_torch.py -opt options/MambaSISR15GAN_x4.yml` with only the data,
  the width, the iterations and the experiments root changed: G comes
  from the `.pth` beside the YAML's `.ckpt`;
- without msgpack the load raises, naming `scripts/convert_jax_to_torch.py`;
  neither file: FileNotFoundError naming both;
- `scripts/convert_jax_to_torch.py` on G and on D, without flax.
"""

import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.models import OSSNet as JaxOSSNet
from vmambair_tpu.models.discriminator import UNetDiscriminatorSN as JaxD
from vmambair_tpu.train.checkpoint import save_network as jax_save_network
from vmambair_torch.models import OSSNet, build_network
from vmambair_torch.train import checkpoint
from vmambair_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import convert_jax_to_torch  # noqa: E402

TINY_G = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              scale=4, tail="pixelshuffle")
TINY_D = {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 8}
TOL = 1e-5

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1,
                                                                  2))))


def _rel(got, ref):
    """max |got - ref| over max |ref|."""
    ref = np.transpose(np.asarray(ref), (0, 3, 1, 2))
    return float(np.abs(got.detach().numpy() - ref).max()
                 / np.abs(ref).max())


def _block_flax(monkeypatch):
    """flax, JAX and the JAX package unimportable from here on in the test
    (the JAX side's writes come first)."""
    for name in ("flax", "flax.serialization", "jax", "jax.numpy",
                 "vmambair_tpu", "vmambair_tpu.train.checkpoint"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(scope="module")
def jax_g():
    """A tiny JAX OSSNet and two sets of its params (params, params_ema)."""
    model = JaxOSSNet(scan_impl="xla", **TINY_G)
    p = _np(jax.jit(model.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 16, 3)))["params"])
    rng = np.random.RandomState(1)
    ema = jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.randn(*a.shape)).astype(a.dtype), p)
    return model, p, ema


@pytest.fixture(scope="module")
def jax_d():
    net = JaxD(num_feat=8)
    v = _np(net.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3))))
    return net, v


def _g_forward_rel(model, params, net):
    x = np.random.RandomState(2).rand(1, 16, 16, 3).astype(np.float32)
    ref = jax.jit(model.apply)({"params": params}, x)
    with torch.inference_mode():
        return _rel(net.eval()(_nchw(x)), ref)


def _d_forward_rel(jnet, variables, d):
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    ref = jnet.apply(variables, x, update_stats=False)
    return _rel(d(_nchw(x), update_stats=False), ref)


@pytest.mark.parametrize("key", ["params", "params_ema"])
def test_port_loads_jax_ckpt_of_g(tmp_path, jax_g, monkeypatch, key):
    """G from JAX's own `.ckpt` (both keys) by `train/checkpoint.py`'s
    loader and by `utils/convert.py`'s (inference: params_ema), without
    flax: its forward is JAX's within 1e-5."""
    model, p, ema = jax_g
    path = str(tmp_path / "net_g_7.ckpt")
    jax_save_network(path, p, ema)
    _block_flax(monkeypatch)
    net = OSSNet(**TINY_G)
    checkpoint.load_network(path, net, key)
    served = OSSNet(**TINY_G)
    served.load_state_dict(convert.load_network(path))
    monkeypatch.undo()  # JAX again, for its forward
    assert _g_forward_rel(model, {"params": p, "params_ema": ema}[key],
                          net) <= TOL
    assert _g_forward_rel(model, ema, served) <= TOL


def test_port_loads_jax_ckpt_of_d(tmp_path, jax_d, monkeypatch):
    """D from JAX's own `.ckpt` of its variables (kernels and the spectral
    norms' state) gives JAX's forward within 1e-5 without flax; from the
    JAX GAN stage's own D checkpoint (its params alone) the kernels load
    and the net keeps its u, v and sigma."""
    jnet, v = jax_d
    full, bare = str(tmp_path / "d_vars.ckpt"), str(tmp_path / "net_d_7.ckpt")
    jax_save_network(full, v)
    jax_save_network(bare, v["params"])
    _block_flax(monkeypatch)
    d = build_network(TINY_D, device="cpu")
    checkpoint.load_network(full, d)
    d2 = build_network(TINY_D, device="cpu")
    before = {k: t.clone() for k, t in d2.state_dict().items()}
    checkpoint.load_network(bare, d2)
    monkeypatch.undo()
    assert _d_forward_rel(jnet, v, d) <= TOL
    after = d2.state_dict()
    for k, t in d.state_dict().items():
        if k.endswith((".weight_u", ".weight_v", ".weight_sigma")):
            assert torch.equal(after[k], before[k]), k
        else:
            assert torch.equal(after[k], t), k


def test_missing_ckpt_loads_the_pth_of_its_stem(tmp_path, caplog,
                                                monkeypatch):
    """A `.ckpt` that does not exist: the `.pth` beside it, said in the
    log; neither: FileNotFoundError naming both."""
    # `get_root_logger` turns propagation off; caplog hooks the root
    monkeypatch.setattr(logging.getLogger("vmambair_torch"), "propagate",
                        True)
    net = OSSNet(**TINY_G)
    want = {k: v + 1 for k, v in net.state_dict().items()}
    checkpoint.save_network(str(tmp_path / "net_g_5.pth"), want, want)
    got = OSSNet(**TINY_G)
    with caplog.at_level(logging.INFO, logger="vmambair_torch"):
        checkpoint.load_network(str(tmp_path / "net_g_5.ckpt"), got,
                                "params_ema")
    assert "net_g_5.pth" in caplog.text
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert all(torch.equal(v, want[k]) for k, v in convert.load_network(
        str(tmp_path / "net_g_5.ckpt")).items())
    with pytest.raises(FileNotFoundError, match="net_g_6.ckpt.*net_g_6.pth"):
        checkpoint.load_network(str(tmp_path / "net_g_6.ckpt"), got)


def test_ckpt_without_msgpack_names_the_converter(tmp_path, jax_d,
                                                  monkeypatch):
    """Where msgpack cannot be imported, reading a `.ckpt` raises
    ImportError naming `scripts/convert_jax_to_torch.py`; nothing falls
    back."""
    path = str(tmp_path / "net_d_1.ckpt")
    jax_save_network(path, jax_d[1]["params"])
    monkeypatch.setitem(sys.modules, "msgpack", None)
    d = build_network(TINY_D, device="cpu")
    for load in (lambda: checkpoint.load_network(path, d),
                 lambda: convert.load_network(path)):
        with pytest.raises(ImportError,
                           match="scripts/convert_jax_to_torch.py"):
            load()


def test_flax_reader_takes_chunked_arrays_and_scalars(tmp_path,
                                                      monkeypatch):
    """flax's chunked leaves (arrays past its chunk size, written as
    {"__msgpack_chunked_array__", "shape", "chunks"}), numpy scalars (ext
    3) and bfloat16 leaves (widened to fp32 exactly), packed here as flax
    packs them."""
    import msgpack

    def nd(a, name=None):
        return msgpack.ExtType(1, msgpack.packb(
            (a.shape, name or a.dtype.name, a.tobytes("C")),
            use_bin_type=True))

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    bf = (np.array([1.5, -2.25], dtype=np.float32).view(np.uint32)
          >> 16).astype(np.uint16)
    tree = {"big": {"__msgpack_chunked_array__": True,
                    "shape": {"0": 3, "1": 4},
                    "chunks": {"0": nd(a.reshape(-1)[:7]),
                               "1": nd(a.reshape(-1)[7:])}},
            "s": msgpack.ExtType(3, msgpack.packb(
                ((), "int32", np.int32(7).tobytes()), use_bin_type=True)),
            "b": nd(bf, "bfloat16"), "n": {"x": nd(a)}}
    path = tmp_path / "t.ckpt"
    path.write_bytes(msgpack.packb(tree, use_bin_type=True))
    _block_flax(monkeypatch)
    got = convert.read_flax_checkpoint(str(path))
    assert np.array_equal(got["big"], a) and np.array_equal(got["n"]["x"], a)
    assert got["s"] == 7
    assert got["b"].dtype == np.float32
    assert got["b"].tolist() == [1.5, -2.25]


@pytest.mark.parametrize("net", ["g", "d"])
@pytest.mark.parametrize("flag", [True, False], ids=["flag", "keys"])
def test_convert_script_without_flax(tmp_path, jax_g, jax_d, net, flag,
                                     monkeypatch):
    """`scripts/convert_jax_to_torch.py` on G's and D's `.ckpt`, flax and
    JAX blocked, with `--net` or by the payload's keys: the `.pth` holds
    what the loaders make of the `.ckpt`."""
    ckpt, out = str(tmp_path / "x.ckpt"), str(tmp_path / "x.pth")
    if net == "g":
        jax_save_network(ckpt, jax_g[1], jax_g[2])
    else:
        jax_save_network(ckpt, jax_d[1])
    _block_flax(monkeypatch)
    convert_jax_to_torch.main(["--ckpt", ckpt, "--output", out]
                              + (["--net", net] if flag else []))
    got = torch.load(out, weights_only=True)
    assert sorted(got) == (["params", "params_ema"] if net == "g"
                           else ["params"])
    for key, sd in convert.read_network(ckpt).items():
        assert sorted(got[key]) == sorted(sd)
        assert all(torch.equal(got[key][k], v) for k, v in sd.items())
    d_or_g = (OSSNet(**TINY_G) if net == "g"
              else build_network(TINY_D, device="cpu"))
    d_or_g.load_state_dict(got["params"])


def test_train_torch_loads_the_gan_yamls_checkpoint(tmp_path):
    """`train_torch.py -opt options/MambaSISR15GAN_x4.yml --device cpu`,
    changing only the data, the width, the iterations and the experiments
    root, with no `path:pretrain_network_g` override: the YAML's
    `experiments/MambaSISR15_x4/models/net_g_100000.ckpt` is missing and
    G (and its EMA) comes from the `.pth` of the same stem that the
    port's S1 run writes there."""
    import yaml

    from vmambair_torch.utils.img_util import imwrite

    with open(os.path.join(ROOT, "options", "MambaSISR15GAN_x4.yml")) as f:
        opt = yaml.safe_load(f)
    ckpt = opt["path"]["pretrain_network_g"]
    assert ckpt.endswith(".ckpt") and opt["path"]["param_key_g"] == \
        "params_ema"
    rng = np.random.RandomState(0)
    for i in range(2):
        gt = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        lq = gt.reshape(8, 4, 8, 4, 3).mean((1, 3)).round().astype(np.uint8)
        imwrite(gt, str(tmp_path / "gt" / f"{i}.png"))
        imwrite(lq, str(tmp_path / "lq" / f"{i}.png"))
    width = ["network_g:dim=8", "network_g:num_blocks=[1,1,1,1]",
             "network_g:num_refinement_blocks=1", "network_d:num_feat=8"]
    g = build_network(dict(opt["network_g"], dim=8, num_blocks=[1, 1, 1, 1],
                           num_refinement_blocks=1), device="cpu", seed=9)
    sd = {k: v + 0.01 for k, v in g.state_dict().items()}
    checkpoint.save_network(
        str(tmp_path / ckpt[:-len(".ckpt")]) + ".pth", g.state_dict(), sd)
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "train_torch.py"), "-opt",
         os.path.join(ROOT, "options", "MambaSISR15GAN_x4.yml"), "--device",
         "cpu", "--force_yml",
         f"datasets:train:dataroot_gt={tmp_path / 'gt'}",
         f"datasets:train:dataroot_lq={tmp_path / 'lq'}",
         "datasets:train:gt_size=32", "datasets:train:batch_size_per_gpu=2",
         "datasets:train:num_worker_per_gpu=1",
         *width, "train:total_iter=1", "logger:save_checkpoint_freq=1",
         f"path:experiments_root={tmp_path / 'exp'}"],
        check=True, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True)
    log = next((tmp_path / "exp").glob("train_*.log")).read_text()
    assert "net_g_100000.pth" in log
    saved = torch.load(tmp_path / "exp" / "models" / "net_g_1.pth",
                       weights_only=True)
    # one step from the loaded weights: the EMA (0.999) stays within a
    # thousandth of a step of the loaded params_ema, not of the seed's
    for k, v in saved["params_ema"].items():
        if v.is_floating_point() and v.numel():
            assert (v - sd[k]).abs().max() < 2e-3 * (1 + sd[k].abs().max()), k
