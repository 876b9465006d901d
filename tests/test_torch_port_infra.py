"""Infrastructure of the PyTorch port: imports without JAX or cv2, the
kernel build command and loader, the CPU/CUDA routing of the kernel
wrappers, the launch counts the dispatch predicts, and the inference CLI.
No JAX here."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vmambair_torch import _build
from vmambair_torch.models import build_network
from vmambair_torch.ops import cuda_effn, cuda_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(type="OSSNet", dim=8, num_blocks=[1, 1, 1, 1],
            num_refinement_blocks=1, scale=4)

torch.set_num_threads(1)


BLOCKED = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'cv2', 'yaml', "
           "'vmambair_tpu'):\n"
           "    sys.modules[m] = None\n")


def test_imports_with_jax_and_cv2_blocked():
    """The port, its entry points and chip_smoke import nothing of JAX,
    flax or the JAX package (vmambair_tpu), and neither cv2 nor yaml:
    every module of the package is imported with those blocked."""
    pkg = os.path.join(ROOT, "vmambair_torch")
    mods = sorted(
        os.path.relpath(os.path.join(d, f), ROOT)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for d, _, files in os.walk(pkg) for f in files if f.endswith(".py"))
    assert {"vmambair_torch.data.loader", "vmambair_torch.train.pipeline",
            "vmambair_torch.utils.img_util", "vmambair_torch.metrics",
            "vmambair_torch.utils.options"} <= set(mods)
    code = BLOCKED + "".join(f"import {m}\n" for m in mods) + (
        "import chip_smoke, inference_torch, train_torch, test_torch\n"
        "assert not any(k.startswith(('jax', 'flax', 'vmambair_tpu'))\n"
        "               and sys.modules[k] for k in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_inference_cli_on_cpu_without_cv2(tmp_path):
    """The inference CLI reads and writes PNG with the port's codec: it
    runs with cv2 (and JAX) blocked."""
    from vmambair_torch.utils.img_util import imread, imwrite

    net = build_network(TINY, device="cpu", seed=3)
    torch.save({"params": net.state_dict()}, tmp_path / "net.pth")
    imwrite((np.random.RandomState(0).rand(10, 6, 3) * 255).astype(
        np.uint8), str(tmp_path / "in" / "b.png"))
    opt = json.dumps({k: v for k, v in TINY.items()
                      if k not in ("type", "scale")})
    argv = ["--model_path", str(tmp_path / "net.pth"), "--arch", "OSSNet",
            "-i", str(tmp_path / "in"), "-o", str(tmp_path / "out"),
            "--network_opt", opt, "--device", "cpu"]
    code = BLOCKED + ("import torch; torch.set_num_threads(1)\n"
                      "from vmambair_torch import inference\n"
                      f"inference.main({argv!r})\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
    assert imread(str(tmp_path / "out" / "b_out.png")).shape == (40, 24, 3)


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command("/x/nvcc", "/tmp/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    srcs = [s for s in cmd if s.endswith(".cu")]
    assert {os.path.basename(s) for s in srcs} == {
        "gdfn.cu", "oss_front.cu", "oss_scan_fused.cu", "oss_tail.cu",
        "selective_scan.cu", "selective_scan_bwd.cu"}


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(build_dir=str(tmp_path / "build"))


def test_source_hash_follows_sources(monkeypatch, tmp_path):
    h = _build.source_hash()
    assert h == _build.source_hash()
    (tmp_path / "k.cu").write_text("// one kernel\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert _build.source_hash() != h


@pytest.mark.parametrize("path", ["vmambair_torch/ops/cuda_scan.py",
                                  "vmambair_torch/ops/cuda_effn.py",
                                  "vmambair_torch/_build.py",
                                  "vmambair_torch/models/unet.py",
                                  "vmambair_torch/models/oss.py",
                                  "vmambair_torch/train/sr_model.py"])
def test_cuda_wrappers_have_no_fallback_try(path):
    """A CUDA tensor goes to the kernel or raises: no try/except in the
    wrappers, their launch helper or the block that calls the GDFN can
    swallow a kernel failure and run the plain version."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_wrappers_refuse_mixed_and_other_devices():
    u2 = torch.zeros(1, 2, 8, 16, device="meta")
    w = [torch.zeros(s) for s in ((2, 5, 8), (2, 8, 1), (2, 8), (2, 8, 2),
                                  (2, 8))]
    with pytest.raises(ValueError, match="expected all on cpu"):
        cuda_scan.oss_scan_fused(u2, *w)
    with pytest.raises(ValueError, match="expected all on cpu"):
        cuda_effn.gdfn_residual_fused(
            torch.zeros(1, 4, 4, 4, device="meta"), torch.ones(4),
            torch.zeros(4), torch.zeros(2, 4), torch.zeros(2, 3, 3),
            torch.zeros(4, 1))


def test_wide_block_takes_the_fused_gdfn_route(monkeypatch):
    """A MamberBlock wider than the GDFN kernel takes (C > 384) still calls
    the fused wrapper, which raises for it on CUDA: the block has no width
    gate that would send it to the plain FFN."""
    from vmambair_torch.models import init_weights, layers, unet

    calls = []
    fused = layers.gdfn_residual_fused
    monkeypatch.setattr(layers, "gdfn_residual_fused",
                        lambda *a, **k: calls.append(a[0].shape) or fused(
                            *a, **k))
    c = cuda_effn.MAX_C + 8
    blk = unet.MamberBlock(c)
    init_weights(blk, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        y = blk(torch.rand(1, c, 4, 4))
    assert calls == [(1, c, 4, 4)] and torch.isfinite(y).all()


def test_cpu_calls_do_not_count_as_launches():
    """Neither a CPU forward nor a CPU training step (the plain versions
    inside the autograd Functions) counts a launch."""
    import chip_smoke

    before = chip_smoke.launches()
    net = build_network(TINY, device="cpu")
    with torch.inference_mode():
        net(torch.rand(1, 3, 8, 8))
    net(torch.rand(1, 3, 8, 8)).mean().backward()
    assert before == chip_smoke.launches()


@pytest.mark.parametrize("dim,blocks", [(8, [1, 1, 1, 1]), (40, [1, 1, 1, 1])])
def test_dispatch_matches_predicted_launches(monkeypatch, dim, blocks):
    """The routing of one forward, counted through spies on CPU, equals
    what chip_smoke.expected_launches predicts. dim 40 puts the latent at
    320 > 256 channels, so its spatial pairs take the plain-scan route."""
    import chip_smoke
    from vmambair_torch.models import oss, unet

    calls = {"oss_scan_fused": 0, "selective_scan": 0,
             "gdfn_residual_fused": 0}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(oss, "oss_scan_fused")
    spy(oss, "selective_scan")
    from vmambair_torch.models import layers
    spy(layers, "gdfn_residual_fused")
    cfg = dict(TINY, dim=dim, num_blocks=blocks)
    net = build_network(cfg, device="cpu")
    with torch.inference_mode():
        net(torch.rand(1, 3, 16, 16))
    want = chip_smoke.expected_launches(net)
    assert calls == {k: want[k] for k in calls}
    assert not any(v for k, v in want.items() if k not in calls)
    n_blocks = sum(isinstance(m, unet.MamberBlock) for m in net.modules())
    assert calls["gdfn_residual_fused"] == n_blocks == 8


def test_inference_cli_on_cpu(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from vmambair_torch import inference

    net = build_network(TINY, device="cpu", seed=3)
    torch.save({"params_ema": net.state_dict()}, tmp_path / "net.pth")
    rng = np.random.RandomState(0)
    os.makedirs(tmp_path / "in")
    cv2.imwrite(str(tmp_path / "in" / "a.png"),
                (rng.rand(12, 20, 3) * 255).astype(np.uint8))
    opt = json.dumps({k: v for k, v in TINY.items()
                      if k not in ("type", "scale")})
    for tile in ("0", "8"):
        out = tmp_path / f"out{tile}"
        inference.main([
            "--model_path", str(tmp_path / "net.pth"), "--arch", "OSSNet",
            "-i", str(tmp_path / "in"), "-o", str(out), "--scale", "4",
            "--tile", tile, "--network_opt", opt, "--device", "cpu"])
        img = cv2.imread(str(out / "a_out.png"))
        assert img.shape == (48, 80, 3)


def test_enhance_modes():
    from vmambair_torch.utils.upscaler import RestorationUpscaler

    ups = RestorationUpscaler(4, build_network(TINY, device="cpu"), "cpu",
                              tile=0, pre_pad=2)
    rng = np.random.RandomState(1)
    gray = (rng.rand(8, 8) * 255).astype(np.uint8)
    rgba = (rng.rand(8, 8, 4) * 65535).astype(np.uint16)
    out, mode = ups.enhance(gray)
    assert mode == "L" and out.shape == (32, 32) and out.dtype == np.uint8
    out, mode = ups.enhance(rgba)
    assert mode == "RGBA" and out.shape == (32, 32, 4)
    assert out.dtype == np.uint16
