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
           "'vmambair_tpu', 'tools'):\n"
           "    sys.modules[m] = None\n")


def test_imports_with_jax_and_cv2_blocked():
    """The port, its entry points and chip_smoke import nothing of JAX,
    flax, the JAX package (vmambair_tpu) or its probes (the root `tools`
    package), and neither cv2 nor yaml: every module of the package,
    `vmambair_torch.tools.*` included, is imported with those blocked."""
    pkg = os.path.join(ROOT, "vmambair_torch")
    mods = sorted(
        os.path.relpath(os.path.join(d, f), ROOT)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for d, _, files in os.walk(pkg) for f in files if f.endswith(".py"))
    assert {"vmambair_torch.data.loader", "vmambair_torch.train.pipeline",
            "vmambair_torch.utils.img_util", "vmambair_torch.metrics",
            "vmambair_torch.utils.options", "vmambair_torch.tools.kseq",
            "vmambair_torch.tools.kvariants",
            "vmambair_torch.tools.kpeak", "vmambair_torch.tools.keffn",
            "vmambair_torch.tools.kprobe", "vmambair_torch.tools.kldio",
            "vmambair_torch.tools.kdualnum",
            "vmambair_torch.tools.ab", "vmambair_torch.ops.degradation",
            "vmambair_torch.data.degradations",
            "vmambair_torch.data.realesrgan_dataset",
            "vmambair_torch.train.realesrgan_model",
            "vmambair_torch.metrics.lpips", "vmambair_torch.metrics.dists",
            "vmambair_torch.metrics.niqe", "vmambair_torch.metrics.inception",
            "vmambair_torch.metrics.fid",
            "vmambair_torch.utils.matlab", "vmambair_torch.parallel",
            "vmambair_torch.parallel.mesh", "vmambair_torch.parallel.sp_scan",
            "vmambair_torch.utils.profiling", "vmambair_torch.cli",
            "vmambair_torch.train.__main__"} <= set(mods)
    code = BLOCKED + "".join(f"import {m}\n" for m in mods) + (
        "import chip_smoke, inference_torch, train_torch, test_torch\n"
        "assert not any(k.startswith(('jax', 'flax', 'vmambair_tpu'))\n"
        "               and sys.modules[k] for k in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_ab_runs_the_trees_in_turns(monkeypatch, capsys, tmp_path):
    """`tools.ab` runs each tree's process in its own checkout (other,
    this, this, other per round) and reports each tree's medians."""
    from vmambair_torch.tools import ab
    ran = []

    def fake_run(cmd, cwd, env, **kw):
        assert cmd[1:] == [ab.__file__, "--child"]
        assert env["PYTHONPATH"] == cwd
        ran.append(cwd)
        ms = 1.0 if cwd == str(tmp_path) else 2.0
        row = dict(k2_ms=ms * len(ran), serve_ms=ms, serve_each=[ms])
        return subprocess.CompletedProcess(cmd, 0, json.dumps(row) + "\n", "")

    monkeypatch.setattr(ab.subprocess, "run", fake_run)
    ab.main(["--other", str(tmp_path), "--rounds", "2"])
    other = str(tmp_path)
    assert ran == [other, ROOT, ROOT, other] * 2
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["tree"] for r in lines[:-1]] == ["other", "this", "this",
                                               "other"] * 2
    assert lines[-1] == {"other": {"k2_ms": 4.5, "serve_ms": 1.0},
                         "this": {"k2_ms": 9.0, "serve_ms": 2.0}}


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
    """One compile per source for sm_90a (started together by the build),
    then one link of their objects into the shared library."""
    compiles, link = _build.nvcc_commands("/x/nvcc", "/tmp/b", "/tmp/lib.so")
    for cmd in compiles:
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-fPIC", "-c"):
            assert flag in cmd
    srcs = [s for cmd in compiles for s in cmd if s.endswith(".cu")]
    assert {os.path.basename(s) for s in srcs} == {
        "gdfn.cu", "oss_front.cu", "oss_scan_fused.cu", "oss_tail.cu",
        "selective_scan.cu", "selective_scan_bwd.cu", "scan_seq.cu",
        "scan_lpar.cu", "scan_stack_bf16.cu", "scan_dual.cu", "peak.cu",
        "probe_io.cu"}
    objs = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert link[link.index("-o") + 1] == "/tmp/lib.so" and "-shared" in link
    assert link[-len(objs):] == objs


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(build_dir=str(tmp_path / "build"))


STUB_NVCC = """#!/bin/sh
# writes its -o target; fails for a source named in $STUB_NVCC_FAIL
out=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  case "$a" in *"$STUB_NVCC_FAIL") [ -n "$STUB_NVCC_FAIL" ] && exit 1;; esac
  prev="$a"
done
sleep 0.2
echo "$@" > "$out"
"""


def _stub_nvcc(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))


@pytest.mark.parametrize("fail", ["", "peak.cu"])
def test_build_keeps_each_build_apart(monkeypatch, tmp_path, fail):
    """Two builds of one hash at once each compile and link in a directory
    of their own and move only the finished library in place: the hash
    directory ends up with the library and the log and no stray object.
    A failed compile raises, names the source and leaves no library."""
    import concurrent.futures

    _stub_nvcc(monkeypatch, tmp_path)
    monkeypatch.setenv("STUB_NVCC_FAIL", fail)
    root = str(tmp_path / "build")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(_build.build, root) for _ in range(2)]
    out_dir = os.path.join(root, _build.source_hash())
    if fail:
        for f in futs:
            with pytest.raises(RuntimeError, match="(?s)nvcc failed.*peak.cu"):
                f.result()
        assert os.listdir(out_dir) == ["build.log"]
        return
    libs = {f.result() for f in futs}
    assert libs == {os.path.join(out_dir, _build.LIB_NAME)}
    assert sorted(os.listdir(out_dir)) == ["build.log", _build.LIB_NAME]
    with open(libs.pop()) as f:
        link = f.read().split()
    assert "-shared" in link and len(
        [a for a in link if a.endswith(".o")]) == len(_build.sources())


def test_source_hash_follows_sources(monkeypatch, tmp_path):
    h = _build.source_hash()
    assert h == _build.source_hash()
    (tmp_path / "k.cu").write_text("// one kernel\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert _build.source_hash() != h


def _c_arg_type(decl: str):
    """The ctypes type a C parameter declaration passes as."""
    if "*" in decl:
        return _build._P
    if "long long" in decl:
        return _build._LL
    if decl.split()[0] == "float":
        return _build._F
    assert decl.split()[0] == "int", decl
    return _build._I


def test_signatures_match_the_exported_c_functions():
    """Every `extern "C"` function of csrc/ has a ctypes signature in
    `_build.SIGNATURES` with its parameters' kinds in its order (pointer,
    int, long long, float), and every signature names such a function: a
    mismatch would pass a truncated pointer or shift every later
    argument, and nothing here compiles the sources to catch it."""
    import re

    exported = {}
    for src in _build.sources():
        with open(src) as f:
            text = f.read()
        for name, params in re.findall(
                r'extern "C" int (\w+)\((.*?)\)\s*\{', text, re.S):
            exported[name] = [_c_arg_type(" ".join(p.split()))
                              for p in params.split(",")]
    assert set(exported) == set(_build.SIGNATURES)
    for name, kinds in exported.items():
        assert kinds == _build.SIGNATURES[name], name


def test_probe_wrappers_pass_their_signatures(monkeypatch):
    """Each probe wrapper's launch path (the view-addressed scans, keffn's
    GDFN, kprobe's two, kldio's fused scan), driven here with the CPU routing and the launch
    stubbed: it names an exported function and passes exactly its
    signature's arguments (a pointer as an int or None, an int or long
    long as an int, a float as a float), the stream added by `launch`."""
    from vmambair_torch.ops import cuda_effn, cuda_probes

    calls = []
    monkeypatch.setattr(cuda_probes, "on_cpu", lambda *ts: False)
    # keffn's fp32 split asks the card's cluster residency: none here
    monkeypatch.setattr(cuda_effn, "_resident", lambda *a: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *a: calls.append((name, a)))
    u = torch.zeros(1, 2, 40, 4)
    bc = torch.zeros(1, 2, 40, 16)
    args = (u, u, torch.zeros(8, 16), bc, bc, torch.ones(8), torch.zeros(8),
            u.clone())
    cuda_probes.scan_seq(*args, win=8)
    cuda_probes.scan_lpar(*args, seg=16)
    cuda_probes.scan_combined(*args, u.clone(), chunk=16)
    cuda_probes.scan_stack_ab(*args, chunk=16)
    cuda_probes.scan_stack_b(*args, chunk=32, sub=8)
    cuda_probes.scan_stack_ab(*args, chunk=16, last_bf16=True)
    u = torch.zeros(1, 2, 256, 4)
    bc = torch.zeros(1, 2, 256, 16)
    dual = (u, u, torch.zeros(8, 16), bc, bc, torch.ones(8), torch.zeros(8),
            u.clone())
    cuda_probes.scan_dual(*dual, form="v22", sub=128, blk=32,
                          zdt=torch.bfloat16)
    cuda_probes.scan_dual(*dual, form="v24", sub=256, blk=64, mid=True)
    cuda_probes.scan_dual(*dual, form="v26", sub=128, blk=64, reverse=True)
    cuda_probes.scan_cumsum(*dual, sub=128)
    x = torch.zeros(1, 5, 7, 8)
    cuda_probes.gdfn_tanh_nhwc(x, torch.ones(8), torch.zeros(8),
                               torch.zeros(8, 42), torch.zeros(3, 3, 42),
                               torch.zeros(21, 8))
    u = torch.zeros(2, 70, 96)
    cuda_probes.probe_transpose(u)
    cuda_probes.probe_proj(u, torch.zeros(38, 96), torch.zeros(96, 6))
    cuda_probes.ld_fused(torch.zeros(1, 2, 40, 16), torch.zeros(2, 34, 16),
                         torch.zeros(2, 16, 2), torch.zeros(2, 16),
                         torch.zeros(2, 16, 16), torch.zeros(2, 16))
    assert [c[0] for c in calls] == [
        "vmt_scan_seq_fwd", "vmt_scan_lpar_fwd", "vmt_scan_combined_fwd",
        "vmt_scan_stack_fwd", "vmt_scan_stack_fwd", "vmt_scan_stack_fwd",
        "vmt_scan_dual_fwd", "vmt_scan_dual_fwd", "vmt_scan_dual_fwd",
        "vmt_scan_dual_fwd",
        "vmt_gdfn_f32_pack", "vmt_gdfn_tanh_nhwc_f32_fwd",
        "vmt_probe_transpose",
        "vmt_probe_proj",
        "vmt_oss_scan_fused_ld_fwd"]
    for name, a in calls:
        kinds = _build.SIGNATURES[name][:-1]  # the stream: added by launch
        assert len(a) == len(kinds), name
        for k, v in zip(kinds, a):
            assert (isinstance(v, int) and k is not _build._F) or (
                k is _build._P and v is None) or (
                k is _build._F and isinstance(v, float)), name


@pytest.mark.parametrize("path", ["vmambair_torch/ops/cuda_scan.py",
                                  "vmambair_torch/ops/cuda_probes.py",
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
