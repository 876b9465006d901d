"""Data-parallel training of the port at world 2 against world 1, and
its entry points, on the CPU (gloo processes; no JAX here).

- The GAN step (`SRGANModel`: L1 + GAN, D's spectral norms) and the
  RealESRNet step (the synthesis and the queue on the gathered global
  batch), 2 steps at world 2 against the port at world 1 on the same
  global batches, within fp32 reassociation: the logged losses within
  1e-5 relative, each step's gradients (G's and D's, DDP's mean against
  world 1's) within 1e-4 of their tensor's largest entry (sums over the
  two halves of the batch in another order: up to 3.9e-5 measured on the
  CPU), the weights after the two Adam steps within 1e-3 (Adam divides
  each element's step by its own gradient's scale, so a small gradient's
  rounding becomes a step's: up to 1.3e-4 measured); the ranks bit-equal.
  conv_cout.bias (an exact gradient of 0) is held to the sum of the
  learning rates.
- `train_torch.py --launcher pytorch --device cpu` under `python -m
  torch.distributed.run --standalone --nproc_per_node 2` for 2 iterations:
  one checkpoint, by rank 0, without a `module.` prefix.
- `inference_torch.py --sp --device cpu` under the same launcher at
  world 2 against the normal path; `--sp` without torchrun's environment
  raises.
- `num_gpu` against the world size, and a launcher without its
  environment: both raise.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from torch_dist_cases import (TINY_D, num_gpu_case, rel, run_world, sr_opt,
                              tiny_train_opt, train_steps_case)
from vmambair_torch.parallel import init_distributed
from vmambair_torch.utils import options
from vmambair_torch.utils.img_util import imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _sr_batches(rng):
    return [{"lq": rng.rand(4, 8, 8, 3).astype(np.float32),
             "gt": rng.rand(4, 32, 32, 3).astype(np.float32)}
            for _ in range(2)]


def _gan_opt(tmp_path):
    opt = sr_opt(tmp_path)
    opt["train"].pop("mixup")
    opt["train"].update(
        optim_d={"type": "Adam", "lr": 2e-4, "weight_decay": 0,
                 "betas": [0.9, 0.99]},
        gan_opt={"type": "GANLoss", "gan_type": "vanilla",
                 "real_label_val": 1.0, "fake_label_val": 0.0,
                 "loss_weight": 0.1},
        net_d_iters=1, net_d_init_iters=0)
    return dict(opt, model_type="MambaSISRGANModel",
                network_d=dict(TINY_D))


def _realesrnet_opt(tmp_path):
    from realsr_cases import SYNTH

    opt = sr_opt(tmp_path)
    opt["train"].pop("mixup")
    return dict(opt, **SYNTH, model_type="MambaRealSR", gt_size=32,
                queue_size=8, l1_gt_usm=True)


def _realsr_batches(rng):
    from realsr_cases import kernels

    out = []
    for i in range(2):
        k1, k2, sinc = kernels(4, seed=i)
        out.append({"gt": rng.rand(4, 64, 64, 3).astype(np.float32),
                    "kernel1": k1, "kernel2": k2, "sinc_kernel": sinc})
    return out


@pytest.mark.parametrize("kind", ["gan", "realesrnet"])
def test_steps_at_world_2_equal_world_1(tmp_path, kind):
    if kind == "gan":
        opt, batches, keys = (_gan_opt(tmp_path),
                              _sr_batches(np.random.RandomState(8)),
                              ("lq", "gt"))
    else:
        opt, batches, keys = (_realesrnet_opt(tmp_path),
                              _realsr_batches(np.random.RandomState(9)),
                              ("gt", "kernel1", "kernel2", "sinc_kernel"))
    one = train_steps_case(0, 1, opt, {}, batches, keys=keys)
    assert one["ddp"] != "DistributedDataParallel"
    two = run_world(functools.partial(train_steps_case, keys=keys), 2,
                    tmp_path, opt, {}, batches)
    assert two[0]["ddp"] == "DistributedDataParallel"
    for a, b in zip(two[0]["logs"], one["logs"]):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), k
    for got, ref in zip(two[0]["grads"], one["grads"]):
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            if not k.endswith("conv_cout.bias"):  # exactly 0: noise
                assert rel(got[k], v) <= 1e-4, (k, rel(got[k], v))
    lr_sum = sum(log["lr"] for log in one["logs"])
    for name, net in one["nets"].items():
        for k, v in net.items():
            got = two[0]["nets"][name][k]
            assert np.array_equal(got, two[1]["nets"][name][k]), (name, k)
            if k.endswith("conv_cout.bias"):
                assert np.abs(got - v).max() <= lr_sum, (name, k)
                continue
            assert rel(got, v) <= 1e-3, (name, k, rel(got, v))
    if kind == "gan":  # D's spectral norms' u agree with world 1
        us = [k for k in one["nets"]["net_d"] if k.endswith("weight_u")]
        assert us and all(rel(two[0]["nets"]["net_d"][k],
                               one["nets"]["net_d"][k]) <= 1e-3 for k in us)


def test_train_torch_under_torchrun_at_world_2(tmp_path):
    """Two ranks of `train_torch.py --launcher pytorch --device cpu`: each
    trains on its slice of the sampler (batch 2 per rank, `num_gpu:
    auto`); rank 0 alone writes the log and the checkpoint, whose keys
    carry no `module.` prefix."""
    exp = tmp_path / "exp"
    opt = tiny_train_opt(tmp_path / "data", exp, total_iter=2,
                         num_gpu="auto")
    yml = tmp_path / "ddp.yml"
    yml.write_text(yaml.safe_dump(opt))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", os.path.join(ROOT, "train_torch.py"),
         "-opt", str(yml), "--launcher", "pytorch", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert sorted(os.listdir(exp / "models")) == ["net_g_2.pth"]
    ckpt = torch.load(exp / "models" / "net_g_2.pth", map_location="cpu")
    assert not any(k.startswith("module.") for k in ckpt["params"])
    logs = [p for p in os.listdir(exp) if p.endswith(".log")]
    assert len(logs) == 1  # rank 0's
    log = (exp / logs[0]).read_text()
    assert "Data parallel over 2 ranks" in log
    assert log.count("l_pix: ") == 2


def test_num_gpu_against_the_world_size(tmp_path, monkeypatch):
    for res in run_world(num_gpu_case, 2, tmp_path):
        assert res["auto"] == res[None] == res[2] == 2
        assert "num_gpu 3 differs from the world size 2" in res[3]
        assert "num_gpu 1 differs" in res[1]
    assert options.resolve_num_gpu("auto") == 1
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="lacks RANK, WORLD_SIZE"):
        init_distributed("pytorch", "cpu")
    with pytest.raises(RuntimeError, match="lacks SLURM_PROCID"):
        init_distributed("slurm", "cpu")


def test_inference_sp_under_torchrun_at_world_2(tmp_path, monkeypatch):
    """`inference_torch.py --sp --device cpu` on two ranks: the spatial
    scans sharded over both, rank 0 writing the image; the output within
    one grey level of the normal path's (the sharded and the fused scans'
    fp32 rounding only)."""
    from vmambair_torch import inference
    from vmambair_torch.models import build_network
    from vmambair_torch.train.checkpoint import save_network
    from vmambair_torch.utils.img_util import imread

    tiny = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1}
    net = build_network(dict(tiny, type="OSSNet", scale=4), device="cpu",
                        seed=5)
    ckpt = str(tmp_path / "net.pth")
    save_network(ckpt, net.state_dict())
    img = (np.random.RandomState(6).rand(24, 16, 3) * 255).astype(np.uint8)
    imwrite(img, str(tmp_path / "in" / "a.png"))
    args = ["--model_path", ckpt, "--arch", "OSSNet", "--network_opt",
            json.dumps(tiny), "-i", str(tmp_path / "in"), "--scale", "4",
            "--device", "cpu"]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", os.path.join(ROOT, "inference_torch.py"),
         *args, "-o", str(tmp_path / "sp"), "--sp"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("Processing a") == 1  # rank 0 alone
    inference.main(args + ["-o", str(tmp_path / "plain")])
    sp = imread(str(tmp_path / "sp" / "a_out.png")).astype(int)
    plain = imread(str(tmp_path / "plain" / "a_out.png")).astype(int)
    assert sp.shape == (96, 64, 3)
    assert np.abs(sp - plain).max() <= 1
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="lacks RANK, WORLD_SIZE"):
        inference.main(args + ["-o", str(tmp_path / "x"), "--sp"])
