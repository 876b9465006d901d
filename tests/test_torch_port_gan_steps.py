"""The port's SRGANModel (the GAN stage, S2) against the JAX package's,
on CPU; the nets and the losses are in `test_torch_port_gan.py`.

- `SRGANModel`: 4 iterations (L1 pixel + VGG19 perceptual and style +
  vanilla GAN, two Adams, EMA 0.999, MultiStepLR with a milestone inside
  the run) from the same G, D, u and batches as JAX's: every logged value
  of every iteration, every u after every iteration, and the final G, EMA
  and D weights within 2e-3 relative (the bar of `test_sr_model_steps_
  match_jax`); the channel scans' `conv_cout.bias`, whose exact gradient
  is 0, moves at most the sum of the learning rates on each side (Adam's
  steps on rounding noise). The perceptual criterion is l2: l1's gradient
  sign(f_out - f_gt) flips where a VGG feature of the two nearly ties
  (at conv5_4, 3e-6 against -1.2e-7 between the frameworks on one entry
  of 4096), which moves G's gradient by about 2 / sqrt(4096) there; l1
  is held by `test_torch_port_perceptual.py`'s loss and gradient tests;
- the gate (`net_d_init_iters`, `net_d_iters`), save and resume (the
  same bits), and `train_torch.py` with the GAN YAML on the CPU (in a
  process of one thread: many threads of tiny ops only wait on each
  other).

Tiny nets, as `tests/test_gan_training.py` builds them: OSSNet dim 8,
D num_feat 8, 8x8 LQ / 32x32 GT (VGG19 reaches conv5_4 at 2x2). Apart
from `test_torch_port_gan.py` so that the scheduler (`--dist loadfile`)
starts this heavy file on a worker of its own.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_port_gan import (LAYER_WEIGHTS, ROOT, TINY_D, TINY_G, _np,
                                 _rel, _u_of)

from vmambair_tpu.train import build_model as jax_build_model
from vmambair_torch.models import build_network
from vmambair_torch.train import build_model
from vmambair_torch.utils.convert import jax_disc_to_torch, jax_to_torch

torch.set_num_threads(1)


def _gan_opt(tmp_path, **train):
    t = {"total_iter": 10, "ema_decay": 0.999,
         "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0,
                     "betas": [0.9, 0.99]},
         "optim_d": {"type": "Adam", "lr": 2e-4, "weight_decay": 0,
                     "betas": [0.9, 0.99]},
         "scheduler": {"type": "MultiStepLR", "milestones": [3],
                       "gamma": 0.5},
         "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                       "reduction": "mean"},
         "perceptual_opt": {"type": "PerceptualLoss",
                            "layer_weights": dict(LAYER_WEIGHTS),
                            "vgg_type": "vgg19", "use_input_norm": True,
                            "perceptual_weight": 1.0, "style_weight": 1.0,
                            "range_norm": False, "criterion": "l2"},
         "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                     "real_label_val": 1.0, "fake_label_val": 0.0,
                     "loss_weight": 0.1},
         "net_d_iters": 1, "net_d_init_iters": 0}
    t.update(train)
    return {"name": "t_gan", "model_type": "MambaSISRGANModel",
            "is_train": True, "scale": 4, "num_gpu": 1, "manual_seed": 0,
            "network_g": dict(TINY_G, scan_impl="xla"),
            "network_d": dict(TINY_D),
            "path": {"models": str(tmp_path),
                     "training_states": str(tmp_path)},
            "train": t, "val": {"window_size": 8}}


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"lq": rng.rand(2, 8, 8, 3).astype(np.float32),
             "gt": rng.rand(2, 32, 32, 3).astype(np.float32)}
            for _ in range(n)]


def _u_dict(net_d):
    return {n: m.weight_u.clone() for n, m in net_d.named_modules()
            if hasattr(m, "weight_u")}


@pytest.fixture(scope="module")
def gan_runs(tmp_path_factory):
    """4 iterations of JAX's SRGANModel and of the port's from the same G,
    D, u and batches; logs and u after each, the final weights."""
    opt = _gan_opt(tmp_path_factory.mktemp("gan"))
    jm = jax_build_model(opt)
    m = build_model(opt, device="cpu")
    g0 = jax_to_torch(_np(jm.params["params"]))
    m.net_g.load_state_dict(g0)
    m.net_g_ema.load_state_dict(g0)
    m.net_d.load_state_dict(jax_disc_to_torch(
        _np(jm.params_d), _np(jm.state_d["batch_stats"])))
    d0 = {k: v.clone() for k, v in m.net_d.state_dict().items()}
    runs = {"logs": [], "u": [], "lr_sum": 0.0}
    for it, batch in enumerate(_batches(4), 1):
        jm.feed_data(batch)
        jm.optimize_parameters(it)
        m.feed_data(batch)
        m.optimize_parameters(it)
        runs["logs"].append((jm.get_current_log(), m.get_current_log()))
        runs["u"].append((_u_of(_np(jm.state_d["batch_stats"])),
                          _u_dict(m.net_d)))
        runs["lr_sum"] += m.log_dict["lr"]
    runs.update(jm=jm, m=m, g0=g0, d0=d0)
    return runs


def test_gan_logs_match_jax(gan_runs):
    keys = {"l_g_pix", "l_g_percep", "l_g_style", "l_g_gan", "l_d_real",
            "l_d_fake", "out_d_real", "out_d_fake", "lr"}
    for it, (lj, lt) in enumerate(gan_runs["logs"], 1):
        assert set(lj) == set(lt) == keys, (it, lj.keys(), lt.keys())
        for k in keys:
            assert abs(lt[k] - lj[k]) <= 2e-3 * abs(lj[k]), (it, k, lt[k],
                                                             lj[k])
    assert [lt["lr"] for _, lt in gan_runs["logs"]] == [1e-4, 1e-4, 5e-5,
                                                        5e-5]


def test_gan_spectral_norm_u_matches_jax_every_iteration(gan_runs):
    for it, (uj, ut) in enumerate(gan_runs["u"], 1):
        assert set(uj) == set(ut) and len(ut) == 8
        for k, v in ut.items():
            assert _rel(v, uj[k]) <= 2e-3, (it, k, _rel(v, uj[k]))
    first = gan_runs["u"][0][1]
    last = gan_runs["u"][-1][1]
    assert all(not torch.equal(first[k], last[k]) for k in first)


def test_gan_final_weights_match_jax(gan_runs):
    jm, m = gan_runs["jm"], gan_runs["m"]
    for name, tree, net in (("params", jm.params, m.net_g),
                            ("ema", jm.params_ema, m.net_g_ema)):
        ref = jax_to_torch(_np(tree["params"]))
        for k, v in net.state_dict().items():
            if k.endswith("conv_cout.bias"):
                # each side's own Adam steps on rounding noise, at most
                # the learning rate each
                for w in (v, ref[k]):
                    assert (w - gan_runs["g0"][k]).abs().max() <= (
                        gan_runs["lr_sum"] * (1 + 1e-5)), k
                continue
            assert _rel(v, ref[k]) <= 2e-3, (name, k, _rel(v, ref[k]))
        assert any(_rel(v, gan_runs["g0"][k]) > 1e-5
                   for k, v in net.state_dict().items()), name
    ref_d = jax_disc_to_torch(_np(jm.params_d),
                              _np(jm.state_d["batch_stats"]))
    for k, v in m.net_d.state_dict().items():
        if k.endswith("weight_v"):
            continue  # JAX keeps no v
        assert _rel(v, ref_d[k]) <= 2e-3, (k, _rel(v, ref_d[k]))
    assert all(_rel(v.detach(), gan_runs["d0"][k]) > 1e-4
               for k, v in m.net_d.named_parameters())


def test_gan_keeps_vgg_frozen_and_out_of_the_optimizers(gan_runs):
    m = gan_runs["m"]
    vgg = m.cri_perceptual
    assert not list(vgg.parameters()) and len(list(vgg.buffers())) == 32
    assert all(not b.requires_grad and b.grad is None for b in vgg.buffers())
    in_opt = {id(p) for o in (m.optimizer, m.optimizer_d)
              for g in o.param_groups for p in g["params"]}
    assert in_opt == {id(p) for p in m.net_g.parameters()} | {
        id(p) for p in m.net_d.parameters()}


def test_gan_g_step_leaves_no_gradient_in_d(tmp_path):
    """After the G step D's parameters hold no gradient (frozen for it),
    and they are trainable again for the D step."""
    m = build_model(_gan_opt(tmp_path), device="cpu")
    m.feed_data(_batches(1)[0])
    m._g_step(1e-4)
    assert all(p.grad is None and p.requires_grad
               for p in m.net_d.parameters())
    assert all(p.grad is not None for p in m.net_g.parameters())


def test_gan_gate_skips_the_g_step(tmp_path):
    """net_d_init_iters 2, net_d_iters 2: iterations 1 and 2 log no G key
    and leave G and its EMA as they were; D and every u move. Iteration 4
    takes the G step."""
    opt = _gan_opt(tmp_path, net_d_init_iters=2, net_d_iters=2)
    m = build_model(opt, device="cpu")
    g0 = {k: v.clone() for k, v in m.net_g.state_dict().items()}
    d0 = {k: v.clone() for k, v in m.net_d.state_dict().items()}
    batches = _batches(4, seed=1)
    for it in (1, 2):
        m.feed_data(batches[it - 1])
        m.optimize_parameters(it)
        log = m.get_current_log()
        assert set(log) == {"l_d_real", "l_d_fake", "out_d_real",
                            "out_d_fake", "lr"}, (it, log)
    for net in (m.net_g, m.net_g_ema):
        assert all(torch.equal(v, g0[k]) for k, v in net.state_dict().items())
    assert all(not torch.equal(v, d0[k])
               for k, v in m.net_d.state_dict().items()
               if k.endswith(("weight_orig", "weight_u")))
    m.feed_data(batches[2])
    m.optimize_parameters(3)
    assert "l_g_pix" not in m.get_current_log()
    m.feed_data(batches[3])
    m.optimize_parameters(4)
    assert {"l_g_pix", "l_g_percep", "l_g_gan"} <= set(m.get_current_log())


def test_gan_save_resume_takes_the_same_iteration(tmp_path):
    """save, then a new model (another seed) resumes from the state: one
    more iteration on each gives the same bits in G, EMA, D (its u, v and
    sigma too) and the log."""
    opt = _gan_opt(tmp_path)
    b1, b2 = _batches(2, seed=3)
    m = build_model(opt, device="cpu")
    m.feed_data(b1)
    m.optimize_parameters(1)
    m.save(epoch=0, current_iter=1)
    for name in ("net_g_1.pth", "net_d_1.pth", "1.state"):
        assert (tmp_path / name).exists(), name
    opt2 = dict(opt, manual_seed=5)
    opt2["path"] = dict(opt["path"],
                        pretrain_network_d=str(tmp_path / "net_d_1.pth"))
    m2 = build_model(opt2, device="cpu")
    m2.load_net_g(str(tmp_path / "net_g_1.pth"))
    assert m2.resume_training(str(tmp_path / "1.state")) == {
        "iter": 1, "epoch": 0}
    logs = []
    for mm in (m, m2):
        mm.feed_data(b2)
        mm.optimize_parameters(2)
        logs.append(mm.get_current_log())
    assert logs[0] == logs[1]
    for a, b in ((m.net_g, m2.net_g), (m.net_g_ema, m2.net_g_ema),
                 (m.net_d, m2.net_d)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


def test_train_torch_runs_the_gan_yaml_on_cpu(tmp_path):
    """`train_torch.py -opt options/MambaSISR15GAN_x4.yml --device cpu`
    with tiny overrides: MambaSISRGANModel from a `params_ema` checkpoint,
    3 iterations, validation, net_g / net_d / state written; then
    auto-resume takes iteration 4."""
    import yaml

    from vmambair_torch.train.checkpoint import save_network
    from vmambair_torch.utils.img_util import imwrite

    rng = np.random.RandomState(0)
    for split, n in (("train", 2), ("val", 1)):
        for i in range(n):
            gt = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
            lq = gt.reshape(8, 4, 8, 4, 3).mean((1, 3)).round().astype(
                np.uint8)
            imwrite(gt, str(tmp_path / split / "gt" / f"{i}.png"))
            imwrite(lq, str(tmp_path / split / "lq" / f"{i}.png"))
    g = build_network(dict(TINY_G, type="MambaSISR6"), device="cpu", seed=9)
    ckpt = str(tmp_path / "s1.pth")
    save_network(ckpt, g.state_dict(), g.state_dict())
    with open(os.path.join(ROOT, "options", "MambaSISR15GAN_x4.yml")) as f:
        assert yaml.safe_load(f)["model_type"] == "MambaSISRGANModel"
    val = {"name": "val", "type": "PairedImageDataset",
           "dataroot_gt": str(tmp_path / "val" / "gt"),
           "dataroot_lq": str(tmp_path / "val" / "lq"),
           "io_backend": {"type": "disk"}}
    common = [
        f"datasets:train:dataroot_gt={tmp_path / 'train' / 'gt'}",
        f"datasets:train:dataroot_lq={tmp_path / 'train' / 'lq'}",
        "datasets:train:gt_size=32", "datasets:train:batch_size_per_gpu=2",
        "datasets:train:num_worker_per_gpu=1",
        "datasets:train:dataset_enlarge_ratio=1",
        f"datasets:val_1={val!r}",
        "network_g:dim=8", "network_g:num_blocks=[1,1,1,1]",
        "network_g:num_refinement_blocks=1", "network_d:num_feat=8",
        f"path:pretrain_network_g={ckpt}",
        f"path:experiments_root={tmp_path / 'exp'}",
        "logger:print_freq=1", "logger:use_tb_logger=False"]

    def run(*force):
        subprocess.run(
            [sys.executable, os.path.join(ROOT, "train_torch.py"), "-opt",
             os.path.join(ROOT, "options", "MambaSISR15GAN_x4.yml"),
             "--device", "cpu", *force[1:], "--force_yml", *common,
             *force[0]],
            check=True, cwd=str(tmp_path), capture_output=True,
            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))

    run(["train:total_iter=3", "val:val_freq=3",
         "logger:save_checkpoint_freq=3"])
    exp = tmp_path / "exp"
    assert sorted(os.listdir(exp / "models")) == ["net_d_3.pth",
                                                  "net_g_3.pth"]
    assert (exp / "training_states" / "3.state").exists()
    log = next(exp.glob("train_*.log")).read_text()
    assert "Model [SRGANModel] is created." in log
    assert "l_g_percep:" in log and "l_d_fake:" in log
    assert log.count("# psnr:") == 3  # before iter 1, at 3, at the end
    run(["train:total_iter=4", "val:val_freq=0",
         "logger:save_checkpoint_freq=4"], "--auto_resume")
    log = sorted(exp.glob("train_*.log"))[-1].read_text()
    assert "Resuming training from epoch" in log and ", iter 3." in log
    assert f"pretrain_network_g: {exp / 'models' / 'net_g_3.pth'}" in log
    assert (exp / "models" / "net_d_4.pth").exists()
