"""The port's RealSR stages against the JAX package's, on CPU.

- `synthesize`, the two-order degradation, against JAX's jitted
  `make_synthesis_fn` on (2, 64, 64, 3) GT crops with seeded blur and
  sinc kernels, for several keys whose draws cover both noise kinds,
  both JPEG/sinc orders and the second blur on and off. The port is fed
  JAX's draws, rebuilt from the same key (`jax_draws`). The GT crops
  agree exactly and the USM crops within 1e-5. The LQ passes two rounds
  (JPEG's coefficients twice, then the uint8 grid), where a 1-ulp
  difference before the round moves a whole step. The rule: at most 2%
  of the LQ's elements differ from JAX's, and at most 0.5% by more than
  one uint8 step (1/255); the measured shares are printed;
- `RealESRGANDataset`: JAX's crops, flips, kernels and sinc kernels bit
  for bit for one seed, on images smaller than `crop_pad_size` (the
  reflect-101 pad), larger (the crop) and between;
- `_dequeue_and_enqueue`: JAX's batches, step by step, over three fills
  of the queue;
- one step of `RealESRNetModel` (L1 against the USM GT) and one
  iteration of `RealESRGANModel` (its G step: L1 against the USM GT,
  VGG19 perceptual against the plain GT, vanilla GAN through D with D's
  u kept; then its D step with the USM GT as real) against JAX's, from
  the same weights (MambaRealSR11 at dim 8, depth [1, 1, 1, 1] + 1, the
  direct channel scan, carried by `jax_to_torch`) and the same (lq, gt,
  gt_usm): the forward within 1e-5, the logged losses within 1e-4
  relative, every weight and u after the step within 2e-3 relative;
- the pipelines as `train_torch.py` / `test_torch.py` run them, with
  `options/mambaSR11_x4.yml`, then `options/mambaSR11GAN_x4.yml` from
  the first run's checkpoint, then `options/test_mambaSR11GAN_x4.yml`, on
  the CPU with tiny overrides (dim 8, gt_size 32, crop_pad_size 64);
- `chip_smoke.py`'s RealSR recipe dicts against the two YAMLs.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmambair_tpu.train.realesrgan_model as jrm
from vmambair_tpu.data.realesrgan_dataset import (
    RealESRGANDataset as JaxDataset,
)
from vmambair_tpu.train import build_model as jax_build_model
from vmambair_torch.data.realesrgan_dataset import RealESRGANDataset
from vmambair_torch.train import build_model
from vmambair_torch.train import realesrgan_model as trm
from vmambair_torch.utils.convert import jax_disc_to_torch, jax_to_torch
from vmambair_torch.utils.img_util import imwrite

from realsr_cases import SYNTH, JaxSampler, kernels, nchw, nhwc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

# keys whose draws cover Gaussian and Poisson noise in both steps, both
# orders of JPEG and sinc, the second blur on and off (asserted below)
SYNTH_KEYS = (0, 1, 2, 3, 5, 8)
TINY_G = {"type": "MambaRealSR11", "dim": 8, "num_blocks": [1, 1, 1, 1],
          "num_refinement_blocks": 1}
TINY_D = {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 8}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_noise(key, shape, opt, sfx, normals, pkeys):
    """JAX's `_noise_step` draws from `key`, as a `NoiseDraw`; its samples'
    keys and normals go into `normals` / `pkeys` under the port's tags."""
    b = shape[0]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    nr, pr = opt[f"noise_range{sfx}"], opt[f"poisson_scale_range{sfx}"]
    sigma = jax.random.uniform(k1, (b,), minval=nr[0], maxval=nr[1]) / 255.0
    pscale = jax.random.uniform(k2, (b,), minval=pr[0], maxval=pr[1])
    gray = jax.random.uniform(k3, (b,)) < opt[f"gray_noise_prob{sfx}"]
    gauss = bool(jax.random.uniform(k4) < opt[f"gaussian_noise_prob{sfx}"])
    tag = sfx or "1"
    ka, kb = jax.random.split(k1)
    normals[f"gauss{tag}"] = jax.random.normal(ka, shape)
    normals[f"gauss{tag}_gray"] = jax.random.normal(kb, shape[:3] + (1,))
    pkeys[f"poisson{tag}"], pkeys[f"poisson{tag}_gray"] = (
        jax.random.split(k2))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return trm.NoiseDraw(gauss, t(sigma), t(pscale), t(gray))


def jax_draws(rng, shape, opt, scale, gt_size):
    """The draws of JAX's `make_synthesis_fn` for key `rng`, rebuilt with
    its own splits and calls, as the port's `Draws` and a sampler."""
    b, h, w, _ = shape
    keys = jax.random.split(rng, 16)
    normals, pkeys = {}, {}
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    lq_h, lq_w, p = h // scale, w // scale, gt_size // scale
    d = trm.Draws(
        s1=float(jrm._draw_scale(keys[0], opt["resize_prob"],
                                 opt["resize_range"])),
        m1=int(jax.random.randint(keys[1], (), 0, 3)),
        noise1=_jax_noise(keys[2], shape, opt, "", normals, pkeys),
        q1=t(jax.random.uniform(keys[3], (b,), minval=opt["jpeg_range"][0],
                                maxval=opt["jpeg_range"][1])),
        blur2=bool(jax.random.uniform(keys[4]) < opt["second_blur_prob"]),
        s2=float(jrm._draw_scale(keys[5], opt["resize_prob2"],
                                 opt["resize_range2"])),
        m2=int(jax.random.randint(keys[6], (), 0, 3)),
        noise2=_jax_noise(keys[7], shape, opt, "2", normals, pkeys),
        q2=t(jax.random.uniform(keys[8], (b,),
                                minval=opt["jpeg_range2"][0],
                                maxval=opt["jpeg_range2"][1])),
        m3=int(jax.random.randint(keys[9], (), 0, 3)),
        sinc_first=bool(jax.random.uniform(keys[10]) < 0.5),
        top=int(jax.random.randint(keys[11], (), 0, lq_h - p + 1)),
        left=int(jax.random.randint(keys[12], (), 0, lq_w - p + 1)))
    return d, JaxSampler(normals, pkeys)


@pytest.fixture(scope="module")
def synth_runs():
    """JAX's synthesis and the port's from JAX's draws, per key."""
    scale, gt_size = 4, 32
    jsynth = jrm.make_synthesis_fn(SYNTH, scale, gt_size)
    gt = np.random.RandomState(11).rand(2, 64, 64, 3).astype(np.float32)
    kern = kernels(2, 12)
    runs = []
    for seed in SYNTH_KEYS:
        key = jax.random.PRNGKey(seed)
        ref = [np.asarray(a) for a in jsynth(key, jnp.asarray(gt),
                                             *map(jnp.asarray, kern))]
        d, sampler = jax_draws(key, gt.shape, SYNTH, scale, gt_size)
        got = trm.synthesize(nchw(gt), *map(torch.from_numpy, kern), d,
                             sampler, scale, gt_size)
        runs.append((d, ref, [nhwc(g) for g in got]))
    return runs


def test_synthesis_draws_cover_every_branch(synth_runs):
    ds = [d for d, _, _ in synth_runs]
    assert {d.noise1.gaussian for d in ds} == {True, False}
    assert {d.noise2.gaussian for d in ds} == {True, False}
    assert {d.sinc_first for d in ds} == {True, False}
    assert {d.blur2 for d in ds} == {True, False}
    assert {d.m1 for d in ds} | {d.m2 for d in ds} == {0, 1, 2}
    assert min(d.s1 for d in ds) < 1 < max(d.s1 for d in ds)


def test_synthesis_matches_jax(synth_runs):
    off_all = far_all = n = 0
    for d, (gt_j, usm_j, lq_j), (gt_t, usm_t, lq_t) in synth_runs:
        assert gt_t.shape == gt_j.shape == (2, 32, 32, 3)
        assert lq_t.shape == lq_j.shape == (2, 8, 8, 3)
        assert np.array_equal(gt_t, gt_j)
        assert np.abs(usm_t - usm_j).max() <= 1e-5
        assert np.array_equal(np.round(lq_t * 255), lq_t * 255) or \
            np.abs(np.round(lq_t * 255) - lq_t * 255).max() < 1e-3
        diff = np.abs(lq_t - lq_j)
        off, far = int((diff > 1e-6).sum()), int((diff > 1.5 / 255).sum())
        print(f"synthesis {d.noise1.gaussian} {d.noise2.gaussian} "
              f"{d.sinc_first} {d.blur2}: {off} of {diff.size} LQ elements "
              f"differ, {far} by more than one step")
        off_all, far_all, n = off_all + off, far_all + far, n + diff.size
    print(f"synthesis: {off_all / n:.4f} of the LQ elements differ, "
          f"{far_all / n:.4f} by more than one uint8 step")
    assert off_all <= 0.02 * n and far_all <= 0.005 * n


def test_synthesis_object_draws_and_applies():
    """`Synthesis` on the CPU: its own draws (host and device generators
    from the seed) give LQ on the uint8 grid and the GT crops of its
    crop; two of the same seed give the same bits."""
    gt = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    kern = [torch.from_numpy(k) for k in kernels(2, 3)]
    outs = [trm.Synthesis(SYNTH, 4, 32, 5, "cpu")(gt, *kern)
            for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    gt_c, usm_c, lq = outs[0]
    assert gt_c.shape == usm_c.shape == (2, 3, 32, 32)
    assert lq.shape == (2, 3, 8, 8)
    assert torch.equal(torch.round(lq * 255) / 255, lq)


# ---------------------------------------------------------------- dataset

DATA_OPT = dict(
    io_backend={"type": "disk"}, crop_pad_size=64, use_hflip=True,
    use_rot=True, blur_kernel_size=21,
    kernel_list=["iso", "aniso", "generalized_iso", "generalized_aniso",
                 "plateau_iso", "plateau_aniso"],
    kernel_prob=[0.45, 0.25, 0.12, 0.03, 0.12, 0.03], sinc_prob=0.3,
    blur_sigma=[0.2, 3], betag_range=[0.5, 4], betap_range=[1, 2],
    blur_kernel_size2=21,
    kernel_list2=["iso", "aniso", "generalized_iso", "generalized_aniso",
                  "plateau_iso", "plateau_aniso"],
    kernel_prob2=[0.45, 0.25, 0.12, 0.03, 0.12, 0.03], sinc_prob2=0.3,
    blur_sigma2=[0.2, 1.5], betag_range2=[0.5, 4], betap_range2=[1, 2],
    final_sinc_prob=0.8)


def test_dataset_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    # smaller than 64 (pad), larger (crop), one side each
    for i, (h, w) in enumerate(((50, 40), (90, 77), (40, 100))):
        imwrite((rng.rand(h, w, 3) * 255).astype(np.uint8),
                str(tmp_path / f"{i}.png"))
    opt = dict(DATA_OPT, dataroot_gt=str(tmp_path))
    jds, tds = JaxDataset(dict(opt)), RealESRGANDataset(dict(opt))
    assert len(jds) == len(tds) == 3
    sincs = 0
    for seed in range(4):
        rj, rt = random.Random(seed), random.Random(seed)
        for i in range(3):
            a, b = jds.__getitem__(i, rng=rj), tds.__getitem__(i, rng=rt)
            assert a["gt"].shape == (64, 64, 3)
            for k in ("gt", "kernel1", "kernel2", "sinc_kernel"):
                assert b[k].dtype == a[k].dtype == np.float32, k
                assert np.array_equal(a[k], b[k]), (seed, i, k)
            sincs += int(b["sinc_kernel"][10, 10] != 1.0)
    assert 0 < sincs < 12


# ------------------------------------------------------------------ queue

def test_queue_matches_jax():
    """queue_size 7 at batch 2 (a queue of 6), 10 steps: three fills of
    the queue, JAX's batches at every step."""
    jq = object.__new__(jrm.RealESRNetModel)
    tq = object.__new__(trm.RealESRNetModel)
    for q in (jq, tq):
        q.queue_size, q._queue, q._queue_ptr = 7, None, 0
        q._enqueue_rng = np.random.RandomState(77)
    tq.device = torch.device("cpu")
    rng = np.random.RandomState(3)
    for step in range(10):
        lq = rng.rand(2, 4, 4, 3).astype(np.float32)
        gt = rng.rand(2, 16, 16, 6).astype(np.float32)
        ja, jb = jq._dequeue_and_enqueue(jnp.asarray(lq), jnp.asarray(gt))
        ta, tb = tq._dequeue_and_enqueue(nchw(lq), nchw(gt))
        assert np.array_equal(nhwc(ta), np.asarray(ja)), step
        assert np.array_equal(nhwc(tb), np.asarray(jb)), step
    assert tq._queue_len == 6 and tq._queue_ptr == 6


# ----------------------------------------------------------------- models

def _opt(tmp_path, model_type, **train):
    t = {"total_iter": 10, "ema_decay": 0.999,
         "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0,
                     "betas": [0.9, 0.99]},
         "scheduler": {"type": "MultiStepLR", "milestones": [100],
                       "gamma": 0.5},
         "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                       "reduction": "mean"}}
    t.update(train)
    return dict(SYNTH, name="t_realsr", model_type=model_type,
                is_train=True, scale=4, num_gpu=1, manual_seed=0,
                gt_size=32, queue_size=4, l1_gt_usm=True,
                percep_gt_usm=False, gan_gt_usm=True,
                network_g=dict(TINY_G, scan_impl="xla"),
                network_d=dict(TINY_D),
                path={"models": str(tmp_path),
                      "training_states": str(tmp_path)},
                train=t, val={"window_size": 8})


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.rand(2, *hw, 3).astype(np.float32)
            for k, hw in (("lq", (8, 8)), ("gt", (32, 32)),
                          ("gt_usm", (32, 32)))}


def _feed(jm, m, batch):
    keys = ("lq", "gt", "gt_usm")
    jb = jm.put_batch(batch, keys)
    jm.lq, jm.gt, jm.gt_usm = (jb[k] for k in keys)
    tb = m.put_batch(batch, keys)
    m.lq, m.gt, m.gt_usm = (tb[k] for k in keys)


def _check_g(jm, m):
    for name, tree, net in (("params", jm.params, m.net_g),
                            ("ema", jm.params_ema, m.net_g_ema)):
        ref = jax_to_torch(_np(tree["params"]))
        for k, v in net.state_dict().items():
            assert _rel(v, ref[k]) <= 2e-3, (name, k, _rel(v, ref[k]))


def test_realesrnet_step_matches_jax(tmp_path):
    """One S1 step from the same MambaRealSR11 weights (the converter on
    its tree, strict) and the same batch: the forward, the L1 against the
    USM GT, the weights after."""
    opt = _opt(tmp_path, "MambaRealSR")
    jm = jax_build_model(opt)
    m = build_model(opt, device="cpu")
    g0 = jax_to_torch(_np(jm.params["params"]))
    assert not any("conv_cin" in k or "conv_cout" in k for k in g0)
    m.net_g.load_state_dict(g0)
    m.net_g_ema.load_state_dict(g0)
    batch = _batch(1)
    _feed(jm, m, batch)
    with torch.no_grad():
        out = nhwc(m.net_g(m.lq))
    ref = np.asarray(jm._apply_jit(jm.params, jm.lq))
    assert np.abs(out - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1)
    jm.optimize_parameters(1)
    m.optimize_parameters(1)
    lj, lt = jm.get_current_log(), m.get_current_log()
    assert set(lj) == set(lt) == {"l_pix", "lr"}
    want = float(np.abs(ref - batch["gt_usm"]).mean())
    assert abs(lt["l_pix"] - want) <= 1e-5 * want
    assert abs(lt["l_pix"] - lj["l_pix"]) <= 1e-4 * abs(lj["l_pix"])
    assert torch.equal(m.gt, torch.from_numpy(
        np.ascontiguousarray(batch["gt"].transpose(0, 3, 1, 2))))
    _check_g(jm, m)


def test_realesrgan_iteration_matches_jax(tmp_path):
    """One GAN iteration (G step, then D step) from the same G, D, u and
    batch, with L1 on the USM GT, VGG19 perceptual on the plain GT and
    D's real the USM GT: the logs, D's u (kept by the G step, moved
    twice by the D step), G, its EMA and D after."""
    opt = _opt(
        tmp_path, "MambaRealSRGAN",
        optim_d={"type": "Adam", "lr": 2e-4, "weight_decay": 0,
                 "betas": [0.9, 0.99]},
        perceptual_opt={"type": "PerceptualLoss",
                        "layer_weights": {"conv1_2": 0.1, "conv2_2": 1},
                        "vgg_type": "vgg19", "use_input_norm": True,
                        "perceptual_weight": 1.0, "style_weight": 0,
                        "range_norm": False, "criterion": "l2"},
        gan_opt={"type": "GANLoss", "gan_type": "vanilla",
                 "real_label_val": 1.0, "fake_label_val": 0.0,
                 "loss_weight": 0.1},
        net_d_iters=1, net_d_init_iters=0)
    jm = jax_build_model(opt)
    m = build_model(opt, device="cpu")
    g0 = jax_to_torch(_np(jm.params["params"]))
    m.net_g.load_state_dict(g0)
    m.net_g_ema.load_state_dict(g0)
    m.net_d.load_state_dict(jax_disc_to_torch(
        _np(jm.params_d), _np(jm.state_d["batch_stats"])))
    _feed(jm, m, _batch(2))
    calls = []
    d_fwd = m.net_d.forward
    m.net_d.forward = lambda x, update_stats=False: (
        calls.append(update_stats) or d_fwd(x, update_stats))
    jm.optimize_parameters(1)
    m.optimize_parameters(1)
    assert calls == [False, True, True]
    lj, lt = jm.get_current_log(), m.get_current_log()
    keys = {"l_g_pix", "l_g_percep", "l_g_gan", "l_d_real", "l_d_fake",
            "out_d_real", "out_d_fake", "lr"}
    assert set(lj) == set(lt) == keys
    for k in keys:
        assert abs(lt[k] - lj[k]) <= 1e-4 * abs(lj[k]) + 1e-7, (k, lt[k],
                                                                lj[k])
    _check_g(jm, m)
    ref_d = jax_disc_to_torch(_np(jm.params_d),
                              _np(jm.state_d["batch_stats"]))
    for k, v in m.net_d.state_dict().items():
        if not k.endswith("weight_v"):  # JAX keeps no v
            assert _rel(v, ref_d[k]) <= 2e-3, (k, _rel(v, ref_d[k]))


# ------------------------------------------------------------ entry points

def test_realsr_yamls_through_the_pipelines(tmp_path):
    """The pipelines as `train_torch.py` and `test_torch.py` run them
    (`-opt`, `--device cpu`, `--force_yml` tiny overrides): the S1 YAML
    (2 iterations, validation), then the GAN YAML from the S1 run's
    `net_g_2.pth` (2 iterations), then the GT-free test YAML on the GAN
    run's G."""
    import yaml

    from vmambair_torch.train.pipeline import test_pipeline, train_pipeline

    for name, n in (("train", 3), ("val_gt", 1), ("val_lq", 1)):
        for i in range(n):
            hw = (48, 40) if name == "val_lq" else (80 - 20 * i, 70)
            imwrite((np.random.RandomState(i).rand(*hw, 3) * 255).astype(
                np.uint8), str(tmp_path / name / f"{i}.png"))
    imwrite((np.random.RandomState(5).rand(192, 160, 3) * 255).astype(
        np.uint8), str(tmp_path / "val_gt" / "0.png"))
    for y in ("mambaSR11_x4.yml", "mambaSR11GAN_x4.yml",
              "test_mambaSR11GAN_x4.yml"):
        with open(os.path.join(ROOT, "options", y)) as f:
            assert yaml.safe_load(f)["network_g"]["type"] == "MambaRealSR11"
    tiny = ["network_g:dim=8", "network_g:num_blocks=[1,1,1,1]",
            "network_g:num_refinement_blocks=1",
            "logger:use_tb_logger=False"]
    train = tiny + [
        f"datasets:train:dataroot_gt={tmp_path / 'train'}",
        "datasets:train:meta_info=None", "datasets:train:gt_size=32",
        "datasets:train:crop_pad_size=64", "gt_size=32", "queue_size=4",
        "datasets:train:batch_size_per_gpu=2",
        "datasets:train:num_worker_per_gpu=1", "train:total_iter=2",
        "logger:print_freq=1", "logger:save_checkpoint_freq=2"]

    def argv(yml, *force):
        return ["-opt", os.path.join(ROOT, "options", yml), "--device",
                "cpu", "--force_yml", *force]

    val = {"name": "val", "type": "PairedImageDataset",
           "dataroot_gt": str(tmp_path / "val_gt"),
           "dataroot_lq": str(tmp_path / "val_lq"),
           "io_backend": {"type": "disk"}}
    m = train_pipeline(ROOT, argv=argv(
        "mambaSR11_x4.yml", *train, f"datasets:val_1={val!r}",
        "val:val_freq=2", f"path:experiments_root={tmp_path / 's1'}"))
    assert type(m).__name__ == "RealESRNetModel"
    s1 = tmp_path / "s1"
    log = next(s1.glob("train_*.log")).read_text()
    assert log.count("l_pix:") == 2 and log.count("# psnr:") >= 2
    ckpt = s1 / "models" / "net_g_2.pth"
    assert ckpt.exists() and (s1 / "training_states" / "2.state").exists()

    m = train_pipeline(ROOT, argv=argv(
        "mambaSR11GAN_x4.yml", *train, "network_d:num_feat=8",
        f"path:pretrain_network_g={ckpt}",
        f"path:experiments_root={tmp_path / 'gan'}"))
    assert type(m).__name__ == "RealESRGANModel"
    gan = tmp_path / "gan"
    log = next(gan.glob("train_*.log")).read_text()
    assert log.count("l_g_percep:") == 2 and "l_d_real:" in log
    assert (gan / "models" / "net_d_2.pth").exists()

    m = test_pipeline(ROOT, argv=argv(
        "test_mambaSR11GAN_x4.yml", *tiny,
        f"datasets:test_1:dataroot_lq={tmp_path / 'val_lq'}",
        f"path:pretrain_network_g={gan / 'models' / 'net_g_2.pth'}",
        f"path:results_root={tmp_path / 'res'}"))
    assert type(m).__name__ == "RealESRGANModel" and m.gt is None
    outs = list((tmp_path / "res").rglob("*.png"))
    assert len(outs) == 1 and m.output.shape == (1, 3, 192, 160)


def test_chip_smoke_realsr_recipes_are_the_yamls():
    """`chip_smoke.py` carries the two RealSR YAMLs as dicts (the card's
    machine has no YAML parser): every key it sets equals the YAML's, but
    the dataset's paths."""
    import yaml

    import chip_smoke

    for name, rec in (("mambaSR11_x4.yml", chip_smoke.REALSR_RECIPE),
                      ("mambaSR11GAN_x4.yml",
                       chip_smoke._realsr_gan_recipe())):
        with open(os.path.join(ROOT, "options", name)) as f:
            ref = yaml.safe_load(f)
        for k, v in rec.items():
            if k not in ("datasets", "path", "is_train", "val"):
                assert ref[k] == v, (name, k)
        for k, v in rec["datasets"]["train"].items():
            if k not in ("dataroot_gt", "meta_info"):
                assert ref["datasets"]["train"][k] == v, (name, k)
        assert set(ref) - set(rec) <= {"datasets", "path", "val", "num_gpu",
                                       "logger"}, (name, set(ref) - set(rec))
