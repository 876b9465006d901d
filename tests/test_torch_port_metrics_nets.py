"""The port's VGG16 metrics, validation and folder CLIs against the JAX
package's, on the CPU (the helpers and NIQE: `test_torch_port_metrics.py`;
apart so that the scheduler, `--dist loadfile`, starts these heavier
cases on a worker of their own).

- VGG16 with L2 pooling (`pool="l2"`): every stage within 1e-5 of its
  largest entry; `l2_pool` alone likewise.
- LPIPS seeded, and with lin heads and a backbone from a temporary `.npz`:
  within 1e-5 relative. DISTS with the shipped alpha / beta, seeded and
  from an `.npz`: within 1e-6 absolute (the score is one minus a float32
  sum near 1).
- `SRModel.validation` on a tiny net with all five metrics: the keys
  (`lpips_uncalibrated`, `dists_uncalibrated`), each value equal to the
  metric called on the saved SR images (NIQE on the SR image alone).
- The three folder CLIs with `--device cpu`: the output of JAX's CLIs on
  the same folders, line for line.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_port_metrics import ROOT, _pair, _rel, _smooth

from vmambair_tpu.losses import perceptual as jp
from vmambair_tpu.metrics import dists as jd
from vmambair_tpu.metrics import lpips as jl
from vmambair_torch import metrics as tmetrics
from vmambair_torch.losses import perceptual as tp
from vmambair_torch.metrics import dists as td
from vmambair_torch.metrics import lpips as tl
from vmambair_torch.train import build_model
from vmambair_torch.utils.img_util import imread, imwrite

torch.set_num_threads(1)


# -- VGG16 and L2 pooling ---------------------------------------------------

def test_vgg16_with_l2_pooling_matches_jax():
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    jparams, _ = jp._init_vgg_params(None, 0, plan=jp.VGG16_LAYERS)
    tparams, _ = tp.init_vgg_params(None, 0, plan=tp.VGG16_LAYERS)
    stages = list(td.STAGES)
    ref = jp.vgg_features(x, jparams, stages, plan=jp.VGG16_LAYERS,
                          pool="l2")
    got = tp.vgg_features(torch.from_numpy(x).permute(0, 3, 1, 2), tparams,
                          stages, plan=tp.VGG16_LAYERS, pool="l2")
    for s in stages:
        r = np.asarray(ref[s])
        g = got[s].permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape and _rel(g, r) < 1e-5, s
    y = x * 3 - 1
    np.testing.assert_allclose(
        tp.l2_pool(torch.from_numpy(y).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy(), np.asarray(jp._l2_pool(y)), rtol=1e-5,
        atol=1e-6)


# -- LPIPS and DISTS ----------------------------------------------------------

@pytest.fixture(scope="module")
def vgg16_npz(tmp_path_factory):
    """A VGG16 in the converted layout with LPIPS's lin heads and DISTS's
    alpha / beta, all from another seed."""
    rng = np.random.RandomState(5)
    arrays, c_in = {}, 3
    for item in tp.VGG16_LAYERS:
        if item == "M":
            continue
        name, c = item
        arrays[f"{name}/kernel"] = (rng.randn(3, 3, c_in, c) * np.sqrt(
            2 / (9 * c_in))).astype(np.float32)
        arrays[f"{name}/bias"] = (rng.randn(c) * 0.01).astype(np.float32)
        c_in = c
    for i, c in enumerate((64, 128, 256, 512, 512)):
        arrays[f"lin{i}/weight"] = rng.rand(c).astype(np.float32) - 0.2
    arrays["alpha"] = rng.rand(1, 1475).astype(np.float32)
    arrays["beta"] = rng.rand(1, 1475).astype(np.float32)
    path = str(tmp_path_factory.mktemp("vgg16") / "vgg16.npz")
    np.savez(path, **arrays)
    return path


@pytest.mark.parametrize("weights", [False, True])
def test_lpips_matches_jax(weights, vgg16_npz):
    path = vgg16_npz if weights else None
    a, b = _pair()
    ref, got = jl.LPIPS(path), tl.LPIPS(path)
    assert got.is_pretrained == ref.is_pretrained == weights
    assert len(got.lin_names) == len(ref.lins)
    for x, y in ((a, b), (a.astype(np.float32) / 255, b)):
        assert got(x, y) == pytest.approx(ref(x, y), rel=1e-5)
    assert tmetrics.calculate_metric({"type": "calculate_lpips"}, a, b,
                                     device="cpu") == pytest.approx(
        jl.LPIPS()(a, b), rel=1e-5)


@pytest.mark.parametrize("weights", [False, True])
def test_dists_matches_jax(weights, vgg16_npz):
    path = vgg16_npz if weights else None
    a, b = _pair(40, 56, seed=3)
    ref, got = jd.DISTS(path), td.DISTS(path)
    assert got.heads_pretrained and ref.heads_pretrained
    torch.testing.assert_close(got.alpha, torch.from_numpy(
        np.asarray(ref.alpha)), rtol=0, atol=0)
    assert got(a, b) == pytest.approx(ref(a, b), abs=1e-6)
    assert tmetrics.calculate_metric({"type": "calculate_dists"}, a, b,
                                     device="cpu") == pytest.approx(
        jd.DISTS()(a, b), abs=1e-6)


# -- the validation loop ----------------------------------------------------

METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 4,
                    "test_y_channel": True},
           "ssim": {"type": "calculate_ssim", "crop_border": 4,
                    "test_y_channel": True},
           "lpips": {"type": "calculate_lpips"},
           "dists": {"type": "calculate_dists"},
           "niqe": {"type": "calculate_niqe", "crop_border": 4}}


def test_validation_reports_all_five_metrics(tmp_path):
    """Two whole images of 26x50 LQ (SR 104x200: two NIQE blocks after the
    crop); each reported value is the metric's own call on the saved SR
    images averaged, NIQE on the SR image alone."""
    rng = np.random.RandomState(6)
    gts = []
    for i in range(2):
        gt = _smooth(104, 200, 0.1 * i)
        gt = np.clip(gt + rng.randint(-9, 9, gt.shape), 0, 255).astype(
            np.uint8)
        lq = gt.reshape(26, 4, 50, 4, 3).mean((1, 3)).round().astype(
            np.uint8)
        imwrite(gt, str(tmp_path / "gt" / f"{i}.png"))
        imwrite(lq, str(tmp_path / "lq" / f"{i}.png"))
        gts.append(gt)
    from vmambair_torch.data import build_dataloader, build_dataset
    ds_opt = {"name": "v", "type": "PairedImageDataset", "phase": "val",
              "scale": 4, "dataroot_gt": str(tmp_path / "gt"),
              "dataroot_lq": str(tmp_path / "lq"),
              "io_backend": {"type": "disk"}}
    loader, _ = build_dataloader(build_dataset(dict(ds_opt)), dict(ds_opt))
    opt = {"model_type": "SRModel", "scale": 4, "is_train": False,
           "manual_seed": 0,
           "network_g": {"type": "OSSNet", "dim": 8,
                         "num_blocks": [1, 1, 1, 1],
                         "num_refinement_blocks": 1, "scale": 4},
           "path": {"visualization": str(tmp_path / "vis")},
           "val": {"window_size": 8, "metrics": METRICS}}
    model = build_model(opt, device="cpu")
    out = model.validation(loader, "t", save_img=True)
    assert set(out) == {"psnr", "ssim", "lpips_uncalibrated",
                        "dists_uncalibrated", "niqe"}
    srs = [imread(str(tmp_path / "vis" / "v" / f"{i}.png")) for i in range(2)]
    for name, mopt in METRICS.items():
        key = next(k for k in out if k.startswith(name))
        fn = getattr(tmetrics, mopt["type"])
        kw = {k: v for k, v in mopt.items() if k != "type"}
        if name in ("lpips", "dists", "niqe"):
            kw["device"] = "cpu"
        args = [(sr,) if name == "niqe" else (sr, gt)
                for sr, gt in zip(srs, gts)]
        assert out[key] == pytest.approx(
            float(np.mean([fn(*a, **kw) for a in args])), rel=1e-12), name


# -- the folder CLIs --------------------------------------------------------

@pytest.mark.parametrize("cli", ["psnr_ssim", "lpips", "dists"])
def test_folder_clis_print_what_the_jax_clis_print(cli, tmp_path, capsys):
    rng = np.random.RandomState(8)
    for i, (h, w) in enumerate(((40, 48), (36, 44))):
        gt = _smooth(h, w, 0.2 * i)
        sr = np.clip(gt + rng.randint(-30, 30, gt.shape), 0, 255).astype(
            np.uint8)
        imwrite(gt, str(tmp_path / "gt" / f"im{i}.png"))
        imwrite(sr, str(tmp_path / "sr" / f"im{i}_x4.png"))
    args = ["--gt", str(tmp_path / "gt"), "--sr", str(tmp_path / "sr")]
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", f"metric_{cli}.py"),
         *args], capture_output=True, text=True, check=True, cwd=ROOT).stdout
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        mod = __import__(f"metric_{cli}_torch")
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    # PSNR / SSIM run on the host: their CLI takes no --device
    mod.main(args + ([] if cli == "psnr_ssim" else ["--device", "cpu"]))
    got = capsys.readouterr().out
    assert got.splitlines() == ref.splitlines() and "Average" in got
