"""The port's learned metrics and MATLAB helpers against the JAX package's,
on the CPU (`vmambair_torch/metrics/`, `utils/matlab.py`).

- `imresize` (up and down, antialiasing on and off, uint8 and float, HW
  and HWC), `ycbcr2rgb` and `ycbcr2bgr`: equal to JAX's numpy versions.
- VGG16 with L2 pooling (`pool="l2"`): every stage within 1e-5 of its
  largest entry; `l2_pool` alone likewise.
- LPIPS seeded, and with lin heads and a backbone from a temporary `.npz`:
  within 1e-5 relative. DISTS with the shipped alpha / beta, seeded and
  from an `.npz`: within 1e-6 absolute (the score is one minus a float32
  sum near 1).
- NIQE on three seeded images of at least 192x192 (noise, a smooth field,
  and one with a flat block whose fits are NaN): every block's gamma fits
  equal to JAX's (`_compute_feature`), the other features within 1e-5
  relative, the score within 1e-4 relative of JAX's `calculate_niqe`;
  the port's replicate filter and 2x halving equal to cv2's.
- `metric_report_key` / `metric_is_calibrated` equal to JAX's, with one
  warning per name.
- `SRModel.validation` on a tiny net with all five metrics: the keys
  (`lpips_uncalibrated`, `dists_uncalibrated`), each value equal to the
  metric called on the saved SR images (NIQE on the SR image alone).
- The three folder CLIs with `--device cpu`: the output of JAX's CLIs on
  the same folders, line for line.
"""

import logging
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from vmambair_tpu import metrics as jax_metrics
from vmambair_tpu.losses import perceptual as jp
from vmambair_tpu.metrics import dists as jd
from vmambair_tpu.metrics import lpips as jl
from vmambair_tpu.metrics import niqe as jn
from vmambair_tpu.utils import matlab as jm
from vmambair_torch import metrics as tmetrics
from vmambair_torch.losses import perceptual as tp
from vmambair_torch.metrics import dists as td
from vmambair_torch.metrics import lpips as tl
from vmambair_torch.metrics import niqe as tn
from vmambair_torch.train import build_model
from vmambair_torch.utils import matlab as tm
from vmambair_torch.utils.img_util import imread, imwrite

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _smooth(h, w, phase=0.0):
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(2 * np.pi * (3 * yy + c + phase) + 5 * xx)
                    for c in range(3)], -1)
    return ((img * 0.5 + 0.5) * 255).round().astype(np.uint8)


def _pair(h=48, w=40, seed=0):
    rng = np.random.RandomState(seed)
    a = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-40, 40, a.shape), 0,
                255).astype(np.uint8)
    return a, b


# -- MATLAB helpers ---------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(scale=0.25), dict(scale=1 / 3),
                                dict(scale=0.5, antialias=False),
                                dict(scale=2.0), dict(scale=3.0),
                                dict(out_shape=(50, 13))])
def test_imresize_matches_jax(kw):
    rng = np.random.RandomState(0)
    for img in ((rng.rand(37, 29, 3) * 255).astype(np.uint8),
                rng.rand(37, 29, 3).astype(np.float32),
                rng.rand(20, 31).astype(np.float32)):
        ref = jm.imresize(img, **kw)
        got = tm.imresize(img, **kw)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        t = tm.imresize(torch.from_numpy(img), **kw)
        np.testing.assert_array_equal(t.numpy(), ref)


def test_ycbcr_inverses_match_jax():
    rng = np.random.RandomState(1)
    for img in ((rng.rand(9, 11, 3) * 255).astype(np.uint8),
                rng.rand(9, 11, 3).astype(np.float32)):
        ycc = jm.rgb2ycbcr(img)
        for f in ("ycbcr2rgb", "ycbcr2bgr"):
            np.testing.assert_array_equal(getattr(tm, f)(ycc),
                                          getattr(jm, f)(ycc))


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


# -- NIQE -----------------------------------------------------------------------

def _niqe_images():
    rng = np.random.RandomState(0)
    flat = _smooth(200, 296, 0.3)
    flat[:100, :100] = 131  # block (0, 0) constant: its fits are NaN
    return {"noise": (rng.rand(200, 296, 3) * 255).astype(np.uint8),
            "smooth": _smooth(256, 200), "flat": flat}


def _jax_block_features(y, window, bs=96):
    """JAX's `_niqe_core` up to its feature rows (its loop and its
    `_compute_feature`), on the Y image."""
    nbh, nbw = y.shape[0] // bs, y.shape[1] // bs
    img = y[:nbh * bs, :nbw * bs]
    out = []
    for scale in (1, 2):
        mu = cv2.filter2D(img, -1, window, borderType=cv2.BORDER_REPLICATE)
        sigma = np.sqrt(np.abs(cv2.filter2D(
            np.square(img), -1, window, borderType=cv2.BORDER_REPLICATE)
            - np.square(mu)))
        norm = (img - mu) / (sigma + 1)
        b = bs // scale
        out.append(np.array([
            jn._compute_feature(norm[ih * b:(ih + 1) * b, iw * b:(iw + 1) * b])
            for iw in range(nbw) for ih in range(nbh)]))
        if scale == 1:
            hh, ww = img.shape
            img = cv2.resize(img / 255.0, (ww // 2, hh // 2),
                             interpolation=cv2.INTER_LINEAR) * 255.0
    return np.concatenate(out, 1)


ALPHA_COLS = [0, 2, 6, 10, 14, 18, 20, 24, 28, 32]


@pytest.mark.parametrize("name", ["noise", "smooth", "flat"])
def test_niqe_matches_jax(name):
    img = _niqe_images()[name]
    p = tn.pris_params()
    y = jm.bgr2ycbcr(img.astype(np.float32) / 255.0, y_only=True) * 255.0
    np.testing.assert_array_equal(tn.to_y(img, 0, "y", "cpu").numpy(), y)
    ref = _jax_block_features(y, p["gaussian_window"])
    got = tn.niqe_features(torch.from_numpy(y), p["gaussian_window"])[
        0].numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan.any(axis=1).any() == (name == "flat")
    np.testing.assert_array_equal(got[:, ALPHA_COLS], ref[:, ALPHA_COLS])
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=1e-5, atol=1e-7)
    for crop in (0, 4):
        assert tn.calculate_niqe(img, crop_border=crop, device="cpu") == \
            pytest.approx(jn.calculate_niqe(img, crop_border=crop), rel=1e-4)


def test_niqe_gray_and_params_path(tmp_path, monkeypatch):
    """`convert_to="gray"`: cv2's BGR2GRAY within one float32 ulp (equal
    on the smooth image; on noise cv2's vector path rounds ~0.1% of the
    pixels the other way), the score within 1e-4 of JAX's; a missing
    pristine model raises."""
    imgs = _niqe_images()
    for name in ("smooth", "noise"):
        img = imgs[name]
        gray = cv2.cvtColor(img.astype(np.float32) / 255.0,
                            cv2.COLOR_BGR2GRAY)
        got = tn.to_y(img, 0, "gray", "cpu").numpy() / np.float32(255.0)
        assert (np.abs(got - gray) <= np.spacing(gray)).all()
        if name == "smooth":
            np.testing.assert_array_equal(got, gray)
        assert tn.calculate_niqe(img, convert_to="gray", device="cpu") == \
            pytest.approx(jn.calculate_niqe(img, convert_to="gray"),
                          rel=1e-4)
    img = imgs["smooth"]
    monkeypatch.setenv("VMAMBAIR_NIQE_PARAMS", str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="pristine-model"):
        tn.calculate_niqe(img, device="cpu")


def test_niqe_filter_and_halving_match_cv2():
    rng = np.random.RandomState(4)
    y = (rng.rand(200, 296) * 255).astype(np.float32)
    w = tn.pris_params()["gaussian_window"]
    np.testing.assert_array_equal(
        tn.replicate_filter(torch.from_numpy(y),
                            torch.from_numpy(w.astype(np.float32))).numpy(),
        cv2.filter2D(y, -1, w, borderType=cv2.BORDER_REPLICATE))
    np.testing.assert_array_equal(
        (tn.halve(torch.from_numpy(y) / 255.0) * 255.0).numpy(),
        cv2.resize(y / 255.0, (148, 100),
                   interpolation=cv2.INTER_LINEAR) * 255.0)


# -- report keys ------------------------------------------------------------

def test_report_keys_match_jax():
    opts = [{"type": "calculate_psnr"}, {"type": "calculate_ssim"},
            {"type": "calculate_niqe"}, {"type": "calculate_lpips"},
            {"type": "calculate_dists"}, {"type": "calculate_fid"},
            {"type": "calculate_lpips", "weights_path": "w.npz"},
            {"type": "calculate_fid", "inception_path": "i.npz"}]
    for opt in opts:
        assert tmetrics.metric_is_calibrated(opt) == \
            jax_metrics.metric_is_calibrated(opt)
        assert tmetrics.metric_report_key("m", opt) == \
            jax_metrics.metric_report_key("m", opt)
    tmetrics._warned_uncalibrated.clear()
    logger = logging.getLogger("vmambair_torch")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    old_level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.WARNING)
    try:
        keys = [tmetrics.metric_report_key("lpips", {"type": t})
                for t in ("calculate_lpips", "calculate_lpips")]
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    assert keys == ["lpips_uncalibrated"] * 2
    assert len([r for r in records
                if "RANDOM backbone" in r.getMessage()]) == 1


# -- the validation loop --------------------------------------------------------

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


# -- the folder CLIs ------------------------------------------------------------

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
