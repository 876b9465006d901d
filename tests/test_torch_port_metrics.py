"""The port's learned metrics and MATLAB helpers against the JAX package's,
on the CPU (`vmambair_torch/metrics/`, `utils/matlab.py`): the helpers and
NIQE here, the VGG16 metrics, the validation and the folder CLIs in
`test_torch_port_metrics_nets.py`.

- `imresize` (up and down, antialiasing on and off, uint8 and float, HW
  and HWC), `ycbcr2rgb` and `ycbcr2bgr`: equal to JAX's numpy versions.
- NIQE on three seeded images of at least 192x192 (noise, a smooth field,
  and one with a flat block whose fits are NaN): every block's gamma fits
  equal to JAX's (`_compute_feature`), the other features within 1e-5
  relative, the score within 1e-4 relative of JAX's `calculate_niqe`;
  the port's replicate filter and 2x halving equal to cv2's.
- `metric_report_key` / `metric_is_calibrated` equal to JAX's, with one
  warning per name.
"""

import logging
import os

import cv2
import numpy as np
import pytest
import torch

from vmambair_tpu import metrics as jax_metrics
from vmambair_tpu.metrics import niqe as jn
from vmambair_tpu.utils import matlab as jm
from vmambair_torch import metrics as tmetrics
from vmambair_torch.metrics import niqe as tn
from vmambair_torch.utils import matlab as tm

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


# -- NIQE -------------------------------------------------------------------

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
