"""The port's task datasets and its 16-bit / grayscale PNG reads against
the JAX package's and cv2, on the CPU.

- the codec: 16-bit PNGs (gray, gray + alpha, RGB, RGBA; every row
  filter; written by cv2 and by the port's encoder) read in each of cv2's
  three modes, and 8-bit colour PNGs read as grayscale, equal cv2's reads
  bit for bit (libpng's fixed-point RGB -> gray weights);
- `DeblurPairedDataset`, `Dataset_GaussianDenoising` (constant, random
  and choice sigma; `in_ch` 3 and 1; train and test; an image smaller
  than `gt_size`, padded) and `Dataset_DefocusDeblur_DualPixel_16bit`
  (train and test), built by name through the registry, give JAX's
  samples exactly for the same files and the same `random.Random` seed,
  with `cv2` blocked in the port;
- two iterations of `train_pipeline` on the dual-pixel data with a
  Mamber33 of six input channels (`dual_pixel_task`).
"""

import random
import sys

import cv2
import numpy as np
import pytest

from vmambair_tpu.data import build_dataset as jax_build_dataset
from vmambair_torch.data import build_dataset
from vmambair_torch.utils import img_util


def _image(rng, h, w, ch, dtype=np.uint8):
    """A smooth image with noise, so that every filter type has work."""
    top = np.iinfo(dtype).max
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(yy / 3.0)[..., None] * np.cos(xx / 5.0)[..., None]
            * 0.4 + 0.5) * np.linspace(0.6, 1.0, ch)
    img = base * top + rng.randint(-top // 9, top // 9, (h, w, ch))
    img = np.clip(img, 0, top).astype(dtype)
    return img[:, :, 0] if ch == 1 else img


READS = (("color", cv2.IMREAD_COLOR), ("unchanged", cv2.IMREAD_UNCHANGED),
         ("grayscale", cv2.IMREAD_GRAYSCALE))


def _same_as_cv2(path):
    for flag, cv_flag in READS:
        got, want = img_util.imread(path, flag), cv2.imread(path, cv_flag)
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=flag)


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_16bit_png_reads_equal_cv2(tmp_path, ch):
    """A 16-bit image written by the port's encoder with each row filter,
    and (but gray + alpha, which cv2 writes as BGRA) by cv2 itself."""
    rng = np.random.RandomState(ch)
    img = _image(rng, 19, 23, ch, np.uint16)
    for ftype in range(5):
        data = img_util.png_encode(img, level=6, ftype=ftype)
        np.testing.assert_array_equal(img_util.png_decode(data), img)
        path = tmp_path / f"p{ftype}.png"
        path.write_bytes(data)
        _same_as_cv2(str(path))
    if ch != 2:
        path = str(tmp_path / "cv.png")
        assert cv2.imwrite(path, img)
        _same_as_cv2(path)
        bgr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        out = str(tmp_path / "port.png")
        assert img_util.imwrite(bgr, out)
        np.testing.assert_array_equal(
            cv2.imread(out, cv2.IMREAD_UNCHANGED), bgr)


@pytest.mark.parametrize("level", [0, 6, 9])
def test_colour_png_read_as_gray_equals_cv2(tmp_path, level):
    """8-bit RGB and RGBA files from cv2 (every level's filter choice) and
    gray-valued pixels (r = g = b) read as grayscale: cv2's bits."""
    rng = np.random.RandomState(level)
    for ch, (h, w) in ((3, (31, 47)), (4, (16, 9))):
        img = _image(rng, h, w, ch)
        img[0, :5, :3] = np.arange(5)[:, None] * 60
        path = str(tmp_path / f"c{ch}.png")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        _same_as_cv2(path)


@pytest.fixture
def no_cv2(monkeypatch):
    """cv2 unimportable for the port (the JAX package's copy is already
    bound); PNG reads must not fall back to it."""
    monkeypatch.setattr(img_util, "_cv2", lambda: None)
    monkeypatch.setitem(sys.modules, "cv2", None)


def _check(opt, n=4, seed=7):
    """n samples of the JAX dataset and of the port's (cv2 blocked for the
    port), each from random.Random(seed): equal."""
    ref = jax_build_dataset(dict(opt))
    ref_rng = random.Random(seed)
    want = [ref.__getitem__(i % len(ref), rng=ref_rng) for i in range(n)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(img_util, "_cv2", lambda: None)
        mp.setitem(sys.modules, "cv2", None)
        ds = build_dataset(dict(opt))
        rng = random.Random(seed)
        got = [ds.__getitem__(i % len(ds), rng=rng) for i in range(n)]
    assert len(ds) == len(ref)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k
    return got


def _write(folder, n, hw, ch=3, dtype=np.uint8, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = hw[i % len(hw)]
        assert cv2.imwrite(str(folder / f"{i:03d}.png"),
                           _image(rng, h, w, ch, dtype))


def test_deblur_dataset_matches_jax(tmp_path):
    (tmp_path / "blur").mkdir()
    (tmp_path / "sharp").mkdir()
    _write(tmp_path / "blur", 3, [(40, 36), (24, 30)], seed=1)
    _write(tmp_path / "sharp", 3, [(40, 36), (24, 30)], seed=2)
    opt = {"name": "deblur", "type": "DeblurPairedDataset",
           "dataroot_lq": str(tmp_path / "blur"),
           "dataroot_gt": str(tmp_path / "sharp"),
           "io_backend": {"type": "disk"}, "scale": 1, "phase": "train",
           "gt_size": 32, "geometric_augs": True}
    got = _check(opt, n=6)
    assert got[0]["lq"].shape == (32, 32, 3)
    _check(dict(opt, phase="val"), n=3)


@pytest.mark.parametrize("sigma", [
    dict(sigma_type="constant", sigma_range=25),
    dict(sigma_type="random", sigma_range=[5, 50]),
    dict(sigma_type="choice", sigma_range=[15, 25, 50])],
    ids=["constant", "random", "choice"])
@pytest.mark.parametrize("in_ch", [3, 1])
def test_gaussian_denoising_dataset_matches_jax(tmp_path, sigma, in_ch):
    """Colour files (and one smaller than gt_size: the pad), read as
    colour or as grayscale; the test phase's sigma_test."""
    _write(tmp_path, 3, [(40, 44), (20, 36), (33, 33)], seed=in_ch)
    opt = {"name": "dn", "type": "Dataset_GaussianDenoising",
           "dataroot_gt": str(tmp_path), "io_backend": {"type": "disk"},
           "phase": "train", "gt_size": 24, "in_ch": in_ch,
           "geometric_augs": True, **sigma}
    got = _check(opt, n=6)
    assert got[0]["lq"].shape == (24, 24, in_ch)
    sigmas = {round(float(s["sigma"]) * 255, 3) for s in got}
    if sigma["sigma_type"] == "random":
        assert len(sigmas) == len(got)
    else:
        assert sigmas <= set(np.atleast_1d(sigma["sigma_range"]))
    test = _check(dict(opt, phase="test", sigma_test=15), n=3)
    assert test[1]["lq"].shape == (20, 36, in_ch)
    assert float(test[0]["sigma"]) == np.float32(15 / 255)


def test_dual_pixel_dataset_matches_jax(tmp_path):
    """16-bit left, right and GT views (RGB), train (crop, augment) and
    test (whole images)."""
    for k, seed in (("lqL", 1), ("lqR", 2), ("gt", 3)):
        (tmp_path / k).mkdir()
        _write(tmp_path / k, 3, [(40, 36), (30, 44)], dtype=np.uint16,
               seed=seed)
    opt = {"name": "dp", "type": "Dataset_DefocusDeblur_DualPixel_16bit",
           "dataroot_lqL": str(tmp_path / "lqL"),
           "dataroot_lqR": str(tmp_path / "lqR"),
           "dataroot_gt": str(tmp_path / "gt"), "phase": "train",
           "gt_size": 24, "geometric_augs": True}
    got = _check(opt, n=6)
    assert got[0]["lq"].shape == (24, 24, 6) and got[0]["gt"].shape == (
        24, 24, 3)
    test = _check(dict(opt, phase="test"), n=3)
    assert test[1]["lq"].shape == (30, 44, 6)
    # the 16-bit grid survives: 65535 * value is an integer
    v = test[0]["gt"].astype(np.float64) * 65535
    assert np.abs(v - np.round(v)).max() < 5e-3


def test_dual_pixel_trains_through_the_pipeline(tmp_path, no_cv2):
    """Two iterations of train_pipeline on the dual-pixel data with a
    six-channel Mamber33 (`dual_pixel_task`: skip_conv, no input
    residual), with cv2 blocked."""
    from vmambair_torch.train.pipeline import train_pipeline
    from vmambair_torch.utils.options import finalize_options

    rng = np.random.RandomState(0)
    for k in ("lqL", "lqR", "gt"):
        for i in range(2):
            img_util.imwrite(_image(rng, 36, 40, 3, np.uint16),
                             str(tmp_path / k / f"{i}.png"))
    opt = {"name": "dp", "model_type": "ImageCleanModel", "scale": 1,
           "num_gpu": 1, "manual_seed": 0, "is_train": True,
           "datasets": {"train": {
               "name": "dp", "type": "Dataset_DefocusDeblur_DualPixel_16bit",
               "dataroot_lqL": str(tmp_path / "lqL"),
               "dataroot_lqR": str(tmp_path / "lqR"),
               "dataroot_gt": str(tmp_path / "gt"), "gt_size": 16,
               "geometric_augs": True, "batch_size_per_gpu": 2,
               "num_worker_per_gpu": 1, "use_shuffle": True}},
           "network_g": {"type": "Mamber33", "inp_channels": 6, "dim": 8,
                         "num_blocks": [1, 1, 1, 1],
                         "num_refinement_blocks": 1,
                         "dual_pixel_task": True},
           "path": {"experiments_root": str(tmp_path / "exp")},
           "train": {"total_iter": 2, "optim_g": {"type": "AdamW",
                                                  "lr": 2e-4},
                     "pixel_opt": {"type": "L1Loss"}},
           "logger": {"print_freq": 1, "use_tb_logger": False}}
    m = train_pipeline(str(tmp_path), finalize_options(opt, str(tmp_path),
                                                       is_train=True),
                       device="cpu")
    assert m.net_g.dual_pixel_task and m.lq.shape == (2, 6, 16, 16)
    assert m.net_g.patch_embed.proj.weight.shape[1] == 6
    assert np.isfinite(m.get_current_log()["l_pix"])
    assert (tmp_path / "exp" / "models" / "net_g_2.pth").exists()
