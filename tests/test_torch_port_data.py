"""The port's data layer, image codec, metrics and utilities against the
JAX package's, on CPU.

The JAX package reads and writes images through cv2; the port through its
own PNG codec. The codec is held against cv2 on files cv2 wrote (gray and
RGB, odd sizes, every compression level) and on its own files (all five
row filters), and must round-trip exactly. The datasets, the sampler and
the loader must give JAX's samples and batches for the same seed; PSNR and
SSIM JAX's values to 1e-10 (the same float64 arithmetic).
"""

import random
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from vmambair_tpu.data import build_dataloader as jax_build_dataloader
from vmambair_tpu.data import build_dataset as jax_build_dataset
from vmambair_tpu.data.loader import EnlargedSampler as JaxSampler
from vmambair_tpu.data.loader import InfinitePrefetcher as JaxPrefetcher
from vmambair_tpu.metrics import psnr_ssim as jax_metrics
from vmambair_tpu.utils import img_util as jax_img
from vmambair_torch.data import build_dataloader, build_dataset
from vmambair_torch.data.file_client import FileClient
from vmambair_torch.data.loader import DevicePrefetcher, EnlargedSampler
from vmambair_torch.data.loader import InfinitePrefetcher
from vmambair_torch.metrics import calculate_metric, psnr_ssim
from vmambair_torch.utils import img_util, misc, options

torch.set_num_threads(1)


def _image(rng, h, w, ch):
    """Smooth content with noise: every PNG filter has work to do."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(yy / 3.0)[..., None] * np.cos(xx / 5.0)[..., None]
    img = base + rng.randint(-30, 30, (h, w, ch))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[:, :, 0] if ch == 1 else img


@pytest.mark.parametrize("level", range(10))
def test_png_decode_matches_cv2_on_cv2_files(tmp_path, level):
    """Gray and BGR images of odd sizes written by cv2 at compression level
    `level`: the port's imread equals cv2.imread in every read mode."""
    rng = np.random.RandomState(level)
    for ch, (h, w) in ((1, (7, 13)), (3, (11, 5)), (3, (33, 40))):
        img = _image(rng, h, w, ch)
        path = str(tmp_path / f"a{ch}_{h}.png")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        for flag, cv_flag in (("color", cv2.IMREAD_COLOR),
                              ("unchanged", cv2.IMREAD_UNCHANGED)):
            np.testing.assert_array_equal(img_util.imread(path, flag),
                                          cv2.imread(path, cv_flag))
        if ch == 1:
            np.testing.assert_array_equal(
                img_util.imread(path, "grayscale"),
                cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(
            img_util.imread(path, float32=True),
            cv2.imread(path).astype(np.float32) / 255.0)


@pytest.mark.parametrize("ftype", range(5))
def test_png_round_trip_every_filter(tmp_path, ftype):
    """The encoder with each row filter (None, Sub, Up, Average, Paeth):
    its own decoder and cv2 read back the image written, gray, gray +
    alpha, RGB and RGBA."""
    rng = np.random.RandomState(10 + ftype)
    for ch in (1, 2, 3, 4):
        img = _image(rng, 9, 14, ch)
        data = img_util.png_encode(img, level=6, ftype=ftype)
        np.testing.assert_array_equal(img_util.png_decode(data), img)
        path = tmp_path / f"f{ch}.png"
        path.write_bytes(data)
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if ch == 3:
            want = want[:, :, ::-1]
        elif ch == 4:
            want = want[:, :, [2, 1, 0, 3]]
        if ch != 2:  # cv2 gives gray + alpha as BGRA
            np.testing.assert_array_equal(want, img)


def test_imwrite_writes_bgr_that_cv2_reads(tmp_path):
    rng = np.random.RandomState(3)
    for ch in (1, 3, 4):
        img = _image(rng, 6, 10, ch)
        path = str(tmp_path / f"w{ch}.png")
        assert img_util.imwrite(img, path, [cv2.IMWRITE_PNG_COMPRESSION, 9])
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(img_util.imread(path, "unchanged"),
                                      img)


def _palette_png(idx: np.ndarray) -> bytes:
    """A palette PNG (colour type 3) of uint8 indices into a gray ramp."""
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    h, w = idx.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), idx], 1).tobytes()
    ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    return (img_util.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", ramp) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def test_png_decoder_refuses_what_it_does_not_read(tmp_path, monkeypatch):
    """A palette PNG goes to cv2 where it is installed and raises a clear
    error where it is not (16-bit PNGs the port reads itself:
    `test_torch_port_task_data.py`); a corrupt chunk raises."""
    idx = (np.arange(30).reshape(5, 6) * 7).astype(np.uint8)
    path = tmp_path / "p8.png"
    path.write_bytes(_palette_png(idx))
    np.testing.assert_array_equal(img_util.imread(str(path), "unchanged"),
                                  cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    monkeypatch.setattr(img_util, "_cv2", lambda: None)
    with pytest.raises(img_util.UnsupportedPNG, match="colour type 3"):
        img_util.imread(str(path), "unchanged")
    with pytest.raises(ValueError, match="cv2"):
        img_util.imfrombytes(b"\xff\xd8 not a png")
    data = bytearray(img_util.png_encode(np.zeros((2, 2), np.uint8)))
    data[40] ^= 0xFF
    with pytest.raises((ValueError, zlib.error)):
        img_util.png_decode(bytes(data))


def test_array_helpers_match_jax():
    """padding repeats the edge pixel as cv2.BORDER_REFLECT does (numpy's
    `symmetric`); the batch helpers and the crops as in JAX."""
    rng = np.random.RandomState(0)
    lq = rng.rand(5, 7, 3).astype(np.float32)
    gt = rng.rand(20, 28, 3).astype(np.float32)
    for size in (4, 6, 9):
        for got, ref in zip(img_util.padding(lq, gt, size),
                            jax_img.padding(lq, gt, size)):
            np.testing.assert_array_equal(got, ref)
    batch = rng.rand(2, 6, 5, 3).astype(np.float32)
    for got, ref in ((img_util.batch2img(batch), jax_img.batch2img(batch)),
                     ([img_util.img2batch(lq)], [jax_img.img2batch(lq)]),
                     ([img_util.pad_to_multiple(batch, 4)],
                      [jax_img.pad_to_multiple(batch, 4)]),
                     ([img_util.crop_border(batch, 1)],
                      [jax_img.crop_border(batch, 1)])):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("crop,y", [(0, False), (4, True), (2, False)])
def test_psnr_and_ssim_match_jax(crop, y):
    rng = np.random.RandomState(crop)
    a = (rng.rand(24, 20, 3) * 255).astype(np.uint8)
    b = np.clip(a + rng.randint(-20, 20, a.shape), 0, 255).astype(np.uint8)
    for name in ("calculate_psnr", "calculate_ssim"):
        opt = {"type": name, "crop_border": crop, "test_y_channel": y}
        got = calculate_metric(opt, a, b)
        ref = getattr(jax_metrics, name)(a, b, crop_border=crop,
                                         test_y_channel=y)
        assert got == pytest.approx(ref, rel=1e-10, abs=1e-10)
    assert psnr_ssim.calculate_psnr(a, a) == float("inf")


def test_learned_metrics_and_other_backends_raise(tmp_path):
    # the learned metrics are ported: what raises is what JAX's raise for
    # (NIQE without its pristine model, FID's mismatched statistics)
    img = np.zeros((200, 200, 3), np.uint8)
    with pytest.raises(FileNotFoundError, match="pristine-model"):
        calculate_metric({"type": "calculate_niqe", "pris_params_path":
                          str(tmp_path / "missing.npz")}, img, device="cpu")
    with pytest.raises(AssertionError):
        calculate_metric({"type": "calculate_fid"}, np.zeros(3), np.eye(3),
                         np.zeros(4), np.eye(4))
    for backend in ("lmdb", "pack"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            FileClient(backend)


def _dataset_dir(tmp_path, n=5, gt_hw=(40, 48)):
    """n paired PNGs: GT of gt_hw and its 4x box-downsampled LQ."""
    rng = np.random.RandomState(1)
    for i in range(n):
        gt = _image(rng, *gt_hw, 3)
        h, w = gt_hw[0] // 4, gt_hw[1] // 4
        lq = gt.reshape(h, 4, w, 4, 3).mean((1, 3)).astype(np.uint8)
        img_util.imwrite(gt, str(tmp_path / "gt" / f"{i:03d}.png"))
        img_util.imwrite(lq, str(tmp_path / "lq" / f"{i:03d}.png"))
    return {"name": "d", "type": "PairedImageDataset",
            "dataroot_gt": str(tmp_path / "gt"),
            "dataroot_lq": str(tmp_path / "lq"),
            "io_backend": {"type": "disk"}, "scale": 4}


@pytest.mark.parametrize("phase,extra", [
    ("train", {"gt_size": 32, "use_hflip": True, "use_rot": True}),
    ("train", {"gt_size": 40, "geometric_augs": True}),
    ("val", {})])
def test_dataset_samples_match_jax(tmp_path, phase, extra):
    opt = dict(_dataset_dir(tmp_path), phase=phase, **extra)
    ours, ref = build_dataset(dict(opt)), jax_build_dataset(dict(opt))
    assert len(ours) == len(ref) == 5
    for i in range(5):
        a = ours.__getitem__(i, rng=random.Random(i))
        b = ref.__getitem__(i, rng=random.Random(i))
        assert a.keys() == b.keys()
        for k in ("lq", "gt"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["lq_path"] == b["lq_path"]


def test_sampler_and_loader_batches_match_jax(tmp_path):
    """EnlargedSampler's indices per epoch and the train loader's batches
    (1 worker: JAX's per-worker random stream) over 2 epochs."""
    for args in ((10, 1, 0, 3, True, 5, 4), (7, 2, 1, 2, True, 1, 3),
                 (6, 1, 0, 1, False, 0, None)):
        ours, ref = EnlargedSampler(*args), JaxSampler(*args)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref) and len(ours) == len(ref)
    opt = dict(_dataset_dir(tmp_path), phase="train", gt_size=32,
               use_hflip=True, use_rot=True, batch_size_per_gpu=2,
               num_worker_per_gpu=1, dataset_enlarge_ratio=2)
    loader, _ = build_dataloader(build_dataset(dict(opt)), dict(opt),
                                 seed=7)
    ref_loader, _ = jax_build_dataloader(jax_build_dataset(dict(opt)),
                                         dict(opt), seed=7)
    assert len(loader) == len(ref_loader) == 5
    ours, ref = InfinitePrefetcher(loader), JaxPrefetcher(ref_loader)
    for step in range(10):  # two epochs of 5 batches
        a, b = ours.next(), ref.next()
        assert ours.epoch == ref.epoch == step // 5
        for k in ("lq", "gt"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=(step, k))
    ours.close()


def test_device_prefetcher_on_cpu_runs_one_batch_ahead():
    """On a CPU device there is no side stream: put runs on the batch one
    step ahead, and the transform sees the consuming step's number."""
    seen = []

    class Source:
        epoch = 0
        n = 0

        def next(self):
            Source.n += 1
            return {"lq": np.full((1, 2, 2, 3), Source.n, np.float32)}

        def close(self):
            pass

    def put(batch):
        return {"lq": torch.from_numpy(batch["lq"])}

    pf = DevicePrefetcher(Source(), put, "cpu",
                          transform=lambda b, seq: seen.append(seq) or b)
    assert pf.stream is None and seen == [1]
    assert pf.next()["lq"][0, 0, 0, 0] == 1 and seen == [1, 2]
    assert pf.next()["lq"][0, 0, 0, 0] == 2


def test_misc_and_options(tmp_path):
    """find_latest_state takes the highest iteration; check_resume points
    pretrain_network_g at the port's .pth; num_gpu resolves to the world
    size (1 without a process group) and an int that differs from it
    raises; --force_yml values are literals."""
    states = tmp_path / "states"
    states.mkdir()
    for name in ("4.state", "12.state", "x.state", "8.state"):
        (states / name).write_text("")
    assert misc.find_latest_state(str(states)) == str(states / "12.state")
    assert misc.find_latest_state(str(tmp_path / "none")) is None
    models = tmp_path / "models"
    models.mkdir()
    (models / "net_g_12.pth").write_text("")
    opt = {"network_g": {}, "path": {"resume_state": "12.state",
                                     "models": str(models)}}
    misc.check_resume(opt, 12)
    assert opt["path"]["pretrain_network_g"] == str(models / "net_g_12.pth")

    opt = options.finalize_options(
        {"name": "x", "num_gpu": "auto", "scale": 4,
         "datasets": {"train": {}, "val_1": {}}}, str(tmp_path))
    assert opt["num_gpu"] == 1 and opt["manual_seed"] >= 1
    assert opt["datasets"]["val_1"] == {"phase": "val", "scale": 4}
    assert opt["path"]["models"] == str(tmp_path / "experiments/x/models")
    with pytest.raises(ValueError, match="differs from the world size 1"):
        options.finalize_options({"name": "x", "num_gpu": 2}, str(tmp_path))
    d = {}
    options.set_nested(d, "train:total_iter", "1e3")
    options.set_nested(d, "train:name", "abc")
    assert d == {"train": {"total_iter": 1000.0, "name": "abc"}}
    misc.set_random_seed(3)
    a = (random.random(), np.random.rand(), torch.rand(1).item())
    misc.set_random_seed(3)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item())
