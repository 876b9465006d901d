"""The port's FID pieces against the JAX package's, on the CPU
(`vmambair_torch/metrics/inception.py`, `fid.py`).

- InceptionV3 pool3 on a seeded `.npz` (`seeded_inception_npz`, read by
  both packages' loaders): 2 x 75x75 without the resize, 64x64 and
  320x320 resized to 299x299 (JAX's antialiased bilinear, the port's
  `resize_to`), within 1e-5 of the largest feature; through both
  `extract_inception_features` at batch 1 likewise.
- `compute_statistics` equal; `calculate_fid` within 1e-10 relative,
  also where `sqrtm` needs the eps retry, and where scipy no longer takes
  `disp`.
- `extract_vgg_features` (VGG19 conv5_4 means), seeded and from an
  `.npz`, within 1e-5 of the largest feature.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vmambair_tpu.metrics import fid as jf
from vmambair_tpu.metrics import inception as ji
from vmambair_torch.losses import perceptual as tp
from vmambair_torch.metrics import fid as tf
from vmambair_torch.metrics import inception as ti

torch.set_num_threads(1)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return ti.seeded_inception_npz(
        str(tmp_path_factory.mktemp("inception") / "inception.npz"), seed=3)


def test_seeded_npz_has_every_module_of_the_checkpoint(npz):
    data = np.load(npz)
    assert len(data.files) == 2 * len(ti.INCEPTION_SPEC) == 2 * 94
    assert data["Mixed_7c.branch_pool/kernel"].shape == (1, 1, 2048, 192)
    assert set(ti.load_inception_params(npz, "cpu")) == set(
        ji.load_inception_params(npz))


@pytest.mark.parametrize("n,hw,resize", [(2, 75, False), (1, 64, True),
                                         (1, 320, True)])
def test_inception_pool3_matches_jax(npz, n, hw, resize):
    imgs = np.random.RandomState(hw).rand(n, hw, hw, 3).astype(np.float32)
    ref = np.asarray(ji.inception_pool3(
        jnp.asarray(imgs), ji.load_inception_params(npz),
        resize_input=resize))
    got = ti.inception_pool3(torch.from_numpy(imgs).permute(0, 3, 1, 2),
                             ti.load_inception_params(npz, "cpu"),
                             resize_input=resize).numpy()
    assert got.shape == ref.shape == (n, 2048)
    assert _rel(got, ref) < 1e-5
    if hw == 75:
        ref_e = jf.extract_inception_features(imgs, npz, resize_input=False,
                                              batch=1)
        got_e = tf.extract_inception_features(imgs, npz, resize_input=False,
                                              batch=1, device="cpu")
        assert _rel(got_e, ref_e) < 1e-5


def test_compute_statistics_and_fid_match_jax(monkeypatch):
    rng = np.random.RandomState(0)
    a = rng.randn(40, 16)
    b = rng.randn(40, 16) * 1.3 + 0.2
    sa, sb = tf.compute_statistics(a), tf.compute_statistics(b)
    for got, ref in zip(sa + sb, jf.compute_statistics(a)
                        + jf.compute_statistics(b)):
        np.testing.assert_array_equal(got, ref)
    ref = jf.calculate_fid(*sa, *sb)
    assert tf.calculate_fid(*sa, *sb) == pytest.approx(ref, rel=1e-10)
    # singular covariances (fewer samples than dimensions): the eps retry
    c, d = rng.rand(4, 24), rng.rand(4, 24) + 0.1
    sc, sd = tf.compute_statistics(c), tf.compute_statistics(d)
    assert tf.calculate_fid(*sc, *sd) == pytest.approx(
        jf.calculate_fid(*sc, *sd), rel=1e-10)
    # a scipy whose sqrtm no longer takes `disp`
    from scipy import linalg
    real = linalg.sqrtm

    def sqrtm(m, **kw):
        if kw:
            raise TypeError("sqrtm() got an unexpected keyword argument "
                            "'disp'")
        return real(m, disp=False)[0]

    monkeypatch.setattr(linalg, "sqrtm", sqrtm)
    assert tf.calculate_fid(*sa, *sb) == pytest.approx(ref, rel=1e-10)


@pytest.mark.parametrize("weights", [False, True])
def test_extract_vgg_features_matches_jax(weights, tmp_path):
    path = None
    if weights:
        rng = np.random.RandomState(9)
        arrays, c_in = {}, 3
        for item in tp.VGG19_LAYERS:
            if item == "M":
                continue
            name, c = item
            arrays[f"{name}/kernel"] = (rng.randn(3, 3, c_in, c) * np.sqrt(
                2 / (9 * c_in))).astype(np.float32)
            arrays[f"{name}/bias"] = (rng.randn(c) * 0.01).astype(np.float32)
            c_in = c
        path = str(tmp_path / "vgg19.npz")
        np.savez(path, **arrays)
    imgs = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    ref = jf.extract_vgg_features(imgs, path)
    got = tf.extract_vgg_features(imgs, path, device="cpu")
    assert got.shape == ref.shape == (2, 512)
    assert _rel(got, ref) < 1e-5
