"""The port's degradation ops (`vmambair_torch/ops/degradation.py`) against
the JAX package's (`vmambair_tpu/ops/degradation.py`), on CPU.

Each op gets the same seeded numpy inputs on both sides and, where it is
random, JAX's own draws, rebuilt from the same keys (the Gaussian samples
passed in; the Poisson samples drawn by `jax.random.poisson` from JAX's
key at the port's rates, through `JaxSampler`). Images are NHWC on the JAX
side and NCHW in the port. Tolerances (fp32):

- `filter2d`, the resampling matrices (against JAX's own
  `compute_weight_mat`), `resize_to`, `random_resize`,
  `random_resize_back`, Gaussian noise, and everything before a round:
  atol 2e-6 / 1e-5 on values in [0, 1];
- `poisson_levels`: exact;
- the USM sharpener's hard mask (`|residual| * 255 > 10`) must agree
  everywhere, and its output within 1e-5;
- Poisson noise: the samples of one key agree where the rates agree to
  the bit; the output within 1e-6 of JAX's at every element whose sample
  agrees, and the share of elements whose sample differs (a rate one ulp
  across a threshold of JAX's sampler) at most 1e-3;
- JPEG's round(coefficient / step): the ratios within 1e-4 of JAX's
  (values up to a few hundred); a rounded coefficient may differ from
  JAX's only where JAX's ratio lies within 1e-4 of a half-integer (a
  tie the two sums break differently), at most 1e-3 of them, the
  measured share printed; given JAX's rounded coefficients, the port's
  decode gives JAX's output within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import (
    _fill_keys_cubic_kernel,
    _fill_triangle_kernel,
    compute_weight_mat,
)

import vmambair_tpu.ops.degradation as jd
from realsr_cases import JaxSampler, nchw, nhwc
from vmambair_torch.ops import degradation as td

torch.set_num_threads(1)
# jitted once per shape: the scale and the mode are traced, as in JAX's
# synthesis, so that one compile serves every case of a shape
J_RESIZE = jax.jit(jd.random_resize)
J_RESIZE_BACK = jax.jit(jd.random_resize_back, static_argnums=3)
J_RESIZE_TO = jax.jit(jd.resize_to, static_argnums=1)
J_WEIGHTS = jax.jit(compute_weight_mat, static_argnums=(0, 1, 4, 5))


def _t(x):
    return torch.from_numpy(np.array(x))


def _img(seed, b=2, h=32, w=40, c=3):
    return np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)


def _close(got, ref, atol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= atol, err
    return err


def test_filter2d_matches_jax():
    img = _img(0)
    kern = np.random.RandomState(1).rand(2, 21, 21).astype(np.float32)
    kern /= kern.sum((1, 2), keepdims=True)
    ref = jd.filter2d(jnp.asarray(img), jnp.asarray(kern))
    got = td.filter2d(nchw(img), torch.from_numpy(kern))
    _close(nhwc(got), ref, 2e-6)


def test_usm_sharp_matches_jax():
    """The separable blur against JAX's 51x51 one: the residual and the
    hard mask agree, the output within 1e-5."""
    img = _img(2, h=64, w=64)
    ref = np.asarray(jd.usm_sharp(jnp.asarray(img)))
    got = nhwc(td.usm_sharp(nchw(img)))
    g = td.usm_kernel(50)
    k2 = np.outer(g.numpy(), g.numpy())
    blur_j = np.asarray(jd.filter2d(jnp.asarray(img), jnp.broadcast_to(
        jnp.asarray(k2), (2, 51, 51))))
    blur_t = nhwc(td._gauss_blur(nchw(img), g))
    _close(blur_t, blur_j, 2e-6)
    assert np.array_equal(np.abs(img - blur_t) * 255 > 10,
                          np.abs(img - blur_j) * 255 > 10)
    _close(got, ref, 1e-5)


KERNELS = {"linear": _fill_triangle_kernel, "cubic": _fill_keys_cubic_kernel}


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("n_in,n_out,scale", [
    (64, 64, 0.15), (64, 64, 0.731), (64, 64, 1.0), (64, 64, 1.5),
    (40, 16, 0.4), (16, 64, 4.0), (100, 25, 0.23)])
def test_resize_weights_match_jax(n_in, n_out, scale, method, antialias):
    """The (out, in) matrix against JAX's (in, out) `compute_weight_mat`
    for a traced fp32 scale."""
    ref = J_WEIGHTS(n_in, n_out, jnp.float32(scale), jnp.float32(0),
                    KERNELS[method], antialias)
    inv = float(np.float32(1) / np.float32(scale))
    got = td.resize_weights(n_in, n_out, inv, method, antialias)
    _close(got.numpy().T, ref, 2e-6)


@pytest.mark.parametrize("method_idx", [0, 1, 2])
@pytest.mark.parametrize("out_hw", [(16, 20), (48, 60), (32, 13)])
def test_resize_to_matches_jax(out_hw, method_idx):
    img = _img(3)
    ref = J_RESIZE_TO(jnp.asarray(img), out_hw, jnp.int32(method_idx))
    got = td.resize_to(nchw(img), out_hw, method_idx)
    _close(nhwc(got), ref, 1e-5)


@pytest.mark.parametrize("method_idx", [0, 1, 2])
@pytest.mark.parametrize("scale", [0.15, 0.62, 1.0, 1.2, 1.5])
def test_random_resizes_match_jax(scale, method_idx):
    """Down and up on the fixed canvas, then back to the canvas and to
    a quarter of it (the LQ grid)."""
    img = _img(4)
    s = jnp.float32(scale)
    m = jnp.int32(method_idx)
    ref = J_RESIZE(jnp.asarray(img), s, m)
    got = td.random_resize(nchw(img), float(s), method_idx)
    _close(nhwc(got), ref, 1e-5)
    for out_hw in ((32, 40), (8, 10)):
        ref_b = J_RESIZE_BACK(ref, s, m, out_hw)
        got_b = td.random_resize_back(got, float(s), method_idx, out_hw)
        _close(nhwc(got_b), ref_b, 1e-5)


def test_gaussian_noise_matches_jax():
    img = _img(5)
    key = jax.random.PRNGKey(3)
    sigma = jnp.asarray([0.02, 0.1], jnp.float32)
    gray = jnp.asarray([True, False])
    ref = jd.add_gaussian_noise(key, jnp.asarray(img), sigma, gray)
    k1, k2 = jax.random.split(key)
    got = td.add_gaussian_noise(
        nchw(img), _t(sigma),
        _t(gray),
        nchw(jax.random.normal(k1, img.shape)),
        nchw(jax.random.normal(k2, img.shape[:3] + (1,))))
    _close(nhwc(got), ref, 1e-6)


def test_poisson_levels_match_jax():
    rng = np.random.RandomState(6)
    q = np.stack([rng.randint(0, 256, (3, 20, 20)),
                  rng.randint(0, 37, (3, 20, 20)),
                  np.full((3, 20, 20), 7), rng.randint(0, 2, (3, 20, 20))])
    ref = np.asarray(jd._poisson_levels(jnp.asarray(q, jnp.int32)))
    got = td.poisson_levels(torch.from_numpy(q).int()).numpy()
    assert np.array_equal(got, ref), (got, ref)
    assert got.tolist() == [256.0, 64.0, 1.0, 2.0]


def test_poisson_noise_matches_jax():
    img = _img(7, h=48, w=48)
    key = jax.random.PRNGKey(4)
    scale = jnp.asarray([0.5, 2.5], jnp.float32)
    gray = jnp.asarray([False, True])
    ref = np.asarray(jd.add_poisson_noise(key, jnp.asarray(img), scale,
                                          gray))
    k1, k2 = jax.random.split(key)
    got = nhwc(td.add_poisson_noise(
        nchw(img), _t(scale),
        _t(gray),
        JaxSampler(keys={"p": k1, "p_gray": k2}), "p"))
    off = np.abs(got - ref) > 1e-6
    share = float(off.mean())
    print(f"poisson: {int(off.sum())} of {off.size} elements off "
          f"(share {share:.2e})")
    assert share <= 1e-3


class RoundRecorder:
    """A `round_fn` for `td.jpeg_compress`: keeps each plane's ratios
    (y, cb, cr) and returns `given[i]` where given, else torch.round."""

    def __init__(self, given=None):
        self.ratios, self.given = [], given

    def __call__(self, ratio):
        self.ratios.append(ratio)
        if self.given is not None:
            return torch.from_numpy(np.asarray(
                self.given[len(self.ratios) - 1]))
        return torch.round(ratio)


def jax_jpeg_ratios(img, quality):
    """JAX's coefficient / step of each plane, from the JAX package's own
    JPEG helpers, in `jd.jpeg_compress`'s order."""
    b, h, w, _ = img.shape
    factor = jd._quality_factor(quality)[:, None, None, None, None]
    dct = jd._dct_matrix()
    ycc = jd._rgb_to_ycbcr_jpeg(img) * 255.0
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    cb = cb.reshape(b, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    cr = cr.reshape(b, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    out = []
    for chan, table in ((y, jd._Y_TABLE), (cb, jd._C_TABLE),
                        (cr, jd._C_TABLE)):
        blocks = jd._blockify(chan - 128.0)
        coefs = jnp.einsum("ij,bhwjk,lk->bhwil", dct, blocks, dct)
        q = jnp.clip(jnp.floor(table * factor + 0.5), 1, 255)
        out.append(np.asarray(coefs / q))
    return out


@pytest.mark.parametrize("quality", [30.0, 95.0])
def test_jpeg_matches_jax(quality):
    img = jnp.asarray(_img(8, h=48, w=64))
    qual = jnp.asarray([quality, quality * 0.9], jnp.float32)
    ref = np.asarray(jd.jpeg_compress(img, qual))
    rec = RoundRecorder()
    got = nhwc(td.jpeg_compress(nchw(img), _t(qual), rec))
    ratios_j = jax_jpeg_ratios(img, qual)
    flips = total = 0
    for rt, rj in zip(rec.ratios, ratios_j):
        rt = rt.numpy()
        _close(rt, rj, 1e-4)
        flip = np.round(rt) != np.round(rj)
        tie = np.abs(np.abs(rj - np.floor(rj)) - 0.5) <= 1e-4
        assert not (flip & ~tie).any()
        flips, total = flips + int(flip.sum()), total + flip.size
    print(f"jpeg q={quality}: {flips} of {total} coefficients round "
          f"the other way")
    assert flips <= 1e-3 * total
    # the decode, from JAX's rounded coefficients
    given = RoundRecorder([np.round(r) for r in ratios_j])
    dec = nhwc(td.jpeg_compress(nchw(img), _t(qual), given))
    _close(dec, ref, 1e-5)
    if flips == 0:
        _close(got, ref, 1e-5)


def test_jpeg_padded_matches_jax():
    """A size no multiple of 16: edge padding, then the crop back."""
    img = jnp.asarray(_img(9, h=40, w=36))
    qual = jnp.asarray([60.0, 80.0], jnp.float32)
    ref = np.asarray(jd.jpeg_compress_padded(img, qual))
    got = nhwc(td.jpeg_compress_padded(nchw(img), _t(qual)))
    off = np.abs(got - ref) > 1e-5
    assert got.shape == ref.shape and off.mean() <= 0.01, off.mean()
