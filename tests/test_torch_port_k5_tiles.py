"""K5's tensor-core route (`vmambair_torch/csrc/oss_front.cu`) against the
JAX package and the port's plain version, on the CPU.

The CUDA kernel runs only on the card. Its arithmetic is modelled here in
torch ops (`tests/k5_tiles.py`): the width class's halo tiles and channel
tiles over the zero-padded E, LN(x), the weights and the biases rounded to
x's dtype, fp32 sums in k-steps of 16, the x-half zeroed outside the image
after its bias, the taps in (dy, dx) order, the z-half from the tile's own
pixels only. The same numpy inputs (seeded `RandomState`) go through that
model, through JAX's `oss_front_fused` (interpret mode) where W is a
multiple of 8 and JAX's composite `_oss_front_xla` otherwise, and through
`oss_front_ref`. Tolerances: fp32 within 1e-5; bf16 within the bf16
envelope (rtol 3e-2, atol 5e-2). Also the wrapper's side: the weight
packing against its inverse, the width classes, and the launch arguments
with the launch stubbed.

The fp32 route (split TF32 on the tensor cores) has a model of its own
(`k5_tiles.k5f_tiles_fwd`: the fp32 class's tiles, fp32 LN(x), the
weights read from the packed images, `k2_tiles.ksum3`'s lo.hi + hi.lo +
hi.hi per k-step of 8), held to JAX and the plain version within fp32
1e-5 at every fp32 class, k-slices included; a single-pass TF32 product
misses that bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from k2_tiles import split_tf32, tf32
from k5_tiles import (k5_tiles_fwd, k5f_tiles_fwd, single_tf32_front,
                      unpack_front_f32_image, unpack_front_weights)

from vmambair_tpu.ops import pallas_effn as jax_effn
from vmambair_torch import _build
from vmambair_torch.ops import cuda_effn

torch.set_num_threads(1)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=5e-2)}


def _inputs(b, c, e, h, w, seed):
    """numpy inputs in K5's layouts: x (B, C, H, W), ln_w, ln_b (C,), w_in
    (2E, C), b_in (2E,), w_dw (E, 3, 3), b_dw (E,)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return [(0.5 * rng.randn(b, c, h, w)).astype(f),
            (1.0 + 0.1 * rng.randn(c)).astype(f),
            (0.1 * rng.randn(c)).astype(f),
            (rng.randn(2 * e, c) / c ** 0.5).astype(f),
            (0.3 * rng.randn(2 * e)).astype(f),
            (rng.randn(e, 3, 3) / 3).astype(f),
            (0.3 * rng.randn(e)).astype(f)]


def _jax(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, dtype):
    """JAX's OSS front in its layouts, x in `dtype`: the Pallas kernel in
    interpret mode where W is a multiple of 8 (its TPU gate), else the
    composite. Returns (xs, z) NCHW fp32."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    e = w_dw.shape[0]
    args = dict(x=jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt),
                ln_w=jnp.asarray(ln_w), ln_b=jnp.asarray(ln_b),
                w_x=jnp.asarray(w_in[:e].T), b_x=jnp.asarray(b_in[:e]),
                w_z=jnp.asarray(w_in[e:].T), b_z=jnp.asarray(b_in[e:]),
                w_dw=jnp.asarray(w_dw.transpose(1, 2, 0)),
                b_dw=jnp.asarray(b_dw))
    if x.shape[3] % 8 == 0:
        outs = jax_effn.oss_front_fused(**args, eps=1e-5, interpret=True)
    else:
        outs = jax_effn._oss_front_xla(**args, eps=1e-5)
    return [torch.from_numpy(np.array(o.astype(jnp.float32))).permute(
        0, 3, 1, 2) for o in outs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,e,h,w", [(8, 8, 13, 16), (20, 36, 9, 7),
                                     (40, 24, 10, 24), (100, 72, 11, 9),
                                     (200, 40, 5, 8)])
def test_k5_tiles_match_jax_and_plain(c, e, h, w, dtype):
    """The model of K5's order, at C's own width class (classes 0, 0, 1,
    2, 3; E != C; C no multiple of 16; odd W; H and W no multiple of the
    tiles), against JAX and the plain version."""
    a = _inputs(2, c, e, h, w, c + e + h)
    ta = [torch.from_numpy(v) for v in a]
    ta[0] = ta[0].to(dtype)
    got = k5_tiles_fwd(*ta, cls=cuda_effn.k5_class(c))
    ref = cuda_effn.oss_front_ref(*ta)
    for name, g, j, r in zip(("xs", "z"), got, _jax(*a, dtype), ref):
        assert g.dtype == dtype and g.shape == (2, e, h, w), name
        torch.testing.assert_close(g.float(), j, **TOL[dtype], msg=name)
        torch.testing.assert_close(g.float(), r.float(), **TOL[dtype],
                                   msg=name)


@pytest.mark.parametrize("cls", range(len(cuda_effn.K5_CLASSES)))
def test_k5_tiles_of_every_class_agree(cls):
    """Every width class's tile and ET gives the same (xs, z) up to the
    order of fp32 sums (fp32, 1e-5), and bf16 within the envelope of the
    plain version, at batch 1 with E past one channel tile: the class
    changes how the work is cut, not what it is."""
    a = [torch.from_numpy(v) for v in _inputs(1, 40, 52, 11, 21, 7)]
    for dtype in (torch.float32, torch.bfloat16):
        a[0] = a[0].to(dtype)
        for g, r in zip(k5_tiles_fwd(*a, cls=cls),
                        cuda_effn.oss_front_ref(*a)):
            torch.testing.assert_close(g.float(), r.float(), **TOL[dtype])


def test_k5_classes_match_the_kernel_source():
    """The wrapper's width classes (largest C, tile, ET) are the kernel's
    `Fc0`..`Fc3` (csrc/oss_front.cu): the packed weights' layout depends
    on them, and nothing here compiles the source to catch a mismatch."""
    import os
    import re

    with open(os.path.join(_build.CSRC, "oss_front.cu")) as f:
        text = f.read()
    found = re.findall(r"using Fc(\d) = Fcls<(\d+), (\d+), (\d+)>;\s*"
                       r"// C <= (\d+)", text)
    assert [int(n) for n, *_ in found] == list(
        range(len(cuda_effn.K5_CLASSES)))
    for n, th, tw, et, cmax in found:
        assert (int(cmax), int(th), int(tw), int(et)) == \
            cuda_effn.K5_CLASSES[int(n)], n


def test_k5_class_takes_the_narrowest_that_fits():
    classes = cuda_effn.K5_CLASSES
    assert [k[0] for k in classes] == sorted(k[0] for k in classes)
    assert classes[-1][0] == cuda_effn.FRONT_MAX_C
    for c, want in ((1, 0), (48, 0), (49, 1), (96, 1), (97, 2), (192, 2),
                    (193, 3), (384, 3), (704, 3)):
        assert cuda_effn.k5_class(c) == want


@pytest.mark.parametrize("cls", range(len(cuda_effn.K5_CLASSES)))
@pytest.mark.parametrize("c,e", [(8, 8), (40, 52), (96, 96), (20, 70)])
def test_front_weight_packing_round_trips(c, e, cls):
    """Unpacking returns the bf16-rounded weights and biases, and every
    packed entry past E or C is exactly zero; the shapes are the kernel's
    (ep / ET tiles, KP = C rounded up to 16, 12 values a channel)."""
    et = cuda_effn.K5_CLASSES[cls][3]
    a = [torch.from_numpy(v) for v in _inputs(1, c, e, 1, 1, c + e)][3:]
    win_p, aux_p = cuda_effn.pack_front_weights(*a, cls)
    ep, kp = -(-e // et) * et, -(-c // 16) * 16
    assert win_p.shape == (ep // et, 2 * et, kp)
    assert aux_p.shape == (ep // et, et, cuda_effn.K5_AUX)
    assert (win_p.dtype, aux_p.dtype) == (torch.bfloat16, torch.float32)
    w_in, b_in, w_dw, b_dw, pad = unpack_front_weights(win_p, aux_p, c, e)
    bf = torch.bfloat16
    assert torch.equal(w_in, a[0].to(bf))
    for got, want in ((b_in, a[1]), (w_dw, a[2]), (b_dw, a[3])):
        assert torch.equal(got, want.to(bf).float())
    assert pad.numel() == (win_p.numel() + aux_p.numel() - 2 * e * c
                           - 12 * e)
    assert torch.count_nonzero(pad) == 0


def test_front_wrapper_passes_its_signatures(monkeypatch):
    """K5's wrapper, with the CPU routing and the launch stubbed: bf16
    names the tensor-core entry with the packed weights and the width
    class; fp32 the packing kernel, then the fp32 entry with the images and
    the fp32 class; each passes exactly its signature's arguments."""
    calls = []
    monkeypatch.setattr(cuda_effn, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *a: calls.append((name, a)))
    a = [torch.from_numpy(v) for v in _inputs(2, 136, 40, 5, 7, 1)]
    for dt in (torch.bfloat16, torch.float32):
        xs, z = cuda_effn.oss_front_fwd(a[0].to(dt), *a[1:])
        assert xs.shape == z.shape == (2, 40, 5, 7) and xs.dtype == dt
    assert [c[0] for c in calls] == ["vmt_oss_front_fwd",
                                     "vmt_oss_front_f32_pack",
                                     "vmt_oss_front_f32_fwd"]
    for name, args in calls:
        kinds = _build.SIGNATURES[name][:-1]  # the stream: added by launch
        assert len(args) == len(kinds), name
        for k, v in zip(kinds, args):
            assert isinstance(v, float) if k is _build._F else isinstance(
                v, int), name
        if name == "vmt_oss_front_fwd":  # B C E H W cls: class 2 (C <= 192)
            assert args[-7:-1] == (2, 136, 40, 5, 7, 2), name
        elif name == "vmt_oss_front_f32_pack":  # C E cls: fp32 class 2
            assert args[-3:] == (136, 40, 2), name
        else:  # B C E H W cls
            assert args[-7:-1] == (2, 136, 40, 5, 7, 2), name


# -- the fp32 route: split TF32 ------------------------------------------------

# C at every fp32 width class (8, 20, 40: Ff0; 96: Ff1; 100, 136: Ff2; 200
# and 400: Ff3, in 2 and 4 k-slices), E != C, ragged H and W, odd W
K5F_SHAPES = [(8, 8, 13, 16), (20, 36, 9, 7), (40, 24, 10, 24),
              (96, 100, 8, 16), (100, 72, 11, 9), (136, 40, 7, 8),
              (200, 40, 5, 8), (400, 20, 5, 9)]


@pytest.mark.parametrize("c,e,h,w", K5F_SHAPES)
def test_k5f_tiles_match_jax_and_plain(c, e, h, w):
    """The model of K5's fp32 route at C's own class, against JAX (its
    kernel in interpret mode where W is a multiple of 8, else its
    composite) and the plain version, fp32 within 1e-5."""
    a = _inputs(2, c, e, h, w, c + e + h)
    ta = [torch.from_numpy(v) for v in a]
    got = k5f_tiles_fwd(*ta)
    ref = cuda_effn.oss_front_ref(*ta)
    for name, g, j, r in zip(("xs", "z"), got, _jax(*a, torch.float32),
                             ref):
        assert g.dtype == torch.float32 and g.shape == (2, e, h, w), name
        torch.testing.assert_close(g, j, **TOL[torch.float32], msg=name)
        torch.testing.assert_close(g, r, **TOL[torch.float32], msg=name)


@pytest.mark.parametrize("cut", ["raw fp32", "hi only"])
@pytest.mark.parametrize("c,e,h,w", [(40, 24, 10, 24), (200, 40, 5, 8)])
def test_k5f_single_pass_tf32_misses_the_fp32_bar(c, e, h, w, cut):
    """The fp32 bar (1e-5) that holds the route's model to JAX and the
    plain version is one a single TF32 pass misses: the in_conv's
    operands cut to TF32 as the tensor core reads raw fp32, or a split
    that keeps only hi; the split's three products are what hold it."""
    ta = [torch.from_numpy(v) for v in _inputs(2, c, e, h, w, c + e + h)]
    f = tf32 if cut == "raw fp32" else (lambda t: split_tf32(t)[0])
    ref = cuda_effn.oss_front_ref(*ta)
    for g, r in zip(single_tf32_front(*ta, cut=f), ref):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(g, r, **TOL[torch.float32])


@pytest.mark.parametrize("cls", range(len(cuda_effn.K5F_CLASSES)))
def test_k5f_tiles_of_every_class_agree(cls):
    """Every fp32 class's tile, ET and k-slices give the plain version's
    (xs, z) within fp32 1e-5, at batch 1 with E past one channel tile:
    the class changes how the work is cut, not what it is."""
    a = [torch.from_numpy(v) for v in _inputs(1, 40, 52, 11, 21, 7)]
    for g, r in zip(k5f_tiles_fwd(*a, cls=cls),
                    cuda_effn.oss_front_ref(*a)):
        torch.testing.assert_close(g, r, **TOL[torch.float32])


def test_k5f_classes_match_the_kernel_source():
    """The wrapper's fp32 classes (largest C, tile, ET, KS) are the
    kernel's `Ff0`..`Ff3` (csrc/oss_front.cu): the images' layout depends
    on them."""
    import os
    import re

    with open(os.path.join(_build.CSRC, "oss_front.cu")) as f:
        text = f.read()
    found = re.findall(r"using Ff(\d) = FCls<(\d+), (\d+), (\d+), (\d+), "
                       r"(\d+)>;\s*// C <= (\d+)", text)
    assert [int(n) for n, *_ in found] == list(
        range(len(cuda_effn.K5F_CLASSES)))
    for n, th, tw, et, ks, _, cmax in found:
        assert (int(cmax), int(th), int(tw), int(et), int(ks)) == \
            cuda_effn.K5F_CLASSES[int(n)], n
    assert re.search(r"constexpr int FRONT_MAX_C = (\d+);", text).group(
        1) == str(cuda_effn.FRONT_MAX_C)


def test_k5f_class_takes_the_narrowest_that_fits():
    classes = cuda_effn.K5F_CLASSES
    assert [k[0] for k in classes] == sorted(k[0] for k in classes)
    assert classes[-1][0] == cuda_effn.FRONT_MAX_C
    for c, want in ((1, 0), (48, 0), (49, 1), (96, 1), (97, 2), (192, 2),
                    (193, 3), (704, 3)):
        assert cuda_effn.k5f_class(c) == want
    # KS covers each class below the widest in one slice
    for cls, (cmax, _, _, _, ks) in enumerate(classes[:-1]):
        assert cuda_effn.k5f_slices(cmax, cls) == [ks]
    assert cuda_effn.k5f_slices(704, 3) == [128] * 5 + [64]
    assert cuda_effn.k5f_slices(200, 3) == [128, 80]


@pytest.mark.parametrize("c,e,cls", [
    (c, e, cls) for cls in range(len(cuda_effn.K5F_CLASSES))
    for c, e in ((8, 8), (40, 52), (96, 96), (20, 70), (300, 20))
    if c <= cuda_effn.K5F_CLASSES[cls][0]])
def test_front_f32_weight_packing_round_trips(c, e, cls):
    """The fp32 route's images (`pack_front_f32_weights`): unpacking
    returns the weights and biases bit for bit, every entry past E or C
    and every row's 4-float pitch pad is exactly zero, and the shapes are
    the kernel's (ceil(E / ET) images of `k5f_tile` floats)."""
    et = cuda_effn.K5F_CLASSES[cls][3]
    a = [torch.from_numpy(v) for v in _inputs(1, c, e, 1, 1, c + e)][3:]
    img = cuda_effn.pack_front_f32_weights(*a, cls)
    assert img.dtype == torch.float32
    assert img.shape == (-(-e // et), cuda_effn.k5f_tile(c, cls))
    win_p, aux_p, pitch = unpack_front_f32_image(img, c, cls)
    assert win_p.shape == (-(-e // et), 2 * et, -(-c // 16) * 16)
    w_in, b_in, w_dw, b_dw, pad = unpack_front_weights(win_p, aux_p, c, e)
    for got, want in ((w_in, a[0]), (b_in, a[1]), (w_dw, a[2]),
                      (b_dw, a[3])):
        assert torch.equal(got, want)
    assert torch.count_nonzero(pad) == 0
    assert torch.count_nonzero(pitch) == 0
