"""K2's tensor-core routes (`vmambair_torch/csrc/gdfn.cu`) against the JAX
package and the port's plain version, on the CPU.

The CUDA kernel runs only on the card. Its arithmetic is modelled here in
torch ops (`tests/k2_tiles.py`): the width class's halo tiles and hidden
tiles over the zero-padded hp, LN(x), the weights and the gate rounded to
x's dtype, fp32 sums in k-steps of 16. The same numpy inputs (seeded
`RandomState`) go through that model, through JAX's `_gdfn_pallas`
(interpret mode, through the public `gdfn_residual_fused`) and through
`gdfn_residual_ref`. Tolerances: fp32 within 1e-5 (the TPU kernel's A&S
erf is off by 1.5e-7; the model takes the true erf); bf16 within the bf16
envelope (rtol 3e-2, atol 5e-2). Also the wrapper's side: the weight
packing against its inverse, the width classes, and the launch arguments
with the launch stubbed.

The fp32 route's model (`k2f_tiles_fwd`: its width class's tiles, fp32
LN(x) and weights, split-TF32 products (Veltkamp's split) in k-steps of 8,
a cluster's partial tiles summed in rank order) is held to JAX's kernel
and to the plain version within the same fp32 1e-5, at C 8 / 48 / 96 /
192 / 384 and ragged C, H and W no multiple of the tiles, at the
wrapper's split and at every split.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from k2_tiles import (h100_resident, k2_tiles_fwd, k2f_tiles_fwd,
                      single_tf32_fwd, split_tf32, tf32,
                      unpack_gdfn_f32_image, unpack_gdfn_weights)

from vmambair_tpu.ops.pallas_effn import gdfn_residual_fused as jax_gdfn
from vmambair_torch import _build
from vmambair_torch.ops import cuda_effn, cuda_probes

torch.set_num_threads(1)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=5e-2)}


def _inputs(b, c, h, w, hid, seed):
    """numpy inputs in K2's layouts: x (B, C, H, W), w_in (2 hid, C),
    w_dw (2 hid, 3, 3), w_out (C, hid)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return [(0.5 * rng.randn(b, c, h, w)).astype(f),
            (1.0 + 0.1 * rng.randn(c)).astype(f),
            (0.1 * rng.randn(c)).astype(f),
            (rng.randn(2 * hid, c) / c ** 0.5).astype(f),
            (0.3 * rng.randn(2 * hid, 3, 3)).astype(f),
            (rng.randn(c, hid) / hid ** 0.5).astype(f)]


def _jax(x, ln_w, ln_b, w_in, w_dw, w_out, dtype):
    """JAX's fused GDFN in interpret mode, in its layouts, x in `dtype`."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = jax_gdfn(jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt),
                   jnp.asarray(ln_w), jnp.asarray(ln_b),
                   jnp.asarray(w_in.T), jnp.asarray(w_dw.transpose(1, 2, 0)),
                   jnp.asarray(w_out.T), eps=1e-5, interpret=True)
    return torch.from_numpy(np.asarray(out.astype(jnp.float32))).permute(
        0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(13, 19), (5, 7)])
@pytest.mark.parametrize("c,hid", [(8, 21), (48, 127)])
def test_k2_tiles_match_jax_and_plain(c, hid, h, w, dtype):
    """The model of K2's order, at C's own width class, against JAX's
    kernel and the plain version."""
    a = _inputs(2, c, h, w, hid, c + h)
    ta = [torch.from_numpy(v) for v in a]
    ta[0] = ta[0].to(dtype)
    got = k2_tiles_fwd(*ta, cls=cuda_effn.k2_class(c))
    assert got.dtype == dtype and got.shape == (2, c, h, w)
    torch.testing.assert_close(got.float(), _jax(*a, dtype), **TOL[dtype])
    torch.testing.assert_close(
        got.float(), cuda_effn.gdfn_residual_ref(*ta).float(), **TOL[dtype])


@pytest.mark.parametrize("cls", range(len(cuda_effn.K2_CLASSES)))
def test_k2_tiles_of_every_class_agree(cls):
    """Every width class's tile and HT gives the same y up to the order of
    fp32 sums (fp32, 1e-5), and bf16 within the envelope of the plain
    version: the class changes how the work is cut, not what it is."""
    a = [torch.from_numpy(v) for v in _inputs(1, 40, 11, 21, 106, 7)]
    ref = cuda_effn.gdfn_residual_ref(*a)
    torch.testing.assert_close(k2_tiles_fwd(*a, cls=cls), ref,
                               **TOL[torch.float32])
    a[0] = a[0].to(torch.bfloat16)
    torch.testing.assert_close(
        k2_tiles_fwd(*a, cls=cls).float(),
        cuda_effn.gdfn_residual_ref(*a).float(), **TOL[torch.bfloat16])


def test_k2_classes_match_the_kernel_source():
    """The wrapper's width classes (largest C, tile, HT) are the kernel's
    `Cls0`..`Cls3` (csrc/gdfn.cu): the packed weights' layout depends on
    them, and nothing here compiles the source to catch a mismatch."""
    import os
    import re

    with open(os.path.join(_build.CSRC, "gdfn.cu")) as f:
        text = f.read()
    found = re.findall(r"using Cls(\d) = Cls<(\d+), (\d+), (\d+), (\d+), "
                       r"(\d+), (\d+), (\d+)>;", text)
    assert [int(n) for n, *_ in found] == list(
        range(len(cuda_effn.K2_CLASSES)))
    for n, th, tw, ht, wm, wmo, ni, minb in found:
        cp = 8 * int(ni) * (8 // int(wmo))   # 8 warps: 8 / WMO along C
        assert (cp, int(th), int(tw), int(ht)) == \
            cuda_effn.K2_CLASSES[int(n)], n


def test_k2_class_takes_the_narrowest_that_fits():
    classes = cuda_effn.K2_CLASSES
    assert [k[0] for k in classes] == sorted(k[0] for k in classes)
    assert classes[-1][0] == cuda_effn.MAX_C
    for c, want in ((1, 0), (48, 0), (49, 1), (96, 1), (97, 2), (192, 2),
                    (193, 3), (384, 3)):
        assert cuda_effn.k2_class(c) == want


@pytest.mark.parametrize("cls", range(len(cuda_effn.K2_CLASSES)))
@pytest.mark.parametrize("c,hid", [(8, 21), (40, 106), (48, 127)])
def test_gdfn_weight_packing_round_trips(c, hid, cls):
    """Unpacking returns the bf16-rounded weights, and every packed entry
    past hid, C or the class's CP is exactly zero; the shapes are the
    kernel's (hp / HT tiles, KP = C rounded up to 16)."""
    cp, _, _, ht = cuda_effn.K2_CLASSES[cls]
    a = [torch.from_numpy(v) for v in _inputs(1, c, 1, 1, hid, c)][3:]
    win_p, wout_p, wdw_p = cuda_effn.pack_gdfn_weights(*a, cls)
    hp, kp = -(-hid // ht) * ht, -(-c // 16) * 16
    assert win_p.shape == (hp // ht, 2 * ht, kp)
    assert wout_p.shape == (hp // ht, cp, ht)
    assert wdw_p.shape == (hp // ht, 2 * ht, 9)
    assert (win_p.dtype, wout_p.dtype, wdw_p.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)
    w_in, w_dw, w_out, pad = unpack_gdfn_weights(win_p, wout_p, wdw_p, c,
                                                 hid)
    bf = torch.bfloat16
    assert torch.equal(w_in, a[0].to(bf))
    assert torch.equal(w_dw, a[1].to(bf).float())
    assert torch.equal(w_out, a[2].to(bf))
    assert pad.numel() == (win_p.numel() + wout_p.numel() + wdw_p.numel()
                           - 2 * hid * c - 2 * hid * 9 - c * hid)
    assert torch.count_nonzero(pad) == 0


def test_gdfn_wrappers_pass_their_signatures(monkeypatch):
    """K2's and keffn's wrappers, with the CPU routing and the launch
    stubbed: bf16 names the tensor-core entry with the packed weights, hp
    and the width class; fp32 the packing kernel, then the fp32 entry with
    hp, the fp32 class and the split (an H100's cluster residency in place
    of the card's count); each passes exactly its signature's arguments."""
    calls = []
    monkeypatch.setattr(cuda_effn, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(cuda_effn, "_resident",
                        lambda dev, nhwc, cls, c, s: h100_resident(cls)(s))
    monkeypatch.setattr(cuda_probes, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *a: calls.append((name, a)))
    a = [torch.from_numpy(v) for v in _inputs(2, 40, 5, 7, 106, 1)]
    for dt in (torch.bfloat16, torch.float32):
        cuda_effn.gdfn_residual_fwd(a[0].to(dt), *a[1:])
        cuda_probes.gdfn_tanh_nhwc(
            a[0].to(dt).permute(0, 2, 3, 1), a[1], a[2], a[3].t(),
            a[4].permute(1, 2, 0), a[5].t())
    assert [c[0] for c in calls] == [
        "vmt_gdfn_residual_fwd", "vmt_gdfn_tanh_nhwc_fwd",
        "vmt_gdfn_f32_pack", "vmt_gdfn_residual_f32_fwd",
        "vmt_gdfn_f32_pack", "vmt_gdfn_tanh_nhwc_f32_fwd"]
    for name, args in calls:
        kinds = _build.SIGNATURES[name][:-1]  # the stream: added by launch
        assert len(args) == len(kinds), name
        for k, v in zip(kinds, args):
            assert isinstance(v, float) if k is _build._F else isinstance(
                v, int), name
        if name == "vmt_gdfn_f32_pack":  # C hid cls
            assert args[-3:] == (40, 106, 0), name
        elif name.endswith("_f32_fwd"):
            # B C H W hp cls split: fp32 class 0 (C <= 48), HT 16, 7 tiles
            # over 2 x 1 blocks, a cluster of 4
            assert args[-8:-1] == (2, 40, 5, 7, 112, 0, 4), name
        else:  # B C H W hp cls: class 0 (C <= 48), HT 32
            assert args[-7:-1] == (2, 40, 5, 7, 128, 0), name


# -- the fp32 route: split TF32 ------------------------------------------------


def test_split_tf32_is_exact_to_2_22():
    """The kernel's split (`split_tf32`): hi has 11 significant bits (TF32
    reads it whole), lo at most 12 before its cut, and a - hi - lo below
    2^-22 of a over six decades; `tf32` drops the low 13 bits toward zero,
    either sign."""
    u = 2.0 ** -10
    v = torch.tensor([1.0, 1 + u / 2, 1 + u + u / 2, -(1 + u + u / 4),
                      0.0, -0.0])
    assert tf32(v).tolist() == [1.0, 1.0, 1 + u, -(1 + u), 0.0, -0.0]
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(1 << 16)
                          * np.exp(3 * rng.randn(1 << 16))).astype(
                              np.float32))
    hi, lo = split_tf32(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    d = x.double() - hi.double()
    assert (d.float().double() == d).all()  # a - hi is exact in fp32
    assert ((d - lo.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


# C at every fp32 width class (8 and 48: Fc0, 96: Fc1, 192: Fc2, 384: Fc3)
# and ragged (40, 72, 136, 264: no multiple of 16 or of the class's width),
# H and W no multiple of the tiles (8 x 16, 8 x 8, 4 x 8)
K2F_CASES = [(8, 13, 19), (48, 13, 19), (96, 9, 17), (192, 11, 10),
             (384, 5, 7), (40, 9, 33), (72, 17, 10), (136, 7, 11),
             (264, 6, 10)]


@pytest.mark.parametrize("c,h,w", K2F_CASES)
def test_k2f_tiles_match_jax_and_plain(c, h, w):
    """The model of K2's fp32 route, at C's own class and the wrapper's
    split, against JAX's kernel (interpret mode) and the plain version,
    fp32 within 1e-5."""
    hid = int(2.66 * c)
    a = _inputs(2, c, h, w, hid, c + h)
    ta = [torch.from_numpy(v) for v in a]
    got = k2f_tiles_fwd(*ta)
    assert got.dtype == torch.float32 and got.shape == (2, c, h, w)
    torch.testing.assert_close(got, _jax(*a, torch.float32),
                               **TOL[torch.float32])
    torch.testing.assert_close(got, cuda_effn.gdfn_residual_ref(*ta),
                               **TOL[torch.float32])


@pytest.mark.parametrize("cut", ["raw fp32", "hi only"])
@pytest.mark.parametrize("c,h,w", [(48, 13, 19), (96, 9, 17), (384, 5, 7)])
def test_single_pass_tf32_misses_the_fp32_bar(c, h, w, cut):
    """The fp32 bar (1e-5) that holds the route's model to JAX's kernel
    tells split TF32 from a single pass: the same inputs with the
    projections' operands cut to TF32, as the tensor core reads raw fp32
    or as the split's hi alone (a kernel that drops the lo terms), miss
    JAX's kernel at that bar where the model holds it."""
    hid = int(2.66 * c)
    a = _inputs(2, c, h, w, hid, c + h)
    ta = [torch.from_numpy(v) for v in a]
    f = tf32 if cut == "raw fp32" else (lambda t: split_tf32(t)[0])
    ref = _jax(*a, torch.float32)
    torch.testing.assert_close(k2f_tiles_fwd(*ta), ref, **TOL[torch.float32])
    with pytest.raises(AssertionError):
        torch.testing.assert_close(single_tf32_fwd(*ta, cut=f), ref,
                                   **TOL[torch.float32])


@pytest.mark.parametrize("cls", range(len(cuda_effn.K2F_CLASSES)))
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_k2f_tiles_of_every_class_and_split_agree(cls, split):
    """Every fp32 class's tiles and every cluster split give the plain
    version's y within fp32 1e-5, the tanh gate too: the class and the
    split change how the work is cut and summed, not what it is (hid 130:
    at least 8 hidden tiles at every class)."""
    a = [torch.from_numpy(v) for v in _inputs(1, 40, 11, 21, 130, 7)]
    torch.testing.assert_close(k2f_tiles_fwd(*a, cls=cls, split=split),
                               cuda_effn.gdfn_residual_ref(*a),
                               **TOL[torch.float32])
    nhwc = [a[0].permute(0, 2, 3, 1), a[1], a[2], a[3].t(),
            a[4].permute(1, 2, 0), a[5].t()]
    torch.testing.assert_close(
        k2f_tiles_fwd(*a, cls=cls, split=split, gate="tanh"),
        cuda_probes.gdfn_tanh_ref(*nhwc).permute(0, 3, 1, 2),
        **TOL[torch.float32])


def test_k2f_classes_match_the_kernel_source():
    """The wrapper's fp32 classes (largest C, tile, HT, blocks an SM) are
    the kernel's `Fc0`..`Fc3` (csrc/gdfn.cu)."""
    import os
    import re

    with open(os.path.join(_build.CSRC, "gdfn.cu")) as f:
        text = f.read()
    found = re.findall(r"using Fc(\d) = FCls<(\d+), (\d+), (\d+), (\d+), "
                       r"(\d+), (\d+), (\d+)(?:, (\d+))?>;", text)
    assert [int(n) for n, *_ in found] == list(
        range(len(cuda_effn.K2F_CLASSES)))
    for n, th, tw, ht, wm, wmo, ni, minb, wk in found:
        cp = 8 * int(ni) * (8 // int(wmo))  # 8 warps: 8 / WMO along C
        assert (cp, int(th), int(tw), int(ht), int(minb), int(wk or 1)) == \
            cuda_effn.K2F_CLASSES[int(n)], n
    assert [k[0] for k in cuda_effn.K2F_CLASSES][-1] == cuda_effn.MAX_C
    for c, want in ((1, 0), (48, 0), (49, 1), (96, 1), (97, 2), (192, 2),
                    (193, 3), (384, 3)):
        assert cuda_effn.k2f_class(c) == want


def test_k2f_split_fills_one_wave():
    """With an H100's cluster residency (`H100_CLUSTERS`), the S1 step's
    two 64 x 64 levels take no cluster (their tiles alone fill the card)
    and clusters of 2, 2 and 4 lift the three small levels to a wave, as
    phase 3 of chip_smoke.py prints on the card; the split never passes 8,
    the hidden tiles, or the clusters the card holds at once."""
    want = {(8, 48, 64, 64): 1, (8, 96, 64, 64): 1, (8, 96, 32, 32): 2,
            (8, 192, 16, 16): 2, (8, 384, 8, 8): 4}
    for (b, c, h, w), split in want.items():
        cls = cuda_effn.k2f_class(c)
        ht = cuda_effn.K2F_CLASSES[cls][3]
        nt = -(-int(2.66 * c) // ht)
        assert cuda_effn.k2f_split(b, h, w, cls, nt,
                                   h100_resident(cls)) == split, c
    for b, h, w, nt in ((1, 1, 1, 3), (1, 1, 1, 64), (2, 100, 100, 8),
                        (1, 8, 16, 2)):
        for cls, (_, th, tw, _, _, _) in enumerate(cuda_effn.K2F_CLASSES):
            resident = h100_resident(cls)
            s = cuda_effn.k2f_split(b, h, w, cls, nt, resident)
            tiles = b * -(-h // th) * -(-w // tw)
            assert s in (1, 2, 4, 8) and s <= nt
            assert s == 1 or tiles <= resident(s)


@pytest.mark.parametrize("c,hid,cls", [
    (c, hid, cls) for cls in range(len(cuda_effn.K2F_CLASSES))
    for c, hid in ((8, 21), (40, 106), (96, 255))
    if c <= cuda_effn.K2F_CLASSES[cls][0]])
def test_gdfn_f32_weight_packing_round_trips(c, hid, cls):
    """The fp32 route's packing (`pack_gdfn_weights` with K2F_CLASSES,
    fp32): unpacking returns the weights bit for bit, every packed entry
    past hid, C or the class's CP is zero, and the shapes are the kernel's
    (hp / HT tiles of the fp32 class's HT, KP = C rounded up to 16); and
    `pack_gdfn_f32_weights` lays those tiles out as the ring slots'
    images."""
    cp, _, _, ht, _, _ = cuda_effn.K2F_CLASSES[cls]
    a = [torch.from_numpy(v) for v in _inputs(1, c, 1, 1, hid, c)][3:]
    win_p, wout_p, wdw_p = cuda_effn.pack_gdfn_weights(
        *a, cls, torch.float32, cuda_effn.K2F_CLASSES)
    hp, kp = -(-hid // ht) * ht, -(-c // 16) * 16
    assert win_p.shape == (hp // ht, 2 * ht, kp)
    assert wout_p.shape == (hp // ht, cp, ht)
    assert wdw_p.shape == (hp // ht, 2 * ht, 9)
    assert {t.dtype for t in (win_p, wout_p, wdw_p)} == {torch.float32}
    w_in, w_dw, w_out, pad = unpack_gdfn_weights(win_p, wout_p, wdw_p, c,
                                                 hid)
    assert torch.equal(w_in, a[0]) and torch.equal(w_dw, a[1])
    assert torch.equal(w_out, a[2])
    assert torch.count_nonzero(pad) == 0
    # the kernel's input: each tile as its ring slot's image, the same
    # tiles at the slot's pitches (KP + 4, HT + 4), the pitch pad zero
    img = cuda_effn.pack_gdfn_f32_weights(*a, cls)
    assert img.dtype == torch.float32 and img.shape == (
        hp // ht, 2 * ht * (kp + 4) + cp * (ht + 4) + 18 * ht)
    assert img.shape[1] * 4 % 16 == 0  # one bulk copy a tile
    *tiles, pitch_pad = unpack_gdfn_f32_image(img, c, cls)
    for got, want in zip(tiles, (win_p, wout_p, wdw_p)):
        assert torch.equal(got, want)
    assert torch.count_nonzero(pitch_pad) == 0
