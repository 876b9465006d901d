"""K2's tensor-core route (`vmambair_torch/csrc/gdfn.cu`) against the JAX
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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from k2_tiles import k2_tiles_fwd, unpack_gdfn_weights

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
    and the width class; fp32 the CUDA-core entry with hid; each passes
    exactly its signature's arguments."""
    calls = []
    monkeypatch.setattr(cuda_effn, "on_cpu", lambda *ts: False)
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
        "vmt_gdfn_residual_f32_fwd", "vmt_gdfn_tanh_nhwc_f32_fwd"]
    for name, args in calls:
        kinds = _build.SIGNATURES[name][:-1]  # the stream: added by launch
        assert len(args) == len(kinds), name
        for k, v in zip(kinds, args):
            assert isinstance(v, float) if k is _build._F else isinstance(
                v, int), name
        if name.endswith("_f32_fwd"):
            assert args[-6:-1] == (2, 40, 5, 7, 106), name
        else:  # B C H W hp cls: class 0 (C <= 48), HT 32
            assert args[-7:-1] == (2, 40, 5, 7, 128, 0), name
