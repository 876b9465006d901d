"""K6's redesigned kernel (`vmambair_torch/csrc/oss_tail.cu`) against the
JAX package and the port's plain version, on the CPU.

The CUDA kernel runs only on the card. Its arithmetic is modelled here in
torch ops (`tests/k6_tiles.py`: the launch plan, the tile walk, the
swizzled shared layout, the rounding points and the order of the
statistics). The same numpy inputs (seeded `RandomState`) go through that
model, through JAX's `oss_tail_fused(interpret=True)` (the Pallas kernel
in interpret mode) and through `oss_tail_ref`, at every width class, at
ragged H and W, in each dtype pair the kernel has an instance for.
Tolerances: an fp32 output within 1e-5 (the statistics sum in another
order in each); a bf16 output within two of its ulps (2^-6 relative), as
`test_torch_port_front_tail.py` holds the plain version: the order can
flip the bf16 rounding of LN(.) by one ulp, and the gate rounds once more.
Also the plan (class, tile, split) at the main path's shapes, the class
table against the source, the shared layout (a permutation, its accesses
on distinct bank groups) and the wrapper's launch arguments.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from k6_tiles import NTH, chunk, consts, k6_tiles_fwd, plan, shared_index

from vmambair_tpu.ops import pallas_effn as jax_effn
from vmambair_torch import _build
from vmambair_torch.ops import cuda_effn

torch.set_num_threads(1)
PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16)]


def _tol(zdtype):
    return (dict(rtol=1e-5, atol=1e-5) if zdtype == torch.float32
            else dict(rtol=2 ** -6, atol=2 ** -6))


def _inputs(b, d, h, w, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    z = rng.randn(b, d, h, w).astype(f)
    return [(0.7 * rng.randn(b, 2, d, h * w)).astype(f),
            (z / (1 + np.exp(-z))).astype(f),
            (1 + 0.1 * rng.randn(d)).astype(f), (0.1 * rng.randn(d)).astype(f)]


def _jax(y, z, lw, lb, ydtype, zdtype):
    """JAX's Pallas tail in interpret mode, its (B, H, W, D) layouts built
    from the scans' (B, 2, D, L) sum; NCHW fp32 back."""
    b, d, h, w = z.shape
    jy = jnp.bfloat16 if ydtype == torch.bfloat16 else jnp.float32
    jz = jnp.bfloat16 if zdtype == torch.bfloat16 else jnp.float32
    out = jax_effn.oss_tail_fused(
        jnp.asarray(y[:, 0].reshape(b, d, h, w).transpose(0, 2, 3, 1)
                    ).astype(jy),
        jnp.asarray(y[:, 1].reshape(b, d, w, h).transpose(0, 3, 2, 1)
                    ).astype(jy),
        jnp.asarray(z.transpose(0, 2, 3, 1)).astype(jz), jnp.asarray(lw),
        jnp.asarray(lb), eps=1e-5, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).permute(
        0, 3, 1, 2)


# (b, d, h, w): the wide tile with its channels split four ways (D = 40),
# partial tiles (24 x 40), width classes 1 (160), 2 (200, ragged 13 x 19)
# and 3 (768, a cluster of 16)
SHAPES = [(2, 40, 16, 24), (1, 96, 24, 40), (1, 160, 16, 16),
          (1, 200, 13, 19), (1, 768, 8, 8)]


@pytest.mark.parametrize("ydtype,zdtype", PAIRS)
@pytest.mark.parametrize("b,d,h,w", SHAPES)
def test_k6_tiles_match_jax_and_plain(b, d, h, w, ydtype, zdtype):
    y, z, lw, lb = _inputs(b, d, h, w, d + h)
    got = k6_tiles_fwd(torch.from_numpy(y).to(ydtype),
                       torch.from_numpy(z).to(zdtype), torch.from_numpy(lw),
                       torch.from_numpy(lb))
    assert got.dtype == zdtype and got.shape == (b, d, h, w)
    ref = cuda_effn.oss_tail_ref(torch.from_numpy(y).to(ydtype),
                                 torch.from_numpy(z).to(zdtype),
                                 torch.from_numpy(lw), torch.from_numpy(lb))
    torch.testing.assert_close(got.float(), ref.float(), **_tol(zdtype))
    torch.testing.assert_close(got.float(),
                               _jax(y, z, lw, lb, ydtype, zdtype),
                               **_tol(zdtype))


def test_k6_classes_match_the_kernel_source():
    """The wrapper's width classes (largest D, least split), the wide
    tile's budget, the largest cluster and the block's threads are the
    kernel's (csrc/oss_tail.cu): the split the wrapper passes must be one
    the kernel takes, and nothing here compiles the source."""
    with open(os.path.join(_build.CSRC, "oss_tail.cu")) as f:
        text = f.read()

    def ints(name):
        body = re.search(rf"constexpr int {name}\[\] = {{([^}}]*)}};",
                         text).group(1)
        return [int(v) for v in body.split(",")]

    assert list(zip(ints("CLASS_D"), ints("CLASS_SPLIT"))) == list(
        cuda_effn.K6_CLASSES)
    assert cuda_effn.K6_CLASSES[-1][0] == cuda_effn.TAIL_MAX_C
    for name, want in (("WIDE_BYTES", cuda_effn.K6_WIDE_BYTES),
                       ("MAX_SPLIT", cuda_effn.K6_MAX_SPLIT),
                       ("NTH", NTH)):
        assert int(re.search(rf"constexpr (?:long long|int) {name} = (\d+);",
                             text).group(1)) == want, name


def test_k6_class_takes_the_narrowest_that_fits():
    for d, want in ((1, 0), (96, 0), (97, 1), (192, 1), (193, 2), (384, 2),
                    (385, 3), (768, 3)):
        assert cuda_effn.k6_class(d) == want


def test_k6_plan_at_the_main_path_shapes():
    """(tile, split) at the served forward's five bf16 shapes and the S1
    step's five fp32 shapes: the wide tile where a block takes all D
    channels of it; the split doubled while the grid is short of 132 SMs
    (and the slices keep 8 channels)."""
    bf, f32 = torch.bfloat16, torch.float32
    want = {(8, 96, 128, bf): ((16, 16), 1), (8, 48, 128, bf): ((16, 32), 1),
            (8, 96, 64, bf): ((16, 16), 2), (8, 192, 32, bf): ((16, 16), 8),
            (8, 384, 16, bf): ((16, 16), 16),
            (8, 48, 64, f32): ((8, 16), 1), (8, 96, 64, f32): ((8, 16), 1),
            (8, 96, 32, f32): ((8, 16), 4), (8, 192, 16, f32): ((8, 8), 8),
            (8, 384, 8, f32): ((8, 8), 16)}
    for (b, d, hw, dt), (tile, split) in want.items():
        k, got = plan(b, d, hw, hw, dt, dt)
        assert ((k["TH"], k["TW"]), got) == (tile, split), (b, d, hw, dt)
        assert got >= cuda_effn.K6_CLASSES[cuda_effn.k6_class(d)][1]
        # a block's slice of the tile fits the budget of the wide tile
        assert -(-d // got) * k["NPX"] * (2 if dt == bf else 4) <= \
            cuda_effn.K6_WIDE_BYTES


@pytest.mark.parametrize("ydtype,zdtype", PAIRS + [(torch.bfloat16,
                                                    torch.float32)])
@pytest.mark.parametrize("d", [40, 96])
def test_k6_shared_layout_is_a_conflict_free_permutation(ydtype, zdtype, d):
    """The swizzled shared tile is a permutation of each channel's chunks;
    the eight threads of each quarter-warp store the merge's chunks to
    eight distinct 16-byte bank groups, and the statistics' warps read 32
    consecutive pixels from distinct banks (or the same word)."""
    k = consts(ydtype, zdtype, d)
    cb = 8
    idx = shared_index(k, cb)
    assert sorted(idx.flatten().tolist()) == list(
        range(cb * k["CK"] * k["VY"]))
    # phase 1: item i = (c, by, bx), bx fastest; step e stores row e of
    # its block
    for e in range(k["VY"]):
        for q0 in range(0, cb * k["NB"], 8):
            groups = set()
            for i in range(q0, q0 + 8):
                bx, by, c = i % k["BX"], (i // k["BX"]) % k["BY"], i // k["NB"]
                h = by * k["VY"] + e
                groups.add(chunk(k, c, h, h * k["BX"] + bx) % 8)
            assert len(groups) == 8, (e, q0)
    # phase 2: thread p reads pixel p of channel c; a warp's 32 pixels
    ebytes = 16 // k["VY"]
    for c in range(2):
        for p0 in range(0, k["NPX"], 32):
            words = {}
            for p in range(p0, p0 + 32):
                el = idx[c, p // k["TW"], p % k["TW"]].item()
                words.setdefault(el * ebytes // 4 % 32, set()).add(
                    el * ebytes // 4)
            assert all(len(v) == 1 for v in words.values()), (c, p0)


def test_k6_wrapper_passes_its_signature(monkeypatch):
    """K6's wrapper with the CPU routing and the launch stubbed: the
    arguments of its signature, the split of its plan."""
    calls = []
    monkeypatch.setattr(cuda_effn, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(cuda_effn, "_sms", lambda dev: 132)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *a: calls.append((name, a)))
    for (b, d, h, w, dt) in ((8, 384, 16, 16, torch.bfloat16),
                             (2, 40, 5, 7, torch.float32)):
        y, z, lw, lb = (torch.from_numpy(v) for v in _inputs(b, d, h, w, 0))
        out = cuda_effn.oss_tail_fwd(y.to(dt), z.to(dt), lw, lb)
        assert out.shape == (b, d, h, w) and out.dtype == dt
        name, args = calls[-1]
        assert name == "vmt_oss_tail_fwd"
        kinds = _build.SIGNATURES[name][:-1]  # the stream: added by launch
        assert len(args) == len(kinds)
        for kd, v in zip(kinds, args):
            assert isinstance(v, float) if kd is _build._F else isinstance(
                v, int)
        assert args[-6:-1] == (b, d, h, w, plan(b, d, h, w, dt, dt)[1])
