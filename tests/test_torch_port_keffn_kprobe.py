"""keffn's fused GDFN and kprobe's in-kernel relayout probes in the port
(`vmambair_torch/tools/{keffn,kprobe}.py`, `ops/cuda_probes.py`) against
the TPU probes, on the CPU.

The same numpy inputs (`numpy.random.RandomState`) go through the TPU
probe's function and through the port's counterpart on CPU tensors, which
takes the plain version. keffn's `gdfn_fused` takes `interpret=True`;
kprobe builds its kernels inside its probe functions at the module's (B, L)
and hands them to its `timeit`, so it is loaded from its file with small B
and L, its `pl` interpreted and its `timeit` replaced by one that keeps
each probe's function untimed; the test then calls that function on its
own inputs. Nothing under `tools/` changes.

Tolerances: keffn in fp32 within 2e-5 of the reference's largest
magnitude (the hidden map and the gate differ from JAX's only by the order
of fp32 sums and tanh's last bit), in bf16 the bf16 envelope (rtol 3e-2,
atol 5e-2); kprobe's transpose pair bit-equal; its projections the bf16
envelope (its output is bf16). The projections' tensor-core route is
emulated too (three bf16 parts of W_xp for a bf16 u, split TF32 for fp32,
the output product from xdbl's accumulators as they lie): against the TPU
probe and the plain version in the bf16 envelope, and before rounding
within 1e-5 of the largest entry of the exact y (fp64), which a single
bf16 or TF32 part of W_xp misses.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vmambair_torch.ops import cuda_probes
from vmambair_torch.tools import keffn as port_keffn
from vmambair_torch.tools import kprobe as port_kprobe

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = dict(rtol=3e-2, atol=5e-2)
BF16 = ml_dtypes.bfloat16


def _load(name, **constants):
    """tools/<name>.py as a fresh module, with `constants` set on it."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_probe_{name}_kk", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in constants.items():
        setattr(mod, k, v)
    return mod


class _Interpreted:
    """A stand-in for a loaded probe's `pl` whose pallas_call interprets."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def pallas_call(self, *args, **kw):
        return self._mod.pallas_call(*args, **dict(kw, interpret=True))


def _t(a):
    """numpy (fp32 or bf16) -> a torch tensor of the same dtype."""
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _np(t):
    """torch (fp32 or bf16) -> numpy of the same dtype."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(BF16)
    return t.numpy()


# -- keffn ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpu_keffn():
    return _load("keffn")


def _keffn_inputs(seed, shape, dtype):
    b, h, w, c = shape
    hid = int(2.66 * c)
    rng = np.random.RandomState(seed)
    p = dict(ln_w=1 + 0.1 * rng.randn(c), ln_b=0.1 * rng.randn(c),
             w_in=0.1 * rng.randn(c, 2 * hid),
             w_dw=0.3 * rng.randn(3, 3, 2 * hid),
             w_out=0.1 * rng.randn(hid, c))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (0.5 * rng.randn(*shape)).astype(dtype), p


def _keffn_close(got, ref, dtype):
    got, ref = got.float().numpy(), _f32(ref)
    if dtype == np.float32:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, **BF16_TOL)


KEFFN_SHAPES = [(2, 16, 16, 48), (1, 32, 32, 96), (1, 16, 20, 48)]


@pytest.mark.parametrize("dtype", [np.float32, BF16])
@pytest.mark.parametrize("shape", KEFFN_SHAPES)
def test_keffn_plain_matches_jax_kernel(tpu_keffn, shape, dtype):
    """The TPU kernel in interpret mode against the port's wrapper on the
    CPU (the plain version): the probe's interpret shape, two row tiles of
    16 (H = 32), W = 20 not a multiple of 8. H is 16 or a multiple of 16:
    the TPU kernel drops the rows past (H // 16) * 16 otherwise."""
    x, p = _keffn_inputs(sum(shape), shape, dtype)
    ref = tpu_keffn.gdfn_fused(jnp.asarray(x), interpret=True,
                               **{k: jnp.asarray(v) for k, v in p.items()})
    n0 = cuda_probes.gdfn_tanh_nhwc.launches
    got = cuda_probes.gdfn_tanh_nhwc(_t(x), **{k: _t(v) for k, v in
                                               p.items()})
    assert cuda_probes.gdfn_tanh_nhwc.launches == n0  # the plain path
    assert got.shape == shape and got.dtype == _t(x).dtype
    _keffn_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [np.float32, BF16])
@pytest.mark.parametrize("shape", KEFFN_SHAPES)
def test_keffn_composite_matches_jax_gdfn_xla(tpu_keffn, shape, dtype):
    """The race partner: the TPU probe's XLA composite against the port's
    cuDNN composite (channels-last conv2d, rounding after each conv)."""
    x, p = _keffn_inputs(sum(shape) + 1, shape, dtype)
    ref = tpu_keffn.gdfn_xla(jnp.asarray(x),
                             **{k: jnp.asarray(v) for k, v in p.items()})
    got = cuda_probes.gdfn_tanh_composite(
        _t(x), **{k: _t(v) for k, v in p.items()})
    assert got.shape == shape and got.dtype == _t(x).dtype
    _keffn_close(got, ref, dtype)


def test_keffn_tool_recipe_matches_jax_kernel(tpu_keffn):
    """The slice as a whole on the CPU: the tool's own inputs (its
    `make_params` and `make_x` at the interpret shape, bf16) through the
    TPU kernel and through the port's wrapper."""
    shape = port_keffn.CPU_SHAPES[0]
    params = port_keffn.make_params(shape[3] + shape[1], shape[3], "cpu")
    x = port_keffn.make_x(shape, torch.bfloat16, 1, "cpu")
    ref = tpu_keffn.gdfn_fused(
        jnp.asarray(_np(x)), interpret=True,
        **{k: jnp.asarray(v.numpy()) for k, v in params.items()})
    _keffn_close(cuda_probes.gdfn_tanh_nhwc(x, **params), ref, BF16)


def test_keffn_cli_prints_its_rows(capsys):
    """`python -m vmambair_torch.tools.keffn --device cpu`: one parity row
    at the interpret shape, the TPU probe's relerr key, no times."""
    port_keffn.main(["--device", "cpu"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert len(rows) == 1 and rows[0]["shape"] == [2, 16, 16, 48]
    assert rows[0]["16x16x48_relerr"] == 0.0
    assert 0 < rows[0]["16x16x48_composite_relerr"] < 3e-2
    assert not any(k.endswith("_ms") for k in rows[0])


def test_keffn_bound_counts_as_k2s():
    """keffn's work at 128x128x48: the projections' 2 (2h C + h C) flops
    per pixel on the tensor cores (bf16 in bf16; for fp32 three TF32
    products each, the split-TF32 route's), the rest on the CUDA cores, x
    and y once and the fp32 weights."""
    shape = (8, 128, 128, 48)
    by, fp32_ops, mma, tf32_mma = port_keffn.work(shape, torch.bfloat16)
    px, c, hid = 8 * 128 * 128, 48, 127
    assert mma == 2 * px * 3 * hid * c and tf32_mma == 0
    assert fp32_ops == px * (36 * hid + 20 * hid + 10 * c)
    assert by == 2 * px * c * 2 + 4 * (2 * c + 3 * hid * c + 18 * hid)
    ms, by_what = port_keffn.bound_ms(shape, torch.bfloat16)
    assert by_what == "operations" and ms > 0
    by32, ops32, mma32, tf32_32 = port_keffn.work(shape, torch.float32)
    assert (ops32, mma32, tf32_32) == (fp32_ops, 0, 3 * mma)
    assert by32 == by + 2 * px * c * 2
    ms32, _ = port_keffn.bound_ms(shape, torch.float32)
    assert ms32 == pytest.approx(max(
        by32 / port_keffn.HBM_BPS,
        ops32 / port_keffn.FP32_FLOPS + tf32_32 / 495e12) * 1e3)


# -- kprobe ---------------------------------------------------------------------

KP_B, KP_L = 2, 2048   # two chunks of 1024 per batch


@pytest.fixture(scope="module")
def tpu_kprobe():
    """The TPU probe at (B, L) = (2, 2048), its kernels interpreted and
    each probe's function kept (untimed) by name."""
    mod = _load("kprobe", B=KP_B, L=KP_L)
    mod.pl = _Interpreted(mod.pl)
    fns = {}

    def keep(fn, *args):
        fns[len(fns)] = fn
        return 1e-3

    mod.timeit = keep
    mod.probe_transpose()
    mod.probe_proj()
    return {"transpose_pair_in_kernel": fns[0], "proj_in_kernel": fns[1]}


def _kprobe_inputs(seed):
    rng = np.random.RandomState(seed)
    D = 96
    return (rng.randn(KP_B, KP_L, D).astype(BF16),
            rng.randn(port_kprobe.RN, D).astype(np.float32),
            rng.randn(D, port_kprobe.R).astype(np.float32))


def test_kprobe_transpose_plain_matches_jax_bit_for_bit(tpu_kprobe):
    u, _, _ = _kprobe_inputs(0)
    ref = tpu_kprobe["transpose_pair_in_kernel"](jnp.asarray(u))
    n0 = cuda_probes.probe_transpose.launches
    got = cuda_probes.probe_transpose(_t(u))
    assert cuda_probes.probe_transpose.launches == n0
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _f32(ref))
    # the library call the race times beside it: the same bits
    assert torch.equal(port_kprobe.library({"u": _t(u)}), got)


def test_kprobe_proj_plain_matches_jax(tpu_kprobe):
    u, wxp, wdt = _kprobe_inputs(1)
    ref = tpu_kprobe["proj_in_kernel"](jnp.asarray(u), jnp.asarray(wxp),
                                       jnp.asarray(wdt))
    n0 = cuda_probes.probe_proj.launches
    got = cuda_probes.probe_proj(_t(u), _t(wxp), _t(wdt))
    assert cuda_probes.probe_proj.launches == n0
    assert got.shape == u.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), **BF16_TOL)


# kprobe's projections as the tensor-core route (csrc/probe_io.cu,
# proj_mma_kernel) computes them: xdbl^T = u W_xp^T with W_xp in three
# bf16 parts (bf16 u) or in split TF32 (fp32 u, u cut to TF32 and its
# rest), RN padded to 40; then y = xdbl[:, :8] B' from xdbl's accumulators
# as they lie, a split-TF32 product. Each product's sum is taken in fp64
# and rounded to fp32 (the tensor core's products are exact; its fp32
# accumulation differs only by the order of the sums).

PJ_RN = 40            # xdbl's rows on the tensor cores: 5 n-tiles of 8
PROJ_F32_BAR = 1e-5   # of the largest entry of y


def _lanes():
    """g = lane / 4 and t = lane % 4 of a warp's 32 lanes."""
    lane = np.arange(32)
    return lane // 4, lane % 4


def _bf16_parts(w):
    """w = p0 + p1 + p2, each the rest so far rounded to bf16."""
    parts = []
    for _ in range(3):
        parts.append(w.astype(BF16).astype(np.float32))
        w = (w - parts[-1]).astype(np.float32)
    return parts


def _tf32_cut(a):
    """fp32 cut to TF32: the low 13 mantissa bits zeroed."""
    return (np.asarray(a, np.float32).view(np.int32) & ~0x1FFF).view(
        np.float32)


def _tf32_split(a):
    """Veltkamp's split in fp32 adds (mma.cuh's split_tf32): hi = a rounded
    to 11 significant bits, lo = a - hi cut to TF32."""
    a = np.asarray(a, np.float32)
    t = a * np.float32(8193)
    hi = (t - (t - a)).astype(np.float32)
    return hi, _tf32_cut(a - hi)


def _dot(a, b):
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _out_operands(wdt, d):
    """The output product's operands as the kernel lays them out: the A
    fragment of lane (g, t) is its accumulators (c0, c2, c1, c3) of xdbl's
    first n-tile, so A'[:, k] = xdbl[:, col[k]]; B'' holds B'[col[k]] at
    row k, packed from W_dt, 0.5 at R and zeros (`wd` in the kernel)."""
    g, t = _lanes()
    col = np.empty(8, int)
    col[t] = 2 * t          # a0 = c0: A'[g][t] = C[g][2t]
    col[t + 4] = 2 * t + 1  # a2 = c1: A'[g][t + 4] = C[g][2t + 1]
    R = wdt.shape[1]
    bp = np.zeros((8, d), np.float32)
    bp[:R] = wdt.T
    bp[R] = 0.5
    return col, bp[col]


def _proj_emulate(u, wxp, wdt, single=False):
    """(y in fp32, y in u's dtype) of the tensor-core route on u (rows, D)
    bf16 or fp32; `single`: W_xp (and an fp32 u) in one part, the control
    that shows the split is what holds the fp32 bar."""
    d = u.shape[-1]
    uf = u.astype(np.float32)
    w = np.zeros((PJ_RN, d), np.float32)
    w[:wxp.shape[0]] = wxp
    if u.dtype == BF16:  # three bf16 parts, the smallest first
        parts = _bf16_parts(w)[:1 if single else 3]
        xdbl = np.zeros((u.shape[0], PJ_RN), np.float32)
        for p in parts[::-1]:
            xdbl = xdbl + _dot(uf, p.T)
    else:  # lo.hi + hi.lo + hi.hi
        uh = _tf32_cut(uf)
        wh, wl = _tf32_split(w)
        if single:
            xdbl = _dot(uh, wh.T)
        else:
            xdbl = (_dot(_tf32_cut(uf - uh), wh.T) + _dot(uh, wl.T)
                    + _dot(uh, wh.T))
    col, bpp = _out_operands(wdt, d)
    ah, al = _tf32_split(xdbl[:, col])
    bh, bl = _tf32_split(bpp)
    y = _dot(al, bh) + _dot(ah, bl) + _dot(ah, bh)
    return y, y.astype(u.dtype)


def _proj_exact(u, wxp, wdt):
    R = wdt.shape[1]
    x = u.astype(np.float64) @ wxp.astype(np.float64).T
    return x[:, :R] @ wdt.astype(np.float64).T + 0.5 * x[:, R:R + 1]


def test_kprobe_proj_output_operands_take_xdbl_as_it_lies():
    """The output product from the accumulators as they lie: A' B'' equals
    xdbl[:, :R] W_dt^T + 0.5 xdbl[:, R] exactly (in fp64) for every R the
    route takes."""
    rng = np.random.RandomState(3)
    x = rng.randn(64, 8)
    for R in range(8):
        wdt = rng.randn(16, R).astype(np.float32)
        col, bpp = _out_operands(wdt, 16)
        want = x[:, :R] @ wdt.astype(np.float64).T + 0.5 * x[:, R:R + 1]
        np.testing.assert_allclose(x[:, col] @ bpp.astype(np.float64), want,
                                   rtol=1e-12, atol=1e-12)


def test_kprobe_proj_split_products_match_jax_and_plain(tpu_kprobe):
    """bf16 u at the probe's (2, 2048, 96): the emulated route against the
    TPU probe (interpreted) and the plain version within the bf16
    envelope; before its rounding, y within 1e-5 of its largest entry of
    the exact y, which one bf16 part of W_xp misses."""
    u, wxp, wdt = _kprobe_inputs(1)
    ref = _f32(tpu_kprobe["proj_in_kernel"](jnp.asarray(u), jnp.asarray(wxp),
                                             jnp.asarray(wdt)))
    y32, y = _proj_emulate(u.reshape(-1, 96), wxp, wdt)
    y = y.astype(np.float32).reshape(u.shape)
    np.testing.assert_allclose(y, ref, **BF16_TOL)
    plain = cuda_probes.probe_proj_ref(_t(u), _t(wxp), _t(wdt))
    np.testing.assert_allclose(y, plain.float().numpy(), **BF16_TOL)
    exact = _proj_exact(u.reshape(-1, 96), wxp, wdt)
    top = np.abs(exact).max()
    assert np.abs(y32 - exact).max() <= PROJ_F32_BAR * top
    ctl, _ = _proj_emulate(u.reshape(-1, 96), wxp, wdt, single=True)
    assert np.abs(ctl - exact).max() > PROJ_F32_BAR * top


@pytest.mark.parametrize("rows,d,rn,r", [(4096, 96, 38, 6), (300, 16, 40, 7),
                                         (77, 256, 9, 0)])
def test_kprobe_proj_fp32_split_tf32_holds_the_fp32_bar(rows, d, rn, r):
    """fp32 u: the emulated route within 1e-5 of the largest entry of the
    plain version and of the exact y, at the probe's rows, RN = 40 with
    the largest R, D = 16 and 256 with R = 0; a single TF32 pass (u and
    W_xp cut to TF32) misses that bar."""
    rng = np.random.RandomState(rows + d)
    u = rng.randn(rows, d).astype(np.float32)
    wxp = rng.randn(rn, d).astype(np.float32)
    wdt = rng.randn(d, r).astype(np.float32)
    y, _ = _proj_emulate(u, wxp, wdt)
    exact = _proj_exact(u, wxp, wdt)
    top = np.abs(exact).max()
    assert np.abs(y - exact).max() <= PROJ_F32_BAR * top
    plain = cuda_probes.probe_proj_ref(_t(u), _t(wxp), _t(wdt)).numpy()
    assert np.abs(y - plain).max() <= PROJ_F32_BAR * np.abs(plain).max()
    ctl, _ = _proj_emulate(u, wxp, wdt, single=True)
    assert np.abs(ctl - exact).max() > PROJ_F32_BAR * top


def test_kprobe_tool_recipe_matches_jax(tpu_kprobe):
    """The slice as a whole on the CPU: the tool's own inputs at (2, 2048,
    96) through both probes of the TPU and of the port."""
    shape = dict(B=KP_B, L=KP_L, D=96)
    inp = port_kprobe.make_inputs(shape, 3, "cpu")
    u = jnp.asarray(_np(inp["u"]))
    for name in port_kprobe.PROBES:
        kern, _ = port_kprobe.calls(name)
        args = (u,) if name == "transpose_pair_in_kernel" else (
            u, jnp.asarray(inp["wxp"].numpy()),
            jnp.asarray(inp["wdt"].numpy()))
        ref = _f32(tpu_kprobe[name](*args))
        got = kern(inp).float().numpy()
        if name == "transpose_pair_in_kernel":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, **BF16_TOL)


def test_kprobe_cli_prints_its_rows(capsys):
    """`python -m vmambair_torch.tools.kprobe --device cpu`: the TPU
    probe's two rows, parity only."""
    port_kprobe.main(["--device", "cpu"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r["probe"] for r in rows] == list(port_kprobe.PROBES)
    assert all(r["max_abs_err"] == 0.0 and "ms_per_call" not in r
               for r in rows)
    assert rows[0]["library_bit_equal"] is True


def test_kprobe_bounds():
    """At the probe shape: the transpose pair by its bytes (u and y once);
    the projections by their bytes too, since y needs only the first 7
    rows of xdbl (their fp32 operations take less time); all 38 rows, as
    the probe computes them, are a separate figure."""
    shape = port_kprobe.SHAPE
    el = 8 * 16384 * 96
    ms, by = port_kprobe.bound_ms("transpose_pair_in_kernel", shape)
    assert by == "bytes" and ms == pytest.approx(4 * el / 3.35e12 * 1e3)
    by_moved, ops = port_kprobe.work("proj_in_kernel", shape)
    assert ops == 8 * 16384 * (2 * 7 * 96 + 2 * 96 * 6 + 96)
    ms, by = port_kprobe.bound_ms("proj_in_kernel", shape)
    assert by == "bytes" and ms == pytest.approx(
        (4 * el + 4 * (38 * 96 + 96 * 6)) / 3.35e12 * 1e3)
    assert ops / 67e12 * 1e3 < ms
    assert port_kprobe.proj_rows_ops_ms(shape) == pytest.approx(
        8 * 16384 * (2 * 38 * 96 + 2 * 96 * 6 + 96) / 67e12 * 1e3)
    # the tensor-core route's own products, three a product, under the
    # bound in either dtype
    rows = 8 * 16384
    for dt, rate in ((torch.bfloat16, 989e12), (torch.float32, 495e12)):
        tc = port_kprobe.proj_tc_ms(shape, dt)
        assert tc == pytest.approx((3 * 2 * rows * 40 * 96 / rate
                                    + 3 * 2 * rows * 8 * 96 / 495e12) * 1e3)
        assert tc < ms


def test_kprobe_refuses_unknown_probes():
    with pytest.raises(ValueError, match="unknown probes"):
        port_kprobe.run(["transpose"], torch.device("cpu"))
