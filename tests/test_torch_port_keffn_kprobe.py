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
envelope (its output is bf16).
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
    """keffn's work at 128x128x48 bf16: the projections' 2 (2h C + h C)
    flops per pixel on the tensor cores, the rest on the CUDA cores, x and
    y once and the fp32 weights."""
    by, fp32_ops, mma = port_keffn.work((8, 128, 128, 48), torch.bfloat16)
    px, c, hid = 8 * 128 * 128, 48, 127
    assert mma == 2 * px * 3 * hid * c
    assert fp32_ops == px * (36 * hid + 20 * hid + 10 * c)
    assert by == 2 * px * c * 2 + 4 * (2 * c + 3 * hid * c + 18 * hid)
    ms, by_what = port_keffn.bound_ms((8, 128, 128, 48), torch.bfloat16)
    assert by_what == "operations" and ms > 0


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


def test_kprobe_refuses_unknown_probes():
    with pytest.raises(ValueError, match="unknown probes"):
        port_kprobe.run(["transpose"], torch.device("cpu"))
