"""kvariants' separated-exponent scans (the matmul dual v22-v26 and the
cumsum form v4) of the port against the TPU's, on the CPU.

The plain versions (`cuda_probes.scan_dual_v22_ref`, `_v24_ref`,
`_v26_ref`, `scan_cumsum_v4_ref`) are what the CPU runs and what the
kernels of csrc/scan_dual.cu are held to on the card. Here:

- each against its TPU kernel in `tools/kvariants.py`, loaded from its
  file with its module constants shrunk (B 2, L 512, D 16, G 2, N 8, grid
  chunk 256) and run in interpret mode, on one seeded numpy input set
  whose first group of channels draws the race's default (hot) delta,
  where the separated exponents pass their clamp and v4 overflows, and
  whose second draws the model-realistic delta; within the bf16 envelope
  (rtol 3e-2, atol 5e-2), non-finite exactly where the TPU's is;
- the equalities the forms claim, on fp32 inputs within rtol 1e-5: v22
  (fp32 Z) and v24 referenced at the block start compute one function, on
  either recipe; v25 and v26 one function where no clamp binds;
- every family inside the exact scan's envelope on the realistic recipe,
  forward and reverse;
- v26's plain version against the TPU's production dual
  (`selective_scan(impl="pallas", interpret=True)` with
  VMAMBAIR_SCAN_DUAL=64), forward and reverse, in fp32 within rtol 1e-5 /
  atol 1e-5, on the recipe of tests/test_selective_scan.py:516-530 at L
  256 and on a hot delta where the clamps bind;
- the race's entry point on the CPU: one parity row per name.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vmambair_tpu.ops import pallas_scan
from vmambair_torch.ops import cuda_probes, cuda_scan
from vmambair_torch.tools import kvariants as port_kv

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = dict(rtol=3e-2, atol=5e-2)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
HOT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = ml_dtypes.bfloat16
SIZE = dict(B=2, L=512, D=16, G=2, N=8, CHUNK=256)
NAMES = list(port_kv.SEPARATED)


def _t(a):
    """numpy (fp32 or bf16) -> a torch tensor of the same dtype."""
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(rng, dtype, recipe):
    """The race's input set at SIZE, numpy: recipe 'hot' (raw delta
    |N(0, 1)| / 2, A = -exp(N(0, 1) / 2)), 'real' (post-softplus delta
    log-uniform in [1e-3, 0.1], A = -n) or 'mixed' (the first group hot,
    the second real, A = -exp(N(0, 1) / 2))."""
    B, L, G, N = SIZE["B"], SIZE["L"], SIZE["G"], SIZE["N"]
    dim = G * SIZE["D"]
    hot = np.abs(rng.randn(B, dim, L)) * 0.5
    tgt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (B, dim, L)))
    real = np.log(np.expm1(tgt))
    delta = {"hot": hot, "real": real,
             "mixed": np.concatenate([hot[:, :dim // 2],
                                      real[:, dim // 2:]], 1)}[recipe]
    A = (-np.tile(np.arange(1.0, N + 1.0), (dim, 1)) if recipe == "real"
         else -np.exp(rng.randn(dim, N) * 0.5))
    return dict(u=rng.randn(B, dim, L).astype(dtype),
                delta=delta.astype(dtype),
                Bm=rng.randn(B, G, N, L).astype(dtype),
                Cm=rng.randn(B, G, N, L).astype(dtype),
                A=A.astype(np.float32), Dv=np.ones(dim, np.float32),
                bias=(rng.randn(dim) * 0.01).astype(np.float32))


def _torch(p):
    return {k: _t(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def case():
    """The mixed input set and each separated-exponent variant of the TPU
    race on it (`build`, interpret mode, chunk 256)."""
    spec = importlib.util.spec_from_file_location(
        "tpu_probe_kvariants_dual", os.path.join(ROOT, "tools",
                                                 "kvariants.py"))
    tpu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tpu)
    for k, v in dict(SIZE, DIM=SIZE["G"] * SIZE["D"],
                     INTERPRET=True).items():
        setattr(tpu, k, v)
    p = _inputs(np.random.RandomState(9), BF16, "mixed")
    out = {}
    for name in NAMES:
        # `build`'s default chunk and tile were bound when it loaded
        y = tpu.build(*tpu.VARIANTS[name], chunk=SIZE["CHUNK"],
                      d_tile=SIZE["D"])(
            p["u"], p["delta"], p["A"].T[:, :, None], p["Bm"], p["Cm"],
            p["Dv"][:, None], p["bias"][:, None])
        out[name] = np.asarray(jnp.asarray(y).astype(jnp.float32))
    return _torch(p), out


@pytest.mark.parametrize("name", NAMES)
def test_separated_plain_matches_the_tpu_kernel(case, name):
    """Every TPU race name (v22 x5, v23, v24 x2, v25 x4, v26 x2, v4): the
    port's plain version on the mixed set within the bf16 envelope of the
    TPU kernel in interpret mode, non-finite at the same elements (v4's
    hot channels overflow in both)."""
    inp, out = case
    got = port_kv.ref_sep(inp, name).float().numpy()
    ref = out[name]
    assert got.shape == ref.shape
    assert (np.isfinite(got) == np.isfinite(ref)).all()
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_allclose(got[fin], ref[fin], **BF16_TOL, err_msg=name)
    if name in port_kv.MAY_OVERFLOW:
        assert not fin.all()  # the hot group overflows, as on the TPU


def _fp32_views(recipe, seed=4):
    p = _inputs(np.random.RandomState(seed), np.float32, recipe)
    inp = _torch(p)
    return port_kv.views(inp, inp["u"], False)[:7]


@pytest.mark.parametrize("recipe", ["hot", "real"])
@pytest.mark.parametrize("sub,blk", [(128, 32), (128, 16), (256, 64)])
def test_v22_and_v24_at_the_block_start_are_one_function(recipe, sub, blk):
    """v22 with Z in fp32 and v24 without mid: E = exp2(s) equals
    exp2(min(s, 120)) for s <= 0, and E (H + c) against E H + E c is a
    rounding apart, clamps binding (hot) or not (real)."""
    v = _fp32_views(recipe)
    a = cuda_probes.scan_dual_v22_ref(*v, sub=sub, blk=blk)
    b = cuda_probes.scan_dual_v24_ref(*v, sub=sub, blk=blk)
    torch.testing.assert_close(a, b, **FP32_TOL)


@pytest.mark.parametrize("sub,blk", [(128, 64), (128, 32), (256, 128)])
def test_v25_and_v26_are_one_function_off_the_clamp(sub, blk):
    """Where no clamp binds (the realistic recipe), v26's decays from
    sigma's ends equal v25's E_end exp2(A2 sigma_mid) to rounding."""
    v = _fp32_views("real")
    a = cuda_probes.scan_dual_v24_ref(*v, sub=sub, blk=blk, mid=True)
    b = cuda_probes.scan_dual_v26_ref(*v, sub=sub, blk=blk)
    torch.testing.assert_close(a, b, **FP32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_every_family_inside_the_exact_envelope_on_the_realistic_recipe(
        reverse):
    """Each of the 15 names on the realistic recipe (bf16 inputs) within
    the bf16 envelope of the exact scan, forward and reverse."""
    inp = _torch(_inputs(np.random.RandomState(11), BF16, "real"))
    v = port_kv.views(inp, inp["u"], False)[:7]
    exact = port_kv.dl_of(cuda_scan.scan_views_ref(*v, True, reverse))
    for name in NAMES:
        got = port_kv.ref_sep(inp, name, reverse=reverse)
        np.testing.assert_allclose(got.float().numpy(),
                                   exact.float().numpy(), **BF16_TOL,
                                   err_msg=f"{name} reverse={reverse}")


def test_clamps_bind_on_the_hot_recipe():
    """The finding behind the race's default recipe: on the hot delta the
    start-referenced dual at blk 128 leaves the exact scan's envelope
    (its Z clamp binds) and v4 overflows, while v22 at blk 16, whose
    blocks span an eighth of the exponent range, leaves it at a hundredth
    as many elements or fewer."""
    inp = _torch(_inputs(np.random.RandomState(11), BF16, "hot"))
    v = port_kv.views(inp, inp["u"], False)[:7]
    exact = port_kv.dl_of(cuda_scan.scan_views_ref(*v, True, False)).float()

    def off(name):
        got = port_kv.ref_sep(inp, name).float()
        return (~torch.isfinite(got) | ((got - exact).abs() > BF16_TOL[
            "atol"] + BF16_TOL["rtol"] * exact.abs())).float().mean().item()

    wide = off("v22_dual_128_128")
    assert wide > 0.01
    assert off("v4_128") > 0.5
    assert off("v22_dual_128_16") < wide / 100


@pytest.fixture
def dual_kernels(monkeypatch):
    """JAX's production dual at blk 64: the env read when a kernel is
    traced, the kernel caches emptied before and after (a cached kernel
    keeps the mode it was traced in)."""
    monkeypatch.setenv("VMAMBAIR_SCAN_DUAL", "64")
    pallas_scan._build_pallas_fwd.cache_clear()
    pallas_scan._make_vjp_op.cache_clear()
    assert pallas_scan._dual_cfg() == 64
    yield
    pallas_scan._build_pallas_fwd.cache_clear()
    pallas_scan._make_vjp_op.cache_clear()


def _gld(a, G):
    """numpy (b, L, G*d) -> the (b, g, l, d) view of its tensor."""
    b, L, dim = a.shape
    return _t(a).view(b, L, G, dim // G).permute(0, 2, 1, 3)


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_v26_plain_matches_the_tpu_production_dual(dual_kernels, reverse,
                                                   hot):
    """`scan_dual_v26_ref(sub=128, blk=64)` against `_scan_block_dual`
    through JAX's `selective_scan` (B 2, L 256: two windows, the fix-up
    chain and the window carry; dim 16, N 4, G 2), fp32. The recipe of
    tests/test_selective_scan.py:516-530 (post-softplus delta log-uniform
    in [1e-3, 0.1], A = -n, D ~ N(0, 1), no bias) and, hot, its raw delta
    |N(0, 1)| / 2 + 2, whose half-block exponents pass 120 bits: the
    production form takes v25's clamped block-end h and v26's unclamped
    decays, which agree. There the separated factors (up to 2^120) carry
    the fp32 roundings of sigma into h: the hot case is held to rtol 1e-4
    / atol 1e-4 (measured: 3 of 8192 elements past 1e-5, by 1.3e-5
    relative)."""
    rng = np.random.RandomState(5)
    b, L, dim, N, G = 2, 256, 16, 4, 2
    tgt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, L, dim)))
    delta = (np.abs(rng.randn(b, L, dim)) * 0.5 + 2.0 if hot
             else np.log(np.expm1(tgt))).astype(np.float32)
    u = rng.randn(b, L, dim).astype(np.float32)
    A = -np.tile(np.arange(1.0, N + 1.0), (dim, 1)).astype(np.float32)
    Bm = rng.randn(b, L, G, N).astype(np.float32)
    Cm = rng.randn(b, L, G, N).astype(np.float32)
    D = rng.randn(dim).astype(np.float32)
    bias = np.zeros(dim, np.float32)
    ref = pallas_scan.selective_scan(
        *(jnp.asarray(x) for x in (u, delta, A, Bm, Cm, D, bias)), True,
        impl="pallas", interpret=True, reverse=reverse)
    got = cuda_probes.scan_dual_v26_ref(
        _gld(u, G), _gld(delta, G), _t(A), _t(Bm).permute(0, 2, 1, 3),
        _t(Cm).permute(0, 2, 1, 3), _t(D), _t(bias), sub=128, blk=64,
        reverse=reverse)
    got = cuda_scan.bl_flat(got).numpy()
    np.testing.assert_allclose(got, np.asarray(ref),
                               **(HOT_TOL if hot else FP32_TOL))
    if hot:  # the clamps bind: the dual is off the exact scan here
        exact = cuda_scan.selective_scan_ref(
            _t(u), _t(delta), _t(A), _t(Bm), _t(Cm), _t(D), _t(bias), True,
            reverse)
        assert np.abs(got - exact.numpy()).max() > 0.1


def test_the_race_prints_a_parity_row_per_name_on_the_cpu(capsys):
    """`python -m vmambair_torch.tools.kvariants <the 15 names> --device
    cpu`: one row each, max abs err 0 against the plain version, the
    distance from the exact scan beside, v4's non-finite shares."""
    port_kv.main(NAMES + ["--device", "cpu"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == NAMES
    for r in rows:
        assert r["max_abs_err"] == 0.0 and "ms" not in r, r
        assert "exact_max_abs_err" in r and "exact_off_envelope" in r, r
    v4 = rows[NAMES.index("v4_128")]
    assert v4["nonfinite_share"] == v4["plain_nonfinite_share"] > 0.5
    assert port_kv.NOT_CARRIED == set()
