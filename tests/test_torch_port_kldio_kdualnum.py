"""kldio's channels-last fused scan in the port (`vmambair_torch/tools/
kldio.py`, `ops/cuda_probes.ld_fused`) against the TPU tool in `tools/`,
on the CPU (kdualnum's range study: `test_torch_port_kdualnum.py`).

The same numpy inputs (`numpy.random.RandomState`) go through the TPU
probe's `ld_fused` in its own interpret mode (`interpret=True`, the
Pallas kernel run by the interpreter) and through the port's `ld_fused`
on CPU tensors, which takes the plain version. The TPU probe is loaded
from its file; nothing under `tools/` changes.

Tolerances: `ld_fused` in fp32 within the scan bar of
`test_torch_port_ops.py` (rtol 1e-4, atol 1e-4), in bf16 the bf16
envelope (rtol 3e-2, atol 5e-2).
"""

import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_torch.ops import cuda_probes, cuda_scan
from vmambair_torch.tools import kldio as port_kl

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=5e-2)}


def _load(name):
    """tools/<name>.py as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_tool_{name}_kk", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ld_inputs(seed, b=1, l=256, G=2, d=16, n=16, r=2):
    """u (B, G, L, D) and K1's weights by kldio's recipe, from numpy."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return [rng.randn(b, G, l, d).astype(f32),
            (0.2 * rng.randn(G, r + 2 * n, d)).astype(f32),
            (0.2 * rng.randn(G, d, r)).astype(f32),
            (0.1 * rng.randn(G, d)).astype(f32),
            (-0.5 - np.exp(0.5 * rng.randn(G, d, n))).astype(f32),
            rng.randn(G, d).astype(f32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_ld_fused_matches_jax(reverse, dtype):
    kl = _load("kldio")
    u, *w = _ld_inputs(1 + reverse)
    ref = kl.ld_fused(jnp.asarray(u, dtype), *w, softplus=True,
                      reverse=reverse, interpret=True)
    got = cuda_probes.ld_fused(
        torch.from_numpy(u).to(getattr(torch, dtype)),
        *map(torch.from_numpy, w), softplus=True, reverse=reverse)
    assert got.shape == u.shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_ld_fused_plain_is_the_plain_fused_scan_moved(reverse, dtype):
    """`ld_fused_plain` is the plain `oss_scan_fused` on (B, G, D, L), bit
    for bit, with u and y moved between the layouts."""
    u, *w = [torch.from_numpy(a) for a in _ld_inputs(3, b=2, l=70, d=24)]
    u = u.to(dtype)
    got = cuda_probes.ld_fused_plain(u, *w, reverse=reverse)
    ref = cuda_scan.oss_scan_fused_ref(u.movedim(2, 3), *w, reverse=reverse)
    assert got.is_contiguous()
    assert torch.equal(got, ref.movedim(3, 2))


def test_kldio_recipe_and_parity_on_the_cpu():
    """The tool on the CPU: its small shape, bf16 u, parity rows only."""
    u2, xw, dw, db, A, Ds = port_kl.make_inputs_small(0, "cpu")
    assert u2.shape == (port_kl.SMALL_B, port_kl.SMALL_L, port_kl.G,
                        port_kl.D) and u2.dtype == torch.bfloat16
    N, R = port_kl.N, port_kl.R
    assert xw.shape == (2, R + 2 * N, 96) and dw.shape == (2, 96, R)
    assert (A <= -0.5).all() and db.shape == Ds.shape == (2, 96)
    rows = port_kl.run(torch.device("cpu"))
    assert [r["piece"] for r in rows] == ["parity_reverse=False",
                                          "parity_reverse=True"]
    assert all(r["rel_err"] == 0.0 for r in rows)


def test_kldio_bound():
    """At (8, 2, 16384, 96) bf16, N = 16: u read and y written once, 100.7
    MB (0.030 ms at 3.35 TB/s); 4.03e8 exp2s at the SFU's nominal rate,
    0.0963 ms, which sets the bound; the projections' 2.2e9 flops and the
    scan's under it."""
    by, ops, ex2 = port_kl.work()
    el = 8 * 2 * 16384 * 96
    assert by - 4 * el == 4 * 2 * 96 * (2 * 6 + 3 * 16 + 2)
    assert ex2 == el * 16 == 402653184
    assert 2 * el * (2 * 6 + 2 * 16) == pytest.approx(2.2e9, rel=0.02)
    ms, by_what = port_kl.bound_ms()
    assert ms == pytest.approx(0.0963, abs=5e-5) and by_what == "operations"
    assert by / port_kl.HBM_BPS * 1e3 == pytest.approx(0.0300, abs=1e-4)


def test_kldio_race_rows(monkeypatch):
    """The race's rows on the card, driven here on CPU tensors at (1, 2, 40,
    96) with the timing replaced: every call runs once on every input
    set; the rows name their kernel, its launches (parity included) and
    the share of the bound, the LD row its speedup over the production
    row."""
    make = port_kl.make_inputs
    ran = []

    def fake_race(calls, pool, repeats):
        for name, fn in calls.items():
            for inp in pool:
                ran.append((name, tuple(fn(inp).shape)))
        return {name: [2.0 + k] * repeats for k, name in enumerate(calls)}

    monkeypatch.setattr(port_kl, "make_inputs", lambda seed, device, small=(
        False): make(seed, "cpu", small=True))
    monkeypatch.setattr(port_kl, "race", fake_race)
    monkeypatch.setattr(port_kl, "SMALL_B", 1)
    monkeypatch.setattr(port_kl, "SMALL_L", 40)
    rows = port_kl.run(types.SimpleNamespace(type="cuda"))
    shape = (port_kl.SMALL_B, port_kl.G, port_kl.SMALL_L, port_kl.D)
    assert {s for _, s in ran} == {
        shape, (shape[0], shape[2], shape[1], shape[3]),
        (shape[0], shape[1], shape[3], shape[2])}
    race_rows = {r["piece"]: r for r in rows[2:5]}
    assert {k: (r["kernel"], r["launches"]) for k, r in race_rows.items()} \
        == {"fused_prod_BLGD": ("oss_scan_fused", 3 + port_kl.REPEATS),
            "fused_ld_BGLD": ("ld_fused", 3 + port_kl.REPEATS),
            "k1_BGDL": ("oss_scan_fused", 1 + port_kl.REPEATS)}
    assert race_rows["fused_ld_BGLD"]["speedup_vs_prod"] == 2.0 / 3.0
    bound = rows[-1]
    assert bound["piece"] == "bound" and bound["ms"] == port_kl.bound_ms()[0]
    assert race_rows["k1_BGDL"]["bound_share"] == bound["ms"] / 4.0


def test_kldio_cli_on_the_cpu(capsys):
    port_kl.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and '"rel_err": 0.0' in out[0]
