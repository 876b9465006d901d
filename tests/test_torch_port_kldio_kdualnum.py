"""kldio's channels-last fused scan and kdualnum's range study in the port
(`vmambair_torch/tools/{kldio,kdualnum}.py`, `ops/cuda_probes.ld_fused`)
against the TPU tools in `tools/`, on the CPU.

kldio: the same numpy inputs (`numpy.random.RandomState`) go through the
TPU probe's `ld_fused` in its own interpret mode (`interpret=True`, the
Pallas kernel run by the interpreter) and through the port's `ld_fused`
on CPU tensors, which takes the plain version. The TPU probe is loaded
from its file; nothing under `tools/` changes.

kdualnum: the TPU tool's `main` runs with `build_network` replaced by one
that builds MambaSISR6 at reduced depth (every level width, 48 to 384, at
one block; one refinement block), records the input and hands `apply` the
port's seeded weights carried to JAX (`scripts/convert_torch_weights.py`);
its watcher's captured calls are read from its closure. The port's
`collect` runs on the port's net and the same input. JAX's eager forward
of that net at 16x16 takes about a minute on one core; the full preset is
marked slow.

Tolerances: `ld_fused` in fp32 within the scan bar of
`test_torch_port_ops.py` (rtol 1e-4, atol 1e-4), in bf16 the bf16
envelope (rtol 3e-2, atol 5e-2); kdualnum's delta within 1e-5 (the
forward differs from JAX's by the order of fp32 sums), |A| = exp(A_log)
within a relative 1e-6 (the two exps' last bit), and the printed rows
equal to the printed digits.
"""

import importlib.util
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmambair_tpu.models as jax_models
from vmambair_torch.models import build_network
from vmambair_torch.ops import cuda_probes, cuda_scan
from vmambair_torch.tools import kdualnum as port_kd
from vmambair_torch.tools import kldio as port_kl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
from convert_torch_weights import convert  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=5e-2)}
# reduced depth: one block at each level, one refinement block
REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
# the kept calls of that net at 16x16: spatial pairs at levels 1 (the
# encoder, decoder and refinement blocks) and 2; channel scans of C >= 64
KDUALNUM_REDUCED_LINE = ("captured by kind: spatial 10 (L=64 x4, L=256 x6); "
                         "channel 7 (L=96 x4, L=192 x2, L=384 x1)")


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


def _jax_tool_run(monkeypatch, capsys, hw, net_kw):
    """The TPU tool's main on MambaSISR6 with `net_kw`, its weights those
    of the port's seeded init carried to JAX (`convert`): its printed
    lines, its watcher's captured (delta, |A|) per call, the port's net and
    the input. `init` returns the carried weights without running the
    JAX forward: the standalone tool's `init` runs the whole forward
    eagerly under its watcher, so it captures every call twice (the
    init's and the apply's, the same values)."""
    kd = _load("kdualnum")
    seen = {}
    build = jax_models.build_network

    class Recorder:
        def __init__(self, net):
            self.net = net

        def init(self, rng, x):
            seen["x"] = np.asarray(x)
            seen["net"] = build_network(dict(type="MambaSISR6", **net_kw),
                                        device="cpu").eval()
            return {"params": convert(seen["net"].state_dict())}

        def apply(self, *a, **kw):
            from vmambair_tpu.models import oss as oss_mod
            spy = oss_mod.selective_scan
            cells = dict(zip(spy.__code__.co_freevars, spy.__closure__))
            seen["stats"] = cells["stats"].cell_contents
            return self.net.apply(*a, **kw)

    monkeypatch.setattr(jax_models, "build_network",
                        lambda opt: Recorder(build(dict(opt, **net_kw))))
    monkeypatch.setenv("KDUALNUM_HW", str(hw))
    kd.main()
    return capsys.readouterr().out.splitlines(), seen


def _kdualnum_matches(monkeypatch, capsys, hw, net_kw):
    lines, seen = _jax_tool_run(monkeypatch, capsys, hw, net_kw)
    x = torch.from_numpy(np.ascontiguousarray(
        seen["x"].transpose(0, 3, 1, 2)))
    stats = port_kd.collect(seen["net"], x)
    jax_stats = seen["stats"]
    assert [s["delta"].shape[1] for s in stats] == [
        d.shape[1] for d, _ in jax_stats]
    for s, (d, absA) in zip(stats, jax_stats):
        assert s["delta"].shape == d.shape
        np.testing.assert_allclose(s["delta"], d, rtol=0, atol=1e-5)
        np.testing.assert_allclose(s["absA"], absA, rtol=1e-6, atol=0)
    assert {s["kind"] for s in stats} == {"spatial", "channel"}
    assert all(s["L"] >= port_kd.MIN_L for s in stats)
    # the TPU tool's capture line and its rows, to the printed digits
    assert lines == [f"captured {len(stats)} spatial scan calls (input "
                     f"{hw}x{hw})"] + port_kd.summarize(stats)
    return stats


def test_kdualnum_matches_the_jax_tool(monkeypatch, capsys):
    """Reduced depth, 16x16: the spatial pairs of L = 256 (levels 1 and
    the refinement) and 64 (level 2), and the channel scans of C = 96,
    192 and 384 (C = 48 is under 64)."""
    stats = _kdualnum_matches(monkeypatch, capsys, 16, REDUCED)
    assert port_kd.capture_line(stats) == KDUALNUM_REDUCED_LINE


@pytest.mark.slow
def test_kdualnum_full_preset_matches_the_jax_tool(monkeypatch, capsys):
    _kdualnum_matches(monkeypatch, capsys, 16, {})


def test_kdualnum_cli_lines(monkeypatch, capsys):
    """`main` on the CPU: the count by kind, the TPU tool's capture line,
    its three window rows and delta's row."""
    monkeypatch.setenv("KDUALNUM_HW", "16")
    monkeypatch.setattr(port_kd, "build_network", lambda opt, **kw:
                        build_network(dict(opt, **REDUCED), **kw))
    port_kd.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == KDUALNUM_REDUCED_LINE
    assert out[1] == "captured 17 spatial scan calls (input 16x16)"
    assert [line[:6] for line in out[2:]] == ["q=  32", "q=  64", "q= 128",
                                             "delta "]
