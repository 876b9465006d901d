"""The scan-design probes of the port (K7, `vmambair_torch/tools/`,
`ops/cuda_probes.py`) against the TPU probes, on the CPU.

The same numpy inputs (`numpy.random.RandomState`) go through the JAX
kernel in interpret mode and through the port's counterpart on CPU
tensors, which takes the plain version. The TPU probes in `tools/` are
loaded from their files (`importlib.util.spec_from_file_location`) and
sized through their module constants, as their own interpret modes size
them; nothing under `tools/` changes. `kvariants.build_ld` passes no
`interpret` to `pallas_call`, so the loaded module's `pl` is wrapped to
pass `interpret=True`. `pltpu.roll` interprets on the CPU, so the roll
probe is held against kpeak's own kernel.

`build` returns only the first output of kernel_v16, so its second (the
chunk-local reverse scan) comes from a two-output pallas_call of
kernel_v16 built here, as `build` builds it.

Tolerances: K7 in fp32 within the scan bar of test_torch_port_ops.py
(rtol 1e-4, atol 1e-4); the bf16 probes (kseq, kvariants, the bf16 FMA)
within the bf16 envelope (rtol 3e-2, atol 5e-2); the fp32 peak probes
within a relative 1e-5 (the roll and shift chains end near 1e-11).
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vmambair_tpu.ops.pallas_scan import _build_pallas_fwd_ld
from vmambair_torch.ops import cuda_probes, cuda_scan
from vmambair_torch.tools import kpeak as port_kpeak
from vmambair_torch.tools import kseq as port_kseq
from vmambair_torch.tools import kvariants as port_kv

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = dict(rtol=3e-2, atol=5e-2)
BF16 = ml_dtypes.bfloat16


class _Interpreted:
    """A stand-in for a loaded probe's `pl` whose pallas_call interprets."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def pallas_call(self, *args, **kw):
        return self._mod.pallas_call(*args, **dict(kw, interpret=True))


def _load(name, **constants):
    """tools/<name>.py as a fresh module, with `constants` set on it."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_probe_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in constants.items():
        setattr(mod, k, v)
    return mod


def _t(a):
    """numpy (fp32 or bf16) -> a torch tensor of the same dtype."""
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- K7 ------------------------------------------------------------------------

@pytest.mark.parametrize("reverse,N", [
    pytest.param(False, 4, id="False"), pytest.param(True, 4, id="True"),
    pytest.param(False, 32, id="False-N32"),
    pytest.param(True, 32, id="True-N32")])
def test_k7_plain_matches_jax_scan_kernel_ld(reverse, N):
    """N = 32: above the 16 states the card once took (it raised there
    while this path and JAX computed)."""
    BT, L, dim, G, chunk, d_tile = 2, 64, 16, 2, 16, 8
    rng = np.random.RandomState(5 + reverse)
    u = rng.randn(BT, L, dim).astype(np.float32)
    delta = rng.uniform(-3.0, 0.5, (BT, L, dim)).astype(np.float32)
    A = -np.exp(rng.uniform(-1.0, 1.5, (dim, N))).astype(np.float32)
    B5 = rng.randn(BT, G, N, L, 1).astype(np.float32)
    C5 = rng.randn(BT, G, N, L, 1).astype(np.float32)
    Dv = rng.randn(dim).astype(np.float32)
    bias = rng.uniform(-1.0, 1.0, dim).astype(np.float32)
    fwd = _build_pallas_fwd_ld(BT, L, dim, N, G, chunk, d_tile, True, True,
                               "float32", reverse=reverse)
    ref = fwd(u, delta, A.T[:, None, :], B5, C5, Dv[None], bias[None])
    n0 = cuda_scan.selective_scan_ld_fwd.launches
    got = cuda_scan.selective_scan_ld_fwd(
        _t(u), _t(delta), _t(A), _t(B5)[..., 0].permute(0, 3, 1, 2),
        _t(C5)[..., 0].permute(0, 3, 1, 2), _t(Dv), _t(bias),
        delta_softplus=True, reverse=reverse)
    assert cuda_scan.selective_scan_ld_fwd.launches == n0  # the plain path
    assert got.shape == (BT, L, dim) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


# -- kseq ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpu_kseq():
    return _load("kseq", INTERPRET=True, L=512, CHUNK=128)


def _kseq_inputs(seed, L):
    G, D, N = port_kseq.G, port_kseq.D, port_kseq.N
    rng = np.random.RandomState(seed)
    return dict(
        u=rng.randn(G, L, 8, D).astype(BF16),
        delta=(np.abs(rng.randn(G, L, 8, D)) * 0.5).astype(BF16),
        Bm=rng.randn(G, L, N, 8, 1).astype(BF16),
        Cm=rng.randn(G, L, N, 8, 1).astype(BF16),
        A=-np.exp(rng.randn(G * D, N) * 0.5).astype(np.float32),
        Dv=np.ones(G * D, np.float32),
        bias=(rng.randn(G * D) * 0.01).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("win", [None, 8])
def test_kseq_plain_matches_jax_kernel_seq(tpu_kseq, win, reverse):
    """kernel_seq (win None) and kernel_seq_win (win 8) at kseq's interpret
    size (L 512, chunks of 128) against the port's scan_seq in kseq's own
    (G, L, 8, Dg) layout."""
    G, D, N = port_kseq.G, port_kseq.D, port_kseq.N
    p = _kseq_inputs(17 + 2 * reverse + (win or 0), 512)
    fwd = tpu_kseq.build_seq(chunk=128, seq=512, reverse=reverse, win=win)
    A_s = np.transpose(p["A"].reshape(G, D, N), (0, 2, 1))[:, :, None, :]
    ref = fwd(p["u"], p["delta"], A_s, p["Bm"], p["Cm"],
              p["Dv"].reshape(G, 1, D), p["bias"].reshape(G, 1, D))
    got = port_kseq.run_seq({k: _t(v) for k, v in p.items()},
                            win or 1, reverse)
    assert got.dtype == torch.bfloat16 and got.shape == (G, 512, 8, D)
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), **BF16_TOL)


# -- kvariants -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tpu_kv():
    mod = _load("kvariants", B=2, L=512, CHUNK=256, INTERPRET=True)
    mod.pl = _Interpreted(pl)
    return mod


def _v16_both(tpu_kv, p):
    """kernel_v16's two outputs (y, y2) through a pallas_call laid out as
    `build` lays it out (tools/kvariants.py:1122-1166), interpreted."""
    B, dim, L = p["u"].shape
    G, N, chunk = p["Bm"].shape[1], p["Bm"].shape[2], tpu_kv.CHUNK
    d_tile = dim // G
    spec = pl.BlockSpec((1, d_tile, chunk), lambda b, dt, c: (b, dt, c))
    bc = pl.BlockSpec((1, 1, N, chunk), lambda b, dt, c: (b, dt, 0, c))
    col = pl.BlockSpec((d_tile, 1), lambda b, dt, c: (dt, 0))
    out = jax.ShapeDtypeStruct((B, dim, L), jnp.bfloat16)
    y, y2 = pl.pallas_call(
        functools.partial(tpu_kv.kernel_v16, nstate=N, chunk=chunk, sub=128),
        grid=(B, G, L // chunk),
        in_specs=[spec, spec,
                  pl.BlockSpec((N, d_tile, 1), lambda b, dt, c: (0, dt, 0)),
                  bc, bc, col, col],
        out_specs=[spec, spec], out_shape=[out, out],
        scratch_shapes=[tpu_kv.pltpu.VMEM((N, d_tile, 1), jnp.float32)],
        interpret=True,
    )(p["u"], p["delta"], p["A"].T[:, :, None], p["Bm"], p["Cm"],
      p["Dv"][:, None], p["bias"][:, None])
    return _f32(y), _f32(y2)


@pytest.fixture(scope="module")
def kv_case(tpu_kv):
    """One seeded input set at the interpret size and the JAX outputs of
    v1_128 (build) and v12_ld_128 (build_ld) on it; of the bf16 stacks v3
    and v10_128 (build); and v16's y and y2."""
    B, L, G, N = 2, 512, port_kv.SHAPE["G"], port_kv.SHAPE["N"]
    dim = G * port_kv.SHAPE["D"]
    rng = np.random.RandomState(23)
    p = dict(u=rng.randn(B, dim, L).astype(BF16),
             delta=(np.abs(rng.randn(B, dim, L)) * 0.5).astype(BF16),
             Bm=rng.randn(B, G, N, L).astype(BF16),
             Cm=rng.randn(B, G, N, L).astype(BF16),
             A=-np.exp(rng.randn(dim, N) * 0.5).astype(np.float32),
             Dv=np.ones(dim, np.float32),
             bias=(rng.randn(dim) * 0.01).astype(np.float32))
    rest = (p["Bm"], p["Cm"], p["Dv"][:, None], p["bias"][:, None])
    # `build`'s default chunk was bound when the module loaded: pass it.
    # `build` takes A as (N, DIM, 1); `build_ld` swaps the first two axes
    # of what it is given (tools/kvariants.py:1090), so it needs A as
    # (DIM, N, 1): given build's (N, DIM, 1), its blocks read past A.
    out = {name: _f32(tpu_kv.build(*tpu_kv.VARIANTS[name],
                                   chunk=tpu_kv.CHUNK)(
               p["u"], p["delta"], a, *rest))
           for name, a in (("v1_128", p["A"].T[:, :, None]),
                           ("v12_ld_128", p["A"][:, :, None]),
                           ("v3", p["A"].T[:, :, None]),
                           ("v10_128", p["A"].T[:, :, None]))}
    out["v16_combined_128"], out["v16_combined_128:y2"] = _v16_both(tpu_kv, p)
    inp = {k: _t(v) for k, v in p.items()}
    inp["u_ld"] = inp["u"].transpose(1, 2).contiguous()
    inp["delta_ld"] = inp["delta"].transpose(1, 2).contiguous()
    return inp, out


@pytest.mark.parametrize("tpu,port", [("v1_128", "lpar_256"),
                                      ("v12_ld_128", "seq_ld"),
                                      ("v12_ld_128", "lpar_ld_1024")])
def test_kvariants_plain_matches_jax_variant(kv_case, tpu, port):
    """v1_128 through `build`, v12_ld_128 through `build_ld`, B 2, L 512,
    chunks of 256, against their port counterparts."""
    inp, out = kv_case
    got = port_kv.VARIANTS[port][0](inp, 256)
    assert got.dtype == torch.bfloat16 and got.shape == out[tpu].shape
    np.testing.assert_allclose(got.float().numpy(), out[tpu], **BF16_TOL)


def test_kvariants_race_variants_all_match_jax(kv_case):
    """The slice as a whole: every variant the port races, on the same
    numpy inputs, against the TPU race's v1_128 (which itself agrees with
    its v12_ld_128 to the bf16 envelope), at the TPU race's interpret
    chunk of 256; the bf16 stacks v3 and v10_128 against the TPU race's
    kernel of the same name (off v1_128 on this hot recipe, as the TPU's
    are), and v16's y2 against the TPU's. The separated-exponent variants
    pass their clamp on this recipe (v4 overflows): each is held to its
    own TPU kernel in tests/test_torch_port_dual.py."""
    inp, out = kv_case
    np.testing.assert_allclose(out["v12_ld_128"], out["v1_128"], **BF16_TOL)
    for name, (call, _, _) in port_kv.VARIANTS.items():
        if name in port_kv.SEPARATED:
            continue
        got = call(inp, 256)
        if isinstance(got, tuple):
            got, y2 = got
            np.testing.assert_allclose(y2.float().numpy(),
                                       out[name + ":y2"], **BF16_TOL,
                                       err_msg=name + " y2")
        ref = out[name] if name in ("v3", "v10_128") else out["v1_128"]
        np.testing.assert_allclose(got.float().numpy(), ref, **BF16_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("name,stack,sub", [("v3", "ab", None),
                                            ("v10_128", "b", 128)])
def test_kvariants_bf16_stack_plain_matches_jax(kv_case, name, stack, sub):
    """kernel_v3 and kernel_v10 (build, B 2, L 512, chunks of 256) against
    `run_stack` at chunk 256: the plain version rounds where the TPU
    kernels round (measured: v3 within 1.6e-2, v10 within 6.3e-2, of
    outputs up to 64.5; each is 0.38 / 0.25 off v1_128)."""
    inp, out = kv_case
    kernel = port_kv.VARIANTS[name][1]
    got = port_kv.run_stack(inp, stack, chunk=256, sub=sub)
    assert got.dtype == torch.bfloat16 and got.shape == out[name].shape
    assert getattr(cuda_probes, kernel).launches == 0  # the plain path
    err = np.abs(got.float().numpy() - out[name]).max()
    np.testing.assert_allclose(got.float().numpy(), out[name], **BF16_TOL,
                               err_msg=f"max abs err {err:.3e}")


def test_kvariants_v16_plain_matches_jax_both_outputs(kv_case):
    """kernel_v16's y (the exact forward scan) and y2 (the reverse scan
    restarted at each chunk of 256) against `run_combined` at chunk 256
    (measured: y within 3.1e-2, y2 within 6.3e-2, of outputs up to
    64.5)."""
    inp, out = kv_case
    y, y2 = port_kv.run_combined(inp, chunk=256)
    for got, ref in ((y, out["v16_combined_128"]),
                     (y2, out["v16_combined_128:y2"])):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        err = np.abs(got.float().numpy() - ref).max()
        np.testing.assert_allclose(got.float().numpy(), ref, **BF16_TOL,
                                   err_msg=f"max abs err {err:.3e}")
    # y2 is no forward scan: it differs from y
    assert np.abs(out["v16_combined_128:y2"] -
                  out["v16_combined_128"]).max() > 1.0


def test_bf16_stacks_leave_the_envelope_on_the_hot_recipe(kv_case):
    """The finding behind kvariants' default recipe (post-softplus delta
    near 0.9): the TPU's v3 and v10 themselves, in interpret mode, are off
    the exact scan's bf16 envelope there. The port's parity holds the
    stacks to their own plain version, which rounds as the TPU's do, and
    reports their distance from the exact scan: off the envelope here, on
    it on the model-realistic recipe (the next test)."""
    _, out = kv_case
    for name in ("v3", "v10_128"):
        err = np.abs(out[name] - out["v1_128"])
        assert (err > BF16_TOL["atol"] + BF16_TOL["rtol"]
                * np.abs(out["v1_128"])).any(), name
    rows = port_kv.run(["v3", "v10_128", "v16_combined_128"],
                       torch.device("cpu"))
    for row in rows[:2]:
        assert row["max_abs_err"] == 0.0, row  # the plain version itself
        assert row["exact_off_envelope"] > 0 and \
            row["exact_max_abs_err"] > BF16_TOL["atol"], row
    assert "exact_off_envelope" not in rows[2]
    # a kernel off its plain version still raises
    with pytest.raises(RuntimeError, match="kvariants v3: y off its plain"):
        port_kv._check("v3", "y", torch.ones(3), torch.zeros(3))


def test_kvariants_cli_prints_the_slice_rows(capsys):
    """`python -m vmambair_torch.tools.kvariants v3 v10_128
    v16_combined_128 --device cpu` on the default recipe: three parity
    rows within the envelope, the stacks' distance from the exact scan
    beside."""
    port_kv.main(["v3", "v10_128", "v16_combined_128", "--device", "cpu"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == ["v3", "v10_128",
                                            "v16_combined_128"]
    assert all(r["max_abs_err"] == 0.0 for r in rows)
    assert all("exact_max_abs_err" in r for r in rows[:2])
    assert "y2_max_abs_err" in rows[2]


def test_kvariants_new_variants_run_on_cpu():
    """The slice as a whole through `run`: the realistic recipe gives one
    parity row per variant, no times, v16's with its y2 error."""
    rows = port_kv.run(["v3", "v10_128", "v16_combined_128"],
                       torch.device("cpu"), delta="real")
    assert [r["variant"] for r in rows] == ["v3", "v10_128",
                                            "v16_combined_128"]
    assert all("ms" not in r for r in rows)
    assert rows[2]["y2_max_abs_err"] == 0.0 == rows[2]["max_abs_err"]
    assert all(r["max_abs_err"] == 0.0 for r in rows[:2])
    assert all(0 < r["exact_max_abs_err"] < 0.05 and
               r["exact_off_envelope"] == 0.0 for r in rows[:2])


# -- kpeak ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpu_kpeak():
    return _load("kpeak", ROWS=8, LANES=128)


KPEAK_KERNELS = {"fma_fp32": "kern_fma", "fma_bf16": "kern_fma",
                 "exp_fp32": "kern_exp", "roll+add_fp32": "kern_roll",
                 "concatshift+add_fp32": "kern_shift_concat"}


@pytest.mark.parametrize("probe", list(KPEAK_KERNELS))
def test_peak_plain_matches_jax_kpeak(tpu_kpeak, probe):
    """kpeak's kernel bodies through a pallas_call built here, blocks of
    (1, 8, 128), at kpeak's REP = 64."""
    fn, _, dtype, _ = cuda_probes.PEAK_PROBES[probe]
    x = (np.random.RandomState(3).rand(2, 8, 128) * 0.1 + 0.5).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    spec = pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))
    ref = pl.pallas_call(
        getattr(tpu_kpeak, KPEAK_KERNELS[probe]), grid=(2,),
        in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jdt),
        interpret=True)(jnp.asarray(x).astype(jdt))
    assert tpu_kpeak.REP == cuda_probes.PEAK_REP
    got = fn(torch.from_numpy(x).to(dtype))
    tol = BF16_TOL if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), **tol)


# -- the entry points and their refusals -----------------------------------------

@pytest.mark.parametrize("tool,args", [
    ("kvariants", ["seq_win8", "lpar_256"]),
    ("kseq", ["seq_win8_rev"]),
    ("kpeak", ["exp_fp32"])])
def test_probe_entry_points_on_cpu(capsys, tool, args):
    """`--device cpu`: the parity rows of the plain versions, no times."""
    mod = {"kvariants": port_kv, "kseq": port_kseq, "kpeak": port_kpeak}[tool]
    mod.main(args + ["--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == len(args)
    assert all(r["max_abs_err"] == 0.0 and "ms" not in r for r in rows)


def test_probes_refuse_what_they_do_not_carry():
    with pytest.raises(ValueError, match="unsupported \\(sub, blk\\)"):
        port_kv.check_names(["v22_dual_128_48"])
    with pytest.raises(ValueError, match="unsupported \\(sub, blk\\)"):
        port_kv.check_names(["v4_64"])
    with pytest.raises(ValueError, match="carried by lpar_256"):
        port_kv.check_names(["v8s_128"])
    with pytest.raises(ValueError, match="unknown variant"):
        port_kv.check_names(["nope"])
    with pytest.raises(ValueError, match="unknown variants"):
        port_kseq.run(["v20_seq"], torch.device("cpu"))
    u = torch.zeros(1, 2, 8, 4)
    bc = torch.zeros(1, 2, 8, 17)
    with pytest.raises(ValueError, match="N=17 over"):
        cuda_probes.scan_seq(u, u, torch.zeros(8, 17), bc, bc, None, None,
                             u.clone())
