"""The port's plain scan and GDFN versions against the JAX package, on CPU.

The same numpy inputs (from `numpy.random.RandomState`) go through the JAX
function, run as the JAX tests run it on the CPU (Pallas in interpret
mode), and through the port's function on CPU tensors, which routes to the
plain version. Tolerances are fp32: 1e-4 for the scans, 1e-5 for the GDFN
(the TPU kernel's A&S erf is off by 1.5e-7; the port uses the true erf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.ops.pallas_effn import gdfn_residual_fused as jax_gdfn
from vmambair_tpu.ops.pallas_scan import oss_scan_fused as jax_oss_scan
from vmambair_tpu.ops.pallas_scan import selective_scan as jax_scan
from vmambair_tpu.ops.selective_scan import selective_scan_seq as jax_seq
from vmambair_torch.ops import cuda_effn, cuda_scan
from vmambair_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                               selective_scan_chunked)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _fused_inputs(rng, B, G, D, L, N, R):
    return dict(
        u2=rng.randn(B, G, D, L).astype(np.float32),
        x_proj_w=(rng.randn(G, R + 2 * N, D) / np.sqrt(D)).astype(
            np.float32),
        dt_proj_w=(rng.randn(G, D, R) / np.sqrt(R)).astype(np.float32),
        dt_bias=rng.uniform(-4.0, -1.0, (G, D)).astype(np.float32),
        A=-np.exp(rng.uniform(0.0, 2.0, (G, D, N))).astype(np.float32),
        Ds=rng.randn(G, D).astype(np.float32),
    )


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,G,D,L,N,R",
                         [(2, 2, 16, 64, 4, 2), (2, 2, 8, 128, 16, 3)])
def test_oss_scan_fused_plain_matches_jax(B, G, D, L, N, R, reverse):
    p = _fused_inputs(np.random.RandomState(L + N), B, G, D, L, N, R)
    ref = jax_oss_scan(*(jnp.asarray(v) for v in p.values()),
                       softplus=True, reverse=reverse, interpret=True,
                       dl=True)
    got = cuda_scan.oss_scan_fused(*(_t(v) for v in p.values()),
                                   softplus=True, reverse=reverse)
    assert got.shape == (B, G, D, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def _scan_inputs(rng, B, L, D, G, N):
    return dict(
        u=rng.randn(B, L, D).astype(np.float32),
        delta=rng.uniform(-3.0, 0.5, (B, L, D)).astype(np.float32),
        A=-np.exp(rng.uniform(-1.0, 1.5, (D, N))).astype(np.float32),
        B=rng.randn(B, L, G, N).astype(np.float32),
        C=rng.randn(B, L, G, N).astype(np.float32),
        D=rng.randn(D).astype(np.float32),
        delta_bias=rng.uniform(-1.0, 1.0, D).astype(np.float32),
    )


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N", [4, 32])
def test_selective_scan_plain_matches_jax(N, reverse):
    p = _scan_inputs(np.random.RandomState(N), 2, 96, 32, 2, N)
    ref = jax_scan(*(jnp.asarray(v) for v in p.values()),
                   delta_softplus=True, impl="pallas", interpret=True,
                   reverse=reverse)
    got = cuda_scan.selective_scan(*(_t(v) for v in p.values()),
                                   delta_softplus=True, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_selective_scan_plain_bf16_out_dtype_matches_jax():
    """out_dtype=bf16 rounds the same fp32 result: the fp32 values agree to
    1e-4, so the bf16 outputs agree to one bf16 step (2^-8 relative)."""
    p = _scan_inputs(np.random.RandomState(7), 2, 64, 32, 2, 16)
    ref = jax_scan(*(jnp.asarray(v) for v in p.values()),
                   delta_softplus=True, impl="pallas", interpret=True,
                   reverse=True, out_dtype=jnp.bfloat16)
    got = cuda_scan.selective_scan(*(_t(v) for v in p.values()),
                                   delta_softplus=True, reverse=True,
                                   out_dtype=torch.bfloat16)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -8, atol=1e-4)


@pytest.mark.parametrize("chunk_size", [1, 16, 64])
def test_selective_scan_chunked_matches_jax_seq(chunk_size):
    """The plain chunked scan against JAX's sequential reference: one step
    per chunk, a chunk that does not divide L, one chunk longer than L."""
    p = _scan_inputs(np.random.RandomState(3), 2, 50, 16, 4, 8)
    ref = jax_seq(*(jnp.asarray(v) for v in p.values()),
                  delta_softplus=True)
    got = selective_scan_chunked(*(_t(v) for v in p.values()),
                                 delta_softplus=True, chunk_size=chunk_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def _f2_inputs(grow):
    """The inputs of the CUDA tests' K3 case without D and bias (drawn as
    `test_torch_port_cuda._scan_args` draws them, on the CPU) and the dy of
    seed 47; grow: the raw delta ~ N(0, 1), else |N(0, 1)|."""
    g = torch.Generator().manual_seed(1)
    u = torch.randn(2, 16, 40, generator=g).transpose(1, 2)
    delta = torch.randn(2, 40, 16, generator=g)
    A = -torch.exp(torch.rand(16, 16, generator=g))
    B = torch.randn(2, 40, 2, 16, generator=g)
    C = torch.randn(2, 40, 2, 16, generator=g)
    args = [u, delta if grow else delta.abs(), A, B, C, None, None]
    return args, torch.randn(2, 40, 16,
                             generator=torch.Generator().manual_seed(47))


@pytest.mark.parametrize("grow", [True, False])
def test_scan_backward_fp32_against_the_fp64_oracle(grow):
    """ROADMAP F2: where the raw delta lets the state grow (to ~7e11 over
    L = 40), the gradients are sums that cancel, and the fp32 plain
    backward itself misses the exact (fp64) gradients by more than the
    CUDA tests' GRAD_TOL (rtol 3e-3, atol 1e-2); with the state decaying
    it holds that bar. So the CUDA tests hold K3 on a growing state to a
    multiple of the plain version's own distance, and to the bar on a
    decaying one."""
    args, dy = _f2_inputs(grow)
    ref = selective_scan_bwd_ref(*args, dy)
    orc = selective_scan_bwd_ref(
        *[None if t is None else t.double() for t in args], dy.double())
    assert all(t.dtype == torch.float64 for t in orc[:5])
    assert orc[5] is None and orc[6] is None
    ratio = max(((a.double() - b).abs() / (1e-2 + 3e-3 * b.abs())).max()
                .item() for a, b in zip(ref[:5], orc[:5]))
    assert (ratio > 1) if grow else (ratio < 1e-2), ratio


# the dy seeds of tests/test_torch_port_cuda.py's F2 tests
F2_SEEDS = (0, 1, 2, 3, 47, 81, 358, 371)


@pytest.mark.parametrize("seed", F2_SEEDS)
def test_k3_order_against_the_fp64_oracle(seed):
    """ROADMAP F2 on the CPU: K3's order of operations (a Hillis-Steele
    tree over each chunk of 32 positions, fp64 sums over states and
    channels; `tests/k3_order.py`) on the growing recipe, from the exact
    carries, within GRAD_TOL of the exact gradients where the fp32 plain
    version is and else within 3x that version's own distance, as the
    CUDA test holds K3 (F2_FACTOR); on the decaying recipe within
    GRAD_TOL. Prints both distances (run with -s)."""
    from k3_order import k3_order_bwd

    def bar(got, ref):
        return ((got.double() - ref).abs() / (1e-2 + 3e-3 * ref.abs())) \
            .max().item()

    for grow in (True, False):
        args, _ = _f2_inputs(grow)
        dy = torch.randn(2, 40, 16,
                         generator=torch.Generator().manual_seed(seed))
        a64 = [None if t is None else t.double() for t in args]
        orc = selective_scan_bwd_ref(*a64, dy.double())
        carries = selective_scan_chunked(
            *a64, chunk_size=32, return_carries=True)[1].float()
        got = [bar(a, b) for a, b in zip(
            k3_order_bwd(*args[:5], dy, carries), orc[:5])]
        ref = [bar(a, b) for a, b in zip(
            selective_scan_bwd_ref(*args, dy)[:5], orc[:5])]
        print(f"F2 seed {seed} grow={grow}: x bar from the fp64 oracle: "
              f"K3's order {[round(r, 3) for r in got]}, fp32 plain "
              f"{[round(r, 3) for r in ref]}")
        for a, b in zip(got, ref):
            assert a <= (max(1.0, 3 * b) if grow else 1.0), (a, b)


@pytest.mark.parametrize("seed", F2_SEEDS)
def test_scan_backward_within_the_conditioned_bound(seed):
    """ROADMAP F2, order-independent: on the growing recipe the fp32 plain
    backward (autograd through its Hillis-Steele chunks) and K3's order
    (`tests/k3_order.py`, from the exact carries) each hold every gradient
    within C_BOUND n u32 kappa of the fp64 oracle, kappa the gradients on
    the magnitudes of their terms, n = L (the bound is derived in
    `tests/f2_bound.py`). Prints each gradient's largest error over its
    bound (run with -s)."""
    from f2_bound import bound_ratios
    from k3_order import k3_order_bwd

    args, _ = _f2_inputs(True)
    dy = torch.randn(2, 40, 16,
                     generator=torch.Generator().manual_seed(seed))
    a64 = [None if t is None else t.double() for t in args]
    orc = selective_scan_bwd_ref(*a64, dy.double())
    carries = selective_scan_chunked(
        *a64, chunk_size=32, return_carries=True)[1].float()
    plain = bound_ratios(selective_scan_bwd_ref(*args, dy)[:5], orc[:5],
                         args, dy)
    order = bound_ratios(k3_order_bwd(*args[:5], dy, carries), orc[:5],
                         args, dy)
    print(f"F2 seed {seed}: error over the conditioned bound (du, ddelta, "
          f"dA, dB, dC): fp32 plain {[f'{r:.3g}' for r in plain]}, K3's "
          f"order {[f'{r:.3g}' for r in order]}")
    assert max(plain) <= 1.0 and max(order) <= 1.0, (plain, order)


@pytest.mark.parametrize("shape,hid", [((1, 8, 8, 8), 21),
                                       ((2, 8, 16, 16), 43)])
def test_gdfn_plain_matches_jax(shape, hid):
    b, h, w, c = shape
    rng = np.random.RandomState(c + hid)
    x = (0.5 * rng.randn(*shape)).astype(np.float32)
    ln_w = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    ln_b = (0.1 * rng.randn(c)).astype(np.float32)
    w_in = (0.2 * rng.randn(c, 2 * hid)).astype(np.float32)    # JAX (C, 2h)
    w_dw = (0.3 * rng.randn(3, 3, 2 * hid)).astype(np.float32)
    w_out = (0.2 * rng.randn(hid, c)).astype(np.float32)      # JAX (h, C)
    ref = jax_gdfn(*(jnp.asarray(v) for v in (x, ln_w, ln_b, w_in, w_dw,
                                               w_out)),
                   eps=1e-5, interpret=True)
    got = cuda_effn.gdfn_residual_fused(
        _t(x).permute(0, 3, 1, 2), _t(ln_w), _t(ln_b), _t(w_in).t(),
        _t(w_dw).permute(2, 0, 1), _t(w_out).t(), eps=1e-5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
