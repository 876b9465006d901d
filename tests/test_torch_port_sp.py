"""The port's sequence-parallel scan against the JAX package's, on CPU.

The plain scan's entering and last state against JAX's
`selective_scan_xla(h0=, return_last_state=)`; `sharded_scan` (each rank's
L shard through `selective_scan_sp`, the shards' y gathered) in worlds of
2 and 4 gloo processes against JAX's `selective_scan_sp` on meshes of 2
and 4 of the conftest's virtual CPU devices, forward and (on the flipped
sequence, as JAX's dispatch runs it) reverse; and a tiny `scan_impl:
"sp"` OSSNet at world 2 against its normal forward. fp32 throughout:
1e-4, the scans' bar in `test_torch_port_ops.py` (the two passes and the
fold of the shards' maps reassociate the sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_dist_cases import run_world, sp_net_case, sp_scan_case
from vmambair_tpu.ops.selective_scan import selective_scan_xla
from vmambair_tpu.parallel.sp_scan import selective_scan_sp as jax_sp
from vmambair_torch.ops import cuda_scan
from vmambair_torch.ops.selective_scan import selective_scan_chunked
from vmambair_torch.parallel import sp_scan

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B=2, L=64, D=8, G=2, N=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, L, D).astype(np.float32),
            (0.5 * rng.randn(B, L, D)).astype(np.float32),
            -np.exp(rng.uniform(0.0, 2.0, (D, N))).astype(np.float32),
            rng.randn(B, L, G, N).astype(np.float32),
            rng.randn(B, L, G, N).astype(np.float32),
            rng.randn(D).astype(np.float32),
            rng.uniform(-3.0, -1.0, D).astype(np.float32))


def _flip(arrays):
    u, d, A, B, C, D, bias = arrays
    return (u[:, ::-1].copy(), d[:, ::-1].copy(), A, B[:, ::-1].copy(),
            C[:, ::-1].copy(), D, bias)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_scan_from_an_entering_state_matches_jax(reverse):
    """y and the last state from a given h0, and from zeros; a reverse
    scan is JAX's scan of the flipped sequence. Also the K4 state form's
    CPU route (its plain version)."""
    arrays = _inputs(1)
    h0 = np.random.RandomState(2).randn(2, 8, 16).astype(np.float32)
    ref_in = _flip(arrays) if reverse else arrays
    for h in (h0, None):
        y_ref, last_ref = selective_scan_xla(
            *(jnp.asarray(a) for a in ref_in), delta_softplus=True,
            return_last_state=True,
            h0=None if h is None else jnp.asarray(h))
        y_ref = np.asarray(y_ref)[:, ::-1] if reverse else np.asarray(y_ref)
        t = [torch.from_numpy(a) for a in arrays]
        ht = None if h is None else torch.from_numpy(h)
        y, last = selective_scan_chunked(*t, delta_softplus=True,
                                         reverse=reverse, h0=ht,
                                         return_last_state=True)
        np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
        np.testing.assert_allclose(last.numpy(), np.asarray(last_ref), **TOL)
        y2, last2 = cuda_scan.selective_scan_fwd_state(
            *t, delta_softplus=True, reverse=reverse, h0=ht)
        assert torch.equal(y2, y) and torch.equal(last2, last)


def test_scan_composes_from_its_first_half_s_last_state():
    """The whole scan's second half equals the scan of the second half
    from the first half's last state (the identity the sp passes rest on)."""
    t = [torch.from_numpy(a) for a in _inputs(3)]
    y, _ = cuda_scan.selective_scan_fwd_state(*t, delta_softplus=True)
    half = [x[:, :32] if x.dim() > 1 and x.shape[1] == 64 else x for x in t]
    rest = [x[:, 32:] if x.dim() > 1 and x.shape[1] == 64 else x for x in t]
    _, s = cuda_scan.selective_scan_fwd_state(*half, delta_softplus=True)
    y2, _ = cuda_scan.selective_scan_fwd_state(*rest, delta_softplus=True,
                                               h0=s)
    np.testing.assert_allclose(y2.numpy(), y[:, 32:].numpy(), **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_sp_scan_matches_jax(tmp_path, world):
    """Forward and reverse, each rank's gathered y against JAX's
    `selective_scan_sp` over a mesh of `world` devices."""
    arrays = _inputs(world)
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    got = run_world(sp_scan_case, world, tmp_path, arrays)
    for reverse in (False, True):
        ref_in = _flip(arrays) if reverse else arrays
        ref = np.asarray(jax_sp(*(jnp.asarray(a) for a in ref_in),
                                delta_softplus=True, mesh=mesh, axis="sp"))
        if reverse:
            ref = ref[:, ::-1]
        for ys in got:
            np.testing.assert_allclose(ys[reverse], ref, **TOL)


def test_sp_net_matches_its_normal_forward(tmp_path):
    """A tiny OSSNet with `scan_impl: "sp"` at world 2: its spatial pairs
    through the sharded scan (L = 192, 48 and 12 divide over 2 ranks; the
    latent's 3 does not and takes the normal path) against the same
    weights' normal forward (K1 on the CPU: the plain fused scan)."""
    net_opt = {"type": "OSSNet", "dim": 8, "num_blocks": [1, 1, 1, 1],
               "num_refinement_blocks": 1, "scale": 4}
    x = np.random.RandomState(4).rand(1, 3, 24, 8).astype(np.float32)
    for y_sp, y, calls in run_world(sp_net_case, 2, tmp_path, net_opt, x):
        # two pairs in each block but the latent's: encoder and decoder
        # levels 1-3 and the refinement block
        assert calls == [12] * 4 + [48] * 4 + [192] * 6
        assert y_sp.shape == (1, 3, 96, 32)
        np.testing.assert_allclose(y_sp, y, **TOL)


def test_sp_scan_refuses_a_gradient_and_a_ragged_l():
    t = [torch.from_numpy(a) for a in _inputs(5)]
    t[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        sp_scan.selective_scan_sp(*t, delta_softplus=True)
    assert not sp_scan.sp_scan_supported(64, None)
