"""The port's gradients against the JAX package's, on CPU.

The same numpy inputs go through the JAX function and the port's. On the
JAX side the scans run their backward kernel (`_scan_bwd_kernel`) in
interpret mode, as `tests/test_selective_scan.py` runs it, or the net runs
its CPU path (`scan_impl="xla"`); on the port's side CPU tensors take the
plain versions inside the same autograd Functions the card runs. Bars: the
plain carries 1e-5 (one fp32 recurrence against another); gradients of the
ops within 5x the reference CUDA forward envelope (rtol 3e-3, atol 1e-2,
the scale of JAX's own gradient tests); net gradients 2e-3 of the largest
entry per tensor (the bar of `test_torch_parity.py`'s A/B run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.models import OSSNet as JaxOSSNet
from vmambair_tpu.ops.pallas_effn import gdfn_residual_fused as jax_gdfn
from vmambair_tpu.ops.pallas_scan import oss_scan_fused as jax_oss_scan
from vmambair_tpu.ops.pallas_scan import selective_scan as jax_scan
from vmambair_tpu.ops.selective_scan import selective_scan_seq as jax_seq
from vmambair_torch.models import OSSNet
from vmambair_torch.ops import cuda_effn, cuda_scan
from vmambair_torch.ops.selective_scan import selective_scan_bwd_ref
from vmambair_torch.utils.convert import jax_to_torch

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=3e-3, atol=1e-2)
SCAN_ARGS = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


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


def _weights(shape):
    """The cotangent of sum(y * w): a fixed, sign-changing pattern."""
    return np.cos(np.arange(np.prod(shape))).reshape(shape).astype(
        np.float32)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_carries_match_jax_prefix_states(reverse):
    """The state entering chunk k is the last state of the sequential scan
    over what precedes it in scan order: the prefix [0, 32k) forward, the
    suffix [32(k+1), L) reversed. L = 80 leaves a ragged last chunk."""
    p = _scan_inputs(np.random.RandomState(4), 2, 80, 8, 2, 4)
    _, car = cuda_scan.selective_scan_carries_ref(
        *(_t(v) for v in p.values()), delta_softplus=True, reverse=reverse)
    ch = cuda_scan.CARRY_CHUNK
    assert ch == 32 and car.shape == (2, 8, 3, 4)

    def seq_state(sl, flip):
        args = []
        for k, v in p.items():
            v = jnp.asarray(v)
            if k in ("u", "delta", "B", "C"):
                v = v[:, sl][:, ::-1] if flip else v[:, sl]
            args.append(v)
        return np.asarray(jax_seq(*args, delta_softplus=True,
                                  return_last_state=True)[1])

    for k in range(3):
        if reverse:
            want = (np.zeros((2, 8, 4), np.float32) if k == 2 else
                    seq_state(slice(ch * (k + 1), 80), True))
        else:
            want = (np.zeros((2, 8, 4), np.float32) if k == 0 else
                    seq_state(slice(0, ch * k), False))
        np.testing.assert_allclose(car[:, :, k].numpy(), want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("G", [1, 2])
def test_scan_gradients_match_jax_backward_kernel(G, reverse):
    """`selective_scan_bwd_ref` and the autograd `selective_scan` (the K4c
    / K3 Function on its plain versions) against jax.grad through the
    Pallas scan with its backward kernel, interpreted."""
    p = _scan_inputs(np.random.RandomState(10 * G + reverse), 2, 64, 8 * G,
                     G, 4)
    w = _weights((2, 64, 8 * G))

    def loss(*a):
        y = jax_scan(*a, delta_softplus=True, impl="pallas", interpret=True,
                     reverse=reverse)
        return jnp.sum(y * w)

    ref = jax.grad(loss, argnums=tuple(range(7)))(
        *(jnp.asarray(v) for v in p.values()))
    direct = selective_scan_bwd_ref(
        *(_t(v) for v in p.values()), _t(w), delta_softplus=True,
        reverse=reverse)
    ins = [_t(v, grad=True) for v in p.values()]
    y = cuda_scan.selective_scan(*ins, delta_softplus=True, reverse=reverse)
    via_fn = torch.autograd.grad(y, ins, _t(w))
    for name, r, a, b in zip(SCAN_ARGS, ref, direct, via_fn):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL,
                                   err_msg=f"bwd_ref d{name}")
        np.testing.assert_allclose(b.numpy(), np.asarray(r), **GRAD_TOL,
                                   err_msg=f"autograd d{name}")


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_scan_gradients_match_jax(reverse):
    """The six gradients of the autograd `oss_scan_fused` (K1c / K3 and the
    projection einsums, on the plain versions) against JAX's fused op with
    its backward kernel, at L = 256, in the kernel layout (dl=True)."""
    rng = np.random.RandomState(20 + reverse)
    B, G, D, L, N, R = 2, 2, 8, 256, 4, 2
    p = [rng.randn(B, G, D, L).astype(np.float32),
         (0.3 * rng.randn(G, R + 2 * N, D)).astype(np.float32),
         (0.3 * rng.randn(G, D, R)).astype(np.float32),
         (0.1 * rng.randn(G, D)).astype(np.float32),
         (-0.5 - np.exp(0.5 * rng.randn(G, D, N))).astype(np.float32),
         rng.randn(G, D).astype(np.float32)]
    w = _weights((B, G, D, L))

    def loss(*a):
        y = jax_oss_scan(*a, softplus=True, reverse=reverse, interpret=True,
                         dl=True)
        return jnp.sum(y * w)

    ref = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, p))
    ins = [_t(v, grad=True) for v in p]
    y = cuda_scan.oss_scan_fused(*ins, softplus=True, reverse=reverse)
    got = torch.autograd.grad(y, ins, _t(w))
    for name, r, g in zip(("u2", "x_proj_w", "dt_proj_w", "dt_bias", "A",
                           "Ds"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_gdfn_gradients_match_jax():
    """The autograd `gdfn_residual_fused` (K2 forward, recompute backward;
    the plain version on CPU) against JAX's fused GDFN with its custom VJP,
    interpreted, weights in each framework's layout."""
    rng = np.random.RandomState(3)
    b, h, w, c, hid = 2, 8, 8, 8, 21
    x = (0.5 * rng.randn(b, h, w, c)).astype(np.float32)
    ln_w = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    ln_b = (0.1 * rng.randn(c)).astype(np.float32)
    w_in = (0.2 * rng.randn(c, 2 * hid)).astype(np.float32)
    w_dw = (0.3 * rng.randn(3, 3, 2 * hid)).astype(np.float32)
    w_out = (0.2 * rng.randn(hid, c)).astype(np.float32)
    wt = _weights((b, h, w, c))

    def loss(*a):
        return jnp.sum(jax_gdfn(*a, eps=1e-5, interpret=True) * wt)

    ref = jax.grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (x, ln_w, ln_b, w_in, w_dw, w_out)))
    ins = [_t(x).permute(0, 3, 1, 2), _t(ln_w), _t(ln_b), _t(w_in).t(),
           _t(w_dw).permute(2, 0, 1), _t(w_out).t()]
    ins = [t.contiguous().requires_grad_() for t in ins]
    y = cuda_effn.gdfn_residual_fused(*ins, eps=1e-5)
    got = torch.autograd.grad(y, ins, _t(wt).permute(0, 3, 1, 2))
    back = [got[0].permute(0, 2, 3, 1), got[1], got[2], got[3].t(),
            got[4].permute(1, 2, 0), got[5].t()]
    for name, r, g in zip(("x", "ln_w", "ln_b", "w_in", "w_dw", "w_out"),
                          ref, back):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


def test_tiny_ossnet_l1_gradients_match_jax():
    """Every parameter gradient of the tiny OSSNet under an L1 loss, from
    weights carried over by `jax_to_torch` (gradients map by the same
    layout changes as weights), within 2e-3 of the largest entry. The
    channel scan's `conv_cout.bias` shifts every channel alike just before
    a mean-subtracting LayerNorm, so its exact gradient is 0: both sides
    must show only rounding there."""
    cfg = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
               scale=4, tail="pixelshuffle")
    rng = np.random.RandomState(0)
    lq = rng.rand(2, 16, 16, 3).astype(np.float32)
    gt = rng.rand(2, 64, 64, 3).astype(np.float32)
    model = JaxOSSNet(scan_impl="xla", **cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(lq))[
        "params"]
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jnp.abs(
        model.apply({"params": p}, lq) - gt))))(params)
    ref = jax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))

    net = OSSNet(**cfg)
    net.load_state_dict(jax_to_torch(params))
    out = net(torch.from_numpy(lq).permute(0, 3, 1, 2))
    (out - torch.from_numpy(gt).permute(0, 3, 1, 2)).abs().mean().backward()
    got = {k: p.grad for k, p in net.named_parameters()}
    assert set(got) == set(ref)
    top = max(g.abs().max().item() for g in ref.values())
    for k, g in got.items():
        if k.endswith("conv_cout.bias"):
            assert max(g.abs().max().item(),
                       ref[k].abs().max().item()) <= 1e-5 * top, k
            continue
        scale = ref[k].abs().max().item()
        assert scale > 0, k
        err = (g - ref[k]).abs().max().item() / scale
        assert err <= 2e-3, f"{k}: {err:.2e}"
