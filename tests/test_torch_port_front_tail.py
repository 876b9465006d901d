"""The port's OSS front (K5) and OSS tail (K6) against the JAX package's,
on CPU.

The same numpy inputs go through JAX's plain composites (`_oss_front_xla`,
`_oss_tail_xla`), JAX's Pallas kernels in interpret mode
(`oss_front_fused` / `oss_tail_fused(interpret=True)`) and the port's
plain versions, which are what the port's wrappers and autograd Functions
run on CPU tensors. Layouts: JAX NHWC with (C, E) weights; the port NCHW
with the in_conv weight (2E, C), and the tail reads the scans' (B, 2, D, L)
sum, so the test builds JAX's y_row and y_colT from it. Bars: fp32 1e-5
for the ops; bf16 two output ulps (2^-6 relative): the fp32 statistics
sum in another order in each framework, which can flip the bf16 rounding
of LN(.) by one ulp, and the gate's product rounds once more (JAX's own
kernel-vs-composite tail test allows one);
gradients 1e-4 relative / 1e-5 absolute (both sides recompute through
their composites), the tiny net 3e-5 forward and 2e-3 of each parameter's
largest gradient entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.models import OSSNet as JaxOSSNet
from vmambair_tpu.ops import pallas_effn as jax_effn
from vmambair_torch.models import OSSNet
from vmambair_torch.ops import cuda_effn
from vmambair_torch.utils.convert import jax_to_torch

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _front(rng, b, h, w, c, e):
    """JAX's arguments (NHWC, (C, E) halves) and the port's (NCHW, the
    in_conv weight (2E, C) with its bias, the depthwise (E, 3, 3))."""
    j = dict(x=(0.5 * rng.randn(b, h, w, c)).astype(np.float32),
             ln_w=(1 + 0.1 * rng.randn(c)).astype(np.float32),
             ln_b=(0.1 * rng.randn(c)).astype(np.float32),
             w_x=(0.3 * rng.randn(c, e)).astype(np.float32),
             b_x=(0.1 * rng.randn(e)).astype(np.float32),
             w_z=(0.3 * rng.randn(c, e)).astype(np.float32),
             b_z=(0.1 * rng.randn(e)).astype(np.float32),
             w_dw=(0.3 * rng.randn(3, 3, e)).astype(np.float32),
             b_dw=(0.1 * rng.randn(e)).astype(np.float32))
    p = [_t(j["x"]).permute(0, 3, 1, 2).contiguous(), _t(j["ln_w"]),
         _t(j["ln_b"]),
         _t(np.concatenate([j["w_x"], j["w_z"]], 1)).t().contiguous(),
         _t(np.concatenate([j["b_x"], j["b_z"]])),
         _t(j["w_dw"]).permute(2, 0, 1).contiguous(), _t(j["b_dw"])]
    return j, p


def _tail(rng, b, h, w, d):
    """The scans' (B, 2, D, L) sum, the gate and out_norm; JAX's y_row and
    y_colT (B, H, W, D) made from it."""
    y = (0.7 * rng.randn(b, 2, d, h * w)).astype(np.float32)
    z = rng.randn(b, d, h, w).astype(np.float32)
    z = z / (1 + np.exp(-z))
    lw = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    lb = (0.1 * rng.randn(d)).astype(np.float32)
    j = dict(y_row=y[:, 0].reshape(b, d, h, w).transpose(0, 2, 3, 1),
             y_colT=y[:, 1].reshape(b, d, w, h).transpose(0, 3, 2, 1),
             z=z.transpose(0, 2, 3, 1), ln_w=lw, ln_b=lb)
    return j, [y, z, lw, lb]


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("b,h,w,c,e", [(2, 8, 8, 8, 8), (1, 12, 16, 16, 24),
                                       (1, 5, 8, 6, 6)])
def test_oss_front_ref_matches_jax(b, h, w, c, e):
    """The plain K5 against JAX's composite and JAX's kernel (interpret):
    E != C, H not a power of two."""
    j, p = _front(np.random.RandomState(h + c), b, h, w, c, e)
    xs, z = cuda_effn.oss_front_ref(*p)
    for fn in (lambda: jax_effn._oss_front_xla(**j, eps=1e-5),
               lambda: jax_effn.oss_front_fused(**j, eps=1e-5,
                                                interpret=True)):
        rxs, rz = fn()
        np.testing.assert_allclose(_nhwc(xs), np.asarray(rxs), **TOL)
        np.testing.assert_allclose(_nhwc(z), np.asarray(rz), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,d", [(2, 8, 8, 8), (1, 10, 16, 12),
                                     (1, 6, 8, 5)])
def test_oss_tail_ref_matches_jax(b, h, w, d, dtype):
    """The plain K6 against JAX's composite and kernel (interpret), H != W
    so the column-major pair's transpose shows; in bf16 the sum and the
    gate round as in JAX."""
    j, p = _tail(np.random.RandomState(h + d), b, h, w, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: (jnp.asarray(v).astype(jdt) if k in ("y_row", "y_colT", "z")
             else jnp.asarray(v)) for k, v in j.items()}
    y, z, lw, lb = (torch.from_numpy(a) for a in p)
    got = cuda_effn.oss_tail_ref(y.to(tdt), z.to(tdt), lw, lb)
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -6, atol=2 ** -6)
    for ref in (jax_effn._oss_tail_xla(**j, eps=1e-5),
                jax_effn.oss_tail_fused(**j, eps=1e-5, interpret=True)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref, np.float32),
                                   **tol)


def test_oss_front_and_tail_gradients_match_jax():
    """The autograd `oss_front_fused` / `oss_tail_fused` (the plain
    versions inside the Functions on CPU) against jax.grad through JAX's
    kernels with their custom VJPs, interpreted."""
    rng = np.random.RandomState(7)
    j, p = _front(rng, 1, 8, 8, 8, 8)
    wxs = np.cos(np.arange(64 * 8)).reshape(1, 8, 8, 8).astype(np.float32)
    wz = np.sin(np.arange(64 * 8)).reshape(1, 8, 8, 8).astype(np.float32)

    def front_loss(*a):
        xs, z = jax_effn.oss_front_fused(*a, eps=1e-5, interpret=True)
        return jnp.sum(xs * wxs) + jnp.sum(z * wz)

    keys = list(j)
    ref = jax.grad(front_loss, argnums=tuple(range(9)))(
        *(jnp.asarray(j[k]) for k in keys))
    ref = dict(zip(keys, (np.asarray(r) for r in ref)))
    ins = [t.requires_grad_() for t in p]
    xs, z = cuda_effn.oss_front_fused(*ins)
    g = torch.autograd.grad((xs, z), ins, (_t(wxs).permute(0, 3, 1, 2),
                                           _t(wz).permute(0, 3, 1, 2)))
    gw_in = g[3].t().numpy()
    got = dict(x=_nhwc(g[0]), ln_w=g[1].numpy(), ln_b=g[2].numpy(),
               w_x=gw_in[:, :8], w_z=gw_in[:, 8:], b_x=g[4][:8].numpy(),
               b_z=g[4][8:].numpy(), w_dw=g[5].permute(1, 2, 0).numpy(),
               b_dw=g[6].numpy())
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"front d{k}")

    j, p = _tail(rng, 1, 6, 8, 8)
    wo = np.cos(np.arange(48 * 8)).reshape(1, 6, 8, 8).astype(np.float32)
    keys = list(j)
    ref = jax.grad(lambda *a: jnp.sum(jax_effn.oss_tail_fused(
        *a, eps=1e-5, interpret=True) * wo), argnums=tuple(range(5)))(
        *(jnp.asarray(j[k]) for k in keys))
    ins = [torch.from_numpy(a).requires_grad_() for a in p]
    g = torch.autograd.grad(cuda_effn.oss_tail_fused(*ins), ins,
                            _t(wo).permute(0, 3, 1, 2))
    b, _, d, _ = ins[0].shape
    dy = g[0].numpy()
    got = [dy[:, 0].reshape(b, d, 6, 8).transpose(0, 2, 3, 1),
           dy[:, 1].reshape(b, d, 8, 6).transpose(0, 3, 2, 1),
           _nhwc(g[1]), g[2].numpy(), g[3].numpy()]
    for k, a, r in zip(keys, got, ref):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4, atol=1e-5,
                                   err_msg=f"tail d{k}")


def test_switches_default_off(monkeypatch):
    for k in ("VMAMBAIR_OSS_FRONT", "VMAMBAIR_OSS_TAIL",
              "VMAMBAIR_EFFN_FUSED"):
        monkeypatch.delenv(k, raising=False)
    assert not cuda_effn.oss_front_supported()
    assert not cuda_effn.oss_tail_supported()
    monkeypatch.setenv("VMAMBAIR_OSS_FRONT", "1")
    monkeypatch.setenv("VMAMBAIR_OSS_TAIL", "1")
    assert cuda_effn.oss_front_supported() and cuda_effn.oss_tail_supported()
    monkeypatch.setenv("VMAMBAIR_EFFN_FUSED", "0")
    assert not cuda_effn.oss_front_supported()
    assert not cuda_effn.oss_tail_supported()


def test_tiny_ossnet_with_front_and_tail_matches_jax(monkeypatch):
    """Both switches on in both frameworks (JAX through its Pallas kernels
    interpreted, `scan_impl="fused_interpret"`; the port through K5's and
    K6's autograd Functions, which the spies count): the forward within
    3e-5 and every parameter's L1 gradient within 2e-3 of its largest
    entry, from weights carried over by `jax_to_torch`."""
    monkeypatch.setenv("VMAMBAIR_OSS_FRONT", "1")
    monkeypatch.setenv("VMAMBAIR_OSS_TAIL", "1")
    calls = {"front": 0, "tail": 0}
    for name, key in (("_OssFront", "front"), ("_OssTail", "tail")):
        fn = getattr(cuda_effn, name)
        apply = fn.apply

        def counted(*a, _apply=apply, _key=key):
            calls[_key] += 1
            return _apply(*a)
        monkeypatch.setattr(fn, "apply", counted)
    cfg = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
               scale=4, tail="pixelshuffle")
    rng = np.random.RandomState(1)
    lq = rng.rand(1, 16, 16, 3).astype(np.float32)
    gt = rng.rand(1, 64, 64, 3).astype(np.float32)
    model = JaxOSSNet(scan_impl="fused_interpret", **cfg)
    params = jax.jit(JaxOSSNet(scan_impl="xla", **cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(lq))["params"]

    def loss(p):
        out = model.apply({"params": p}, lq)
        return jnp.mean(jnp.abs(out - gt)), out

    (_, ref_out), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    ref = jax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))

    net = OSSNet(**cfg)
    net.load_state_dict(jax_to_torch(params))
    out = net(torch.from_numpy(lq).permute(0, 3, 1, 2))
    assert calls == {"front": 8, "tail": 8}
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), rtol=3e-5,
                               atol=3e-5)
    (out - torch.from_numpy(gt).permute(0, 3, 1, 2)).abs().mean().backward()
    top = max(g.abs().max().item() for g in ref.values())
    for k, p in net.named_parameters():
        if k.endswith("conv_cout.bias"):  # exactly 0: test_torch_port_grads
            assert max(p.grad.abs().max().item(),
                       ref[k].abs().max().item()) <= 1e-5 * top, k
            continue
        err = (p.grad - ref[k]).abs().max().item() / ref[k].abs().max().item()
        assert err <= 2e-3, f"{k}: {err:.2e}"
