"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda`: each test takes the `cuda` fixture, which skips when no
CUDA device is present (as on a CPU-only machine). On a card, run

    python -m pytest -o addopts="" -p no:cacheprovider --noconftest tests/test_torch_port_cuda.py

Shapes are small and ragged (L not a multiple of the kernels' chunk, odd
image sizes, N above one register batch) to reach the kernels' edges.
Tolerances: fp32 within the reference CUDA envelope (rtol 6e-4, atol
2e-3), bf16 within 3e-2 / 5e-2; gradients and the scan backward within 5x
the fp32 envelope (rtol 3e-3, atol 1e-2). No JAX here.
"""

import pytest
import torch

from vmambair_torch.models import build_network, init_weights
from vmambair_torch.models.unet import MamberBlock
from vmambair_torch.ops import cuda_effn, cuda_scan

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=6e-4, atol=2e-3),
       torch.bfloat16: dict(rtol=3e-2, atol=5e-2)}
GRAD_TOL = dict(rtol=3e-3, atol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dtype):
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("d,L", [(48, 300), (202, 64)])
def test_oss_scan_fused_kernel_matches_plain(cuda, d, L, reverse, dtype):
    g = torch.Generator().manual_seed(d + L)
    N, R = 16, -(-d // 16)
    args = [torch.randn(2, 2, d, L, generator=g).to(cuda, dtype),
            torch.randn(2, R + 2 * N, d, generator=g) / d ** 0.5,
            torch.randn(2, d, R, generator=g) / R ** 0.5,
            torch.rand(2, d, generator=g) * 3 - 5,
            -torch.exp(torch.rand(2, d, N, generator=g) * 2),
            torch.randn(2, d, generator=g)]
    args[1:] = [a.to(cuda) for a in args[1:]]
    n0 = cuda_scan.oss_scan_fused_fwd.launches
    got = cuda_scan.oss_scan_fused(*args, reverse=reverse)
    assert cuda_scan.oss_scan_fused_fwd.launches == n0 + 1
    _close(got, cuda_scan.oss_scan_fused_ref(*args, reverse=reverse), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,G,D", [(16, 2, 8), (200, 4, 96)])
def test_selective_scan_kernel_matches_plain(cuda, N, G, D, reverse, dtype):
    g = torch.Generator().manual_seed(N + D)
    L = 77
    u = torch.randn(2, D, L, generator=g).to(cuda, dtype).transpose(1, 2)
    args = [u, torch.randn(2, L, D, generator=g),
            -torch.exp(torch.rand(D, N, generator=g)),
            torch.randn(2, L, G, N, generator=g),
            torch.randn(2, L, G, N, generator=g),
            torch.randn(D, generator=g), torch.rand(D, generator=g) - 2]
    args[1:] = [a.to(cuda) for a in args[1:]]
    got = cuda_scan.selective_scan(*args, delta_softplus=True,
                                   reverse=reverse)
    assert got.shape == (2, L, D) and got.dtype == dtype
    _close(got, cuda_scan.selective_scan_ref(
        *args, delta_softplus=True, reverse=reverse), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w", [(48, 13, 19), (96, 8, 8), (384, 5, 7)])
def test_gdfn_kernel_matches_plain(cuda, c, h, w, dtype):
    g = torch.Generator().manual_seed(c + h)
    hid = int(2.66 * c)
    args = [0.5 * torch.randn(2, c, h, w, generator=g),
            1 + 0.1 * torch.randn(c, generator=g),
            0.1 * torch.randn(c, generator=g),
            torch.randn(2 * hid, c, generator=g) / c ** 0.5,
            torch.randn(2 * hid, 3, 3, generator=g) / 3,
            torch.randn(c, hid, generator=g) / hid ** 0.5]
    args = [a.to(cuda) for a in args]
    args[0] = args[0].to(dtype)
    got = cuda_effn.gdfn_residual_fused(*args)
    assert got.dtype == dtype
    _close(got, cuda_effn.gdfn_residual_ref(*args), dtype)


def test_tiny_ossnet_forward_launches_kernels(cuda):
    import chip_smoke

    net = build_network(dict(type="OSSNet", dim=40, num_blocks=[1, 1, 1, 1],
                             num_refinement_blocks=1, scale=4), device=cuda)
    chip_smoke.reset_launches()
    with torch.inference_mode():
        y = net(torch.rand(2, 3, 32, 24, device=cuda))
    assert y.shape == (2, 3, 128, 96) and torch.isfinite(y).all()
    assert chip_smoke.launches() == chip_smoke.expected_launches(net)


def test_wide_block_raises_on_cuda(cuda):
    """C=392 is over the GDFN kernel's 384: the block raises rather than
    running the plain FFN on the card."""
    blk = MamberBlock(392)
    init_weights(blk, torch.Generator().manual_seed(0))
    blk = blk.to(cuda)
    n0 = cuda_effn.gdfn_residual_fwd.launches
    with torch.inference_mode(), pytest.raises(ValueError, match="C=392"):
        blk(torch.rand(1, 392, 8, 8, device=cuda))
    assert cuda_effn.gdfn_residual_fwd.launches == n0


def test_kernels_launch_on_a_device_that_is_not_current(cuda):
    """Each wrapper launches on its tensors' device, whatever device is
    current: tensors on cuda:1, cuda:0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda:1")
    g = torch.Generator().manual_seed(5)
    net = build_network(dict(type="OSSNet", dim=40, num_blocks=[1, 1, 1, 1],
                             num_refinement_blocks=1, scale=4), device=cuda,
                        seed=1)
    x = torch.rand(1, 3, 16, 24, generator=g)
    with torch.inference_mode():
        ref = net.to(cuda)(x.to(cuda))
        with torch.cuda.device(0):
            got = net.to(dev)(x.to(dev))
    assert got.device == dev
    torch.testing.assert_close(got.cpu(), ref.cpu(), **TOL[torch.float32])


def _fused_args(cuda, d, L, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    N, R = 16, -(-d // 16)
    args = [torch.randn(2, 2, d, L, generator=g).to(cuda, dtype),
            torch.randn(2, R + 2 * N, d, generator=g) / d ** 0.5,
            torch.randn(2, d, R, generator=g) / R ** 0.5,
            torch.rand(2, d, generator=g) * 3 - 5,
            -torch.exp(torch.rand(2, d, N, generator=g) * 2),
            torch.randn(2, d, generator=g)]
    return [args[0]] + [a.to(cuda) for a in args[1:]]


def _scan_args(cuda, N, G, D, L, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(2, D, L, generator=g).to(cuda, dtype).transpose(1, 2)
    args = [torch.randn(2, L, D, generator=g),
            -torch.exp(torch.rand(D, N, generator=g)),
            torch.randn(2, L, G, N, generator=g),
            torch.randn(2, L, G, N, generator=g),
            torch.randn(D, generator=g), torch.rand(D, generator=g) - 2]
    return [u] + [a.to(cuda) for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("d,L", [(48, 300), (202, 64)])
def test_oss_scan_fused_carries_kernel_matches_plain(cuda, d, L, reverse,
                                                     dtype):
    """K1c: y equal to K1's, carries within the fp32 envelope."""
    args = _fused_args(cuda, d, L, dtype, d + L)
    n0 = cuda_scan.oss_scan_fused_fwd_carries.launches
    y, car = cuda_scan.oss_scan_fused_fwd_carries(*args, reverse=reverse)
    assert cuda_scan.oss_scan_fused_fwd_carries.launches == n0 + 1
    assert torch.equal(y, cuda_scan.oss_scan_fused_fwd(*args,
                                                       reverse=reverse))
    _, ref = cuda_scan.oss_scan_fused_carries_ref(*args, reverse=reverse)
    assert car.shape == (2, 2 * d, cuda_scan.n_chunks(L), 16)
    _close(car, ref, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,G,D", [(16, 2, 8), (200, 4, 96), (16, 2, 6)])
def test_scan_carries_and_backward_kernels_match_plain(cuda, N, G, D,
                                                       reverse, dtype):
    """K4c: y equal to K4's, carries within the fp32 envelope; K3 from those
    carries: all seven outputs within 5x the fp32 envelope. D=6, G=2 has 3
    channels to a group (not a multiple of 8); N=200 takes 13 state passes
    of K3, the last one ragged."""
    args = _scan_args(cuda, N, G, D, 77, dtype, N + D)
    kw = dict(delta_softplus=True, reverse=reverse)
    y, car = cuda_scan.selective_scan_fwd_carries(*args, **kw)
    assert torch.equal(y, cuda_scan.selective_scan_fwd(*args, **kw))
    _close(car, cuda_scan.selective_scan_carries_ref(*args, **kw)[1],
           torch.float32)
    dy = torch.randn(2, D, 77, device=cuda).to(dtype).transpose(1, 2)
    n0 = cuda_scan.selective_scan_bwd.launches
    got = cuda_scan.selective_scan_bwd(*args, dy, car, **kw)
    assert cuda_scan.selective_scan_bwd.launches == n0 + 1
    ref = cuda_scan.selective_scan_bwd_ref(*args, dy, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_scan_backward_without_skip_and_bias(cuda):
    args = _scan_args(cuda, 16, 2, 16, 40, torch.float32, 1)
    args[5] = args[6] = None
    y, car = cuda_scan.selective_scan_fwd_carries(*args)
    dy = torch.randn_like(y)
    got = cuda_scan.selective_scan_bwd(*args, dy, car)
    ref = cuda_scan.selective_scan_bwd_ref(*args, dy)
    assert got[5] is None and got[6] is None
    for a, b in zip(got[:5], ref[:5]):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_autograd_scans_match_plain_path(cuda, reverse):
    """The autograd Functions (K1c/K4c forward, K3 backward) against
    autograd through the plain versions, on the card."""
    fa = [a.requires_grad_() for a in _fused_args(cuda, 48, 100,
                                                  torch.float32, 3)]
    sa = [a.requires_grad_() for a in _scan_args(cuda, 16, 2, 16, 70,
                                                 torch.float32, 4)]
    cases = [(lambda *a: cuda_scan.oss_scan_fused(*a, reverse=reverse),
              lambda *a: cuda_scan.oss_scan_fused_ref(*a, reverse=reverse),
              fa),
             (lambda *a: cuda_scan.selective_scan(
                 *a, delta_softplus=True, reverse=reverse),
              lambda *a: cuda_scan.selective_scan_ref(
                  *a, delta_softplus=True, reverse=reverse), sa)]
    for fn, ref_fn, ins in cases:
        n0 = cuda_scan.selective_scan_bwd.launches
        y = fn(*ins)
        w = torch.randn_like(y)
        got = torch.autograd.grad(y, ins, w)
        assert cuda_scan.selective_scan_bwd.launches == n0 + 1
        ref = torch.autograd.grad(ref_fn(*ins), ins, w)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, **GRAD_TOL)


def test_autograd_gdfn_matches_plain_path(cuda):
    g = torch.Generator().manual_seed(9)
    c, hid = 48, 127
    ins = [0.5 * torch.randn(2, c, 9, 13, generator=g),
           1 + 0.1 * torch.randn(c, generator=g),
           0.1 * torch.randn(c, generator=g),
           torch.randn(2 * hid, c, generator=g) / c ** 0.5,
           torch.randn(2 * hid, 3, 3, generator=g) / 3,
           torch.randn(c, hid, generator=g) / hid ** 0.5]
    ins = [a.to(cuda).requires_grad_() for a in ins]
    n0 = cuda_effn.gdfn_residual_fwd.launches
    y = cuda_effn.gdfn_residual_fused(*ins)
    assert cuda_effn.gdfn_residual_fwd.launches == n0 + 1
    w = torch.randn_like(y)
    got = torch.autograd.grad(y, ins, w)
    ref = torch.autograd.grad(cuda_effn.gdfn_residual_ref(*ins), ins, w)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_kernel_wrappers_raise_where_a_gradient_is_needed(cuda):
    """A kernel wrapper called on tensors that need a gradient raises
    instead of returning a detached result."""
    fa = _fused_args(cuda, 48, 40, torch.float32, 5)
    fa[1].requires_grad_()
    sa = _scan_args(cuda, 16, 2, 16, 40, torch.float32, 6)
    sa[0].requires_grad_()
    ga = [torch.rand(1, 8, 4, 4, device=cuda, requires_grad=True),
          torch.ones(8, device=cuda), torch.zeros(8, device=cuda),
          torch.rand(42, 8, device=cuda), torch.rand(42, 3, 3, device=cuda),
          torch.rand(8, 21, device=cuda)]
    calls = [lambda: cuda_scan.oss_scan_fused_fwd(*fa),
             lambda: cuda_scan.oss_scan_fused_fwd_carries(*fa),
             lambda: cuda_scan.selective_scan_fwd(*sa),
             lambda: cuda_scan.selective_scan_fwd_carries(*sa),
             lambda: cuda_effn.gdfn_residual_fwd(*ga)]
    for call in calls:
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    with torch.no_grad():
        for call in calls:
            call()


def test_tiny_ossnet_training_step_launches_kernels(cuda):
    """One L1 training step of a tiny OSSNet on the card: every launch the
    dispatch predicts for a step, and a finite, non-zero gradient at every
    parameter but the channel scans' conv_cout.bias (exactly 0: it shifts
    every channel before a mean-subtracting LayerNorm)."""
    import chip_smoke

    net = build_network(dict(type="OSSNet", dim=40, num_blocks=[1, 1, 1, 1],
                             num_refinement_blocks=1, scale=4), device=cuda)
    chip_smoke.reset_launches()
    out = net(torch.rand(2, 3, 32, 24, device=cuda))
    (out - torch.rand_like(out)).abs().mean().backward()
    assert chip_smoke.launches() == chip_smoke.expected_launches(
        net, train=True)
    for k, p in net.named_parameters():
        assert torch.isfinite(p.grad).all(), k
        if not k.endswith("conv_cout.bias"):
            assert p.grad.abs().max() > 0, k


def _front_args(cuda, c, e, h, w, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    args = [0.5 * torch.randn(2, c, h, w, generator=g),
            1 + 0.1 * torch.randn(c, generator=g),
            0.1 * torch.randn(c, generator=g),
            torch.randn(2 * e, c, generator=g) / c ** 0.5,
            0.3 * torch.randn(2 * e, generator=g),
            torch.randn(e, 3, 3, generator=g) / 3,
            0.3 * torch.randn(e, generator=g)]
    args = [a.to(cuda) for a in args]
    args[0] = args[0].to(dtype)
    return args


def _tail_args(cuda, d, h, w, ydtype, zdtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(2, 2, d, h * w, generator=g).to(cuda, ydtype),
            torch.nn.functional.silu(torch.randn(2, d, h, w, generator=g)
                                     ).to(cuda, zdtype),
            (1 + 0.1 * torch.randn(d, generator=g)).to(cuda),
            (0.1 * torch.randn(d, generator=g)).to(cuda)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,e,h,w", [(48, 48, 13, 19), (96, 100, 8, 8),
                                     (384, 384, 5, 7), (20, 70, 3, 33)])
def test_oss_front_kernel_matches_plain(cuda, c, e, h, w, dtype):
    """K5 at ragged tiles, E past one channel tile and E != C."""
    args = _front_args(cuda, c, e, h, w, dtype, c + h)
    n0 = cuda_effn.oss_front_fwd.launches
    xs, z = cuda_effn.oss_front_fused(*args)
    assert cuda_effn.oss_front_fwd.launches == n0 + 1
    rxs, rz = cuda_effn.oss_front_ref(*args)
    assert xs.dtype == z.dtype == dtype and xs.shape == (2, e, h, w)
    _close(xs, rxs, dtype)
    _close(z, rz, dtype)


@pytest.mark.parametrize("ydtype,zdtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("d,h,w", [(48, 13, 19), (96, 16, 16), (192, 9, 16),
                                   (384, 5, 7)])
def test_oss_tail_kernel_matches_plain(cuda, d, h, w, ydtype, zdtype):
    """D=192 fills exactly the 48 KB of dynamic shared memory that needs
    no opt-in, beside the static statistics."""
    args = _tail_args(cuda, d, h, w, ydtype, zdtype, d + w)
    n0 = cuda_effn.oss_tail_fwd.launches
    got = cuda_effn.oss_tail_fused(*args)
    assert cuda_effn.oss_tail_fwd.launches == n0 + 1
    assert got.dtype == zdtype and got.shape == (2, d, h, w)
    _close(got, cuda_effn.oss_tail_ref(*args), zdtype)


def test_autograd_oss_front_and_tail_match_plain_path(cuda):
    cases = [(cuda_effn.oss_front_fused, cuda_effn.oss_front_ref,
              _front_args(cuda, 48, 48, 9, 13, torch.float32, 1)),
             (cuda_effn.oss_tail_fused, cuda_effn.oss_tail_ref,
              _tail_args(cuda, 48, 9, 13, torch.float32, torch.float32, 2))]
    for fn, ref_fn, ins in cases:
        ins = [a.requires_grad_() for a in ins]
        out = fn(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        ws = [torch.randn_like(o) for o in outs]
        got = torch.autograd.grad(outs, ins, ws)
        ref = ref_fn(*ins)
        ref = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,),
                                  ins, ws)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, **GRAD_TOL)
    fa = _front_args(cuda, 8, 8, 4, 4, torch.float32, 3)
    fa[0].requires_grad_()
    ta = _tail_args(cuda, 8, 4, 4, torch.float32, torch.float32, 4)
    ta[1].requires_grad_()
    for call in (lambda: cuda_effn.oss_front_fwd(*fa),
                 lambda: cuda_effn.oss_tail_fwd(*ta)):
        with pytest.raises(RuntimeError, match="has no backward"):
            call()


def test_tiny_ossnet_with_front_and_tail_matches_plain(cuda, monkeypatch):
    """Both switches on: a forward and a training step launch K5 and K6
    once per MamberBlock, and the forward agrees with the switches off."""
    import chip_smoke

    net = build_network(dict(type="OSSNet", dim=40, num_blocks=[1, 1, 1, 1],
                             num_refinement_blocks=1, scale=4), device=cuda)
    x = torch.rand(2, 3, 32, 24, device=cuda)
    with torch.inference_mode():
        ref = net(x)
    monkeypatch.setenv("VMAMBAIR_OSS_FRONT", "1")
    monkeypatch.setenv("VMAMBAIR_OSS_TAIL", "1")
    chip_smoke.reset_launches()
    with torch.inference_mode():
        got = net(x)
    assert chip_smoke.launches() == chip_smoke.expected_launches(net)
    assert chip_smoke.launches()["oss_front_fused"] == 8
    _close(got, ref, torch.float32)
    chip_smoke.reset_launches()
    (net(x) - 1).abs().mean().backward()
    assert chip_smoke.launches() == chip_smoke.expected_launches(
        net, train=True)
