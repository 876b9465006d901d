"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda`: each test takes the `cuda` fixture, which skips when no
CUDA device is present (as on a CPU-only machine). On a card, run

    python -m pytest -o addopts="" -p no:cacheprovider --noconftest tests/test_torch_port_cuda.py

Shapes are small and ragged (L not a multiple of the kernels' chunk, odd
image sizes, N above one register batch) to reach the kernels' edges.
Tolerances: fp32 within the reference CUDA envelope (rtol 6e-4, atol
2e-3), bf16 within 3e-2 / 5e-2. No JAX here.
"""

import pytest
import torch

from vmambair_torch.models import build_network, init_weights
from vmambair_torch.models.unet import MamberBlock
from vmambair_torch.ops import cuda_effn, cuda_scan

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=6e-4, atol=2e-3),
       torch.bfloat16: dict(rtol=3e-2, atol=5e-2)}


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
    n0 = cuda_scan.oss_scan_fused.launches
    got = cuda_scan.oss_scan_fused(*args, reverse=reverse)
    assert cuda_scan.oss_scan_fused.launches == n0 + 1
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
    n0 = cuda_effn.gdfn_residual_fused.launches
    with torch.inference_mode(), pytest.raises(ValueError, match="C=392"):
        blk(torch.rand(1, 392, 8, 8, device=cuda))
    assert cuda_effn.gdfn_residual_fused.launches == n0


def test_kernels_launch_on_a_device_that_is_not_current(cuda):
    """Each wrapper launches on its tensors' device, whatever device is
    current: tensors on cuda:1, cuda:0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda:1")
    g = torch.Generator().manual_seed(5)
    net = build_network(dict(type="OSSNet", dim=40, num_blocks=[1, 1, 1, 1],
                             num_refinement_blocks=1, scale=4), seed=1)
    x = torch.rand(1, 3, 16, 24, generator=g)
    with torch.inference_mode():
        ref = net.to(cuda)(x.to(cuda))
        with torch.cuda.device(0):
            got = net.to(dev)(x.to(dev))
    assert got.device == dev
    torch.testing.assert_close(got.cpu(), ref.cpu(), **TOL[torch.float32])
