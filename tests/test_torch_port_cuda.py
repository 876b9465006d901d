"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda`: each test takes the `cuda` fixture, which skips when no
CUDA device is present (as on a CPU-only machine). On a card, run

    python -m pytest -o addopts="" -p no:cacheprovider --noconftest tests/test_torch_port_cuda.py

Shapes are small and ragged (L not a multiple of the kernels' chunk, odd
image sizes, N above one register batch) to reach the kernels' edges.
Tolerances: fp32 within the reference CUDA envelope (rtol 6e-4, atol
2e-3), bf16 within 3e-2 / 5e-2; gradients and the scan backward within 5x
the fp32 envelope (rtol 3e-3, atol 1e-2); K2's fp32 route (split-TF32
products) and K5's (the same split) also within their CPU models' fp32
bar (rtol 1e-5, atol 1e-5), which a single-pass TF32 product misses. No
JAX here.
"""

import pytest
import torch
from k3_order import k3_order_bwd

from vmambair_torch.models import build_network, init_weights
from vmambair_torch.models.unet import MamberBlock
from vmambair_torch.ops import cuda_effn, cuda_scan

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=6e-4, atol=2e-3),
       torch.bfloat16: dict(rtol=3e-2, atol=5e-2)}
GRAD_TOL = dict(rtol=3e-3, atol=1e-2)
K2F_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _gdfn_args(cuda, b, c, h, w, dtype):
    g = torch.Generator().manual_seed(c + h)
    hid = int(2.66 * c)
    args = [0.5 * torch.randn(b, c, h, w, generator=g),
            1 + 0.1 * torch.randn(c, generator=g),
            0.1 * torch.randn(c, generator=g),
            torch.randn(2 * hid, c, generator=g) / c ** 0.5,
            torch.randn(2 * hid, 3, 3, generator=g) / 3,
            torch.randn(c, hid, generator=g) / hid ** 0.5]
    args = [a.to(cuda) for a in args]
    args[0] = args[0].to(dtype)
    return args


# K2 at every width class of its tensor-core routes (C 48, 96, 192, 384),
# at a ragged C in each (40, 72, 136, 264: no multiple of 16 or of the
# class's width), at H and W no multiple of the tiles (8 x 16, 8 x 8, 4 x
# 8; an odd W takes the element-wise halo load), at batch 1, and at the
# S1 step's three levels where the fp32 route splits the hidden channels
# over a cluster (of 2, 2 and 4 blocks on an H100; the small shapes above
# split too)
GDFN_SPLIT_SHAPES = [(8, 96, 32, 32), (8, 192, 16, 16), (8, 384, 8, 8)]
GDFN_SHAPES = [(2, 48, 13, 19), (2, 96, 8, 8), (2, 384, 5, 7),
               (1, 192, 13, 19), (1, 40, 9, 33), (1, 72, 17, 10),
               (2, 136, 7, 11), (1, 264, 6, 10), (1, 20, 30, 2),
               *GDFN_SPLIT_SHAPES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w", GDFN_SHAPES)
def test_gdfn_kernel_matches_plain(cuda, b, c, h, w, dtype):
    args = _gdfn_args(cuda, b, c, h, w, dtype)
    got = cuda_effn.gdfn_residual_fused(*args)
    assert got.dtype == dtype
    ref = cuda_effn.gdfn_residual_ref(*args)
    _close(got, ref, dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, **K2F_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdfn_kernel_is_deterministic(cuda, dtype):
    """Two calls on the same inputs give the same bits, at every width
    class and at the cluster splits (no atomics: each output is summed by
    one thread in a fixed order, a cluster's partial tiles in rank
    order)."""
    for b, c, h, w in GDFN_SHAPES[:4] + GDFN_SPLIT_SHAPES:
        args = _gdfn_args(cuda, b, c, h, w, dtype)
        assert torch.equal(cuda_effn.gdfn_residual_fwd(*args),
                           cuda_effn.gdfn_residual_fwd(*args)), (c, h, w)


@pytest.mark.parametrize("c,hid", [(48, 127), (40, 106), (96, 255),
                                   (136, 361), (384, 1021), (8, 21)])
def test_gdfn_f32_packing_kernel_matches_plain(cuda, c, hid):
    """The fp32 route's packing kernel (`vmt_gdfn_f32_pack`) writes the
    slot images of `pack_gdfn_f32_weights` bit for bit, pads included."""
    from vmambair_torch import _build
    g = torch.Generator().manual_seed(c)
    w_in, w_dw, w_out = (torch.randn(*s, generator=g).to(cuda) for s in (
        (2 * hid, c), (2 * hid, 3, 3), (c, hid)))
    cls = cuda_effn.k2f_class(c)
    want = cuda_effn.pack_gdfn_f32_weights(w_in, w_dw, w_out, cls)
    got = torch.full_like(want, float("nan"))
    _build.launch("vmt_gdfn_f32_pack", got.device, w_in.data_ptr(),
                  w_dw.data_ptr(), w_out.data_ptr(), got.data_ptr(), c, hid,
                  cls)
    assert got.shape[1] == cuda_effn.k2f_slot(c, cls)
    assert torch.equal(got, want)


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


def _fused_args(cuda, d, L, dtype, seed, b=2, N=16):
    g = torch.Generator().manual_seed(seed)
    R = -(-d // 16)
    args = [torch.randn(b, 2, d, L, generator=g).to(cuda, dtype),
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
@pytest.mark.parametrize("b,d,L,N", [(2, 96, 4100, 16), (1, 48, 1057, 16),
                                     (1, 64, 700, 32), (2, 40, 333, 5)])
def test_k1_and_k1c_segments_match_plain(cuda, b, d, L, N, reverse, dtype):
    """K1 and K1c as four grids (the projection, the segmented scan) at L
    over several segments with a ragged last segment and a ragged last
    chunk; N at K1's limit of 32 and N below a register batch. K1c's y
    equal to K1's, its carries within the fp32 envelope."""
    args = _fused_args(cuda, d, L, dtype, b + d + L + N, b=b, N=N)
    n0 = cuda_scan.oss_scan_fused_fwd.launches
    y = cuda_scan.oss_scan_fused_fwd(*args, reverse=reverse)
    assert cuda_scan.oss_scan_fused_fwd.launches == n0 + 1
    yc, car = cuda_scan.oss_scan_fused_fwd_carries(*args, reverse=reverse)
    ref, ref_car = cuda_scan.oss_scan_fused_carries_ref(*args,
                                                        reverse=reverse)
    assert torch.equal(y, yc)
    _close(y, ref, dtype)
    assert car.shape == (b, 2 * d, cuda_scan.n_chunks(L), N)
    _close(car, ref_car, torch.float32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seg", [32, 40, 64, 1024])
def test_k1_takes_any_segment_length(cuda, monkeypatch, seg, reverse):
    """The carries are placed by position, so a segment of any length, one
    that starts inside a chunk too (40), gives K1c's plain carries."""
    monkeypatch.setattr(cuda_scan, "k1_segment", lambda *sizes: seg)
    args = _fused_args(cuda, 48, 1057, torch.float32, seg, b=1)
    y, car = cuda_scan.oss_scan_fused_fwd_carries(*args, reverse=reverse)
    ref, ref_car = cuda_scan.oss_scan_fused_carries_ref(*args,
                                                        reverse=reverse)
    _close(y, ref, torch.float32)
    _close(car, ref_car, torch.float32)


def test_k1_and_k1c_are_deterministic(cuda):
    """Fixed orders only: two calls on the same inputs give the same bits,
    at the served forward's widest shape."""
    args = _fused_args(cuda, 96, 16384, torch.bfloat16, 3, b=8)
    assert torch.equal(cuda_scan.oss_scan_fused_fwd(*args),
                       cuda_scan.oss_scan_fused_fwd(*args))
    (y1, c1), (y2, c2) = (cuda_scan.oss_scan_fused_fwd_carries(
        *args, reverse=True) for _ in range(2))
    assert torch.equal(y1, y2) and torch.equal(c1, c2)


def test_k1_refuses_what_it_cannot_take(cuda):
    """D over 256 and N over 32 raise before a launch."""
    for d, N, what in ((264, 16, "D=264"), (48, 33, "N=33")):
        args = _fused_args(cuda, d, 64, torch.float32, 0, b=1, N=N)
        for fn in (cuda_scan.oss_scan_fused_fwd,
                   cuda_scan.oss_scan_fused_fwd_carries):
            n0 = fn.launches
            with pytest.raises(ValueError, match=what):
                fn(*args)
            assert fn.launches == n0


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


def _k4_args(cuda, b, L, D, G, N, dtype, seed, layout):
    """K4's inputs as the model passes them, in `dtype` (u) and fp32:
    "pair", a latent direction pair (u, delta (b, L, D) views of (b, D, L)
    buffers, B and C views of x_dbl's (b, G, R + 2N, L) rows); "channel",
    a channel scan (u, delta contiguous, B and C views of x_dbl's (b, G,
    L, R + 2N)); R = 3, so that the B and C views start at an odd
    offset."""
    g = torch.Generator().manual_seed(seed)
    R = 3
    M = R + 2 * N
    if layout == "pair":
        u = torch.randn(b, D, L, generator=g).to(cuda, dtype).transpose(1, 2)
        delta = torch.randn(b, D, L, generator=g).to(cuda).transpose(1, 2)
        xdbl = torch.randn(b, G, M, L, generator=g).to(cuda).permute(
            0, 3, 1, 2)
    else:
        u = torch.randn(b, L, D, generator=g).to(cuda, dtype)
        delta = torch.randn(b, L, D, generator=g).to(cuda)
        xdbl = torch.randn(b, G, L, M, generator=g).to(cuda).transpose(1, 2)
    return [u, delta, -torch.exp(torch.rand(D, N, generator=g) * 2).to(cuda),
            xdbl[..., R:R + N], xdbl[..., R + N:],
            torch.randn(D, generator=g).to(cuda),
            (torch.rand(D, generator=g) * 2 - 3).to(cuda)]


# K4 / K4c at the channel scans' shapes (8, C, 8), G = 2; at an L no
# multiple of 8, 32 or 256; over several segments of `k4_segment` (L =
# 3001: 12 of 256, the last of 185; L = 2100 with N = 40: 9 of 256 in 3
# state passes); at N = 200 (13 passes of 16, the last of 8), N = 40 and
# N = 5 (below a pass); at 3 channels to a group; at a latent pair's shape
# (every one of them on the model's strided views)
K4_CASES = [(8, 48, 8, 2, 16, "channel"), (8, 96, 8, 2, 16, "channel"),
            (8, 192, 8, 2, 16, "channel"), (8, 384, 8, 2, 16, "channel"),
            (2, 77, 8, 2, 16, "channel"), (2, 77, 6, 2, 5, "pair"),
            (2, 3001, 8, 2, 16, "channel"), (1, 2100, 6, 2, 40, "pair"),
            (2, 77, 96, 4, 200, "pair"), (1, 300, 24, 2, 200, "channel"),
            (2, 256, 64, 2, 16, "pair")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,L,D,G,N,layout", K4_CASES)
def test_k4_and_k4c_match_plain(cuda, b, L, D, G, N, layout, reverse, dtype):
    """K4 within the forward envelope of its plain version, one launch per
    call; K4c's y equal to K4's, its carries within the fp32 envelope of
    `selective_scan_carries_ref`, one launch per call."""
    args = _k4_args(cuda, b, L, D, G, N, dtype, b + L + D + N, layout)
    kw = dict(delta_softplus=True, reverse=reverse)
    fwd = cuda_scan.selective_scan_fwd
    fwc = cuda_scan.selective_scan_fwd_carries
    n0, n1 = fwd.launches, fwc.launches
    y = fwd(*args, **kw)
    y2, car = fwc(*args, **kw)
    assert (fwd.launches, fwc.launches) == (n0 + 1, n1 + 1)
    _close(y, cuda_scan.selective_scan_ref(*args, **kw), dtype)
    assert torch.equal(y2, y)
    _close(car, cuda_scan.selective_scan_carries_ref(*args, **kw)[1],
           torch.float32)


# dy seeds of the K3 tests without D and bias; 47, 81, 358 and 371 drew the
# dy whose gradients missed GRAD_TOL on the growing recipe (ROADMAP F2)
F2_SEEDS = (0, 1, 2, 3, 47, 81, 358, 371)
# on the growing recipe no fp32 order holds GRAD_TOL against the exact
# gradients: K3 (a Hillis-Steele tree over each chunk of 32 positions, as
# the TPU kernel walks its windows, its sums over states and channels in
# fp64) may be this many times further from them than the fp32 plain
# version (a Hillis-Steele tree over the chunk of 64 it scans,
# differentiated by autograd) is, in units of GRAD_TOL's bar, where the
# plain version itself is off it. It holds 2x at every seed but 47, whose
# ddelta it misses by 2.95x (ROADMAP F2)
F2_FACTOR = 3


def _f2_case(cuda, seed, grow):
    """K3's inputs without D, bias or softplus, and its dy from `seed`.
    grow: the raw delta ~ N(0, 1), negative at half the positions, so the
    state grows to ~7e11 over L = 40; else |N(0, 1)|, a decaying state, as
    a softplus delta gives the model's scans."""
    args = _scan_args(cuda, 16, 2, 16, 40, torch.float32, 1)
    args[5] = args[6] = None
    if not grow:
        args[1] = args[1].abs()
    y, car = cuda_scan.selective_scan_fwd_carries(*args)
    g = torch.Generator().manual_seed(seed)
    return args, torch.randn(y.shape, generator=g).to(cuda), car


def _bwd_oracle(args, dy):
    """The exact gradients: the plain backward on fp64 copies."""
    return cuda_scan.selective_scan_bwd_ref(
        *[None if t is None else t.double() for t in args], dy.double())


def _bar_ratio(got, ref):
    """Largest |got - ref| over GRAD_TOL's bar (above 1: off the bar)."""
    got, ref = got.double(), ref.double()
    bar = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * ref.abs()
    return ((got - ref).abs() / bar).max().item()


@pytest.mark.parametrize("seed", F2_SEEDS)
def test_scan_backward_without_skip_and_bias(cuda, seed):
    """K3 with dD and dbias None on the growing recipe, against the exact
    (fp64) gradients: each of du, ddelta, dA, dB, dC within GRAD_TOL where
    the fp32 plain version is, else within F2_FACTOR times the plain
    version's own distance. Prints both distances per output, in units of
    GRAD_TOL's bar (run with -s)."""
    args, dy, car = _f2_case(cuda, seed, grow=True)
    got = cuda_scan.selective_scan_bwd(*args, dy, car)
    assert got[5] is None and got[6] is None
    orc = _bwd_oracle(args, dy)
    ref = cuda_scan.selective_scan_bwd_ref(*args, dy)
    k3 = [_bar_ratio(a, b) for a, b in zip(got[:5], orc[:5])]
    r32 = [_bar_ratio(a, b) for a, b in zip(ref[:5], orc[:5])]
    # K3 again from the exact carries (the fp64 plain forward's, rounded to
    # fp32) in place of K4c's: what the carries add to K3's distance; and
    # K3's order in torch ops on the card (tests/k3_order.py)
    exact = cuda_scan.selective_scan_carries_ref(
        *[None if t is None else t.double() for t in args])[1].float()
    k3x = [_bar_ratio(a, b) for a, b in zip(
        cuda_scan.selective_scan_bwd(*args, dy, exact)[:5], orc[:5])]
    order = [_bar_ratio(a, b) for a, b in zip(
        k3_order_bwd(*args[:5], dy, exact), orc[:5])]
    print(f"F2 seed {seed}: state max {car.abs().max().item():.4g}; x bar "
          f"from the fp64 oracle: K3 {[round(r, 3) for r in k3]}, K3 from "
          f"exact carries {[round(r, 3) for r in k3x]}, K3's order in torch "
          f"{[round(r, 3) for r in order]}, fp32 reference "
          f"{[round(r, 3) for r in r32]}")
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC"), k3, r32):
        assert a <= max(1.0, F2_FACTOR * b), (name, a, b)


@pytest.mark.parametrize("seed", F2_SEEDS)
def test_scan_backward_on_a_decaying_state(cuda, seed):
    """K3 without D and bias on a decaying state, against the exact (fp64)
    gradients within GRAD_TOL."""
    args, dy, car = _f2_case(cuda, seed, grow=False)
    got = cuda_scan.selective_scan_bwd(*args, dy, car)
    orc = _bwd_oracle(args, dy)
    print(f"F2 seed {seed}, decaying: x bar from the fp64 oracle: K3 "
          f"{[round(_bar_ratio(a, b), 4) for a, b in zip(got[:5], orc[:5])]}")
    for a, b in zip(got[:5], orc[:5]):
        torch.testing.assert_close(a.double(), b, **GRAD_TOL)


@pytest.mark.parametrize("seed", F2_SEEDS)
def test_scan_backward_within_the_conditioned_bound(cuda, seed):
    """ROADMAP F2, order-independent: on the growing recipe K3 and the
    fp32 plain version on the card each hold every gradient (du, ddelta,
    dA, dB, dC) within C_BOUND n u32 kappa of the fp64 oracle, kappa the
    gradients on the magnitudes of their terms, n = L (derived in
    `tests/f2_bound.py`). Prints each gradient's largest error over its
    bound (run with -s)."""
    from f2_bound import bound_ratios

    args, dy, car = _f2_case(cuda, seed, grow=True)
    orc = _bwd_oracle(args, dy)
    k3 = bound_ratios(cuda_scan.selective_scan_bwd(*args, dy, car)[:5],
                      orc[:5], args, dy)
    r32 = bound_ratios(cuda_scan.selective_scan_bwd_ref(*args, dy)[:5],
                       orc[:5], args, dy)
    print(f"F2 seed {seed}: error over the conditioned bound (du, ddelta, "
          f"dA, dB, dC): K3 {[f'{r:.3g}' for r in k3]}, fp32 reference "
          f"{[f'{r:.3g}' for r in r32]}")
    assert max(k3) <= 1.0 and max(r32) <= 1.0, (k3, r32)


@pytest.mark.parametrize("seed", F2_SEEDS)
def test_scan_backward_is_deterministic_on_the_growing_recipe(cuda, seed):
    """K3 twice on the same inputs of the growing recipe: bit-identical (it
    has no atomics)."""
    args, dy, car = _f2_case(cuda, seed, grow=True)
    got = cuda_scan.selective_scan_bwd(*args, dy, car)
    again = cuda_scan.selective_scan_bwd(*args, dy, car)
    for a, b in zip(got[:5], again[:5]):
        assert torch.equal(a, b)


def _k3_args(cuda, b, L, D, G, N, dtype, seed, full, layout):
    """K3's inputs, u, delta, B, C and dy in `dtype`: laid out as the fused
    scans pass them (layout "dl": (b, L, D) views of (b, D, L) buffers, B
    and C (b, L, G, N) views of (b, G, N, L)) or contiguous, as the
    channel scans do ("ld"). full: with D, a bias and softplus; else the
    raw delta is |N(0, 1)| (a decaying state)."""
    g = torch.Generator().manual_seed(seed)

    def act(pos=False):
        t = torch.randn(b, D, L, generator=g)
        t = t.abs() if pos else t
        if layout == "dl":
            return t.to(cuda, dtype).transpose(1, 2)
        return t.transpose(1, 2).contiguous().to(cuda, dtype)

    def rows():
        t = torch.randn(b, G, N, L, generator=g)
        if layout == "dl":
            return t.to(cuda, dtype).permute(0, 3, 1, 2)
        return t.permute(0, 3, 1, 2).contiguous().to(cuda, dtype)

    u, delta = act(), act(pos=not full)
    A = -torch.exp(torch.rand(D, N, generator=g)).to(cuda)
    B, C = rows(), rows()
    Dsk = torch.randn(D, generator=g).to(cuda) if full else None
    bias = (torch.rand(D, generator=g) - 2).to(cuda) if full else None
    return [u, delta, A, B, C, Dsk, bias], act()


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,L,D,G,N,layout,seg", [
    (2, 1000, 16, 2, 16, "dl", None),  # 16 segments, the last of 40
    (1, 77, 16, 2, 16, "ld", None),    # 2 segments, the last 13 positions
    (2, 20, 16, 2, 16, "dl", None),    # L below a chunk: one segment
    (1, 333, 6, 2, 5, "ld", 96),       # segments of 3 chunks, 3 channels
    (2, 300, 48, 2, 40, "dl", 32),     # segments of a chunk, N over a pass
])
def test_k3_segments_match_plain(cuda, monkeypatch, b, L, D, G, N, layout,
                                 seg, reverse, dtype, full):
    """K3 over several segments (the segment of `k3_segment`, or one set
    here), with a ragged last segment and chunk, and within one segment
    shorter than a chunk; forward and reverse, fp32 and bf16 inputs, G =
    2, D, bias and softplus on and off: all seven outputs within 5x the
    fp32 envelope of the plain version, one launch per call."""
    if seg:
        monkeypatch.setattr(cuda_scan, "k3_segment", lambda *sizes: seg)
    args, dy = _k3_args(cuda, b, L, D, G, N, dtype, L + D + N, full, layout)
    kw = dict(delta_softplus=full, reverse=reverse)
    _, car = cuda_scan.selective_scan_fwd_carries(*args, **kw)
    n0 = cuda_scan.selective_scan_bwd.launches
    got = cuda_scan.selective_scan_bwd(*args, dy, car, **kw)
    assert cuda_scan.selective_scan_bwd.launches == n0 + 1
    ref = cuda_scan.selective_scan_bwd_ref(*args, dy, **kw)
    for name, a, r in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dbias"),
                          got, ref):
        if r is None:
            assert a is None, name
        else:
            torch.testing.assert_close(a, r, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [0, 47])
def test_k3_segments_within_the_conditioned_bound(cuda, monkeypatch, seed,
                                                  reverse):
    """ROADMAP F2 over segments: on a growing state (raw delta 0.5 N(0, 1),
    no D, bias or softplus) at L = 232 in 4 segments of 64, the last of
    40, every gradient within C_BOUND n u32 kappa of the fp64 oracle (a
    reverse scan held as the forward scan of the flipped sequence), as
    `test_torch_port_k3_segments.py` holds K3's order on the CPU."""
    from f2_bound import bound_ratios

    monkeypatch.setattr(cuda_scan, "k3_segment", lambda *sizes: 64)
    g = torch.Generator().manual_seed(seed)
    args = [torch.randn(2, 232, 16, generator=g),
            0.5 * torch.randn(2, 232, 16, generator=g),
            -torch.exp(torch.rand(16, 16, generator=g)),
            torch.randn(2, 232, 2, 16, generator=g),
            torch.randn(2, 232, 2, 16, generator=g), None, None]
    dy = torch.randn(2, 232, 16, generator=g)
    dev = [None if t is None else t.to(cuda) for t in args]
    _, car = cuda_scan.selective_scan_fwd_carries(*dev, reverse=reverse)
    got = [t.cpu() for t in cuda_scan.selective_scan_bwd(
        *dev, dy.to(cuda), car, reverse=reverse)[:5]]
    orc = cuda_scan.selective_scan_bwd_ref(
        *[None if t is None else t.double() for t in args], dy.double(),
        reverse=reverse)[:5]
    if reverse:
        def fl(gr):
            return [gr[0].flip(1), gr[1].flip(1), gr[2], gr[3].flip(1),
                    gr[4].flip(1)]
        got, orc = fl(got), fl(orc)
        args = [args[0].flip(1), args[1].flip(1), args[2], args[3].flip(1),
                args[4].flip(1)]
        dy = dy.flip(1)
    ratios = bound_ratios(got, orc, args[:5], dy)
    print(f"K3 over segments, seed {seed} reverse={reverse}: error over the "
          f"conditioned bound {[f'{r:.3g}' for r in ratios]}")
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("reverse", [False, True])
def test_k3_takes_bf16_views_at_odd_offsets(cuda, reverse):
    """bf16 inputs staged in 4-byte words: u, delta, dy, B and C as views
    that start at an odd element of a wider buffer (so half of their
    elements sit in the upper half of a word), over 3 segments: all seven
    outputs within 5x the fp32 envelope of the plain version."""
    g = torch.Generator().manual_seed(11)
    b, L, D, G, N = 2, 150, 16, 2, 16

    def view(*shape):
        t = torch.randn(*shape[:-1], shape[-1] + 1, generator=g)
        return t.to(cuda, torch.bfloat16)[..., 1:]

    u, delta, dy = view(b, L, D), view(b, L, D), view(b, L, D)
    B, C = view(b, L, G, N), view(b, L, G, N)
    args = [u, delta, -torch.exp(torch.rand(D, N, generator=g)).to(cuda),
            B, C, torch.randn(D, generator=g).to(cuda),
            (torch.rand(D, generator=g) - 2).to(cuda)]
    assert u.storage_offset() % 2 == 1
    kw = dict(delta_softplus=True, reverse=reverse)
    assert -(-L // cuda_scan.k3_segment(b, D, 8, L)) == 3
    _, car = cuda_scan.selective_scan_fwd_carries(*args, **kw)
    got = cuda_scan.selective_scan_bwd(*args, dy, car, **kw)
    ref = cuda_scan.selective_scan_bwd_ref(*args, dy, **kw)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **GRAD_TOL)


def test_k3_is_deterministic_over_segments(cuda):
    """Fixed orders only, no atomics: two calls over 9 segments (the last
    of 4 positions) give the same bits, forward and reverse."""
    args, dy = _k3_args(cuda, 8, 4100, 192, 2, 16, torch.float32, 9, True,
                        "dl")
    assert cuda_scan.k3_segment(8, 192, 8, 4100) == 512
    for rev in (False, True):
        kw = dict(delta_softplus=True, reverse=rev)
        _, car = cuda_scan.selective_scan_fwd_carries(*args, **kw)
        got = cuda_scan.selective_scan_bwd(*args, dy, car, **kw)
        again = cuda_scan.selective_scan_bwd(*args, dy, car, **kw)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


def test_k3_keeps_the_recorded_bits_in_one_segment(cuda):
    """Where L fits one segment, K3's du, ddelta, dB and dC on the plain
    carries are the bits recorded from the build of its segmented design
    (`tools/k3_digests.json`, made by `python -m vmambair_torch.tools.ab
    --other DIR --digests`)."""
    import json

    from vmambair_torch.tools import ab

    with open(ab.K3_DIGESTS_FILE) as f:
        want = json.load(f)["digests"]
    got = ab.k3_digests()
    assert got.keys() == want.keys()
    assert [k for k in got if got[k] != want[k]] == []


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
                                     (384, 384, 5, 7), (20, 70, 3, 33),
                                     (40, 52, 9, 33), (136, 72, 7, 11),
                                     (200, 200, 16, 16), (704, 64, 5, 8)])
def test_oss_front_kernel_matches_plain(cuda, c, e, h, w, dtype):
    """K5 at ragged tiles, E past one channel tile and E != C, every width
    class of the bf16 route (C up to 704)."""
    args = _front_args(cuda, c, e, h, w, dtype, c + h)
    n0 = cuda_effn.oss_front_fwd.launches
    xs, z = cuda_effn.oss_front_fused(*args)
    assert cuda_effn.oss_front_fwd.launches == n0 + 1
    rxs, rz = cuda_effn.oss_front_ref(*args)
    assert xs.dtype == z.dtype == dtype and xs.shape == (2, e, h, w)
    _close(xs, rxs, dtype)
    _close(z, rz, dtype)


# K5's fp32 route: every width class (C 48, 96, 192, 704 and between), E
# != C and past one channel tile, H and W no multiple of the tiles, an odd
# W, W no multiple of 4, batch 1, a 1x1 image, the widest class's k-slices
K5F_CASES = [(2, 48, 48, 13, 19), (2, 96, 100, 8, 8), (2, 20, 70, 3, 33),
             (1, 40, 52, 9, 33), (1, 136, 72, 7, 11), (1, 192, 200, 16, 16),
             (2, 384, 384, 5, 7), (1, 264, 136, 6, 10), (1, 704, 64, 5, 8),
             (1, 704, 704, 6, 10), (2, 96, 96, 1, 1), (8, 96, 96, 32, 32),
             (8, 384, 384, 8, 8)]


@pytest.mark.parametrize("b,c,e,h,w", K5F_CASES)
def test_oss_front_f32_kernel_holds_the_fp32_bar(cuda, b, c, e, h, w):
    """K5's fp32 route (split TF32 on the tensor cores) against its plain
    version, fp32 and cuDNN without TF32: within the envelope, and within
    the CPU model's fp32 bar at the models' widths (C <= 384; past that
    two fp32 sums of C products part by more than 1e-5 of their size);
    two calls give the same bits."""
    args = _front_args(cuda, c, e, h, w, torch.float32, c + e + h)
    if b != 2:
        g = torch.Generator().manual_seed(b + c)
        args[0] = (0.5 * torch.randn(b, c, h, w, generator=g)).to(cuda)
    n0 = cuda_effn.oss_front_fwd.launches
    xs, z = cuda_effn.oss_front_fwd(*args)
    assert cuda_effn.oss_front_fwd.launches == n0 + 1
    for got, ref in zip((xs, z), cuda_effn.oss_front_ref(*args)):
        assert got.shape == (b, e, h, w) and got.dtype == torch.float32
        _close(got, ref, torch.float32)
        if c <= 384:
            torch.testing.assert_close(got, ref, **K2F_TOL)
    again = cuda_effn.oss_front_fwd(*args)
    assert torch.equal(again[0], xs) and torch.equal(again[1], z)


@pytest.mark.parametrize("c,e", [(48, 48), (96, 96), (20, 70), (192, 200),
                                 (384, 384), (704, 64), (200, 40)])
def test_oss_front_f32_packing_kernel_matches_plain(cuda, c, e):
    """The fp32 route's packing kernel (`vmt_oss_front_f32_pack`) writes
    the images of `pack_front_f32_weights` bit for bit, pads included."""
    from vmambair_torch import _build

    _, _, _, w_in, b_in, w_dw, b_dw = _front_args(cuda, c, e, 1, 1,
                                                  torch.float32, c + e)
    cls = cuda_effn.k5f_class(c)
    want = cuda_effn.pack_front_f32_weights(w_in, b_in, w_dw, b_dw, cls)
    got = torch.full_like(want, float("nan"))
    wd = w_dw.reshape(e, 9).contiguous()
    _build.launch("vmt_oss_front_f32_pack", got.device, w_in.data_ptr(),
                  b_in.data_ptr(), wd.data_ptr(), b_dw.data_ptr(),
                  got.data_ptr(), c, e, cls)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("ydtype,zdtype", PAIRS)
@pytest.mark.parametrize("d,h,w", [(40, 16, 32), (96, 24, 40), (160, 32, 16),
                                   (384, 16, 16), (768, 16, 16),
                                   (200, 8, 24), (96, 1, 1)])
def test_oss_tail_takes_every_class(cuda, d, h, w, ydtype, zdtype):
    """K6 at every width class (D = 40, 96; 160; 384; 768, the widest, a
    cluster of 16), its 16-byte route with partial tiles (24 x 40, 8 x 24)
    and its edge path (a 1 x 1 image); two calls the same bits."""
    args = _tail_args(cuda, d, h, w, ydtype, zdtype, d + h)
    got = cuda_effn.oss_tail_fwd(*args)
    assert got.dtype == zdtype and got.shape == (2, d, h, w)
    _close(got, cuda_effn.oss_tail_ref(*args), zdtype)
    assert torch.equal(got, cuda_effn.oss_tail_fwd(*args))


@pytest.mark.parametrize("ydtype,zdtype", PAIRS)
@pytest.mark.parametrize("d", [96, 384])
def test_oss_tail_at_every_split(cuda, d, ydtype, zdtype):
    """K6 with its channels split over clusters of every size the launch
    takes for D (the class's least up to 16), on the 16-byte route (16 x
    16) and the edge path (13 x 19): each within the envelope of the
    plain version, and a split of fewer blocks than the class's least
    refused."""
    from vmambair_torch import _build

    cls = cuda_effn.k6_class(d)
    least = cuda_effn.K6_CLASSES[cls][1]
    for h, w in ((16, 16), (13, 19)):
        y, z, lnw, lnb = _tail_args(cuda, d, h, w, ydtype, zdtype, d + w)
        ref = cuda_effn.oss_tail_ref(y, z, lnw, lnb)
        split = least
        while split <= cuda_effn.K6_MAX_SPLIT:
            out = torch.empty_like(z)
            _build.launch("vmt_oss_tail_fwd", z.device, y.data_ptr(),
                          _build.dtype_code(y, "y"), z.data_ptr(),
                          _build.dtype_code(z, "z"), out.data_ptr(),
                          lnw.data_ptr(), lnb.data_ptr(), 2, d, h, w, split,
                          1e-5)
            _close(out, ref, zdtype)
            split *= 2
        if least > 1:
            with pytest.raises(RuntimeError, match="CUDA error"):
                _build.launch("vmt_oss_tail_fwd", z.device, y.data_ptr(),
                              _build.dtype_code(y, "y"), z.data_ptr(),
                              _build.dtype_code(z, "z"), out.data_ptr(),
                              lnw.data_ptr(), lnb.data_ptr(), 2, d, h, w,
                              least // 2, 1e-5)


@pytest.mark.parametrize("ydtype,zdtype", PAIRS)
@pytest.mark.parametrize("offset", [1, 2, 8])
def test_oss_tail_takes_misaligned_views(cuda, offset, ydtype, zdtype):
    """y and z as views 1, 2 or 8 elements into buffers of their own (1
    and 2: not 16-byte aligned, the edge path; 8: aligned, the 16-byte
    route): the same bits as the 16-byte route on aligned copies."""
    y, z, lnw, lnb = _tail_args(cuda, 96, 16, 16, ydtype, zdtype, offset)
    views = []
    for t in (y, z):
        buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=cuda)
        buf[offset:] = t.flatten()
        views.append(buf[offset:].view(t.shape))
    got = cuda_effn.oss_tail_fwd(*views, lnw, lnb)
    _close(got, cuda_effn.oss_tail_ref(y, z, lnw, lnb), zdtype)
    assert torch.equal(got, cuda_effn.oss_tail_fwd(y, z, lnw, lnb))


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


# -- K7 and the scan-design probes (csrc/scan_seq.cu, scan_lpar.cu, peak.cu) --

# memory orders of the (b, g, l, d) activations and (b, g, l, n) B/C: DL
# (B, D, L) with B/C (B, G, N, L); LD (B, L, D) with B/C (B, L, G, N);
# kseq's (G, L, b, Dg) with B/C (G, L, N, b)
LAYOUTS = {"dl": ((0, 1, 3, 2), (0, 1, 3, 2)),
           "ld": ((0, 2, 1, 3), (0, 2, 1, 3)),
           "kseq": ((1, 2, 0, 3), (1, 2, 3, 0))}


def _laid(t, perm):
    """A (b, g, l, x) view of t stored in the memory order `perm`."""
    inv = sorted(range(4), key=perm.__getitem__)
    return t.permute(perm).contiguous().permute(inv)


def _view_args(cuda, layout, b, G, dg, L, N, dtype, seed):
    """u, delta, A, B, C, D, bias, y for the view-addressed scans, laid out
    as `layout`; delta raw (softplus on) around 0.05-0.3."""
    g = torch.Generator().manual_seed(seed)
    act, bc = LAYOUTS[layout]
    dim = G * dg
    u = torch.randn(b, G, L, dg, generator=g)
    delta = torch.rand(b, G, L, dg, generator=g) * 2 - 3
    Bm = torch.randn(b, G, L, N, generator=g)
    Cm = torch.randn(b, G, L, N, generator=g)
    rest = [-torch.exp(torch.rand(dim, N, generator=g)).to(cuda),
            torch.randn(dim, generator=g).to(cuda),
            (torch.rand(dim, generator=g) - 1).to(cuda)]
    u, delta, Bm, Cm = (_laid(t.to(cuda, dtype), p) for t, p in
                        ((u, act), (delta, act), (Bm, bc), (Cm, bc)))
    y = _laid(torch.empty(b, G, L, dg, device=cuda, dtype=dtype), act)
    return [u, delta, rest[0], Bm, Cm, rest[1], rest[2], y]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("layout", ["dl", "ld", "kseq"])
@pytest.mark.parametrize("win,N,seg", [
    pytest.param(1, 16, None, id="1-16"), pytest.param(16, 5, None, id="16-5"),
    pytest.param(7, 16, None, id="7-16"),
    pytest.param(8, 16, 4096, id="8-16-seg4096"),
    pytest.param(8, 16, 16, id="8-16-seg16"),
    pytest.param(16, 5, 30, id="16-5-seg30")])
def test_scan_seq_kernel_matches_plain(cuda, win, N, seg, layout, reverse,
                                       dtype):
    """L = 101 is no multiple of the window; Dg = 37 is a tile of 32
    channels and a ragged one; N = 5 is no power of two. seg None is the
    rule's (`seq_segment`: two segments of 64 here); 4096 one segment (one
    grid, no scratch); 16 seven, the last ragged; 30 four, 30 no multiple
    of the window of 16 nor a divisor of L."""
    from vmambair_torch.ops import cuda_probes

    args = _view_args(cuda, layout, 3, 2, 37, 101, N, dtype, win + N)
    n0 = cuda_probes.scan_seq.launches
    got = cuda_probes.scan_seq(*args, reverse=reverse, win=win, seg=seg)
    assert cuda_probes.scan_seq.launches == n0 + 1 and got is args[7]
    _close(got, cuda_scan.scan_views_ref(*args[:7], True, reverse), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("layout", ["dl", "ld", "kseq"])
@pytest.mark.parametrize("seg,L", [(64, 300), (100, 300), (4096, 300),
                                   (256, 1000)])
def test_scan_lpar_kernel_matches_plain(cuda, seg, L, layout, reverse,
                                        dtype):
    """Segments that do not divide L, one segment of several 256-position
    windows, D = 74 (no multiple of a block's 4 channels)."""
    from vmambair_torch.ops import cuda_probes

    args = _view_args(cuda, layout, 2, 2, 37, L, 16, dtype, seg + L)
    n0 = cuda_probes.scan_lpar.launches
    got = cuda_probes.scan_lpar(*args, reverse=reverse, seg=seg)
    assert cuda_probes.scan_lpar.launches == n0 + 1
    _close(got, cuda_scan.scan_views_ref(*args[:7], True, reverse), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse,N", [
    pytest.param(False, 16, id="False"), pytest.param(True, 16, id="True"),
    pytest.param(False, 32, id="False-N32"),
    pytest.param(True, 64, id="True-N64")])
def test_selective_scan_ld_kernel_matches_plain(cuda, reverse, N, dtype):
    """K7 on a contiguous (B, L, D) u, a strided delta and B/C viewed from
    (B, G, N, L) memory; L = 101, D = 74. N = 32 and 64 walk the states in
    register passes of 16 (the card refused N > 16 before)."""
    g = torch.Generator().manual_seed(11)
    b, L, G, dg = 2, 101, 2, 37
    dim = G * dg
    args = [torch.randn(b, L, dim, generator=g).to(cuda, dtype),
            (torch.rand(b, dim, L, generator=g) * 2 - 3).to(cuda, dtype)
            .transpose(1, 2),
            -torch.exp(torch.rand(dim, N, generator=g)).to(cuda),
            torch.randn(b, G, N, L, generator=g).to(cuda, dtype)
            .permute(0, 3, 1, 2),
            torch.randn(b, G, N, L, generator=g).to(cuda, dtype)
            .permute(0, 3, 1, 2),
            torch.randn(dim, generator=g).to(cuda),
            (torch.rand(dim, generator=g) - 1).to(cuda)]
    n0 = cuda_scan.selective_scan_ld_fwd.launches
    got = cuda_scan.selective_scan_ld_fwd(*args, True, reverse)
    assert cuda_scan.selective_scan_ld_fwd.launches == n0 + 1
    assert got.shape == (b, L, dim) and got.is_contiguous()
    _close(got, cuda_scan.selective_scan_ld_ref(*args, True, reverse), dtype)


@pytest.mark.parametrize("shape", [(2, 8, 128), (3, 5, 1024), (1, 3, 256)])
@pytest.mark.parametrize("probe", ["fma_fp32", "fma_bf16", "exp_fp32",
                                   "roll+add_fp32", "concatshift+add_fp32"])
def test_peak_probe_kernels_match_plain(cuda, probe, shape):
    """kpeak's five probes at its REP = 64 against their plain versions:
    fp32 within a relative 1e-5 (the roll and shift chains end near
    1e-11), the bf16 FMA within the bf16 envelope."""
    from vmambair_torch.ops import cuda_probes
    from vmambair_torch.tools import kpeak

    fn, name, dtype, _ = cuda_probes.PEAK_PROBES[probe]
    x = kpeak.make_x(shape, dtype, 3, cuda)
    n0 = fn.launches
    got = fn(x)
    assert fn.launches == n0 + 1 and got.dtype == dtype
    rtol, atol = kpeak.TOL[dtype]
    torch.testing.assert_close(got.float(), cuda_probes.peak_ref(
        name, x).float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dl", "ld", "kseq"])
@pytest.mark.parametrize("chunk,L,N", [(256, 1000, 16), (1024, 300, 16),
                                       (100, 300, 5), (512, 2048, 16)])
def test_scan_combined_kernel_matches_plain(cuda, chunk, L, N, layout,
                                            dtype):
    """kvariants' v16: y and the chunk-local reverse y2. Chunks that do
    not divide L, a chunk of several 256-position windows and one that is
    no multiple of a window, a chunk longer than L, N = 5."""
    from vmambair_torch.ops import cuda_probes

    args = _view_args(cuda, layout, 2, 2, 37, L, N, dtype, chunk + L + N)
    y2 = torch.empty_strided(args[7].shape, args[7].stride(), dtype=dtype,
                             device=cuda)
    n0 = cuda_probes.scan_combined.launches
    y, got2 = cuda_probes.scan_combined(*args, y2, chunk=chunk)
    assert cuda_probes.scan_combined.launches == n0 + 1
    assert y is args[7] and got2 is y2
    ref, ref2 = cuda_probes.scan_combined_ref(*args[:7], chunk=chunk)
    _close(y, ref, dtype)
    _close(y2, ref2, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dl", "ld"])
@pytest.mark.parametrize("stack,chunk,sub,L,N", [
    ("ab", 1024, None, 1000, 16),  # one stack longer than L
    ("ab", 256, None, 1000, 5),    # a stack per window, ragged tail
    ("ab", 512, 64, 300, 16),      # stacks of 8 lanes
    ("b", 1024, 128, 1000, 16),    # v10's sub-chunks of 128
    ("b", 512, 512, 2048, 16),     # a stack over two windows
    ("b", 64, 8, 300, 5),          # a stack per lane
])
def test_scan_stack_kernels_match_plain(cuda, stack, chunk, sub, L, N,
                                        layout, dtype):
    """kvariants' v3 (stack "ab") and v10 (stack "b") against the plain
    version, which rounds where the TPU kernels round. Both round the
    stack to bf16 whatever the input dtype, so both dtypes are held to
    the bf16 envelope."""
    from vmambair_torch.ops import cuda_probes

    fn = getattr(cuda_probes, f"scan_stack_{stack}")
    args = _view_args(cuda, layout, 2, 2, 37, L, N, dtype, chunk + L + N)
    n0 = fn.launches
    got = fn(*args, chunk=chunk, sub=sub)
    assert fn.launches == n0 + 1 and got is args[7]
    ref = cuda_probes.scan_stack_bf16_ref(*args[:7], stack=stack,
                                          sub=sub or chunk)
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("stack,sub", [("ab", None), ("b", 128)])
def test_scan_stack_last_bf16_matches_plain_on_the_probe_recipe(cuda, stack,
                                                                 sub):
    """The stacks with each position's last composition in bf16, the
    TPU's rounding, which `chip_smoke.py` times beside the default: on
    kvariants' model-realistic recipe, where it is timed, within the bf16
    envelope of the plain version (two chunks and a ragged tail). It is
    not the default because elsewhere two bf16 trees can differ by more
    than the envelope: on test_scan_stack_kernels_match_plain's inputs
    v3's left it on 1 of 148000 elements, by 1.14x."""
    from vmambair_torch.tools import kvariants

    shape = kvariants.Shape(B=2, L=2304, D=96, G=2, N=16, chunk=1024)
    inp = kvariants.make_inputs(shape, 5, cuda, "real")
    got = kvariants.run_stack(inp, stack, shape.chunk, sub, last_bf16=True)
    ref = kvariants.ref_stack(inp, stack, shape.chunk, sub)
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOL[torch.bfloat16])


def test_probe_kernels_refuse_what_they_cannot_take(cuda):
    from vmambair_torch.ops import cuda_probes

    args = _view_args(cuda, "dl", 1, 2, 8, 40, 16, torch.float32, 1)
    with pytest.raises(ValueError, match="win=17"):
        cuda_probes.scan_seq(*args, win=17)
    with pytest.raises(ValueError, match="LANES=100"):
        cuda_probes.peak_roll(torch.rand(1, 2, 100, device=cuda))
    with pytest.raises(ValueError, match="divides chunk=100"):
        cuda_probes.scan_stack_b(*args, chunk=100, sub=64)
    with pytest.raises(ValueError, match="power of two"):
        cuda_probes.scan_stack_ab(*args, chunk=96, sub=48)
    with pytest.raises(ValueError, match="y's shape, strides"):
        cuda_probes.scan_combined(*args, args[7].contiguous())
    wide = _view_args(cuda, "dl", 1, 2, 8, 40, 17, torch.float32, 1)
    for call in (cuda_probes.scan_stack_ab, cuda_probes.scan_stack_b,
                 lambda *a: cuda_probes.scan_combined(*a, a[7].clone())):
        with pytest.raises(ValueError, match="N=17 over"):
            call(*wide)
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        cuda_probes.scan_lpar(*args)
    with pytest.raises(RuntimeError, match="has no backward"):
        cuda_probes.scan_stack_ab(*args)


# -- kvariants' separated-exponent scans (csrc/scan_dual.cu) --------------------

def _sep_inputs(cuda, recipe, dtype, L=768, D=6):
    """kvariants' inputs at B 2, G 2, D channels (a tile of 4 and a ragged
    one), N 16, L = 6 windows of 128; recipe 'default' (hot) or 'real'."""
    from vmambair_torch.tools import kvariants

    shape = kvariants.Shape(B=2, L=L, D=D, G=2, N=16, chunk=256)
    inp = kvariants.make_inputs(shape, 3, cuda, recipe)
    for k in ("u", "delta", "Bm", "Cm"):
        inp[k] = inp[k].to(dtype)
    return inp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("recipe", ["default", "real"])
def test_scan_dual_kernels_match_plain(cuda, recipe, reverse, dtype):
    """Every separated-exponent name of the race (v22-v26, v4) against its
    plain version, forward and reverse, on the hot default recipe (the
    clamps bind; v4 is compared where both are finite) and the realistic
    one: fp32 inputs within the fp32 envelope, bf16 within 3e-2 / 5e-2
    (v23 within 3e-2 / 5e-2 on either: its Z is rounded to bf16, where
    the kernel's exp2 and the plain version's, an ulp or two apart, can
    round to neighbours 2^-8 apart); one launch each of its form's
    wrapper."""
    from vmambair_torch.ops import cuda_probes
    from vmambair_torch.tools import kvariants

    inp = _sep_inputs(cuda, recipe, dtype)
    for name in kvariants.SEPARATED:
        fn = getattr(cuda_probes, kvariants.sep_kernel(name))
        n0 = fn.launches
        got = kvariants.run_sep(inp, name, reverse=reverse).float()
        assert fn.launches == n0 + 1, name
        ref = kvariants.ref_sep(inp, name, reverse=reverse).float()
        if name in kvariants.MAY_OVERFLOW:
            both = torch.isfinite(got) & torch.isfinite(ref)
            assert both.any(), name
            if recipe == "real":
                assert both.all(), name
            got, ref = got[both], ref[both]
        zbf16 = "zdt" in kvariants.SEPARATED[name][3]
        torch.testing.assert_close(
            got, ref, **TOL[torch.bfloat16 if zbf16 else dtype], msg=name)


@pytest.mark.parametrize("form,sub,blk,opts", [
    ("v22", 256, 32, {}), ("v24", 128, 16, {"mid": True}),
    ("v26", 256, 128, {})])
def test_scan_dual_kernel_takes_strided_views(cuda, form, sub, blk, opts):
    """The channels-last and kseq layouts (strided views of u, delta, B, C
    and y), Dg = 37 (9 tiles of 4 channels, the last ragged), N = 5."""
    from vmambair_torch.ops import cuda_probes

    for layout in ("ld", "kseq"):
        args = _view_args(cuda, layout, 2, 2, 37, 512, 5, torch.float32, 7)
        got = cuda_probes.scan_dual(*args, form=form, sub=sub, blk=blk,
                                    **opts)
        ref = cuda_probes.DUAL_REFS[form](*args[:7], sub=sub, blk=blk,
                                          **opts)
        _close(got, ref, torch.float32)


def test_scan_dual_kernels_refuse_what_they_cannot_take(cuda):
    from vmambair_torch.ops import cuda_probes

    args = _view_args(cuda, "dl", 1, 2, 8, 256, 16, torch.float32, 1)
    with pytest.raises(ValueError, match=r"\(sub, blk\) = \(128, 48\)"):
        cuda_probes.scan_dual(*args, form="v22", sub=128, blk=48)
    with pytest.raises(ValueError, match=r"\(sub, blk\) = \(64, 64\)"):
        cuda_probes.scan_cumsum(*args, sub=64)
    with pytest.raises(ValueError, match="form='v23'"):
        cuda_probes.scan_dual(*args, form="v23", sub=128, blk=32)
    ragged = _view_args(cuda, "dl", 1, 2, 8, 200, 16, torch.float32, 1)
    with pytest.raises(ValueError, match="L=200"):
        cuda_probes.scan_dual(*ragged, form="v26", sub=128, blk=64)
    wide = _view_args(cuda, "dl", 1, 2, 8, 256, 17, torch.float32, 1)
    with pytest.raises(ValueError, match="N=17 over"):
        cuda_probes.scan_dual(*wide, form="v24", sub=128, blk=32)
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        cuda_probes.scan_cumsum(*args)


# -- keffn and kprobe --------------------------------------------------------------

def _keffn_args(cuda, b, h, w, c, dtype, seed):
    """keffn's inputs in its layouts: x (B, H, W, C), w_in (C, 2h), w_dw
    (3, 3, 2h), w_out (h, C)."""
    g = torch.Generator().manual_seed(seed)
    hid = int(2.66 * c)
    args = [0.5 * torch.randn(b, h, w, c, generator=g),
            1 + 0.1 * torch.randn(c, generator=g),
            0.1 * torch.randn(c, generator=g),
            torch.randn(c, 2 * hid, generator=g) / c ** 0.5,
            torch.randn(3, 3, 2 * hid, generator=g) / 3,
            torch.randn(hid, c, generator=g) / hid ** 0.5]
    args = [a.to(cuda) for a in args]
    args[0] = args[0].to(dtype)
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", [(2, 13, 19, 48), (1, 16, 20, 96),
                                     (2, 5, 7, 384), (1, 9, 33, 40)])
def test_gdfn_tanh_nhwc_kernel_matches_plain(cuda, b, h, w, c, dtype):
    """keffn's kernel: H and W no multiples of K2's tiles (13 x 19, 5 x 7,
    9 x 33), W not a multiple of 8 (20), C = 40 a ragged width."""
    from vmambair_torch.ops import cuda_probes

    args = _keffn_args(cuda, b, h, w, c, dtype, c + h)
    n0 = cuda_probes.gdfn_tanh_nhwc.launches
    got = cuda_probes.gdfn_tanh_nhwc(*args)
    assert cuda_probes.gdfn_tanh_nhwc.launches == n0 + 1
    assert got.shape == (b, h, w, c) and got.dtype == dtype
    _close(got, cuda_probes.gdfn_tanh_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 300, 96), (1, 64, 96), (3, 77, 40),
                                   (1, 5, 256)])
def test_probe_transpose_kernel_matches_plain(cuda, shape, dtype):
    """kprobe's transpose pair, bit-equal to its plain version: rows that
    are no multiple of a tile, fewer rows than one tile, D = 40 and the
    largest D, 256."""
    from vmambair_torch.ops import cuda_probes

    g = torch.Generator().manual_seed(shape[1])
    u = torch.randn(*shape, generator=g).to(cuda, dtype)
    n0 = cuda_probes.probe_transpose.launches
    got = cuda_probes.probe_transpose(u)
    assert cuda_probes.probe_transpose.launches == n0 + 1
    assert got.dtype == dtype
    assert torch.equal(got, cuda_probes.probe_transpose_ref(u))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,RN,R", [((2, 300, 96), 38, 6),
                                        ((3, 77, 40), 64, 13),
                                        ((1, 5, 256), 7, 1)])
def test_probe_proj_kernel_matches_plain(cuda, shape, RN, R, dtype):
    """kprobe's projections: the probe's RN = 38, R = 6 on ragged rows, the
    largest RN (64) and D (256)."""
    from vmambair_torch.ops import cuda_probes

    g = torch.Generator().manual_seed(RN + R)
    D = shape[-1]
    u = torch.randn(*shape, generator=g).to(cuda, dtype)
    wxp = (torch.randn(RN, D, generator=g) / D ** 0.5).to(cuda)
    wdt = (torch.randn(D, R, generator=g) / R ** 0.5).to(cuda)
    n0 = cuda_probes.probe_proj.launches
    got = cuda_probes.probe_proj(u, wxp, wdt)
    assert cuda_probes.probe_proj.launches == n0 + 1
    assert got.shape == u.shape and got.dtype == dtype
    _close(got, cuda_probes.probe_proj_ref(u, wxp, wdt), dtype)


PROJ_F32_BAR = 1e-5  # of the plain version's largest entry


def _tf32_rn(t):
    """fp32 rounded to TF32's 10 mantissa bits (ties away from zero)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


@pytest.mark.parametrize("shape,RN,R", [((8, 16384, 96), 38, 6),
                                        ((2, 300, 96), 38, 6),
                                        ((1, 77, 256), 40, 7),
                                        ((3, 50, 16), 9, 0)])
def test_probe_proj_fp32_within_the_fp32_bar(cuda, shape, RN, R):
    """kprobe's projections in fp32 (split TF32 on the tensor cores):
    within 1e-5 of the plain version's (cuBLAS, TF32 off) largest entry,
    at the probe's shape, ragged rows, the largest RN and R the route
    takes and the smallest D; a single-pass TF32 control (u and W_xp cut
    to TF32) misses that bar; two calls the same bits."""
    from vmambair_torch.ops import cuda_probes

    g = torch.Generator().manual_seed(RN + shape[1])
    D = shape[-1]
    u = torch.randn(*shape, generator=g).to(cuda)
    wxp = torch.randn(RN, D, generator=g).to(cuda)
    wdt = torch.randn(D, R, generator=g).to(cuda)
    got = cuda_probes.probe_proj(u, wxp, wdt)
    ref = cuda_probes.probe_proj_ref(u, wxp, wdt)
    top = ref.abs().max()
    assert (got - ref).abs().max() <= PROJ_F32_BAR * top
    ctl = cuda_probes.probe_proj_ref(_tf32_rn(u), _tf32_rn(wxp), wdt)
    assert (ctl - ref).abs().max() > PROJ_F32_BAR * top
    assert torch.equal(got, cuda_probes.probe_proj(u, wxp, wdt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D,RN,R,offset", [
    (131072, 96, 38, 6, 0), (20001, 96, 38, 6, 0), (100, 32, 40, 7, 0),
    (700, 64, 41, 6, 0), (700, 64, 38, 8, 0), (700, 96, 38, 6, 4),
    (700, 96, 38, 6, 8)])
def test_probe_proj_takes_both_paths(cuda, rows, D, RN, R, offset, dtype):
    """The projections' tensor-core route (D a multiple of 16, RN <= 40,
    R < 8, u 16-byte aligned: the probe's 131072 rows, a ragged last warp
    tile, D = 32, a u 8 elements into its buffer, 4 in fp32) and its edge
    path (RN = 41, R = 8, a u 4 bf16 elements into its buffer): within
    the envelope of the plain version."""
    from vmambair_torch.ops import cuda_probes

    g = torch.Generator().manual_seed(rows + D + RN + offset)
    buf = torch.randn(rows * D + offset, generator=g).to(cuda, dtype)
    u = buf[offset:].view(rows, D)
    wxp = (torch.randn(RN, D, generator=g) / D ** 0.5).to(cuda)
    wdt = (torch.randn(D, R, generator=g) / max(R, 1) ** 0.5).to(cuda)
    got = cuda_probes.probe_proj(u, wxp, wdt)
    assert got.shape == u.shape and got.dtype == dtype
    _close(got, cuda_probes.probe_proj_ref(u, wxp, wdt), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,offset", [(45, 0), (96, 1)])
def test_probe_kernels_take_odd_widths_and_offset_views(cuda, D, offset,
                                                       dtype):
    """kprobe's kernels on rows of 45 channels, and on a u that starts 1
    element into a larger buffer."""
    from vmambair_torch.ops import cuda_probes

    g = torch.Generator().manual_seed(D + offset)
    n = 2 * 130 * D
    buf = torch.randn(n + offset, generator=g).to(cuda, dtype)
    u = buf[offset:].view(2, 130, D)
    got = cuda_probes.probe_transpose(u)
    assert torch.equal(got, cuda_probes.probe_transpose_ref(u))
    wxp = (torch.randn(38, D, generator=g) / D ** 0.5).to(cuda)
    wdt = (torch.randn(D, 6, generator=g) / 6 ** 0.5).to(cuda)
    _close(cuda_probes.probe_proj(u, wxp, wdt),
           cuda_probes.probe_proj_ref(u, wxp, wdt), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D,offset", [
    (20000, 33, 0), (20000, 96, 1), (20000, 96, 4), (20000, 96, 8),
    (131072, 96, 0), (5000, 8, 0), (3001, 4, 0), (9000, 256, 0),
    (777, 72, 0), (777, 1, 3)])
def test_probe_transpose_takes_both_paths(cuda, rows, D, offset, dtype):
    """The transpose pair's 16-byte route (D a multiple of 8 bf16 or 4
    fp32, u 16-byte aligned: several tiles a block at 131072 rows, the
    probe's (8, 16384, 96); ragged last tiles; D of 1, 3 and 4 chunks a
    row, 9 (groups of 8 in pass B), 32) and its edge path (D = 33, a u
    that starts 1, 4 or 8 elements into its buffer, D = 1): bit-equal to
    the plain version either way, y of u's shape."""
    from vmambair_torch.ops import cuda_probes

    g = torch.Generator().manual_seed(rows + D + offset)
    buf = torch.randn(rows * D + offset, generator=g).to(cuda, dtype)
    u = buf[offset:].view(rows, D)
    got = cuda_probes.probe_transpose(u)
    assert got.shape == u.shape and got.dtype == dtype
    assert torch.equal(got, cuda_probes.probe_transpose_ref(u))


def test_keffn_and_kprobe_kernels_refuse_what_they_cannot_take(cuda):
    from vmambair_torch.ops import cuda_probes

    args = _keffn_args(cuda, 1, 4, 4, 392, torch.float32, 0)
    with pytest.raises(ValueError, match="C=392"):
        cuda_probes.gdfn_tanh_nhwc(*args)
    args = _keffn_args(cuda, 1, 4, 4, 8, torch.float32, 0)
    with pytest.raises(ValueError, match="weight shapes"):
        cuda_probes.gdfn_tanh_nhwc(*args[:3], args[3].t(), *args[4:])
    u = torch.zeros(1, 8, 300, device=cuda)
    with pytest.raises(ValueError, match="D=300"):
        cuda_probes.probe_transpose(u)
    u = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="R < RN"):
        cuda_probes.probe_proj(u, torch.zeros(6, 16, device=cuda),
                               torch.zeros(16, 6, device=cuda))
    with pytest.raises(ValueError, match="R < RN"):
        cuda_probes.probe_proj(u, torch.zeros(65, 16, device=cuda),
                               torch.zeros(16, 6, device=cuda))
    u.requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        cuda_probes.probe_transpose(u)


def _ld_args(cuda, b, d, L, dtype, seed):
    """kldio's recipe at (b, 2, L, d): u (B, G, L, D) and K1's weights."""
    g = torch.Generator().manual_seed(seed)
    N, R = 16, -(-d // 16)
    args = [torch.randn(b, 2, L, d, generator=g).to(cuda, dtype),
            torch.randn(2, R + 2 * N, d, generator=g) * 0.2,
            torch.randn(2, d, R, generator=g) * 0.2,
            0.1 * torch.randn(2, d, generator=g),
            -0.5 - torch.exp(torch.randn(2, d, N, generator=g) * 0.5),
            torch.randn(2, d, generator=g)]
    args[1:] = [a.to(cuda) for a in args[1:]]
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,d,L", [(2, 96, 300), (1, 202, 64), (2, 256, 33),
                                   (1, 45, 97)])
def test_ld_fused_kernel_matches_plain(cuda, b, d, L, reverse, dtype):
    """kldio's kernel (K1's Ld policy) on (B, G, L, D) against its plain
    version: kldio's width, a width no multiple of 4 or of 16, the widest,
    ragged L."""
    from vmambair_torch.ops import cuda_probes

    args = _ld_args(cuda, b, d, L, dtype, d + L)
    n0 = cuda_probes.ld_fused.launches
    got = cuda_probes.ld_fused(*args, reverse=reverse)
    assert cuda_probes.ld_fused.launches == n0 + 1
    assert got.shape == args[0].shape and got.dtype == dtype
    _close(got, cuda_probes.ld_fused_plain(*args, reverse=reverse), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_ld_and_dl_policies_give_the_same_bits(cuda, reverse, dtype):
    """K1's two layout policies on the same values: y bit for bit (the
    policies change only where u is read and y written)."""
    from vmambair_torch.ops import cuda_probes

    args = _ld_args(cuda, 2, 96, 1000, dtype, 5)
    got = cuda_probes.ld_fused(*args, reverse=reverse)
    dl = cuda_scan.oss_scan_fused_fwd(args[0].movedim(2, 3).contiguous(),
                                      *args[1:], reverse=reverse)
    assert torch.equal(got, dl.movedim(3, 2))


def test_dl_policy_keeps_the_recorded_k1_bits(cuda):
    """K1 and K1c (the Dl policy) give the bits recorded from the recorded
    build (`tools/k1_digests.json`, made by `python -m
    vmambair_torch.tools.ab --other DIR --digests`)."""
    import json

    from vmambair_torch.tools import ab

    with open(ab.DIGESTS_FILE) as f:
        want = json.load(f)["digests"]
    got = ab.digests()
    assert got.keys() == want.keys()
    assert [k for k in got if got[k] != want[k]] == []


def test_ld_fused_refuses_what_it_cannot_take(cuda):
    from vmambair_torch.ops import cuda_probes

    args = _ld_args(cuda, 1, 264, 40, torch.float32, 0)
    with pytest.raises(ValueError, match="D=264"):
        cuda_probes.ld_fused(*args)
    args = _ld_args(cuda, 1, 16, 40, torch.float32, 0)
    with pytest.raises(ValueError, match="parameter shapes"):
        cuda_probes.ld_fused(args[0], args[1].transpose(1, 2), *args[2:])
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        cuda_probes.ld_fused(*args)


def _gan_model(cuda):
    """A tiny S2 GAN model on the card: OSSNet dim 40, D num_feat 8, L1 +
    VGG19 perceptual + vanilla GAN, on 2 x 16x16 LQ / 64x64 GT."""
    import numpy as np

    from vmambair_torch.train import build_model

    opt = {"name": "t_gan", "model_type": "MambaSISRGANModel",
           "is_train": True, "scale": 4, "manual_seed": 0,
           "network_g": dict(type="OSSNet", dim=40, num_blocks=[1, 1, 1, 1],
                             num_refinement_blocks=1, scale=4),
           "network_d": {"type": "UNetDiscriminatorSN", "num_feat": 8},
           "path": {}, "val": {"window_size": 8},
           "train": {"ema_decay": 0.999,
                     "optim_g": {"type": "Adam", "lr": 1e-4},
                     "optim_d": {"type": "Adam", "lr": 1e-4},
                     "pixel_opt": {"type": "L1Loss"},
                     "perceptual_opt": {"type": "PerceptualLoss",
                                        "layer_weights": {"conv3_4": 1.0}},
                     "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                                 "loss_weight": 0.1}}}
    m = build_model(opt, device=cuda)
    rng = np.random.RandomState(0)
    m.feed_data({"lq": rng.rand(2, 16, 16, 3).astype(np.float32),
                 "gt": rng.rand(2, 64, 64, 3).astype(np.float32)})
    return m


def test_gan_iteration_launches_the_generators_kernels(cuda):
    """A GAN iteration's G step launches what the dispatch predicts for a
    training step and nothing else; a gated iteration G's no-grad
    forward; every logged value finite."""
    import numpy as np

    import chip_smoke

    m = _gan_model(cuda)
    for it, train in ((1, True), (2, False)):
        m.net_d_init_iters = 0 if train else 2
        chip_smoke.reset_launches()
        m.optimize_parameters(it)
        torch.cuda.synchronize()
        assert chip_smoke.launches() == chip_smoke.expected_launches(
            m.net_g, train=train), it
        log = m.get_current_log()
        assert ("l_g_gan" in log) == train
        assert all(np.isfinite(v) for v in log.values()), log


def test_gan_g_step_raises_where_a_kernel_cannot_take_a_gradient(
        cuda, monkeypatch):
    """With the GDFN's autograd Function swapped for its bare kernel
    wrapper (which has no backward), the G step raises instead of
    training G around a detached GDFN."""
    from vmambair_torch.models import layers

    m = _gan_model(cuda)
    monkeypatch.setattr(layers, "gdfn_residual_fused",
                        cuda_effn.gdfn_residual_fwd)
    with pytest.raises(RuntimeError, match="has no backward"):
        m.optimize_parameters(1)


def test_oss_front_f32_takes_weights_that_need_a_copy(cuda):
    """F5: K5's fp32 route with every weight a view that the wrapper must
    copy (in_conv's weight a transposed view, the biases and the
    depthwise weight strided) against its plain version. A copy freed
    before the launch lets the next copy take its memory: both biases
    fit one 512-byte block."""
    x, lnw, lnb, w_in, b_in, w_dw, b_dw = _front_args(
        cuda, 48, 48, 13, 19, torch.float32, 5)
    views = (w_in.t().contiguous().t(),
             torch.stack([b_in, -b_in], 1)[:, 0],
             torch.stack([w_dw, -w_dw], -1)[..., 0],
             torch.stack([b_dw, -b_dw], 1)[:, 0])
    assert not any(v.is_contiguous() for v in views)
    for _ in range(3):
        xs, z = cuda_effn.oss_front_fwd(x, lnw, lnb, *views)
        rxs, rz = cuda_effn.oss_front_ref(x, lnw, lnb, w_in, b_in, w_dw,
                                          b_dw)
        _close(xs, rxs, torch.float32)
        _close(z, rz, torch.float32)


@pytest.mark.parametrize("c", [48, 96, 192, 384])
def test_direct_channel_scan_kernels_match_plain(cuda, c):
    """MambaRealSR11's direct channel scan: (9, c, 2), one channel to each
    of the two groups, on the model's channel-scan views. K4 and K4c
    within the fp32 envelope of the plain scan (K4c's y equal to K4's,
    its carries within the envelope); K3 from those carries within 5x
    the envelope."""
    args = _k4_args(cuda, 9, c, 2, 2, 16, torch.float32, c, "channel")
    kw = dict(delta_softplus=True)
    y = cuda_scan.selective_scan_fwd(*args, **kw)
    _close(y, cuda_scan.selective_scan_ref(*args, **kw), torch.float32)
    yc, car = cuda_scan.selective_scan_fwd_carries(*args, **kw)
    assert torch.equal(y, yc)
    _close(car, cuda_scan.selective_scan_carries_ref(*args, **kw)[1],
           torch.float32)
    dy = torch.randn(9, c, 2, device=cuda)
    got = cuda_scan.selective_scan_bwd(*args, dy, car, **kw)
    for a, b in zip(got, cuda_scan.selective_scan_bwd_ref(*args, dy, **kw)):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_realsr_synthesis_on_the_card_matches_the_cpu(cuda):
    """The two-order synthesis on the card against the same synthesis on
    the CPU, with the same draws and noise samples, for 8 seeds: the GT
    crops equal, the USM GT under `chip_smoke.usm_vs_cpu`'s rule (its hard
    mask may flip only at a tie, the output within 1e-5 outside the
    flips' blur footprints), and the LQ (past JPEG's rounds and
    the uint8 grid) under the rule of the CPU tests: at most 2% of its
    elements differ, at most 0.5% by more than one uint8 step."""
    import chip_smoke
    from realsr_cases import SYNTH, kernels
    from vmambair_torch.train import realesrgan_model as trm

    g = torch.Generator().manual_seed(0)
    gt = torch.rand(2, 3, 64, 64, generator=g)
    kern = [torch.from_numpy(k) for k in kernels(2, 1)]
    off = far = n = 0
    for seed in range(8):
        d = trm.Synthesis(SYNTH, 4, 32, seed, "cpu").draw(2, 64, 64)
        sampler = chip_smoke.Replay(seed)
        ref = trm.synthesize(gt, *kern, d, sampler, 4, 32)
        sampler.replay_on(cuda)
        got = trm.synthesize(gt.to(cuda), *(k.to(cuda) for k in kern),
                             chip_smoke.draws_to(d, cuda), sampler, 4, 32)
        assert torch.equal(got[0].cpu(), ref[0])
        chip_smoke.usm_vs_cpu(gt, gt.to(cuda), 4 * d.top, 4 * d.left,
                              got[1], ref[1])
        diff = (got[2].cpu() - ref[2]).abs()
        off += int((diff > 1e-6).sum())
        far += int((diff > 1.5 / 255).sum())
        n += diff.numel()
    print(f"synthesis, card against CPU: {off / n:.4f} of the LQ elements "
          f"differ, {far / n:.4f} by more than one uint8 step")
    assert off <= 0.02 * n and far <= 0.005 * n


def _realsr_model(cuda, model_type="MambaRealSR"):
    from realsr_cases import SYNTH
    from vmambair_torch.train import build_model

    opt = dict(SYNTH, name="t_realsr", model_type=model_type,
               is_train=True, scale=4, manual_seed=0, gt_size=32,
               queue_size=4, path={}, val={"window_size": 8},
               network_g=dict(type="MambaRealSR11", dim=40,
                              num_blocks=[1, 1, 1, 1],
                              num_refinement_blocks=1),
               train={"ema_decay": 0.999,
                      "optim_g": {"type": "Adam", "lr": 1e-4},
                      "pixel_opt": {"type": "L1Loss"}})
    return build_model(opt, device=cuda)


def _realsr_batch(seed):
    import numpy as np

    from realsr_cases import kernels
    k1, k2, sinc = kernels(2, seed)
    return {"gt": np.random.RandomState(seed).rand(2, 64, 64, 3).astype(
        np.float32), "kernel1": k1, "kernel2": k2, "sinc_kernel": sinc}


def test_realsr_feed_data_makes_no_host_sync(cuda):
    """feed_data on the card (the copies, the synthesis, the queue's fill
    and its shuffle) under `set_sync_debug_mode("error")`: any operation
    that waits for the card raises."""
    m = _realsr_model(cuda)
    batches = [_realsr_batch(s) for s in range(4)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches:  # two fills of a queue of 4, then two swaps
            m.feed_data(b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert m._queue_ptr == 4
    assert m.lq.shape == (2, 3, 8, 8) and m.gt_usm.shape == (2, 3, 32, 32)
    assert torch.isfinite(m.lq).all()


def test_realsr_step_launches_the_training_kernels(cuda):
    """A RealSR S1 step of MambaRealSR11 (direct channel scans) launches
    what the dispatch predicts for a training step, with a finite
    loss."""
    import numpy as np

    import chip_smoke

    m = _realsr_model(cuda)
    m.feed_data(_realsr_batch(0))
    chip_smoke.reset_launches()
    m.optimize_parameters(1)
    torch.cuda.synchronize()
    assert chip_smoke.launches() == chip_smoke.expected_launches(
        m.net_g, train=True)
    assert all(np.isfinite(v) for v in m.get_current_log().values())


# Mamber33's deraining regimes: the latent pair at stage 6 (1 x 384x384:
# L = 2304, over several of K4's segments, with scratch; K3 at batch 1)
# and at stage 1 (8, 256, 768); the conv2 channel scans (b, c, 4), two
# channels to each of the two groups, at batch 8 and 1
DERAIN_SCANS = [(1, 2304, 768, "pair"), (8, 256, 768, "pair"),
                (8, 48, 4, "channel"), (8, 384, 4, "channel"),
                (1, 96, 4, "channel"), (1, 192, 4, "channel")]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,L,D,layout", DERAIN_SCANS)
def test_derain_scans_match_plain(cuda, b, L, D, layout, reverse):
    """K4, K4c and K3 at the deraining step's and evaluation's new shapes,
    on the model's views: K4 within the fp32 envelope, K4c's y equal to
    K4's and its carries within the envelope, K3 from those carries within
    5x the envelope."""
    args = _k4_args(cuda, b, L, D, 2, 16, torch.float32, L + D, layout)
    if L > 1024:
        assert cuda_scan.k4_segment(b, D, 2, L) < L
    kw = dict(delta_softplus=True, reverse=reverse)
    y = cuda_scan.selective_scan_fwd(*args, **kw)
    _close(y, cuda_scan.selective_scan_ref(*args, **kw), torch.float32)
    yc, car = cuda_scan.selective_scan_fwd_carries(*args, **kw)
    assert torch.equal(y, yc)
    _close(car, cuda_scan.selective_scan_carries_ref(*args, **kw)[1],
           torch.float32)
    dy = torch.randn(b, L, D, device=cuda)
    got = cuda_scan.selective_scan_bwd(*args, dy, car, **kw)
    for a, r in zip(got, cuda_scan.selective_scan_bwd_ref(*args, dy, **kw)):
        torch.testing.assert_close(a, r, **GRAD_TOL)


@pytest.mark.parametrize("arch,kw", [
    ("Mamber33", {}), ("Mamber32", {}),
    ("Mamber33", {"inp_channels": 6, "dual_pixel_task": True})],
    ids=["Mamber33", "Mamber32", "dual_pixel"])
def test_derain_net_through_the_kernels_matches_plain(cuda, arch, kw):
    """The deraining nets at their full width, depth [1,1,1,1] + 1, fp32
    (the dual-pixel one with six channels in): the forward through the
    kernels against the plain path within 1e-3 on a non-square batch, and
    every parameter's L1 gradient within 2e-3 of its largest entry, with
    the launches of a training step (`chip_smoke.grads_vs_plain`)."""
    import chip_smoke

    net = build_network(dict(type=arch, num_blocks=[1, 1, 1, 1],
                             num_refinement_blocks=1, **kw), device=cuda,
                        seed=3)
    c = kw.get("inp_channels", 3)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, c, 40, 56, generator=g).to(cuda)
    with torch.inference_mode():
        chip_smoke.reset_launches()
        got = net(x)
        assert chip_smoke.launches() == chip_smoke.expected_launches(net)
        with chip_smoke.plain_ops():
            ref = net(x)
    assert got.shape == (2, 3, 40, 56)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    chip_smoke.grads_vs_plain(net, x, torch.rand(2, 3, 40, 56,
                                                 generator=g).to(cuda),
                              arch)


# -- the learned metrics: the card against the CPU on the same images ------

def _metric_images(h=200, w=232, seed=0):
    """A pair of uint8 BGR images: a smooth field and a noisy copy."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(2 * np.pi * (3 * yy + c) + 5 * xx)
                    for c in range(3)], -1) * 100 + 128
    a = np.clip(img, 0, 255).round().astype(np.uint8)
    b = np.clip(img + rng.randn(h, w, 3) * 12, 0, 255).round().astype(
        np.uint8)
    return a, b


@pytest.mark.parametrize("name", ["lpips", "dists"])
def test_metrics_lpips_dists_on_the_card_match_the_cpu(cuda, name):
    """Within 1e-4 of the CPU's value plus 1e-6 (fp32, TF32 off inside
    the metric)."""
    from vmambair_torch.metrics import calculate_metric
    a, b = _metric_images()
    opt = {"type": f"calculate_{name}"}
    got = calculate_metric(opt, a, b, device=cuda)
    ref = calculate_metric(opt, a, b, device="cpu")
    assert abs(got - ref) <= 1e-4 * abs(ref) + 1e-6, (got, ref)


def test_metrics_niqe_on_the_card_matches_the_cpu(cuda):
    """The score within 1e-3 relative; the gamma argmins equal except at
    ties (neighbouring table entries, rhatnorm within 1e-5 of their
    midpoint on both devices)."""
    from vmambair_torch.metrics import niqe
    a, b = _metric_images(232, 296)
    p = niqe.pris_params()
    for img in (a, b):
        res = {}
        for dev in (cuda, "cpu"):
            feats, fits = niqe.niqe_features(niqe.to_y(img, 4, "y", dev),
                                             p["gaussian_window"])
            res[str(dev)] = (niqe.niqe_quality(
                feats.cpu().numpy(), p["mu_pris_param"],
                p["cov_pris_param"]), fits)
        (q_card, f_card), (q_cpu, f_cpu) = res["cuda"], res["cpu"]
        flips, at_ties = niqe.argmin_flips(f_card, f_cpu)
        assert at_ties, flips
        assert abs(q_card - q_cpu) <= 1e-3 * abs(q_cpu), (q_card, q_cpu)
        assert niqe.calculate_niqe(img, 4, device=cuda) == pytest.approx(
            q_card, rel=1e-12)


def test_metrics_inception_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Pool3 features of seeded weights, 64x64 and 320x320 images resized
    to 299 on the card, within 1e-4 of the largest CPU feature."""
    import numpy as np
    from vmambair_torch.metrics import fid, inception
    npz = inception.seeded_inception_npz(str(tmp_path / "inception.npz"))
    rng = np.random.RandomState(1)
    for hw in (64, 320):
        imgs = rng.rand(2, hw, hw, 3).astype(np.float32)
        got = fid.extract_inception_features(imgs, npz, device=cuda)
        ref = fid.extract_inception_features(imgs, npz, device="cpu")
        assert got.shape == (2, 2048) and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("scale", [0.25, 0.5, 2.0])
def test_metrics_imresize_on_the_card_matches_the_cpu(cuda, scale):
    """MATLAB's bicubic on the card (float64 inside): the float32 output
    within 1e-6 of the CPU's, the uint8 output equal."""
    import numpy as np
    from vmambair_torch.utils.matlab import imresize
    a, _ = _metric_images(37, 45)
    for img in (a, a.astype(np.float32) / 255.0):
        got = imresize(torch.from_numpy(img).to(cuda), scale).cpu().numpy()
        ref = imresize(img, scale)
        if img.dtype == np.uint8:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# K4's state form (the sequence-parallel scan's passes): within one
# segment (a latent pair, a channel scan) and over several (L = 3001: 12
# segments of 256; L = 2100 with N = 40: 9 segments in 3 state passes)
SP_K4_CASES = [(2, 256, 64, 2, 16, "pair"), (8, 96, 8, 2, 16, "channel"),
               (2, 3001, 8, 2, 16, "channel"), (1, 2100, 6, 2, 40, "pair")]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,L,D,G,N,layout", SP_K4_CASES)
def test_sp_k4_state_form_matches_plain(cuda, b, L, D, G, N, layout,
                                        reverse, dtype, with_h0):
    """y within the forward envelope of `selective_scan_state_ref` and the
    last state within the fp32 envelope, from a given h0 or from zeros;
    one launch of the state form's count per call; from zeros, y equal
    to K4's (the combine's zeros are the zeros K4 starts from)."""
    args = _k4_args(cuda, b, L, D, G, N, dtype, 7 * b + L + N, layout)
    g = torch.Generator().manual_seed(L)
    h0 = torch.randn(b, D, N, generator=g).to(cuda) if with_h0 else None
    kw = dict(delta_softplus=True, reverse=reverse)
    fn = cuda_scan.selective_scan_fwd_state
    n0 = fn.launches
    y, last = fn(*args, h0=h0, **kw)
    assert fn.launches == n0 + 1
    y_ref, last_ref = cuda_scan.selective_scan_state_ref(*args, h0=h0, **kw)
    _close(y, y_ref, dtype)
    _close(last, last_ref, torch.float32)
    if h0 is None:
        assert torch.equal(y, cuda_scan.selective_scan_fwd(*args, **kw))


@pytest.mark.parametrize("reverse", [False, True])
def test_sp_scan_composes_from_the_first_part_s_last_state(cuda, reverse):
    """The scan of the latter part of L from the former part's last state
    is the whole scan's latter part (reverse: the parts swap roles), fp32
    over several segments."""
    b, L, D, G, N = 2, 3000, 8, 2, 16
    args = _k4_args(cuda, b, L, D, G, N, torch.float32, 3, "channel")
    fn = cuda_scan.selective_scan_fwd_state
    kw = dict(delta_softplus=True, reverse=reverse)
    y, last = fn(*args, **kw)

    def part(t, sl):
        return t[:, sl] if t.dim() > 1 and t.shape[1] == L else t

    first, second = ((slice(1200, L), slice(0, 1200)) if reverse
                     else (slice(0, 1200), slice(1200, L)))
    _, s = fn(*(part(t, first) for t in args), **kw)
    y2, last2 = fn(*(part(t, second) for t in args), h0=s, **kw)
    _close(y2, y[:, second], torch.float32)
    _close(last2, last, torch.float32)


def test_sp_leaves_the_recorded_k1_and_k3_bits(cuda):
    """The combine's entering and last state (scan_seg.cuh) leave K1, K1c
    and K3 as they were: their recorded digests hold."""
    import json

    from vmambair_torch.tools import ab

    for path, fn in ((ab.DIGESTS_FILE, ab.digests),
                     (ab.K3_DIGESTS_FILE, ab.k3_digests)):
        with open(path) as f:
            want = json.load(f)["digests"]
        got = fn()
        assert [k for k in want if got.get(k) != want[k]] == []


def test_sp_and_ddp_at_world_1_over_nccl(cuda, tmp_path):
    """A world of one over NCCL: `sharded_scan` equals the plain scan
    (both ways), and a tiny S1 step under DDP equals the step without a
    group within the fp32 envelope."""
    import torch.distributed as dist

    from vmambair_torch.parallel.sp_scan import sharded_scan
    from vmambair_torch.train import build_model

    def step():
        opt = {"name": "t", "model_type": "MambaSISRModel", "is_train": True,
               "scale": 4, "num_gpu": 1, "manual_seed": 0,
               "network_g": {"type": "OSSNet", "dim": 8, "scale": 4,
                             "num_blocks": [1, 1, 1, 1],
                             "num_refinement_blocks": 1},
               "path": {"models": str(tmp_path),
                        "training_states": str(tmp_path)},
               "train": {"ema_decay": 0.999,
                         "optim_g": {"type": "Adam", "lr": 2e-4},
                         "pixel_opt": {"type": "L1Loss"}},
               "val": {"window_size": 8}}
        m = build_model(opt, device="cuda")
        g = torch.Generator().manual_seed(1)
        m.feed_data({"lq": torch.rand(2, 16, 16, 3, generator=g).numpy(),
                     "gt": torch.rand(2, 64, 64, 3, generator=g).numpy()})
        m.optimize_parameters(1)
        return m

    plain = step()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        args = _k4_args(cuda, 2, 512, 16, 2, 16, torch.float32, 5, "pair")
        for rev in (False, True):
            with torch.no_grad():
                y = sharded_scan(*args, delta_softplus=True, reverse=rev)
            _close(y, cuda_scan.selective_scan_ref(
                *args, delta_softplus=True, reverse=rev), torch.float32)
        ddp = step()
        assert type(ddp.train_g).__name__ == "DistributedDataParallel"
        for (k, a), b in zip(ddp.net_g.state_dict().items(),
                             plain.net_g.state_dict().values()):
            _close(a, b, torch.float32)
    finally:
        dist.destroy_process_group()
