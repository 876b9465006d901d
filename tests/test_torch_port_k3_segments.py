"""K3's segmented order (`vmambair_torch/csrc/selective_scan_bwd.cu`)
against the exact gradients and the JAX package, on the CPU.

The CUDA kernel runs only on the card. Its arithmetic is emulated here in
fp32 torch (`emulate_k3`), in the kernel's order: L cut into segments of
`seg` positions at the forward's positions; pass 1, each segment's
adjoint from dh = 0, position by position (one fma each), handing on a
dh (a dh at its first scanned position) and its decay, a running
product; pass 2, the segments in the adjoint's order giving each its
entering dh; pass 3, each chunk recomputed from its carry and the
adjoint from the segment's entering dh, chunk to chunk, with the
in-chunk trees of `tests/k3_order.py`, the sums over states and channels
in fp64. A reverse scan runs as the forward scan of the flipped
sequence, its chunks and segments still cut at the forward's
positions.

Held: within one segment, bit-equal to `k3_order_bwd` (the order that PR
8's F2 guards settled); over several segments with a ragged tail, forward
and reverse, G = 2, within C_BOUND n u32 kappa of the fp64 oracle
(`tests/f2_bound.py`) on a growing state and within GRAD_TOL (rtol 3e-3,
atol 1e-2, the CUDA tests' scan-backward bar) of it on a decaying one;
against jax.grad through JAX's Pallas scan with its backward kernel
(`_scan_bwd_kernel`, interpret mode, as `test_torch_port_grads.py` runs
it) within GRAD_TOL. Also the wrapper's side of the launch, with the
launch stubbed: the segment rule, the scratch and the C arguments.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from f2_bound import bound_ratios
from k3_order import CH, _fma, _tree, k3_order_bwd

from vmambair_tpu.ops.pallas_scan import selective_scan as jax_scan
from vmambair_torch import _build
from vmambair_torch.ops import cuda_scan
from vmambair_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                               selective_scan_chunked)

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=3e-3, atol=1e-2)


def _pieces(L, size, reverse):
    """[(i0, i1, k)]: the k-th piece of `size` positions, [k size, min((k
    + 1) size, L)), as scan indices [i0, i1) of the flipped sequence when
    reverse, in ascending scan order."""
    out = []
    for k in range(-(-L // size)):
        t0, t1 = k * size, min(L, (k + 1) * size)
        out.append((L - t1, L - t0, k) if reverse else (t0, t1, k))
    return sorted(out)


def emulate_k3(u, delta, A, B, C, D, bias, dy, carries, *, softplus=False,
               reverse=False, seg=64):
    """(du, ddelta, dA, dB, dC, dD, dbias) of sum(y * dy), y the scan of
    u, delta (b, L, D), A (D, N), B, C (b, L, G, N), D, bias (D,) or
    None, from K4c's `carries` (b, D, ceil(L / 32), N), in K3's order."""
    bsz, L, Dm = u.shape
    N, G = A.shape[1], B.shape[2]
    gi = torch.arange(Dm) // (Dm // G)
    raw = delta if bias is None else delta + bias
    sg = torch.ones_like(raw)
    dts = raw
    if softplus:
        sg = torch.where(raw > 20, torch.ones_like(raw),
                         1 / (1 + torch.exp(-raw)))
        dts = torch.where(raw > 20, raw, torch.log1p(torch.exp(raw)))

    def fl(t):  # to scan order and back
        return t.flip(1) if reverse else t

    us, ds, ys = fl(u), fl(dts), fl(dy)
    Bx, Cx = fl(B[:, :, gi]), fl(C[:, :, gi])       # (b, L, D, N)
    a = torch.exp(ds[..., None] * A)

    def adjoint(i0, i1, dhc):
        """dh over scan indices [i0, i1), dhc folded into the last pair."""
        alpha = torch.ones_like(a[:, i0:i1])
        alpha[:, :-1] = a[:, i0 + 1:i1]
        beta = Cx[:, i0:i1] * ys[:, i0:i1, :, None]
        beta[:, -1] = _fma(Cx[:, i1 - 1], ys[:, i1 - 1, :, None], dhc)
        return _tree(alpha, beta, True)

    chunks = _pieces(L, CH, reverse)
    segs = [[c for c in chunks if s0 <= c[0] < s1]
            for s0, s1, _ in _pieces(L, seg, reverse)]
    zero = torch.zeros(bsz, Dm, N)
    # pass 1: each segment but the one walked last, from dh = 0, position
    # by position: dh = fma(a_next, dh, C dy); it hands on a dh at its
    # first scanned position and its decay, a running product
    ends = [None] * len(segs)
    for s in range(1, len(segs)):
        g, an, dec = zero, zero, torch.ones_like(zero)
        for i0, i1, _ in reversed(segs[s]):
            for i in range(i1 - 1, i0 - 1, -1):
                g = _fma(an, g, Cx[:, i] * ys[:, i, :, None])
                an = a[:, i]
                dec = dec * an
        ends[s] = an * g, dec
    # pass 2: the entering dh, the segments in the adjoint's order
    hin = [None] * len(segs)
    h = zero
    for s in reversed(range(len(segs))):
        hin[s] = h
        if s:
            hend, aend = ends[s]
            h = torch.where(h != 0, _fma(aend, h, hend), hend)
    # pass 3: each chunk from its carry, the adjoint from the segment's dh
    H = torch.zeros(bsz, L, Dm, N)
    W, DH = torch.zeros_like(H), torch.zeros_like(H)
    dA = torch.zeros(bsz, len(segs), Dm, N)
    for s, chunks_s in enumerate(segs):
        dhc = hin[s]
        for i0, i1, ck in reversed(chunks_s):
            d = ds[:, i0:i1, :, None]
            aa = a[:, i0:i1]
            h0 = carries[:, :, ck]
            b_ = (d[..., 0] * us[:, i0:i1])[..., None] * Bx[:, i0:i1]
            b_[:, 0] = _fma(aa[:, 0], h0, b_[:, 0])
            h = _tree(aa, b_, False)
            ah = aa * torch.cat([h0[:, None], h[:, :-1]], 1)
            dh = adjoint(i0, i1, dhc)
            w = dh * ah
            H[:, i0:i1], DH[:, i0:i1], W[:, i0:i1] = h, dh, w
            dhc = aa[:, 0] * dh[:, 0]
            dA[:, s] = dA[:, s] + (d * w).sum(1)
    sB = (Bx.double() * DH).sum(-1)
    du = (ds * sB).float()
    if D is not None:
        du = du + D * ys
    dd = ((us * sB + (A.double() * W).sum(-1)) * fl(sg).double()).float()
    dB = torch.zeros(bsz, L, G, N)
    dC = torch.zeros_like(dB)
    for g in range(G):
        sl = slice(g * (Dm // G), (g + 1) * (Dm // G))
        dB[:, :, g] = ((ds * us)[:, :, sl, None].double()
                       * DH[:, :, sl]).sum(2).float()
        dC[:, :, g] = (ys[:, :, sl, None].double() * H[:, :, sl]).sum(2) \
            .float()
    return (fl(du), fl(dd), dA.view(-1, Dm, N).sum(0), fl(dB), fl(dC),
            None if D is None else (dy * u).sum((0, 1)),
            None if bias is None else fl(dd).sum((0, 1)))


def _carries(args, reverse):
    """K4c's carries by the fp32 plain chunked scan."""
    return selective_scan_chunked(*args, chunk_size=CH, reverse=reverse,
                                  return_carries=True)[1]


def _recipe(seed, L, grow):
    """u, delta, A, B, C (b = 2, D = 16, G = 2, N = 16) and dy, from numpy
    seeded by `seed`. grow: delta ~ 0.5 N(0, 1) against A in [-e, -1], so
    the state grows at about half the positions (|delta A| <= 10, the
    bound's reach); else |delta|, a decaying state."""
    rng = np.random.RandomState(seed)
    u = rng.randn(2, L, 16)
    delta = 0.5 * rng.randn(2, L, 16)
    A = -np.exp(rng.rand(16, 16))
    B, C = rng.randn(2, L, 2, 16), rng.randn(2, L, 2, 16)
    dy = rng.randn(2, L, 16)
    t = [torch.tensor(x, dtype=torch.float32)
         for x in (u, delta if grow else np.abs(delta), A, B, C, dy)]
    return t[:5], t[5]


@pytest.mark.parametrize("seed", [0, 47])
@pytest.mark.parametrize("L,seg", [(40, 64), (100, 128), (64, 1024)])
def test_one_segment_is_k3_order(L, seg, seed):
    """Where L fits one segment K3 runs its main pass alone, from dh = 0:
    the order of `tests/k3_order.py`, bit for bit (du, ddelta, dA, dB,
    dC), the F2 recipe's L = 40 among them."""
    args, dy = _recipe(seed, L, grow=True)
    car = _carries(args, False)
    got = emulate_k3(*args, None, None, dy, car, seg=seg)
    want = k3_order_bwd(*args, dy, car)
    for name, g, w in zip(("du", "ddelta", "dA", "dB", "dC"), got, want):
        assert torch.equal(g, w), name


def _flip(grads):
    """du, ddelta, dA, dB, dC of a reverse scan in forward order."""
    du, dd, dA, dB, dC = grads
    return du.flip(1), dd.flip(1), dA, dB.flip(1), dC.flip(1)


@pytest.mark.parametrize("seg", [32, 64])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 47])
def test_segments_within_the_conditioned_bound(seed, reverse, seg):
    """L = 232: 4 or 8 segments, the last ragged (40 / 8 positions, a
    chunk of 8): on a growing state every gradient within C_BOUND n u32
    kappa of the fp64 oracle (a reverse scan held as the forward scan of
    the flipped sequence)."""
    args, dy = _recipe(seed, 232, grow=True)
    got = emulate_k3(*args, None, None, dy, _carries(args, reverse),
                     reverse=reverse, seg=seg)
    orc = selective_scan_bwd_ref(*[t.double() for t in args], None, None,
                                 dy.double(), reverse=reverse)
    if reverse:
        u, delta, A, B, C = args
        ratios = bound_ratios(_flip(got[:5]), _flip(orc[:5]),
                              [u.flip(1), delta.flip(1), A, B.flip(1),
                               C.flip(1)], dy.flip(1))
    else:
        ratios = bound_ratios(got[:5], orc[:5], args, dy)
    print(f"seed {seed} reverse={reverse} seg {seg}: error over the "
          f"conditioned bound {[f'{r:.3g}' for r in ratios]}")
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("reverse", [False, True])
def test_segments_on_a_decaying_state_with_skip_bias_softplus(reverse):
    """The same segments with D, a bias and softplus on a decaying state:
    all seven gradients within GRAD_TOL of the fp64 oracle."""
    args, dy = _recipe(5, 232, grow=False)
    rng = np.random.RandomState(6)
    Dsk = torch.tensor(rng.randn(16), dtype=torch.float32)
    bias = torch.tensor(rng.uniform(-1, 1, 16), dtype=torch.float32)
    full = [*args, Dsk, bias]
    car = selective_scan_chunked(*full, delta_softplus=True, chunk_size=CH,
                                 reverse=reverse, return_carries=True)[1]
    got = emulate_k3(*full, dy, car, softplus=True, reverse=reverse, seg=64)
    orc = selective_scan_bwd_ref(*[t.double() for t in full], dy.double(),
                                 delta_softplus=True, reverse=reverse)
    for g, o in zip(got, orc):
        torch.testing.assert_close(g.double(), o, **GRAD_TOL)


def _jax_inputs(reverse):
    rng = np.random.RandomState(30 + reverse)
    B, L, D, G, N = 2, 232, 16, 2, 4
    return dict(
        u=rng.randn(B, L, D).astype(np.float32),
        delta=rng.uniform(-3.0, 0.5, (B, L, D)).astype(np.float32),
        A=-np.exp(rng.uniform(-1.0, 1.5, (D, N))).astype(np.float32),
        B=rng.randn(B, L, G, N).astype(np.float32),
        C=rng.randn(B, L, G, N).astype(np.float32),
        D=rng.randn(D).astype(np.float32),
        delta_bias=rng.uniform(-1.0, 1.0, D).astype(np.float32),
    ), np.cos(np.arange(B * L * D)).reshape(B, L, D).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_grads(reverse):
    p, w = _jax_inputs(reverse)

    def loss(*a):
        y = jax_scan(*a, delta_softplus=True, impl="pallas", interpret=True,
                     reverse=reverse)
        return jnp.sum(y * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(7)))(
        *(jnp.asarray(v) for v in p.values()))]


@pytest.mark.parametrize("seg", [64, 128])
@pytest.mark.parametrize("reverse", [False, True])
def test_segments_match_jax_backward_kernel(reverse, seg):
    """L = 232 in 4 or 2 segments, the last ragged, with D, bias and
    softplus, G = 2: the seven gradients against jax.grad through JAX's
    Pallas scan and its backward kernel (interpret mode)."""
    p, w = _jax_inputs(reverse)
    args = [torch.from_numpy(v) for v in p.values()]
    car = selective_scan_chunked(*args, delta_softplus=True, chunk_size=CH,
                                 reverse=reverse, return_carries=True)[1]
    got = emulate_k3(*args, torch.from_numpy(w), car, softplus=True,
                     reverse=reverse, seg=seg)
    for name, g, r in zip(("u", "delta", "A", "B", "C", "D", "delta_bias"),
                          got, _jax_grads(reverse)):
        np.testing.assert_allclose(g.numpy(), r, **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("b,L,D,T,seg", [
    (8, 4096, 192, 8, 512), (8, 4096, 96, 8, 256), (8, 1024, 192, 8, 128),
    (8, 256, 384, 8, 1024), (8, 64, 768, 8, 1024), (8, 384, 8, 4, 64),
    (2, 40, 16, 8, 64), (8, 1024, 1152, 8, 1024), (8, 4100, 192, 8, 512),
    (8, 4096, 1152, 8, 1024)])
def test_k3_segment_rule(b, L, D, T, seg):
    """One segment where L fits 1024 and the grid gives each of 132 SMs
    two blocks ((8,256,384), the latent scan); else 1024 halved down to
    64 while the grid has fewer than 1056 blocks: the S1 step's three
    longer fused scans get at least 8 blocks per SM, the channel scans
    and the F2 recipe segments of 64 (L = 40: one)."""
    assert cuda_scan.k3_segment(b, D, T, L) == seg
    tiles = b * D // T
    if L <= seg:
        assert tiles >= 264 or seg == cuda_scan.K3_MIN_SEG
    else:
        assert tiles * -(-L // seg) >= 1056 or seg == cuda_scan.K3_MIN_SEG


def test_k3_tile_and_workspace():
    """T: the largest divisor of the group's width up to 8; the scratch:
    three fp32 values per (b, channel, segment, state)."""
    assert [cuda_scan.k3_tile(dg) for dg in (96, 48, 4, 3, 7, 12)] == [
        8, 8, 4, 3, 7, 6]
    assert cuda_scan.k3_workspace(8, 192, 4096, 16, 512) == 3 * 8 * 192 * 8 * 16


@pytest.mark.parametrize("L", [40, 300])
def test_k3_launch_passes_its_signature(monkeypatch, L):
    """The wrapper, with the CPU routing and the launch stubbed, names its
    exported function and passes exactly its signature's arguments: the
    scratch (None within one segment), the tile and the segment of
    `k3_segment`; one call counts one launch."""
    calls = []
    monkeypatch.setattr(cuda_scan, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(cuda_scan.selective_scan_bwd, "launches", 0)
    b, D, G, N = 1, 6, 2, 16
    args = [torch.zeros(b, L, D), torch.zeros(b, L, D), torch.zeros(D, N),
            torch.zeros(b, L, G, N), torch.zeros(b, L, G, N),
            torch.zeros(D), torch.zeros(D)]
    car = torch.zeros(b, D, cuda_scan.n_chunks(L), N)
    out = cuda_scan.selective_scan_bwd(*args, torch.zeros(b, L, D), car,
                                       delta_softplus=True, reverse=True)
    assert cuda_scan.selective_scan_bwd.launches == 1
    assert [tuple(t.shape) for t in out] == [
        (b, L, D), (b, L, D), (D, N), (b, L, G, N), (b, L, G, N), (D,),
        (D,)]
    (name, a), = calls
    assert name == "vmt_selective_scan_bwd"
    kinds = _build.SIGNATURES[name][:-1]  # the stream: added by launch
    assert len(a) == len(kinds)
    for k, v in zip(kinds, a):
        assert isinstance(v, int) or (k is _build._P and v is None)
    T, seg = 3, cuda_scan.k3_segment(b, D, 3, L)
    assert list(a[-9:]) == [b, L, D, G, N, T, seg, 1, 1]
    assert (a[-10] is None) == (L <= seg)
