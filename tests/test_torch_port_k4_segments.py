"""K4's decomposition (csrc/selective_scan.cu) against the JAX package, on
the CPU.

The CUDA kernel runs only on the card. Its arithmetic is emulated here in
fp32 torch, in the kernel's order: delta = softplus(delta + bias) once
per position; within one segment of `seg` positions (every call of the
model's main path) a single replay from a zero state; over several, a
scan of each segment from a zero state with the per-position decays
exp2(A log2(e) delta) and the segment's decay exp2(A log2(e) sum(delta)),
the chain of the segments in scan order, and the replay of each segment
from its entering state. The replay writes y = D u + C h, the states
summed in order in passes of `K4_NS`, and, at the first position that the
scan visits of every 32-position chunk, the state entering it (K4c's
carries). The same numpy inputs go through JAX's `selective_scan_dl`
(interpret mode) for y and through JAX's carry-saving forward
(`_build_pallas_fwd(save_carries=True)`, interpret mode) for the carries
where L is a multiple of its chunk; elsewhere the carries are held to the
port's plain `selective_scan_carries_ref`. Tolerance: fp32, 1e-4 (the bar
of `test_torch_port_k1_segments.py`).

Also the wrapper's side of the launch, with the launch stubbed: the
segment rule, the scratch (none within one segment) and the arguments of
the C function on both layouts the model passes.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.ops.pallas_scan import _build_pallas_fwd, selective_scan_dl
from vmambair_torch import _build
from vmambair_torch.ops import cuda_scan

torch.set_num_threads(1)
B, CH = 2, 32
LOG2E = 1.4426950408889634
K4_NS = 16  # states a pass of K4 holds (`K4_NS` of csrc/selective_scan.cu)

# (D, G, N, L): the channel scans' 8 channels in 2 groups at N = 16; 3
# channels to a group, N = 5 (below a pass) and a ragged L; N = 40 (three
# passes of 16, the last of 8)
CASES = [(8, 2, 16, 64), (6, 2, 5, 72), (8, 1, 40, 64)]


def _inputs(D, G, N, L):
    rng = np.random.RandomState(D * 1000 + N * 100 + L)
    return dict(
        u=rng.randn(B, L, D).astype(np.float32),
        delta=rng.randn(B, L, D).astype(np.float32),
        A=-np.exp(rng.uniform(0.0, 2.0, (D, N))).astype(np.float32),
        B=rng.randn(B, L, G, N).astype(np.float32),
        C=rng.randn(B, L, G, N).astype(np.float32),
        D=rng.randn(D).astype(np.float32),
        bias=rng.uniform(-3.0, -1.0, D).astype(np.float32),
    )


def emulate_k4(u, delta, A, Bm, Cm, Ds, bias, *, seg, reverse):
    """The kernel's arithmetic in fp32 torch: y (B, L, D) and K4c's carries
    (B, D, ceil(L / 32), N)."""
    b, L, D = u.shape
    G, N = Bm.shape[2], A.shape[1]
    raw = delta + bias
    dl = torch.where(raw > 20, raw, torch.log1p(torch.exp(raw)))
    a2 = A * LOG2E                                  # (D, N)
    Bg = Bm.repeat_interleave(D // G, 2)           # (b, L, D, N)
    Cg = Cm.repeat_interleave(D // G, 2)

    def step(t, h):
        dt = dl[:, t, :, None]
        return torch.exp2(dt * a2) * h + (dt * u[:, t, :, None]) * Bg[:, t]

    segs = [(s0, min(s0 + seg, L)) for s0 in range(0, L, seg)]

    def order(s0, s1):
        return range(s1 - 1, s0 - 1, -1) if reverse else range(s0, s1)

    hin = [torch.zeros(b, D, N)] * len(segs)
    if len(segs) > 1:
        # pass 1: each segment from zero; its end state and decay
        ends = []
        for s0, s1 in segs:
            h = torch.zeros(b, D, N)
            dsum = torch.zeros(b, D, 1)
            for t in order(s0, s1):
                h = step(t, h)
                dsum = dsum + dl[:, t, :, None]
            ends.append((h, torch.exp2(a2 * dsum)))
        # pass 2: the chain, in scan order
        h = torch.zeros(b, D, N)
        for s in (reversed(range(len(segs))) if reverse
                  else range(len(segs))):
            hin[s] = h
            h = ends[s][1] * h + ends[s][0]
    # pass 3: the replay; y over the states in passes of K4_NS
    y = torch.empty(b, L, D)
    car = torch.zeros(b, D, -(-L // CH), N)
    for (s0, s1), h in zip(segs, hin):
        for t in order(s0, s1):
            first = (t % CH == CH - 1 or t == L - 1) if reverse else (
                t % CH == 0)
            if first:
                car[:, :, t // CH] = h
            h = step(t, h)
            yt = Ds * u[:, t]
            for n0 in range(0, N, K4_NS):
                for n in range(n0, min(n0 + K4_NS, N)):
                    yt = yt + Cg[:, t, :, n] * h[..., n]
            y[:, t] = yt
    return y, car


def _dl(p):
    """JAX's (B, D, L) / (B, G, N, L) arguments of the same inputs."""
    return (jnp.asarray(p["u"].transpose(0, 2, 1)),
            jnp.asarray(p["delta"].transpose(0, 2, 1)),
            jnp.asarray(p["B"].transpose(0, 2, 3, 1)),
            jnp.asarray(p["C"].transpose(0, 2, 3, 1)))


@functools.lru_cache(maxsize=None)
def _jax_y(D, G, N, L, reverse):
    p = _inputs(D, G, N, L)
    u, d, Bm, Cm = _dl(p)
    y = selective_scan_dl(u, d, jnp.asarray(p["A"]), Bm, Cm,
                          jnp.asarray(p["D"]), jnp.asarray(p["bias"]),
                          softplus=True, interpret=True, reverse=reverse)
    return np.asarray(y).transpose(0, 2, 1)


@functools.lru_cache(maxsize=None)
def _jax_carries(D, G, N, L, reverse):
    """JAX's carry-saving forward (chunk 32, one channel tile a group), its
    (B, D / Dg, n_chunks, N, Dg) carries in the port's (B, D, n_chunks, N)
    layout."""
    p = _inputs(D, G, N, L)
    u, d, Bm, Cm = _dl(p)
    dg = D // G
    fwd = _build_pallas_fwd(B, L, D, N, G, CH, dg, True, True, "float32",
                            reverse, save_carries=True)
    _, car = fwd(u, d, jnp.asarray(p["A"]).T[:, :, None], Bm, Cm,
                 jnp.asarray(p["D"]).reshape(D, 1),
                 jnp.asarray(p["bias"]).reshape(D, 1))
    car = np.asarray(car).transpose(0, 1, 4, 2, 3)
    return car.reshape(B, D, L // CH, N)


@pytest.mark.parametrize("seg", [None, 32])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("D,G,N,L", CASES)
def test_k4_segments_match_jax(D, G, N, L, reverse, seg):
    """y against JAX's forward; the carries against JAX's carry-saving
    forward (L a multiple of 32) or the port's plain version (ragged L,
    which `_build_pallas_fwd` refuses). seg None: the segment of
    `k4_segment`, one segment (pass 3 alone); 32: two or three segments,
    the last ragged at L = 72."""
    seg = seg or cuda_scan.k4_segment(B, D, G, L)
    p = {k: torch.from_numpy(v) for k, v in _inputs(D, G, N, L).items()}
    y, car = emulate_k4(*p.values(), seg=seg, reverse=reverse)
    np.testing.assert_allclose(y.numpy(), _jax_y(D, G, N, L, reverse),
                               rtol=1e-4, atol=1e-4)
    if L % CH == 0:
        ref = _jax_carries(D, G, N, L, reverse)
    else:
        _, ref = cuda_scan.selective_scan_carries_ref(
            *p.values(), delta_softplus=True, reverse=reverse)
        ref = ref.numpy()
    assert car.shape == (B, D, cuda_scan.n_chunks(L), N)
    np.testing.assert_allclose(car.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,D,G,L,seg", [
    (8, 768, 2, 256, 1024), (8, 768, 2, 64, 1024), (8, 8, 2, 48, 1024),
    (8, 8, 2, 384, 1024), (8, 8, 2, 1024, 1024), (8, 768, 2, 4096, 1024),
    (2, 8, 2, 3001, 256), (1, 6, 2, 2100, 256), (8, 96, 2, 4096, 512)])
def test_k4_segment_rule(b, D, G, L, seg):
    """One segment where L fits 1024 positions (every call of the main
    path: the latent pairs at 256 and 64, the channel scans up to 384);
    longer L: 1024, halved down to 256 while the grid has fewer than 1056
    blocks."""
    got = cuda_scan.k4_segment(b, D, G, L)
    assert got == seg
    blocks = b * G * -(-(D // G) // 4) * -(-L // got)
    assert L <= got or got == 256 or blocks >= 1056


def test_k4_workspace_holds_every_scratch():
    """Three fp32 values per (b, channel, segment, state)."""
    assert cuda_scan.k4_workspace(2, 8, 3001, 16, 256) == 3 * 2 * 8 * 12 * 16


def test_k4_passes_are_the_kernels():
    """The emulation's passes are as wide as the kernel's."""
    with open(f"{_build.CSRC}/selective_scan.cu") as f:
        assert f"constexpr int K4_NS = {K4_NS};" in f.read()


def _views(layout, b, L, D, G, N):
    """K4's arguments on the CPU as the model passes them: a latent pair's
    (b, L, D) views of (b, D, L) buffers and B, C views of x_dbl's (b, G,
    R + 2N, L) rows, or a channel scan's contiguous u, delta and B, C
    views of x_dbl's (b, G, L, R + 2N)."""
    R, M = 3, 3 + 2 * N
    if layout == "pair":
        u = torch.zeros(b, D, L).transpose(1, 2)
        d = torch.zeros(b, D, L).transpose(1, 2)
        x = torch.zeros(b, G, M, L).permute(0, 3, 1, 2)
    else:
        u, d = torch.zeros(b, L, D), torch.zeros(b, L, D)
        x = torch.zeros(b, G, L, M).transpose(1, 2)
    return (u, d, torch.zeros(D, N), x[..., R:R + N], x[..., R + N:],
            torch.zeros(D), torch.zeros(D))


@pytest.mark.parametrize("carries", [False, True])
@pytest.mark.parametrize("layout,L", [("pair", 256), ("channel", 96),
                                      ("channel", 3001)])
def test_k4_launch_passes_its_signature(monkeypatch, layout, L, carries):
    """K4's and K4c's wrappers, with the CPU routing and the launch stubbed,
    name `vmt_selective_scan_fwd` and pass exactly its signature's
    arguments: every tensor's own strides (no copy), the carries' pointer
    (K4c), no scratch within one segment and `k4_workspace`'s floats over
    several, and the segment of `k4_segment`."""
    calls, sizes = [], []
    monkeypatch.setattr(cuda_scan, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *a: calls.append((name, a)))
    real = cuda_scan.k4_workspace
    monkeypatch.setattr(cuda_scan, "k4_workspace",
                        lambda *s: sizes.append(s) or real(*s))
    b, D, G, N = 2, 8, 2, 16
    args = _views(layout, b, L, D, G, N)
    fn = (cuda_scan.selective_scan_fwd_carries if carries
          else cuda_scan.selective_scan_fwd)
    monkeypatch.setattr(fn, "launches", 0)
    fn(*args, delta_softplus=True, reverse=True)
    assert fn.launches == 1
    (name, got), = calls
    assert name == "vmt_selective_scan_fwd"
    kinds = _build.SIGNATURES[name][:-1]  # the stream: added by launch
    assert len(got) == len(kinds)
    for k, v in zip(kinds, got):
        assert isinstance(v, int) or (k is _build._P and v is None)
    u, d, _, Bm, Cm = args[:5]
    assert list(got[2:5]) == list(u.stride())
    assert list(got[7:10]) == list(d.stride())
    assert list(got[13:17]) == list(Bm.stride())
    assert list(got[19:23]) == list(Cm.stride())
    seg = cuda_scan.k4_segment(b, D, G, L)
    assert list(got[-8:]) == [b, L, D, G, N, seg, 1, 1]
    assert (got[-10] is None) == (not carries)
    if L <= seg:
        assert got[-9] is None and sizes == []
    else:
        assert got[-9] is not None
        assert sizes == [(b, D, L, N, seg)]
