"""K1's decomposition (csrc/oss_scan_fused.cu) against the JAX package, on
the CPU.

The CUDA kernel runs only on the card. Its arithmetic is emulated here in
fp32 torch, in the kernel's order: pass 0 once per position (x_dbl, then
delta = softplus(W_dt x_dbl[:R] + bias)); per segment of `seg` positions
a scan from a zero state with the per-position decays exp2(A log2(e)
delta) and the segment's decay exp2(A log2(e) sum(delta)); the chain of
the segments in scan order; the replay of each segment from its entering
state, which writes y and, at the first position that the scan visits of
every 32-position chunk, the state entering it (K1c's carries). The same
numpy inputs go through JAX's `oss_scan_fused` (interpret mode, the
kernel's (B, G, D, L) layout) for y and through JAX's carry-saving
forward (`_build_fused_fwd(save_carries=True)`, interpret mode) for the
carries where L is a multiple of its chunk; elsewhere the carries are
held to the port's plain `oss_scan_fused_carries_ref`. Tolerance: fp32,
1e-4 (the bar of `test_oss_scan_fused_plain_matches_jax`).

Also the wrappers' side of the launch, with the launch stubbed: the
segment rule, the scratch's size and the arguments of the C functions.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.ops.pallas_scan import _build_fused_fwd
from vmambair_tpu.ops.pallas_scan import oss_scan_fused as jax_oss_scan
from vmambair_torch import _build
from vmambair_torch.ops import cuda_probes, cuda_scan

torch.set_num_threads(1)
B, G, N, CH = 2, 2, 16, 32
LOG2E = 1.4426950408889634


def _inputs(D, L):
    rng = np.random.RandomState(D * 1000 + L)
    R = -(-D // 16)
    return dict(
        u2=rng.randn(B, G, D, L).astype(np.float32),
        x_proj_w=(rng.randn(G, R + 2 * N, D) / np.sqrt(D)).astype(
            np.float32),
        dt_proj_w=(rng.randn(G, D, R) / np.sqrt(R)).astype(np.float32),
        dt_bias=rng.uniform(-4.0, -1.0, (G, D)).astype(np.float32),
        A=-np.exp(rng.uniform(0.0, 2.0, (G, D, N))).astype(np.float32),
        Ds=rng.randn(G, D).astype(np.float32),
    )


def emulate_k1(u2, xw, dw, db, A, Ds, *, seg, reverse):
    """The kernel's arithmetic in fp32 torch: y (B, G, D, L) and K1c's
    carries (B, G*D, ceil(L / 32), N)."""
    b, g, d, L = u2.shape
    R, n = dw.shape[2], A.shape[2]
    # pass 0: once per (b, g, position)
    x_dbl = torch.einsum("gcd,bgdl->bgcl", xw, u2)
    raw = torch.einsum("gdr,bgrl->bgdl", dw, x_dbl[:, :, :R]) + db[..., None]
    delta = torch.where(raw > 20, raw, torch.log1p(torch.exp(raw)))
    Bm, Cm = x_dbl[:, :, R:R + n], x_dbl[:, :, R + n:]
    a2 = A * LOG2E                                  # (g, d, n)

    def step(t, h):
        dt = delta[..., t, None]                    # (b, g, d, 1)
        x = dt * Bm[:, :, None, :, t] * u2[..., t, None]
        return torch.exp2(dt * a2) * h + x

    segs = [(s0, min(s0 + seg, L)) for s0 in range(0, L, seg)]

    def order(s0, s1):
        return range(s1 - 1, s0 - 1, -1) if reverse else range(s0, s1)

    # pass 1: each segment from zero; its end state and decay
    ends = []
    for s0, s1 in segs:
        h = torch.zeros(b, g, d, n)
        dsum = torch.zeros(b, g, d, 1)
        for t in order(s0, s1):
            h = step(t, h)
            dsum = dsum + delta[..., t, None]
        ends.append((h, torch.exp2(a2 * dsum)))
    # pass 2: the chain, in scan order
    hin = [None] * len(segs)
    h = torch.zeros(b, g, d, n)
    for s in (reversed(range(len(segs))) if reverse else range(len(segs))):
        hin[s] = h
        h = ends[s][1] * h + ends[s][0]
    # pass 3: the replay, y and the carries
    y = torch.empty(b, g, d, L)
    car = torch.zeros(b, g, d, -(-L // CH), n)
    for (s0, s1), h in zip(segs, hin):
        for t in order(s0, s1):
            first = (t % CH == CH - 1 or t == L - 1) if reverse else (
                t % CH == 0)
            if first:
                car[:, :, :, t // CH] = h
            h = step(t, h)
            y[..., t] = (h * Cm[:, :, None, :, t]).sum(-1) + Ds * u2[
                ..., t]
    return y, car.reshape(b, g * d, -1, n)


@functools.lru_cache(maxsize=None)
def _jax_y(D, L, reverse):
    p = _inputs(D, L)
    return np.asarray(jax_oss_scan(
        *(jnp.asarray(v) for v in p.values()), softplus=True,
        reverse=reverse, interpret=True, dl=True))


@functools.lru_cache(maxsize=None)
def _jax_carries(D, L, reverse):
    """JAX's carry-saving forward, its (B, G, n_chunks, N, D) carries in
    the port's (B, G*D, n_chunks, N) layout."""
    p = _inputs(D, L)
    R = -(-D // 16)
    fwd = _build_fused_fwd(B, G, D, L, N, R, CH, True, True, "float32",
                           reverse, save_carries=True)
    _, car = fwd(jnp.asarray(p["u2"]), jnp.asarray(p["x_proj_w"]),
                 jnp.asarray(p["dt_proj_w"]),
                 jnp.transpose(jnp.asarray(p["A"]), (0, 2, 1))[..., None],
                 jnp.asarray(p["Ds"])[..., None],
                 jnp.asarray(p["dt_bias"])[..., None])
    car = np.asarray(car).transpose(0, 1, 4, 2, 3)
    return car.reshape(B, G * D, L // CH, N)


@pytest.mark.parametrize("D", [16, 45])
@pytest.mark.parametrize("seg", [32, 64, 256])
@pytest.mark.parametrize("L", [64, 97, 300])
@pytest.mark.parametrize("reverse", [False, True])
def test_k1_segments_match_jax(reverse, L, seg, D):
    """y against JAX's fused forward; the carries against JAX's
    carry-saving forward (L a multiple of 32) or the port's plain
    version (ragged L, which `_build_fused_fwd` refuses)."""
    p = {k: torch.from_numpy(v) for k, v in _inputs(D, L).items()}
    y, car = emulate_k1(*p.values(), seg=seg, reverse=reverse)
    np.testing.assert_allclose(y.numpy(), _jax_y(D, L, reverse),
                               rtol=1e-4, atol=1e-4)
    if L % CH == 0:
        ref = _jax_carries(D, L, reverse)
    else:
        _, ref = cuda_scan.oss_scan_fused_carries_ref(*p.values(),
                                                      reverse=reverse)
        ref = ref.numpy()
    assert car.shape == (B, G * D, cuda_scan.n_chunks(L), N)
    np.testing.assert_allclose(car.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,d,L,seg", [
    (8, 96, 16384, 1024), (8, 48, 16384, 1024), (8, 96, 4096, 1024),
    (8, 192, 1024, 512), (8, 48, 4096, 512), (8, 96, 1024, 256),
    (8, 192, 256, 256), (2, 96, 4100, 256), (1, 48, 1057, 256)])
def test_k1_segment_rule(b, d, L, seg):
    """1024 positions at the served forward's level-1 shapes; halved down
    to 256 while the grid has fewer than 1056 blocks."""
    got = cuda_scan.k1_segment(b, 2, d, L)
    assert got == seg
    blocks = b * 2 * -(-d // 4) * -(-L // got)
    assert got == 256 or blocks >= 1056


def test_k1_workspace_holds_every_scratch():
    """x_dbl's B and C rows and delta per (b, g, position), three fp32
    values per (b, channel, segment, state)."""
    b, g, d, L, n, seg = 8, 2, 96, 16384, 16, 1024
    nseg = 16
    assert cuda_scan.k1_workspace(b, g, d, L, n, seg) == (
        b * g * 2 * n * L + b * g * d * L + 3 * b * g * d * nseg * n)


@pytest.mark.parametrize("wrapper", ["k1", "k1c", "ld"])
def test_k1_launch_passes_its_signature(monkeypatch, wrapper):
    """Each of K1's wrappers, with the CPU routing and the launch stubbed,
    names its exported function and passes exactly its signature's
    arguments: the carries' pointer (K1, K1c), the scratch, sized by
    `k1_workspace`, and the segment of `k1_segment`."""
    calls, sizes = [], []
    for mod in (cuda_scan, cuda_probes):
        monkeypatch.setattr(mod, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *a: calls.append((name, a)))
    real = cuda_scan.k1_workspace
    monkeypatch.setattr(cuda_scan, "k1_workspace",
                        lambda *s: sizes.append(s) or real(*s))
    d, L = 40, 300
    w = [torch.zeros(2, 3 + 2 * N, d), torch.zeros(2, d, 3),
         torch.zeros(2, d), torch.zeros(2, d, N), torch.zeros(2, d)]
    fn, name, u = {
        "k1": (cuda_scan.oss_scan_fused_fwd, "vmt_oss_scan_fused_fwd",
               torch.zeros(1, 2, d, L)),
        "k1c": (cuda_scan.oss_scan_fused_fwd_carries,
                "vmt_oss_scan_fused_fwd", torch.zeros(1, 2, d, L)),
        "ld": (cuda_probes.ld_fused, "vmt_oss_scan_fused_ld_fwd",
               torch.zeros(1, 2, L, d)),
    }[wrapper]
    monkeypatch.setattr(fn, "launches", 0)
    fn(u, *w)
    assert fn.launches == 1
    (got, args), = calls
    assert got == name
    kinds = _build.SIGNATURES[name][:-1]  # the stream: added by launch
    assert len(args) == len(kinds)
    for k, v in zip(kinds, args):
        assert isinstance(v, int) or (k is _build._P and v is None)
    seg = cuda_scan.k1_segment(1, 2, d, L)
    assert sizes == [(1, 2, d, L, N, seg)]
    assert list(args[-9:]) == [1, 2, d, L, N, 3, seg, 0, 1]
    if wrapper != "ld":
        assert (args[8] is None) == (wrapper == "k1")
