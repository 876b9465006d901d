"""The sequential register scan's arithmetic (csrc/scan_seq.cu: K7 and
kseq's probes, L split over segments) against the JAX package and the
port's plain version, on the CPU.

The CUDA kernel runs only on the card; `tests/seq_segments.py` emulates it
in fp32 torch, in its order (the segment rule at the H100's residency, each
segment walked from zero, the combine in scan order, the replay from the
entering states with y in passes of 16 states). The same numpy inputs
(`numpy.random.RandomState`) go through that model, through the plain
version (`cuda_scan.scan_views_ref`) and through JAX's kernels in interpret
mode: kseq's `kernel_seq` / `kernel_seq_win` (the TPU probe loaded from
`tools/kseq.py` as `test_torch_port_probes.py` loads it) and K7's
`_build_pallas_fwd_ld`. Forward and reverse, ragged L, segments that do not
divide L, N = 5, 16 and 32, bf16 and fp32.

Tolerances: fp32 rtol / atol 1e-4 (the scan bar of
`test_torch_port_ops.py`); bf16 3e-2 / 5e-2 (the bf16 envelope).

Also the rule's segment and warp counts at the probe shape and at the
probes' CPU shapes, and both wrappers' launch arguments with the launch
stubbed.
"""

import ctypes
import functools
import importlib.util
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from seq_segments import H100_RESIDENT, plan, scan_seq_model

from vmambair_tpu.ops.pallas_scan import _build_pallas_fwd_ld
from vmambair_torch import _build
from vmambair_torch.ops import cuda_probes, cuda_scan

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=3e-2, atol=5e-2)}
BF16 = ml_dtypes.bfloat16


def _views(b, G, Dg, L, N, dtype, seed):
    """u, delta (b, g, l, d) as channels-last (b, l, g*d) memory; B, C
    (b, g, l, n) as (b, g, n, l) memory; A, D, bias."""
    rng = np.random.RandomState(seed)
    dim = G * Dg
    u = torch.from_numpy(rng.randn(b, L, dim).astype(np.float32))
    delta = torch.from_numpy(rng.uniform(-3.0, 0.5, (b, L, dim))
                             .astype(np.float32))
    Bm = torch.from_numpy(rng.randn(b, G, N, L).astype(np.float32))
    Cm = torch.from_numpy(rng.randn(b, G, N, L).astype(np.float32))
    A = torch.from_numpy(-np.exp(rng.uniform(-1.0, 1.5, (dim, N)))
                         .astype(np.float32))
    Dv = torch.from_numpy(rng.randn(dim).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1.0, 1.0, dim).astype(np.float32))
    gld = cuda_scan._gld
    return (gld(u.to(dtype), G), gld(delta.to(dtype), G), A,
            Bm.to(dtype).transpose(2, 3), Cm.to(dtype).transpose(2, 3), Dv,
            bias)


@pytest.mark.parametrize("dtype,reverse,L,seg,N", [
    (torch.float32, False, 101, None, 16),
    (torch.float32, True, 101, 30, 5),
    (torch.bfloat16, False, 203, 64, 16),
    (torch.bfloat16, True, 101, 16, 32)])
def test_seq_model_matches_plain(dtype, reverse, L, seg, N):
    """b 3, 2 groups of 37 channels (a tile of 32 and a ragged one). seg
    None is the rule's (two segments of 64 here); 30 and 16 divide no L;
    N = 32 is two register passes. At seg 64 the combine's entering states
    are also the plain scan's states at the segments' edges (the carries of
    chunk 2s, for the forward scan)."""
    b, G, Dg = 3, 2, 37
    args = _views(b, G, Dg, L, N, dtype, L + N)
    y, inner = scan_seq_model(*args, seg=seg, reverse=reverse,
                              internals=True)
    assert y.dtype == dtype and y.shape == (b, G, L, Dg)
    assert inner["plan"]["nseg"] == -(-L // inner["plan"]["seg"]) > 1
    ref = cuda_scan.scan_views_ref(*args, True, reverse)
    torch.testing.assert_close(y.float(), ref.float(), **TOL[dtype])
    if seg == 64 and not reverse:
        u, d, A, Bm, Cm, Dv, bias = args
        _, car = cuda_scan.selective_scan_carries_ref(
            cuda_scan.bl_flat(u.float()), cuda_scan.bl_flat(d.float()), A,
            Bm.float().transpose(1, 2), Cm.float().transpose(1, 2), Dv,
            bias, True)
        hin = inner["hin"].permute(0, 2, 3, 1, 4).reshape(b, G * Dg, -1, N)
        torch.testing.assert_close(hin, car[:, :, ::2], rtol=1e-4,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def tpu_kseq():
    spec = importlib.util.spec_from_file_location(
        "tpu_probe_kseq_seg", os.path.join(ROOT, "tools", "kseq.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET, mod.L, mod.CHUNK = True, 512, 128
    return mod


@pytest.mark.parametrize("win,reverse", [(None, False), (8, True)])
def test_seq_model_matches_jax_kernel_seq(tpu_kseq, win, reverse):
    """kernel_seq (win None) and kernel_seq_win (8) at kseq's interpret
    size (G 2, L 512, 8 batch rows, Dg 96, N 16, chunks of 128), bf16, in
    kseq's (G, L, 8, Dg) layout: the rule's 8 segments of 64."""
    G, D, N, L = 2, 96, 16, 512
    rng = np.random.RandomState(31 + reverse)
    p = dict(u=rng.randn(G, L, 8, D).astype(BF16),
             delta=(np.abs(rng.randn(G, L, 8, D)) * 0.5).astype(BF16),
             Bm=rng.randn(G, L, N, 8, 1).astype(BF16),
             Cm=rng.randn(G, L, N, 8, 1).astype(BF16),
             A=-np.exp(rng.randn(G * D, N) * 0.5).astype(np.float32),
             Dv=np.ones(G * D, np.float32),
             bias=(rng.randn(G * D) * 0.01).astype(np.float32))
    fwd = tpu_kseq.build_seq(chunk=128, seq=L, reverse=reverse, win=win)
    A_s = np.transpose(p["A"].reshape(G, D, N), (0, 2, 1))[:, :, None, :]
    ref = fwd(p["u"], p["delta"], A_s, p["Bm"], p["Cm"],
              p["Dv"].reshape(G, 1, D), p["bias"].reshape(G, 1, D))
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    t = {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.bfloat16 if v.dtype == BF16 else torch.float32)
        for k, v in p.items()}

    def act(x):  # (G, L, 8, Dg) -> (8, G, L, Dg)
        return x.permute(2, 0, 1, 3)

    def bc(x):   # (G, L, N, 8, 1) -> (8, G, L, N)
        return x[..., 0].permute(3, 0, 1, 2)

    assert plan(8, G, D, L)["nseg"] == 8
    y = scan_seq_model(act(t["u"]), act(t["delta"]), t["A"], bc(t["Bm"]),
                       bc(t["Cm"]), t["Dv"], t["bias"], reverse=reverse)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.permute(1, 2, 0, 3).float().numpy(), ref,
                               **{k: v for k, v in
                                  TOL[torch.bfloat16].items()})


@pytest.mark.parametrize("N,reverse,seg", [(5, False, 24), (16, True, None),
                                           (32, False, 24)])
def test_seq_model_matches_jax_k7(N, reverse, seg):
    """K7's kernel (`_build_pallas_fwd_ld`, chunks of 16, tiles of 8
    channels) at BT 2, L 64, 2 groups of 8 channels, fp32; segments of 24
    (24, 24, 16) or the rule's; N = 32 in two register passes."""
    BT, L, dim, G, chunk, d_tile = 2, 64, 16, 2, 16, 8
    rng = np.random.RandomState(40 + N + reverse)
    u = rng.randn(BT, L, dim).astype(np.float32)
    delta = rng.uniform(-3.0, 0.5, (BT, L, dim)).astype(np.float32)
    A = -np.exp(rng.uniform(-1.0, 1.5, (dim, N))).astype(np.float32)
    B5 = rng.randn(BT, G, N, L, 1).astype(np.float32)
    C5 = rng.randn(BT, G, N, L, 1).astype(np.float32)
    Dv = rng.randn(dim).astype(np.float32)
    bias = rng.uniform(-1.0, 1.0, dim).astype(np.float32)
    fwd = _build_pallas_fwd_ld(BT, L, dim, N, G, chunk, d_tile, True, True,
                               "float32", reverse=reverse)
    ref = np.asarray(fwd(u, delta, A.T[:, None, :], B5, C5, Dv[None],
                         bias[None]))
    tb = torch.from_numpy(B5[..., 0]).transpose(2, 3)  # (BT, G, L, N)
    tc = torch.from_numpy(C5[..., 0]).transpose(2, 3)
    y = scan_seq_model(
        cuda_scan._gld(torch.from_numpy(u), G),
        cuda_scan._gld(torch.from_numpy(delta), G), torch.from_numpy(A), tb,
        tc, torch.from_numpy(Dv), torch.from_numpy(bias), seg=seg,
        reverse=reverse)
    got = cuda_scan.bl_flat(y)
    np.testing.assert_allclose(got.numpy(), ref, **{
        k: v for k, v in TOL[torch.float32].items()})


def test_seq_segment_rule():
    """The rule's segment and the walk's warps at the H100's residency of
    a walk of 16 states (`H100_RESIDENT`, 16 warps on each of 132 SMs): the
    probe shape (8, 16384, 2 x 96) (kvariants' and kseq's card shape, K7's
    race) takes segments of 128, 6144 warps, over two waves; the probes'
    CPU shapes (kvariants' B 2 and kseq's 8 batch rows at L 512) and the
    tests' (3, 101, 2 x 37) the shortest, 64; a grid that fills the card
    twice in one segment takes one (one grid, no scratch). K7 at N = 256,
    whose walk's shared memory leaves fewer warps an SM, takes longer
    segments at the probe shape: the target follows the residency."""
    res = H100_RESIDENT[(16, 8)]
    cases = {(8, 2, 96, 16384): (128, 128, 6144), (2, 2, 96, 512): (64, 8, 96),
             (8, 2, 96, 512): (64, 8, 384), (3, 2, 37, 101): (64, 2, 24),
             (2, 2, 8, 64): (64, 1, 4), (64, 2, 2048, 4096): (4096, 1, 8192)}
    for (b, G, Dg, L), (seg, nseg, warps) in cases.items():
        p = plan(b, G, Dg, L)
        assert (p["seg"], p["nseg"], p["warps"]) == (seg, nseg, warps)
        assert p["grids"] == (1 if nseg == 1 else 3)
        assert seg == cuda_scan.SEQ_MIN_SEG or \
            warps >= cuda_scan.SEQ_WAVES * res
    assert res == 16 * 132
    p = plan(8, 2, 96, 16384, resident=H100_RESIDENT[(256, 8)])
    assert (p["seg"], p["warps"]) == (512, 1536)
    assert cuda_scan.seq_workspace(8, 2, 96, 16384, 16, 128) == \
        8 * 128 * 192 * 17
    assert cuda_scan.seq_workspace(2, 2, 8, 64, 16, 64) == 0


@pytest.mark.parametrize("which", ["scan_seq", "k7_n32"])
def test_seq_launch_passes_its_signature(monkeypatch, which):
    """scan_seq and K7 (N = 32) with the CPU routing and the launch stubbed:
    the residency asked once per (N, window) (`vmt_scan_seq_resident`,
    answered with the H100's count), then `vmt_scan_seq_fwd`, each with
    exactly its signature's arguments, every view's own strides, the
    scratch of `seq_workspace` over several segments (none within one),
    the window and the segment (the rule's, or the caller's)."""
    calls, sizes = [], []
    for mod in (cuda_scan, cuda_probes):
        monkeypatch.setattr(mod, "on_cpu", lambda *ts: False)
    for fn in (cuda_probes.scan_seq, cuda_scan.selective_scan_ld_fwd):
        monkeypatch.setattr(fn, "launches", 0)  # put back after the test
    # a cache of its own, so that no stubbed answer outlives the test
    monkeypatch.setattr(cuda_scan, "seq_resident", functools.lru_cache()(
        cuda_scan.seq_resident.__wrapped__))

    def launch(name, dev, *a):
        calls.append((name, a))
        if name == "vmt_scan_seq_resident":
            ctypes.c_int.from_address(a[-1]).value = H100_RESIDENT[a[:2]]

    monkeypatch.setattr(_build, "launch", launch)
    real = cuda_scan.seq_workspace
    monkeypatch.setattr(cuda_scan, "seq_workspace",
                        lambda *s: sizes.append(s) or real(*s))
    b, G, Dg, L = 2, 2, 8, 200
    if which == "scan_seq":
        N = 16
        args = list(_views(b, G, Dg, L, N, torch.float32, 1))
        args.append(torch.empty(b, G, L, Dg))
        cuda_probes.scan_seq(*args, win=16)
        cuda_probes.scan_seq(*args, win=1, seg=256)
        want = [(16, 64), (1, 256)]
    else:
        N = 32
        u, d, A, Bm, Cm, Dv, bias = _views(b, G, Dg, L, N, torch.float32, 1)
        fl = cuda_scan.bl_flat
        args = [fl(u), fl(d), A, Bm.transpose(1, 2), Cm.transpose(1, 2), Dv,
                bias]
        cuda_scan.selective_scan_ld_fwd(*args, True, True)
        cuda_scan.selective_scan_ld_fwd(*args, True, False)
        want = [(cuda_scan.K7_WIN, 64), (cuda_scan.K7_WIN, 64)]
    assert [c[0] for c in calls] == ["vmt_scan_seq_resident"] + [
        "vmt_scan_seq_fwd"] * 2
    (_, asked), calls = calls[0], calls[1:]
    assert len(asked) == len(_build.SIGNATURES["vmt_scan_seq_resident"]) - 1
    assert asked[:2] == (N, want[0][0]) and isinstance(asked[2], int)
    kinds = _build.SIGNATURES["vmt_scan_seq_fwd"][:-1]  # the stream: launch's
    fn = cuda_probes.scan_seq if which == "scan_seq" else \
        cuda_scan.selective_scan_ld_fwd
    assert fn.launches == 2
    assert sizes == [(b, G, Dg, L, N, seg) for _, seg in want]
    for (_, got), (win, seg) in zip(calls, want):
        assert len(got) == len(kinds)
        for k, v in zip(kinds, got):
            assert isinstance(v, int) or (k is _build._P and v is None)
        assert got[-9:-4] == (b, G, L, Dg, N)
        assert got[-4:-2] == (win, seg)
        assert (got[-10] is None) == (seg >= L)
    rev = [c[1][-2] for c in calls]
    assert rev == ([0, 0] if which == "scan_seq" else [1, 0])
    if which == "scan_seq":
        u = args[0]
        assert list(calls[0][1][2:6]) == list(u.stride())
