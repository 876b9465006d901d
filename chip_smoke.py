#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines and timings; any failed check exits
non-zero, and without a CUDA device the script stops before any result:

1. probe  - torch/CUDA versions, the card, its capability and power limit;
2. build  - compiles `vmambair_torch/csrc/*.cu` with nvcc for sm_90a;
3. kernels vs plain - each kernel at the main path's shapes against its
   plain PyTorch version on the same inputs on the card: fp32 within the
   reference CUDA envelope (rtol 6e-4, atol 2e-3), bf16 within 3e-2 /
   5e-2; times from CUDA events (median of repeats);
4. model  - MambaSISR6 widths at depth [1,1,1,1] + 1, one batch of 8
   128x128 tiles in fp32, kernels vs the plain path, within 1e-3;
5. serve  - full-size MambaSISR6 (bf16 activations, fp32 weights, seeded
   weights) answers 3 requests of a 512x256 image through
   `RestorationUpscaler.tile_process` (tile 128, tile_pad 0, tile_batch 8:
   one batch of 8 tiles each); checks the output shape, finiteness and
   that each kernel launched exactly as often as the dispatch predicts;
   then a torch.profiler table of one more request, by kernel and op, is
   printed (top rows) and written to `chiprun_out/serve_profile.txt`.

The second-to-last lines are a JSON object of the kernels (launches in the
serve phase, max error and times from phase 3) and the card's name and
power limit from nvidia-smi; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from vmambair_torch import _build
from vmambair_torch.models import MamberBlock, build_network
from vmambair_torch.models import layers as _layers
from vmambair_torch.models import oss as _oss
from vmambair_torch.ops import cuda_effn, cuda_scan
from vmambair_torch.utils.upscaler import RestorationUpscaler

KERNELS = {
    "oss_scan_fused": dict(
        fn=cuda_scan.oss_scan_fused,
        source="vmambair_torch/csrc/oss_scan_fused.cu",
        replaces="vmambair_tpu/ops/pallas_scan.py:1112"),
    "selective_scan": dict(
        fn=cuda_scan.selective_scan,
        source="vmambair_torch/csrc/selective_scan.cu",
        replaces="vmambair_tpu/ops/pallas_scan.py:74"),
    "gdfn_residual_fused": dict(
        fn=cuda_effn.gdfn_residual_fused,
        source="vmambair_torch/csrc/gdfn.cu",
        replaces="vmambair_tpu/ops/pallas_effn.py:119"),
}
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
OUT_DIR = "chiprun_out"


def expected_launches(net) -> dict:
    """Kernel launches of one forward, as the port's dispatch routes it:
    per MamberBlock two spatial pair scans (K1 when the width is at most
    256, else K4), one channel scan (K4) and one GDFN (K2)."""
    out = dict.fromkeys(KERNELS, 0)
    for m in net.modules():
        if not isinstance(m, MamberBlock):
            continue
        wide = not cuda_scan.fused_scan_supported(m.attn.d_inner,
                                                  m.attn.d_state)
        out["selective_scan" if wide else "oss_scan_fused"] += 2
        out["selective_scan"] += 1
        if not m.use_bias and m.ln_bias:
            out["gdfn_residual_fused"] += 1
    return out


def reset_launches():
    for k in KERNELS.values():
        k["fn"].launches = 0


def launches() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


def time_ms(fn, reps=5) -> float:
    """Median over `reps` of CUDA-event time, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def check_close(name, got, ref, rtol, atol) -> float:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err = err.max().item()
    if bad.any():
        raise SystemExit(
            f"FAIL {name}: {int(bad.sum())} of {bad.numel()} elements off "
            f"(max abs err {max_err:.3e}, rtol {rtol}, atol {atol})")
    return max_err


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# -- phase 1 + 2 ---------------------------------------------------------------

def probe():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    cap = torch.cuda.get_device_capability(0)
    print(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[probe] device {torch.cuda.get_device_name(0)} capability {cap} "
          f"count {torch.cuda.device_count()}")
    print(f"[probe] nvidia-smi: {nvidia_smi_line()}")
    if cap != (9, 0):
        raise SystemExit(f"FAIL probe: capability {cap}; the kernels are "
                         "built for sm_90a")


def build():
    t0 = time.perf_counter()
    _build.load_library()
    lib = _build.build()
    print(f"[build] {lib} in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        for line in f:
            if "Used" in line or "spill" in line or "Compiling" in line:
                print("[build] " + line.strip())


# -- phase 3: kernels vs plain -------------------------------------------------

def _fused_case(b, d, L, dtype, gen):
    N, R = 16, -(-d // 16)
    dev = "cuda"
    dt = torch.exp(torch.rand(2, d, generator=gen)
                   * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    args = (
        torch.randn(b, 2, d, L, generator=gen).to(dev, dtype),
        ((torch.rand(2, R + 2 * N, d, generator=gen) * 2 - 1)
         / d ** 0.5).to(dev),
        ((torch.rand(2, d, R, generator=gen) * 2 - 1) / R ** 0.5).to(dev),
        (dt + torch.log(-torch.expm1(-dt))).to(dev),
        -torch.arange(1, N + 1.0).expand(2, d, N).contiguous().to(dev),
        torch.ones(2, d, device=dev),
    )
    return args


def _scan_case(b, L, d, dtype, gen, n_groups=2, N=16, lifted=True):
    """Inputs laid out as the model passes them: u, delta, B, C are views
    of (B, 2D, L) / (B, 2, M, L) buffers for the latent pairs, or
    contiguous (B, L, 8) / (B, L, 2, N) for the channel scan."""
    dev = "cuda"
    dg = d // n_groups
    A = -torch.exp(torch.rand(d, N, generator=gen) * 2).to(dev)
    Dsk = torch.randn(d, generator=gen).to(dev)
    bias = (torch.rand(d, generator=gen) * 2 - 3).to(dev)
    if lifted:
        R = -(-dg // 16)
        u2 = torch.randn(b, n_groups, dg, L, generator=gen).to(dev, dtype)
        xpw = ((torch.rand(n_groups, R + 2 * N, dg, generator=gen) * 2 - 1)
               / dg ** 0.5).to(dev)
        dtw = ((torch.rand(n_groups, dg, R, generator=gen) * 2 - 1)
               / R ** 0.5).to(dev)
        x_dbl = torch.einsum("bgdl,gcd->bgcl", u2.float(), xpw)
        dts = torch.einsum("bgrl,gdr->bgdl", x_dbl[:, :, :R], dtw)
        u = u2.reshape(b, d, L).transpose(1, 2)
        delta = dts.reshape(b, d, L).transpose(1, 2)
        Bm = x_dbl[:, :, R:R + N].permute(0, 3, 1, 2)
        Cm = x_dbl[:, :, R + N:].permute(0, 3, 1, 2)
    else:
        u = torch.randn(b, L, d, generator=gen).to(dev, dtype)
        delta = torch.randn(b, L, d, generator=gen).to(dev)
        Bm = torch.randn(b, L, n_groups, N, generator=gen).to(dev)
        Cm = torch.randn(b, L, n_groups, N, generator=gen).to(dev)
    return (u, delta, A, Bm, Cm, Dsk, bias)


def _gdfn_case(b, c, hw, dtype, gen):
    hid = int(c * 2.66)
    dev = "cuda"
    return (
        (0.5 * torch.randn(b, c, hw, hw, generator=gen)).to(dev, dtype),
        (1 + 0.1 * torch.randn(c, generator=gen)).to(dev),
        (0.1 * torch.randn(c, generator=gen)).to(dev),
        ((torch.rand(2 * hid, c, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
        ((torch.rand(2 * hid, 3, 3, generator=gen) * 2 - 1) / 3).to(dev),
        ((torch.rand(c, hid, generator=gen) * 2 - 1) / hid ** 0.5).to(dev),
    )


def kernels_vs_plain() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    stats = {name: dict(max_abs_err=0.0, ms=None, plain_ms=None)
             for name in KERNELS}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for (b, d, L) in ((8, 48, 16384), (8, 192, 1024)):
            for rev in (False, True):
                args = _fused_case(b, d, L, dtype, gen)
                cases.append((
                    "oss_scan_fused", f"({b},2,{d},{L}) rev={rev}", dtype,
                    lambda a=args, r=rev: cuda_scan.oss_scan_fused(
                        *a, reverse=r),
                    lambda a=args, r=rev: cuda_scan.oss_scan_fused_ref(
                        *a, reverse=r)))
        for rev in (False, True):
            args = _scan_case(8, 256, 768, dtype, gen)
            cases.append((
                "selective_scan", f"latent (8,256,768) G=2 rev={rev}", dtype,
                lambda a=args, r=rev: cuda_scan.selective_scan(
                    *a, delta_softplus=True, reverse=r),
                lambda a=args, r=rev: cuda_scan.selective_scan_ref(
                    *a, delta_softplus=True, reverse=r)))
        for (b, c, hw) in ((8, 48, 128), (8, 384, 16)):
            args = _gdfn_case(b, c, hw, dtype, gen)
            cases.append((
                "gdfn_residual_fused", f"({b},{c},{hw},{hw})", dtype,
                lambda a=args: cuda_effn.gdfn_residual_fused(*a),
                lambda a=args: cuda_effn.gdfn_residual_ref(*a)))
    args = _scan_case(8, 96, 8, torch.float32, gen, lifted=False)
    cases.append((
        "selective_scan", "channel scan (8,96,8) G=2", torch.float32,
        lambda a=args: cuda_scan.selective_scan(*a, delta_softplus=True),
        lambda a=args: cuda_scan.selective_scan_ref(*a,
                                                     delta_softplus=True)))

    for name, shape, dtype, kern, plain in cases:
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        rtol, atol = TOL[dtype]
        err = check_close(f"{name} {shape} {dtype}", got, ref, rtol, atol)
        ms, pms = time_ms(kern), time_ms(plain, reps=3)
        print(f"[kernels] {name} {shape} {str(dtype)[6:]}: max abs err "
              f"{err:.3e} (rtol {rtol}, atol {atol}); kernel {ms:.3f} ms, "
              f"plain {pms:.3f} ms")
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if st["ms"] is None:  # the first case: the bench shape in bf16
            st["ms"], st["plain_ms"] = ms, pms
    return stats


# -- phase 4: the model, kernels vs plain --------------------------------------

@contextlib.contextmanager
def plain_ops():
    """Routes the model's kernel calls to the plain versions, on CUDA
    tensors too, for the comparison only."""
    saved = (_oss.oss_scan_fused, _oss.selective_scan,
             _layers.gdfn_residual_fused)
    _oss.oss_scan_fused = cuda_scan.oss_scan_fused_ref
    _oss.selective_scan = cuda_scan.selective_scan_ref
    _layers.gdfn_residual_fused = cuda_effn.gdfn_residual_ref
    try:
        yield
    finally:
        (_oss.oss_scan_fused, _oss.selective_scan,
         _layers.gdfn_residual_fused) = saved


def model_vs_plain():
    net = build_network(dict(type="MambaSISR6", num_blocks=[1, 1, 1, 1],
                             num_refinement_blocks=1), device="cuda", seed=1)
    x = torch.rand(8, 3, 128, 128, generator=torch.Generator().manual_seed(2)
                   ).cuda()
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = net(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with plain_ops():
            ref = net(x)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    assert got.shape == (8, 3, 512, 512), got.shape
    err = check_close("model [1,1,1,1]+1 fp32", got, ref, 1e-3, 1e-3)
    print(f"[model] MambaSISR6 widths, depth [1,1,1,1]+1, (8,3,128,128) "
          f"fp32: max abs err {err:.3e} (tol 1e-3); kernels "
          f"{1e3 * (t1 - t0):.1f} ms, plain {1e3 * (t2 - t1):.1f} ms "
          "(first calls)")


# -- phase 5: serve ------------------------------------------------------------

def serve() -> dict:
    net = build_network(dict(type="MambaSISR6", dtype=torch.bfloat16),
                        device="cuda", seed=0)
    ups = RestorationUpscaler(4, net, "cuda", tile=128, tile_pad=0,
                              pre_pad=0, tile_batch=8)
    predicted = expected_launches(net)
    print(f"[serve] predicted launches per forward: {predicted}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for i in range(3):
        img = np.random.RandomState(100 + i).rand(512, 256, 3).astype(
            np.float32)
        t0 = time.perf_counter()
        out = ups.tile_process(img)
        times.append(time.perf_counter() - t0)
        if out.shape != (2048, 1024, 3):
            raise SystemExit(f"FAIL serve: output shape {out.shape}")
        if not np.isfinite(out).all():
            raise SystemExit("FAIL serve: non-finite output")
        print(f"[serve] request {i}: {1e3 * times[-1]:.1f} ms, "
              f"{out.shape[0] * out.shape[1] / times[-1] / 1e6:.3f} MP/s "
              f"out, mean {out.mean():.4f}")
    counts = launches()
    want = {k: 3 * v for k, v in predicted.items()}
    print(f"[serve] launches in 3 requests: {counts} (predicted {want})")
    if counts != want:
        raise SystemExit("FAIL serve: launch counts differ from the "
                         "dispatch's prediction")
    steady = statistics.median(times[1:])
    print(f"[serve] ms per forward (median of requests 1-2, one batch of "
          f"8 tiles): {1e3 * steady:.1f}; output MP/s "
          f"{2048 * 1024 / steady / 1e6:.3f}; first request "
          f"{1e3 * times[0]:.1f} ms; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
          f"{nvidia_smi_line()}")
    profile_serve(ups)
    return counts


def profile_serve(ups):
    from torch.profiler import ProfilerActivity, profile as tprofile

    img = np.random.RandomState(7).rand(512, 256, 3).astype(np.float32)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        ups.tile_process(img)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "serve_profile.txt"), "w") as f:
        f.write(table)
    print("\n".join(table.splitlines()[:25]))


def main():
    t0 = time.perf_counter()
    probe()
    build()
    stats = kernels_vs_plain()
    model_vs_plain()
    counts = serve()
    kernels = [dict(name=name, route="cuda", source=k["source"],
                    replaces=k["replaces"], launches=counts[name],
                    **stats[name])
               for name, k in KERNELS.items()]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
