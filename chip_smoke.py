#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines and timings; any failed check exits
non-zero, and without a CUDA device the script stops before any result:

1. probe  - torch/CUDA versions, the card, its capability and power limit;
2. build  - compiles `vmambair_torch/csrc/*.cu` with nvcc for sm_90a;
3. kernels vs plain - each kernel at the main paths' shapes against its
   plain PyTorch version on the same inputs on the card. The forwards (K1,
   K4, K2): fp32 within the reference CUDA envelope (rtol 6e-4, atol
   2e-3), bf16 within 3e-2 / 5e-2. The carry-saving forwards (K1c, K4c):
   y equal to K1's / K4's, carries within the fp32 envelope. The scan
   backward (K3): all seven outputs within 5x the fp32 envelope (rtol
   3e-3, atol 1e-2), on fp32 and on bf16 inputs. Times from CUDA events
   (median of repeats) for the kernel and the plain version, beside the
   least time the card could take (bound) at the case's shapes;
4. model  - MambaSISR6 widths at depth [1,1,1,1] + 1, one batch of 8
   128x128 tiles in fp32, kernels vs the plain path, within 1e-3;
4b. model gradients - the same depth, fp32, 8 x 64x64 LQ, L1 loss: every
   parameter's gradient through the kernels against the plain path on the
   card within 2e-3 of its largest entry, and every scan and GDFN
   parameter's gradient non-zero and finite;
5. serve  - full-size MambaSISR6 (bf16 activations, fp32 weights, seeded
   weights) answers 3 requests of a 512x256 image through
   `RestorationUpscaler.tile_process` (tile 128, tile_pad 0, tile_batch 8:
   one batch of 8 tiles each); checks the output shape, finiteness and
   that each kernel launched exactly as often as the dispatch predicts;
   then a torch.profiler table of one more request is printed (top rows)
   and written to `chiprun_out/serve_profile.txt`;
6. train  - full-size MambaSISR6 through `build_model` with the recipe of
   `options/MambaSISR15_x4.yml` (L1, Adam 2e-4 (0.9, 0.99), EMA 0.999,
   MultiStepLR), fp32, on one fixed seeded batch of 8 64x64 LQ / 256x256
   GT: 1 warm-up step and 5 timed steps (ms per step, GT MP/s, peak
   memory), the launches of every step against the dispatch's
   prediction, finite losses falling from step 1 to step 6; save, resume
   into a new model, one more step on each: the same step; a
   torch.profiler table of one step in `chiprun_out/train_profile.txt`.
7. pipeline - `train_pipeline` with both OSS switches on (K5, K6) at the
   full size of the recipe, on a synthetic paired PNG dataset written by
   the port's encoder into `build/chip_smoke_data/` (16 pairs of 480x480
   GT / 120x120 LQ, 2 validation pairs, one with a 61x45 LQ): 8 steps,
   validation with PSNR-Y at iters 0, 4, 8 and the end, checkpoints at 4
   and 8, the launches of the whole run against the dispatch's prediction;
   auto-resume to iter 10; `test_pipeline`; `inference_torch.py --device
   cuda` on the validation LQ, outputs read back at 4x; ms per iteration
   and data ms per iteration from the pipeline's timers.

The OSS switches (`VMAMBAIR_OSS_FRONT`, `VMAMBAIR_OSS_TAIL`) are off except
where a phase turns them on: phase 3 holds K5 and K6 against their plain
versions (fp32 and bf16, the forward envelope), phases 4 and 4b run once
with them off and once on, and phase 5 races served forwards with them off
and on (interleaved, 6 of each; K5 and K6 once per MamberBlock when on,
never when off). fp32 matrix products and convolutions run in full fp32
(TF32 off). The second-to-last lines are a JSON object of the kernels
(launches in the serve, train and pipeline phases, max error, times and
bound from phase 3) and the card's name and power limit from nvidia-smi;
the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vmambair_torch import _build
from vmambair_torch.models import MamberBlock, build_network
from vmambair_torch.ops import cuda_effn, cuda_scan
from vmambair_torch.train import build_model
from vmambair_torch.train.pipeline import test_pipeline, train_pipeline
from vmambair_torch.utils.img_util import imread, imwrite
from vmambair_torch.utils.options import finalize_options
from vmambair_torch.utils.upscaler import RestorationUpscaler

PALLAS = "vmambair_tpu/ops/pallas_scan.py"
KERNELS = {
    "oss_scan_fused": dict(
        fn=cuda_scan.oss_scan_fused_fwd,
        source="vmambair_torch/csrc/oss_scan_fused.cu",
        replaces=f"{PALLAS}:1112"),
    "oss_scan_fused_carries": dict(
        fn=cuda_scan.oss_scan_fused_fwd_carries,
        source="vmambair_torch/csrc/oss_scan_fused.cu",
        replaces=f"{PALLAS}:1161"),
    "selective_scan": dict(
        fn=cuda_scan.selective_scan_fwd,
        source="vmambair_torch/csrc/selective_scan.cu",
        replaces=f"{PALLAS}:74"),
    "selective_scan_carries": dict(
        fn=cuda_scan.selective_scan_fwd_carries,
        source="vmambair_torch/csrc/selective_scan.cu",
        replaces=f"{PALLAS}:401"),
    "selective_scan_bwd": dict(
        fn=cuda_scan.selective_scan_bwd,
        source="vmambair_torch/csrc/selective_scan_bwd.cu",
        replaces=f"{PALLAS}:694"),
    "gdfn_residual_fused": dict(
        fn=cuda_effn.gdfn_residual_fwd,
        source="vmambair_torch/csrc/gdfn.cu",
        replaces="vmambair_tpu/ops/pallas_effn.py:119"),
    "oss_front_fused": dict(
        fn=cuda_effn.oss_front_fwd,
        source="vmambair_torch/csrc/oss_front.cu",
        replaces="vmambair_tpu/ops/pallas_effn.py:269"),
    "oss_tail_fused": dict(
        fn=cuda_effn.oss_tail_fwd,
        source="vmambair_torch/csrc/oss_tail.cu",
        replaces="vmambair_tpu/ops/pallas_effn.py:444"),
}
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
BWD_TOL = (3e-3, 1e-2)
GRAD_BAR = 2e-3
OUT_DIR = "chiprun_out"
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s; fp32 outside the
# tensor cores and bf16 dense tensor-core FLOP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# the S1 recipe of options/MambaSISR15_x4.yml (the script reads no YAML:
# the card's machine need not have a YAML parser)
RECIPE = {
    "name": "MambaSISR15_x4", "model_type": "MambaSISRModel", "scale": 4,
    "manual_seed": 0, "is_train": True,
    "network_g": {"type": "MambaSISR6", "inp_channels": 3,
                  "out_channels": 3, "dim": 48,
                  "num_blocks": [15, 1, 1, 1], "num_refinement_blocks": 15,
                  "ffn_expansion_factor": 2.66, "bias": False,
                  "LayerNorm_type": "WithBias"},
    "train": {"ema_decay": 0.999,
              "optim_g": {"type": "Adam", "lr": 2e-4, "weight_decay": 0,
                          "betas": [0.9, 0.99]},
              "scheduler": {"type": "MultiStepLR",
                            "milestones": [50000, 70000], "gamma": 0.5},
              "total_iter": 100000, "warmup_iter": -1,
              "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                            "reduction": "mean"}},
    "val": {"window_size": 8},
}
SCAN_PARAMS = ("x_proj_weight", "dt_projs_weight", "dt_projs_bias",
               "A_logs", "Ds", "xc_proj_weight", "dtc_projs_weight",
               "dtc_projs_bias", "Ac_logs", "Dsc")
GDFN_PARAMS = ("ffn.project_in.weight", "ffn.dwconv.weight",
               "ffn.project_out.weight", "norm2.body.weight",
               "norm2.body.bias")
# parameters K5 (norm1 .. conv2d) and K6 (out_norm) take
FRONT_TAIL_PARAMS = ("attn.in_conv.weight", "attn.in_conv.bias",
                     "attn.conv2d.weight", "attn.conv2d.bias",
                     "attn.out_norm.body.weight", "attn.out_norm.body.bias",
                     "norm1.body.weight", "norm1.body.bias")
SWITCHES = ("VMAMBAIR_OSS_FRONT", "VMAMBAIR_OSS_TAIL")


def expected_launches(net, train: bool = False) -> dict:
    """Kernel launches of one forward (train: one training step), as the
    port's dispatch routes it: per MamberBlock two spatial pair scans (K1
    when the width is at most 256, else K4), one channel scan (K4) and one
    GDFN (K2), and with the switches on one OSS front (K5) and one OSS
    tail (K6). A training step takes the carry-saving forwards (K1c, K4c)
    instead of K1 and K4, and one scan backward (K3) per scan; K2, K5 and
    K6 have no backward kernel."""
    out = dict.fromkeys(KERNELS, 0)
    sfx = "_carries" if train else ""
    for m in net.modules():
        if not isinstance(m, MamberBlock):
            continue
        wide = not cuda_scan.fused_scan_supported(m.attn.d_inner,
                                                  m.attn.d_state)
        out[("selective_scan" if wide else "oss_scan_fused") + sfx] += 2
        out["selective_scan" + sfx] += 1
        if train:
            out["selective_scan_bwd"] += 3
        if not m.use_bias and m.ln_bias:
            out["gdfn_residual_fused"] += 1
        if m.ln_bias and cuda_effn.oss_front_supported():
            out["oss_front_fused"] += 1
        if cuda_effn.oss_tail_supported():
            out["oss_tail_fused"] += 1
    return out


@contextlib.contextmanager
def oss_switches(on: bool):
    """Turns K5 and K6 on (or off) for the phase inside."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    os.environ.update({k: "1" if on else "0" for k in SWITCHES})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    if got.shape != ref.shape:
        raise SystemExit(f"FAIL {name}: shape {tuple(got.shape)} vs "
                         f"{tuple(ref.shape)}")
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved, fp32_ops, bf16_mma=0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over their peak rate."""
    t_b = bytes_moved / HBM_BPS * 1e3
    t_o = (fp32_ops / FP32_FLOPS + bf16_mma / BF16_TC_FLOPS) * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
        (u, delta, _, Bm, Cm, _, _), _ = cuda_scan.fused_scan_inputs(
            u2, xpw, dtw, bias.view(n_groups, dg), A.view(n_groups, dg, N),
            Dsk.view(n_groups, dg))
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


def _front_case(b, c, hw, dtype, gen):
    """K5's inputs at a MamberBlock's shape (E = C), drawn on the card."""
    def r(*shape):
        return torch.rand(*shape, generator=gen, device="cuda") * 2 - 1
    return ((0.5 * torch.randn(b, c, hw, hw, generator=gen, device="cuda")
             ).to(dtype), 1 + 0.1 * r(c), 0.1 * r(c), r(2 * c, c) / c ** 0.5,
            r(2 * c) / c ** 0.5, r(c, 3, 3) / 3, r(c) / 3)


def _tail_case(b, d, hw, dtype, gen):
    """K6's inputs: the scans' (B, 2, D, L) sum and the SiLU gate."""
    return (torch.randn(b, 2, d, hw * hw, generator=gen, device="cuda"
                        ).to(dtype),
            F.silu(torch.randn(b, d, hw, hw, generator=gen, device="cuda")
                   ).to(dtype),
            1 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
            0.1 * torch.randn(d, generator=gen, device="cuda"))


def _front_bound(args):
    """JAX's count (pallas_effn.py:322): B H W (4 C E + 18 E), the in_conv
    products on the tensor cores for bf16 inputs; x read, xs and z
    written once."""
    x, w_dw = args[0], args[5]
    b, c, h, w = x.shape
    e = w_dw.shape[0]
    px = b * h * w
    mma, other = px * 4 * c * e, px * 18 * e
    by = nbytes(x) + 2 * px * e * x.element_size() + nbytes(*args[1:])
    if x.dtype == torch.bfloat16:
        return bound(by, other, mma)
    return bound(by, other + mma)


def _tail_bound(args):
    """y read, z read and out written once; 10 flops per element."""
    y, z = args[0], args[1]
    return bound(nbytes(y) + 2 * nbytes(z) + nbytes(*args[2:]),
                 10 * z.numel())


def _fused_bound(args, carries=False):
    u2 = args[0]
    b, g, d, L = u2.shape
    N, R = args[4].shape[2], args[2].shape[2]
    el = b * g * d * L
    by = 2 * nbytes(u2) + nbytes(*args[1:])
    if carries:
        by += b * g * d * cuda_scan.n_chunks(L) * N * 4
    ops = 10 * el * N + 2 * el * (2 * R + 2 * N)
    return bound(by, ops)


def _scan_bound(args, out_dtype, carries=False):
    u, delta, A, Bm, Cm, _, _ = args
    b, L, d = u.shape
    N = A.shape[1]
    by = (nbytes(*args) + b * L * d * torch.finfo(out_dtype).bits // 8)
    if carries:
        by += b * d * cuda_scan.n_chunks(L) * N * 4
    return bound(by, 10 * b * L * d * N)


def _bwd_bound(args, dy):
    u, delta, A, Bm, Cm, _, _ = args
    b, L, d = u.shape
    N = A.shape[1]
    # inputs and carries read once; du, ddelta, dA, dB, dC, dD, dbias
    # written once (fp32)
    by = (nbytes(*args, dy) + b * d * cuda_scan.n_chunks(L) * N * 4
          + 4 * (2 * b * L * d + 2 * b * L * Bm.shape[2] * N + d * N + 2 * d))
    return bound(by, 24 * b * L * d * N)


def _gdfn_bound(args):
    x, _, _, w_in, _, w_out = args
    b, c, h, w = x.shape
    hid = w_out.shape[1]
    px = b * h * w
    mma = 2 * px * (2 * hid * c + hid * c)
    other = px * (2 * hid * 18 + hid * 20 + 10 * c)
    by = 2 * nbytes(x) + nbytes(*args[1:])
    if x.dtype == torch.bfloat16:
        return bound(by, other, mma)
    return bound(by, other + mma)


def kernels_vs_plain() -> dict:
    """Each case: (kernel name, label, dtype, kernel call, plain call,
    compare(got, ref) -> max error, bound). The first case of each kernel
    is its main-path shape: its times go into the kernels line."""
    gen = torch.Generator().manual_seed(0)
    stats = {name: dict(max_abs_err=0.0, ms=None, plain_ms=None,
                        bound_ms=None, bound_by=None, library_ms=None)
             for name in KERNELS}
    cases = []

    def fwd_cmp(label, dtype):
        return lambda got, ref: check_close(label, got, ref, *TOL[dtype])

    def pair_cmp(label, dtype):
        return lambda got, ref: max(
            check_close(f"{label} {n}", g, r, *TOL[dtype])
            for n, g, r in zip(("xs", "z"), got, ref))

    def carries_cmp(label, kernel_y):
        def cmp(got, ref):
            y, car = got
            if not torch.equal(y, kernel_y()):
                raise SystemExit(f"FAIL {label}: y differs from the "
                                 "no-carry kernel's")
            return check_close(label + " carries", car, ref[1],
                               *TOL[torch.float32])
        return cmp

    def bwd_cmp(label):
        def cmp(got, ref):
            names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
            return max(check_close(f"{label} {n}", g, r, *BWD_TOL)
                       for n, g, r in zip(names, got, ref))
        return cmp

    def add(name, label, dtype, kern, plain, cmp, bnd):
        cases.append((name, label, dtype, kern, plain, cmp, bnd))

    # serve: K1, K4, K2 (bf16 first: the serve dtype)
    for dtype in (torch.bfloat16, torch.float32):
        for (b, d, L) in ((8, 48, 16384), (8, 192, 1024)):
            for rev in (False, True):
                a = _fused_case(b, d, L, dtype, gen)
                lab = f"({b},2,{d},{L}) rev={rev}"
                add("oss_scan_fused", lab, dtype,
                    lambda a=a, r=rev: cuda_scan.oss_scan_fused_fwd(
                        *a, reverse=r),
                    lambda a=a, r=rev: cuda_scan.oss_scan_fused_ref(
                        *a, reverse=r),
                    fwd_cmp(f"K1 {lab} {dtype}", dtype), _fused_bound(a))
        for rev in (False, True):
            a = _scan_case(8, 256, 768, dtype, gen)
            lab = f"latent (8,256,768) G=2 rev={rev}"
            add("selective_scan", lab, dtype,
                lambda a=a, r=rev: cuda_scan.selective_scan_fwd(
                    *a, delta_softplus=True, reverse=r),
                lambda a=a, r=rev: cuda_scan.selective_scan_ref(
                    *a, delta_softplus=True, reverse=r),
                fwd_cmp(f"K4 {lab} {dtype}", dtype), _scan_bound(a, dtype))
        for (b, c, hw) in ((8, 48, 128), (8, 384, 16), (8, 96, 64)):
            a = _gdfn_case(b, c, hw, dtype, gen)
            lab = f"({b},{c},{hw},{hw})"
            add("gdfn_residual_fused", lab, dtype,
                lambda a=a: cuda_effn.gdfn_residual_fwd(*a),
                lambda a=a: cuda_effn.gdfn_residual_ref(*a),
                fwd_cmp(f"K2 {lab} {dtype}", dtype), _gdfn_bound(a))
    # K5 and K6 at the five MamberBlock shapes of a served forward (the
    # first, 30 of the 50 blocks, is the main shape)
    cgen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for (b, c, hw) in ((8, 96, 128), (8, 48, 128), (8, 96, 64),
                           (8, 192, 32), (8, 384, 16)):
            lab = f"({b},{c},{hw},{hw})"
            a = _front_case(b, c, hw, dtype, cgen)
            add("oss_front_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_front_fwd(*a),
                lambda a=a: cuda_effn.oss_front_ref(*a),
                pair_cmp(f"K5 {lab} {dtype}", dtype), _front_bound(a))
            a = _tail_case(b, c, hw, dtype, cgen)
            add("oss_tail_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_tail_fwd(*a),
                lambda a=a: cuda_effn.oss_tail_ref(*a),
                fwd_cmp(f"K6 {lab} {dtype}", dtype), _tail_bound(a))
    a = _scan_case(8, 96, 8, torch.float32, gen, lifted=False)
    add("selective_scan", "channel scan (8,96,8) G=2", torch.float32,
        lambda a=a: cuda_scan.selective_scan_fwd(*a, delta_softplus=True),
        lambda a=a: cuda_scan.selective_scan_ref(*a, delta_softplus=True),
        fwd_cmp("K4 channel", torch.float32), _scan_bound(a, torch.float32))

    # train: K1c, K4c, K3 at the S1 step's shapes (fp32 first: the
    # training dtype), K3 fed by the carries of the forward it follows
    for dtype in (torch.float32, torch.bfloat16):
        for (b, d, L) in ((8, 96, 4096), (8, 48, 4096), (8, 96, 1024),
                          (8, 192, 256)):
            for rev in (False, True):
                a = _fused_case(b, d, L, dtype, gen)
                lab = f"({b},2,{d},{L}) rev={rev}"
                add("oss_scan_fused_carries", lab, dtype,
                    lambda a=a, r=rev: cuda_scan.oss_scan_fused_fwd_carries(
                        *a, reverse=r),
                    lambda a=a, r=rev: cuda_scan.oss_scan_fused_carries_ref(
                        *a, reverse=r),
                    carries_cmp(f"K1c {lab} {dtype}",
                                lambda a=a, r=rev: cuda_scan
                                .oss_scan_fused_fwd(*a, reverse=r)),
                    _fused_bound(a, carries=True))
                _, car = cuda_scan.oss_scan_fused_fwd_carries(*a, reverse=rev)
                s, _ = cuda_scan.fused_scan_inputs(*a)
                dy = torch.randn(b, 2 * d, L, generator=gen).to(
                    "cuda", dtype).transpose(1, 2)
                add("selective_scan_bwd", f"fused {lab}", dtype,
                    lambda s=s, dy=dy, c=car, r=rev: cuda_scan
                    .selective_scan_bwd(*s, dy, c, delta_softplus=True,
                                        reverse=r),
                    lambda s=s, dy=dy, r=rev: cuda_scan
                    .selective_scan_bwd_ref(*s, dy, delta_softplus=True,
                                            reverse=r),
                    bwd_cmp(f"K3 fused {lab} {dtype}"), _bwd_bound(s, dy))
        scans = [(f"latent (8,64,768) G=2 rev={rev}", rev,
                  _scan_case(8, 64, 768, dtype, gen)) for rev in (False, True)]
        scans += [(f"channel scan (8,{c},8) G=2", False,
                   _scan_case(8, c, 8, dtype, gen, lifted=False))
                  for c in (48, 96, 192, 384)]
        for lab, rev, a in scans:
            add("selective_scan_carries", lab, dtype,
                lambda a=a, r=rev: cuda_scan.selective_scan_fwd_carries(
                    *a, delta_softplus=True, reverse=r),
                lambda a=a, r=rev: cuda_scan.selective_scan_carries_ref(
                    *a, delta_softplus=True, reverse=r),
                carries_cmp(f"K4c {lab} {dtype}",
                            lambda a=a, r=rev: cuda_scan.selective_scan_fwd(
                                *a, delta_softplus=True, reverse=r)),
                _scan_bound(a, dtype, carries=True))
            _, car = cuda_scan.selective_scan_fwd_carries(
                *a, delta_softplus=True, reverse=rev)
            dy = torch.randn(a[0].shape, generator=gen).to("cuda", dtype)
            add("selective_scan_bwd", lab, dtype,
                lambda a=a, dy=dy, c=car, r=rev: cuda_scan.selective_scan_bwd(
                    *a, dy, c, delta_softplus=True, reverse=r),
                lambda a=a, dy=dy, r=rev: cuda_scan.selective_scan_bwd_ref(
                    *a, dy, delta_softplus=True, reverse=r),
                bwd_cmp(f"K3 {lab} {dtype}"), _bwd_bound(a, dy))

    for name, label, dtype, kern, plain, cmp, bnd in cases:
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        err = cmp(got, ref)
        del got, ref
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        line = (f"[kernels] {name} {label} {str(dtype)[6:]}: max abs err "
                f"{err:.3e}")
        if st["ms"] is None:  # the first case: the main path's shape
            st["ms"], st["plain_ms"] = time_ms(kern), time_ms(plain, reps=3)
            st.update(bnd)
            line += (f"; kernel {st['ms']:.3f} ms, plain "
                     f"{st['plain_ms']:.3f} ms, bound {bnd['bound_ms']:.4f}"
                     f" ms ({bnd['bound_by']})")
        print(line)
    torch.cuda.empty_cache()
    return stats


# -- phase 4: the model, kernels vs plain --------------------------------------

def _bwd_ref_from_carries(*args, **kw):
    """The plain scan backward in the place of K3 (it needs no carries)."""
    *scan_args, dy, _carries = args
    return cuda_scan.selective_scan_bwd_ref(*scan_args, dy, **kw)


@contextlib.contextmanager
def plain_ops():
    """Routes every kernel wrapper to its plain version, on CUDA tensors
    too, for the comparison only: the forward entry points and the
    autograd Functions then run the plain path."""
    swaps = [
        (cuda_scan, "oss_scan_fused_fwd", cuda_scan.oss_scan_fused_ref),
        (cuda_scan, "oss_scan_fused_fwd_carries",
         cuda_scan.oss_scan_fused_carries_ref),
        (cuda_scan, "selective_scan_fwd", cuda_scan.selective_scan_ref),
        (cuda_scan, "selective_scan_fwd_carries",
         cuda_scan.selective_scan_carries_ref),
        (cuda_scan, "selective_scan_bwd", _bwd_ref_from_carries),
        (cuda_effn, "gdfn_residual_fwd", cuda_effn.gdfn_residual_ref),
        (cuda_effn, "oss_front_fwd", cuda_effn.oss_front_ref),
        (cuda_effn, "oss_tail_fwd", cuda_effn.oss_tail_ref),
    ]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _reduced_net(seed):
    return build_network(dict(type="MambaSISR6", num_blocks=[1, 1, 1, 1],
                              num_refinement_blocks=1), seed=seed)


def model_vs_plain(fused: bool):
    """Phase 4; `fused`: with K5 and K6 on."""
    net = _reduced_net(1)
    x = torch.rand(8, 3, 128, 128, generator=torch.Generator().manual_seed(2)
                   ).cuda()
    with oss_switches(fused), torch.inference_mode():
        t0 = time.perf_counter()
        got = net(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with plain_ops():
            ref = net(x)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    assert got.shape == (8, 3, 512, 512), got.shape
    tag = "K5/K6 on" if fused else "K5/K6 off"
    err = check_close(f"model [1,1,1,1]+1 fp32 {tag}", got, ref, 1e-3, 1e-3)
    print(f"[model] MambaSISR6 widths, depth [1,1,1,1]+1, (8,3,128,128) "
          f"fp32, {tag}: max abs err {err:.3e} (tol 1e-3); kernels "
          f"{1e3 * (t1 - t0):.1f} ms, plain {1e3 * (t2 - t1):.1f} ms "
          "(first calls)")


def _grads(net, lq, gt):
    net.zero_grad(set_to_none=True)
    (net(lq) - gt).abs().mean().backward()
    torch.cuda.synchronize()
    return {k: p.grad.detach().clone() for k, p in net.named_parameters()}


def model_grads_vs_plain(fused: bool):
    """Phase 4b; `fused`: with K5 and K6 on (their parameters' gradients
    then come through the recompute backward of their Functions)."""
    net = _reduced_net(3)
    g = torch.Generator().manual_seed(4)
    gt = torch.rand(8, 3, 256, 256, generator=g)
    lq = torch.nn.functional.avg_pool2d(gt, 4).cuda()
    gt = gt.cuda()
    with oss_switches(fused):
        want = expected_launches(net, train=True)
        reset_launches()
        t0 = time.perf_counter()
        got = _grads(net, lq, gt)
        t1 = time.perf_counter()
        counts = launches()
        if counts != want:
            raise SystemExit(f"FAIL model grads: launches {counts}, "
                             f"predicted {want}")
        with plain_ops():
            ref = _grads(net, lq, gt)
        t2 = time.perf_counter()
    top = max(r.abs().max().item() for r in ref.values())
    worst, checked = (0.0, ""), 0
    for k, gk in got.items():
        r = ref[k]
        if not torch.isfinite(gk).all():
            raise SystemExit(f"FAIL model grads: {k} not finite")
        if k.endswith("conv_cout.bias"):
            # a shift of every channel before a mean-subtracting LayerNorm:
            # its exact gradient is 0, both sides must show only rounding
            if max(gk.abs().max().item(), r.abs().max().item()) > 1e-5 * top:
                raise SystemExit(f"FAIL model grads: {k} not ~0")
            continue
        rel = (gk - r).abs().max().item() / r.abs().max().item()
        worst = max(worst, (rel, k))
        checked += 1
        if rel > GRAD_BAR:
            raise SystemExit(f"FAIL model grads: {k} rel err {rel:.3e} > "
                             f"{GRAD_BAR}")
    groups = SCAN_PARAMS + GDFN_PARAMS + (FRONT_TAIL_PARAMS if fused
                                          else ())
    kernel_params = [k for k in got if k.rsplit(".", 1)[-1] in SCAN_PARAMS
                     or k.endswith(GDFN_PARAMS)
                     or (fused and k.endswith(FRONT_TAIL_PARAMS))]
    zero = [k for k in kernel_params if not got[k].abs().max() > 0]
    n_blocks = sum(isinstance(m, MamberBlock) for m in net.modules())
    if zero or len(kernel_params) != n_blocks * len(groups):
        raise SystemExit(f"FAIL model grads: zero gradients at {zero} "
                         f"({len(kernel_params)} kernel tensors)")
    tag = "K5/K6 on" if fused else "K5/K6 off"
    print(f"[grads] MambaSISR6 widths, depth [1,1,1,1]+1, 8x64x64 LQ, L1, "
          f"fp32, {tag}: {checked} parameter tensors within {GRAD_BAR} of "
          "their "
          f"largest entry (worst {worst[0]:.3e} at {worst[1]}); "
          f"{len(kernel_params)} scan/GDFN{'/front/tail' if fused else ''} "
          "tensors with non-zero finite "
          f"gradients; launches {counts}; kernels {1e3 * (t1 - t0):.1f} ms,"
          f" plain {1e3 * (t2 - t1):.1f} ms (first calls)")
    del net, got, ref
    torch.cuda.empty_cache()


# -- phase 5: serve ------------------------------------------------------------

def serve() -> dict:
    net = build_network(dict(type="MambaSISR6", dtype=torch.bfloat16),
                        seed=0)
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
    profile("serve", lambda: ups.tile_process(
        np.random.RandomState(7).rand(512, 256, 3).astype(np.float32)))
    raced = race(ups, net)
    with oss_switches(True):
        profile("serve_front_tail", lambda: ups.tile_process(
            np.random.RandomState(7).rand(512, 256, 3).astype(np.float32)))
    return {k: counts[k] + raced[k] for k in counts}


def race(ups, net, rounds=6) -> dict:
    """The served forward with K5/K6 off against on, in turns (off, on, on,
    off, ...), `rounds` of each in this process: every forward's launches
    against the prediction (K5 and K6 once per MamberBlock when on, never
    when off), the two medians, and the largest difference between the two
    outputs. Returns the launches of all the forwards."""
    img = np.random.RandomState(200).rand(512, 256, 3).astype(np.float32)
    n_blocks = sum(isinstance(m, MamberBlock) for m in net.modules())
    times, outs = {False: [], True: []}, {}
    total = dict.fromkeys(KERNELS, 0)
    for i in range(rounds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            with oss_switches(on):
                want = expected_launches(net)
                reset_launches()
                t0 = time.perf_counter()
                outs[on] = ups.tile_process(img)
                times[on].append(time.perf_counter() - t0)
                got = launches()
            if got != want or any(got[k] != (n_blocks if on else 0) for k
                                  in ("oss_front_fused", "oss_tail_fused")):
                raise SystemExit(f"FAIL race: K5/K6 {'on' if on else 'off'}"
                                 f" launches {got}, predicted {want}")
            for k, v in got.items():
                total[k] += v
    off, on = (1e3 * statistics.median(times[k]) for k in (False, True))
    every = {k: [round(1e3 * t, 1) for t in v] for k, v in times.items()}
    diff = np.abs(outs[True] - outs[False]).max()
    print(f"[race] served forward (8 bf16 tiles of 128x128), median of "
          f"{rounds} each, in turns: K5/K6 off {off:.1f} ms, on {on:.1f} ms "
          f"({off / on:.3f}x); all off {every[False]}, all on "
          f"{every[True]}; launches per "
          f"forward K5 {n_blocks} / K6 {n_blocks} on, 0 off; max |out on - "
          f"out off| {diff:.3e}; card {nvidia_smi_line()}")
    return total


# device kernels by class, for the "where the time goes" tables: the
# first class whose key is in the kernel's name takes it
KERNEL_CLASSES = (
    ("K3 scan backward", ("selective_scan_bwd_kernel",)),
    ("K1/K1c fused scan", ("oss_scan_fused_kernel",)),
    ("K4/K4c scan", ("selective_scan_kernel",)),
    ("K2 GDFN", ("gdfn_kernel",)),
    ("K5 OSS front", ("oss_front_kernel",)),
    ("K6 OSS tail", ("oss_tail_kernel",)),
    ("convolutions", ("fprop", "dgrad", "wgrad", "conv", "implicit",
                      "cudnn", "winograd")),
    ("matrix products (einsums)", ("gemm", "xmma", "cutlass", "splitK")),
    ("optimizer (Adam, EMA)", ("multi_tensor", "adam", "lerp")),
    ("copies", ("Memcpy", "Memset", "copy")),
)


def device_breakdown(prof) -> dict:
    """Device time (ms) of the profiled kernels, by class."""
    out = {}
    for row in prof.key_averages():
        # kernels only, as the table's own total counts them: no CPU rows,
        # no ranges annotated on the device (such as Optimizer.step)
        if row.device_type != torch.autograd.DeviceType.CUDA or getattr(
                row, "is_user_annotation", False):
            continue
        ms = getattr(row, "self_device_time_total",
                     getattr(row, "self_cuda_time_total", 0)) / 1e3
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in row.key for k in keys)),
                   "elementwise and reductions")
        out[cls] = out.get(cls, 0.0) + ms
    return out


def profile(name, fn):
    """A torch.profiler table of one call of fn (top rows printed, all in
    chiprun_out/<name>_profile.txt) and its device time by class against
    the host clock around the call."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    by_class = device_breakdown(prof)
    busy = sum(by_class.values())
    summary = (f"[{name}] device time by class (ms): " + ", ".join(
        f"{c} {v:.1f}" for c, v in sorted(by_class.items(),
                                          key=lambda kv: -kv[1]))
        + f"; device sum {busy:.1f} ms of {wall:.1f} ms on the host clock "
        f"under the profiler (idle {100 * (1 - busy / wall):.1f}%)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{name}_profile.txt"), "w") as f:
        f.write(table + "\n" + summary + "\n")
    print("\n".join(table.splitlines()[:25]))
    print(summary)


# -- phase 6: train ------------------------------------------------------------

def _train_batch():
    """One seeded S1 pair: 8 256x256 GT crops and their 4x box-downsampled
    64x64 LQ, NHWC float32 as the data layer hands them over."""
    gt = np.random.RandomState(0).rand(8, 256, 256, 3).astype(np.float32)
    lq = gt.reshape(8, 64, 4, 64, 4, 3).mean((2, 4))
    return {"lq": lq, "gt": gt}


def train() -> dict:
    # checkpoints go to the git-ignored build/, not to the output directory
    root = os.path.join("build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    opt = dict(RECIPE, path={"models": os.path.join(root, "models"),
                             "training_states": os.path.join(root, "state")})
    model = build_model(opt)
    predicted = expected_launches(model.net_g, train=True)
    print(f"[train] predicted launches per step: {predicted}")
    batch = _train_batch()
    model.feed_data(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times, before = [], [], launches()
    for it in range(1, 7):  # step 1 warms up, steps 2-6 are timed
        t0 = time.perf_counter()
        model.optimize_parameters(it)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(model.get_current_log()["l_pix"])
        now = launches()
        step = {k: now[k] - before[k] for k in now}
        before = now
        if step != predicted:
            raise SystemExit(f"FAIL train: step {it} launches {step}, "
                             f"predicted {predicted}")
        if not np.isfinite(losses[-1]):
            raise SystemExit(f"FAIL train: step {it} loss {losses[-1]}")
        print(f"[train] step {it}: {1e3 * times[-1]:.1f} ms, l_pix "
              f"{losses[-1]:.6f}, lr {model.log_dict['lr']:g}")
    counts = launches()
    if not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL train: loss did not fall: {losses}")
    step_ms = 1e3 * statistics.median(times[1:])
    print(f"[train] ms per step (median of steps 2-6): {step_ms:.1f}; GT "
          f"MP/s {8 * 256 * 256 / step_ms / 1e3:.3f}; first step "
          f"{1e3 * times[0]:.1f} ms; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
          f"{nvidia_smi_line()}")

    # save, resume into a new model, one more step on each: the same step
    model.save(epoch=0, current_iter=6)
    other = build_model(dict(opt, manual_seed=1))
    other.load_net_g(os.path.join(root, "models", "net_g_6.pth"))
    st = other.resume_training(os.path.join(root, "state", "6.state"))
    if st != {"iter": 6, "epoch": 0}:
        raise SystemExit(f"FAIL train: resumed state {st}")
    torch.backends.cudnn.deterministic = True
    step7 = []
    for m in (model, other):
        m.feed_data(batch)
        m.optimize_parameters(7)
        step7.append(m.get_current_log()["l_pix"])
    torch.backends.cudnn.deterministic = False
    worst = 0.0
    for a, b in ((model.net_g, other.net_g),
                 (model.net_g_ema, other.net_g_ema)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            worst = max(worst, (v - w).abs().max().item())
    if step7[0] != step7[1] or worst > 1e-6:
        raise SystemExit(f"FAIL train: resumed step differs: losses "
                         f"{step7}, max weight difference {worst:.3e}")
    print(f"[train] save + resume: step 7 loss {step7[0]:.6f} on both, "
          f"max weight/EMA difference {worst:.3e}")
    del other
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    profile("train", lambda: model.optimize_parameters(8))
    return counts


# -- phase 7: the pipeline ----------------------------------------------------

DATA = os.path.join("build", "chip_smoke_data")
PIPE = os.path.join("build", "chip_smoke_pipeline")


def _synthetic_image(rng, h, w) -> np.ndarray:
    """A seeded HWC uint8 image: smooth waves and a little noise."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, 3))
    for _ in range(4):
        f, phase = rng.uniform(2, 24, 2), rng.uniform(0, 2 * np.pi, 3)
        img += np.sin(2 * np.pi * (f[0] * yy + f[1] * xx)[..., None] + phase)
    img = 0.5 + 0.1 * img + 0.03 * rng.randn(h, w, 3)
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def write_dataset():
    """16 training pairs of 480x480 GT (the DF2K sub-image size) and their
    4x box-downsampled 120x120 LQ, and 2 validation pairs (120x120 and
    61x45 LQ), as PNG by the port's encoder."""
    shutil.rmtree(DATA, ignore_errors=True)
    rng = np.random.RandomState(0)
    sizes = [("train", f"{i:04d}", 120, 120) for i in range(16)] + [
        ("val", "v0", 120, 120), ("val", "v1", 61, 45)]
    for split, name, h, w in sizes:
        gt = _synthetic_image(rng, 4 * h, 4 * w)
        lq = gt.reshape(h, 4, w, 4, 3).mean((1, 3)).round().astype(np.uint8)
        imwrite(gt, os.path.join(DATA, split, "gt", f"{name}.png"))
        imwrite(lq, os.path.join(DATA, split, "lq", f"{name}.png"))


def _val_dataset() -> dict:
    return {"name": "synthetic val", "type": "PairedImageDataset",
            "dataroot_gt": os.path.join(DATA, "val", "gt"),
            "dataroot_lq": os.path.join(DATA, "val", "lq"),
            "io_backend": {"type": "disk"}}


def _pipeline_opt(total_iter: int, auto_resume: bool) -> dict:
    """RECIPE with its datasets pointed at the synthetic PNGs, 8 steps,
    validation (PSNR-Y, crop 4) every 4, checkpoints every 4."""
    train_ds = {"name": "synthetic DF2K", "type": "PairedImageDataset",
                "dataroot_gt": os.path.join(DATA, "train", "gt"),
                "dataroot_lq": os.path.join(DATA, "train", "lq"),
                "io_backend": {"type": "disk"}, "gt_size": 256,
                "use_hflip": True, "use_rot": True, "num_worker_per_gpu": 8,
                "batch_size_per_gpu": 8, "dataset_enlarge_ratio": 100}
    opt = json.loads(json.dumps(RECIPE))
    opt.update(num_gpu=1, auto_resume=auto_resume,
               datasets={"train": train_ds, "val_1": _val_dataset()},
               path={"experiments_root": os.path.join(PIPE, "exp"),
                     "pretrain_network_g": None, "param_key_g": "params_ema",
                     "strict_load_g": True, "resume_state": None},
               logger={"print_freq": 1, "save_checkpoint_freq": 4,
                       "use_tb_logger": False})
    opt["train"]["total_iter"] = total_iter
    opt["val"] = {"window_size": 8, "val_freq": 4, "save_img": False,
                  "metrics": {"psnr": {"type": "calculate_psnr",
                                       "crop_border": 4,
                                       "test_y_channel": True}}}
    return finalize_options(opt, ".", is_train=True)


def _last_log(prefix: str) -> str:
    log_dir = os.path.join(PIPE, "exp")
    names = sorted(f for f in os.listdir(log_dir)
                   if f.startswith(prefix) and f.endswith(".log"))
    with open(os.path.join(log_dir, names[-1])) as f:
        return f.read()


def _numbers(log: str, key: str) -> list:
    return [float(line.rsplit(key, 1)[1].split()[0])
            for line in log.splitlines() if key in line]


def pipeline() -> dict:
    """Phase 7: train, validate, save, resume, test and serve through the
    pipeline's entry points with K5 and K6 on."""
    t0 = time.perf_counter()
    write_dataset()
    shutil.rmtree(PIPE, ignore_errors=True)
    print(f"[pipeline] dataset written in {time.perf_counter() - t0:.1f} s")
    with oss_switches(True):
        arch = build_network(dict(type="MambaSISR6"), device="cpu")
        fwd, step = (expected_launches(arch, train=t) for t in (False, True))
        del arch
        reset_launches()
        t1 = time.perf_counter()
        model = train_pipeline(".", _pipeline_opt(8, False), device="cuda")
        t2 = time.perf_counter()
        log = _last_log("train_")
        first = launches()
        # validation before step 1, at 4 and 8, and after the loop: 2
        # images each
        n_val = 2 * 4
        want = {k: 8 * step[k] + n_val * fwd[k] for k in KERNELS}
        if first != want:
            raise SystemExit(f"FAIL pipeline: launches {first}, predicted "
                             f"{want}")
        losses, psnrs = _numbers(log, "l_pix:"), _numbers(log, "# psnr:")
        if len(losses) != 8 or not np.isfinite(losses).all():
            raise SystemExit(f"FAIL pipeline: losses {losses}")
        if len(psnrs) != 4 or not np.isfinite(psnrs).all():
            raise SystemExit(f"FAIL pipeline: validation PSNR {psnrs}")
        exp = os.path.join(PIPE, "exp")
        for path in ("models/net_g_4.pth", "models/net_g_8.pth",
                     "training_states/8.state"):
            if not os.path.isfile(os.path.join(exp, path)):
                raise SystemExit(f"FAIL pipeline: no {path}")
        iter_ms = 1e3 * model.timers["iter"].get_avg_time()
        data_ms = 1e3 * model.timers["data"].get_avg_time()
        print(f"[pipeline] 8 steps of the recipe: l_pix "
              f"{[round(v, 5) for v in losses]}; validation PSNR-Y "
              f"{[round(v, 4) for v in psnrs]} dB (iters 0, 4, 8, end); ms "
              f"per iter {iter_ms:.1f}, data ms per iter {data_ms:.1f} (mean "
              f"of 8); run {t2 - t1:.1f} s; launches {first}; card "
              f"{nvidia_smi_line()}")
        del model

        # auto-resume to 10: steps 9 and 10, then validation
        reset_launches()
        model = train_pipeline(".", _pipeline_opt(10, True), device="cuda")
        log = _last_log("train_")
        resumed = launches()
        want = {k: 2 * step[k] + 2 * fwd[k] for k in KERNELS}
        if "Resuming training from epoch 0, iter 8." not in log \
                or resumed != want:
            raise SystemExit(f"FAIL pipeline: resume: launches {resumed} "
                             f"(predicted {want}); log:\n{log[-2000:]}")
        if not os.path.isfile(os.path.join(exp, "models", "net_g_10.pth")):
            raise SystemExit("FAIL pipeline: no net_g_10.pth")
        del model
        print(f"[pipeline] auto-resume at iter 8 to iter 10: launches "
              f"{resumed}")

        # test_pipeline on the validation pairs, then the inference CLI
        ckpt = os.path.join(exp, "models", "net_g_10.pth")
        res = os.path.join(PIPE, "results")
        opt = finalize_options({
            "name": "chip_smoke_test", "model_type": "MambaSISRModel",
            "scale": 4, "manual_seed": 0,
            "network_g": RECIPE["network_g"],
            "datasets": {"test_1": _val_dataset()},
            "path": {"results_root": res, "pretrain_network_g": ckpt,
                     "param_key_g": "params_ema"},
            "val": {"window_size": 8, "save_img": True,
                    "metrics": {"psnr": {"type": "calculate_psnr",
                                         "crop_border": 4,
                                         "test_y_channel": True}}},
        }, ".", is_train=False)
        reset_launches()
        test_pipeline(".", opt, device="cuda")
        tested = launches()
        if tested != {k: 2 * fwd[k] for k in KERNELS}:
            raise SystemExit(f"FAIL pipeline: test launches {tested}")
        lq_dir = os.path.join(DATA, "val", "lq")
        out_dir = os.path.join(PIPE, "cli")
        t3 = time.perf_counter()
        subprocess.run([sys.executable, "inference_torch.py", "--model_path",
                        ckpt, "--arch", "MambaSISR6", "-i", lq_dir, "-o",
                        out_dir, "--scale", "4", "--device", "cuda"],
                       check=True)
        t4 = time.perf_counter()
    for name in sorted(os.listdir(lq_dir)):
        stem = os.path.splitext(name)[0]
        lq = imread(os.path.join(lq_dir, name))
        for out in (os.path.join(res, "visualization", "synthetic val",
                                 name),
                    os.path.join(out_dir, f"{stem}_out.png")):
            img = imread(out)
            if img.shape != (4 * lq.shape[0], 4 * lq.shape[1], 3):
                raise SystemExit(f"FAIL pipeline: {out} is {img.shape} for "
                                 f"an LQ of {lq.shape}")
    print(f"[pipeline] test_pipeline and inference_torch.py --device cuda "
          f"(subprocess, {t4 - t3:.1f} s): outputs 4x their LQ; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: first[k] + resumed[k] + tested[k] for k in KERNELS}


def main():
    t0 = time.perf_counter()
    os.environ.update({k: "0" for k in SWITCHES})
    os.environ.pop("VMAMBAIR_EFFN_FUSED", None)
    probe()
    build()
    stats = kernels_vs_plain()
    for fused in (False, True):
        model_vs_plain(fused)
        model_grads_vs_plain(fused)
    serve_counts = serve()
    train_counts = train()
    pipe_counts = pipeline()
    kernels = []
    for name, k in KERNELS.items():
        n = serve_counts[name] + train_counts[name] + pipe_counts[name]
        if n == 0 or pipe_counts[name] == 0:
            raise SystemExit(f"FAIL: {name} never launched on a main path")
        kernels.append(dict(
            name=name, route="cuda", source=k["source"],
            replaces=k["replaces"], launches=n,
            launches_serve=serve_counts[name],
            launches_train=train_counts[name],
            launches_pipeline=pipe_counts[name], **stats[name]))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
