"""Times two checkouts of the port on one card, interleaved: the kernels a
change touched, at `chip_smoke.py` phase 3's main shapes, and the served
forward of phase 5.

    python -m vmambair_torch.tools.ab --other DIR [--rounds 2]

DIR is another checkout of the repository (for example the parent commit,
unpacked with `git archive` into a directory that `.gitignore` lists). The
two trees run in turns, other, this, this, other, ... (`--rounds` pairs),
each in a process of its own that imports `vmambair_torch` from its tree
and builds that tree's kernels there. Each process prints one JSON row:
the card ms of K1 at (8, 2, 48, 16384) and (8, 2, 96, 16384) bf16, K1c at
(8, 2, 96, 4096) fp32, K2 (8, 48, 128, 128) bf16 and at the other shapes
of a served forward (bf16: `k2_96_ms` (8, 96, 128, 128), `k2_96_64_ms`,
`k2_192_ms`, `k2_384_ms`) and of the S1 step (fp32: `k2f_48_ms` (8, 48,
64, 64), `k2f_96_ms`, `k2f_96_32_ms`, `k2f_192_ms`, `k2f_384_ms`), K5
(8, 96, 128, 128) bf16 and at the other shapes of a served forward
(`k5_48_ms` (8, 48, 128, 128), `k5_96_64_ms`, `k5_192_ms`, `k5_384_ms`)
and at the S1 step's five in fp32 (`k5f_96_ms` (8, 96, 64, 64),
`k5f_48_ms`, `k5f_96_32_ms`, `k5f_192_ms`, `k5f_384_ms`), kprobe's
transpose pair and projections at (8, 16384, 96) bf16 and fp32
(`kprobe_t_ms`, `kprobe_t_f32_ms`, `kprobe_p_ms`, `kprobe_p_f32_ms`; RN =
38, R = 6), K6 at the served forward's (8, 96, 128, 128) bf16 (`k6_ms`)
and the S1 step's (8, 96, 64, 64) fp32 (`k6_f32_ms`) and at their other
four (`k6_48_ms`, `k6_96_64_ms`, `k6_192_ms`, `k6_384_ms`; `k6f_48_ms`,
`k6f_96_32_ms`, `k6f_192_ms`, `k6f_384_ms`), K3 at
every shape of the S1 step (on K1c's fp32
inputs and carries at the fused scans' (8, 2, 96, 4096), (8, 2, 48,
4096), (8, 2, 96, 1024) and (8, 2, 192, 256); on K4c's at the latent
(8, 64, 768) and
the channel scans (8, c, 8), c = 48, 96, 192, 384), each tree's own,
K4 at every shape of a served forward (`k4_latent_ms`: the latent pair
(8, 256, 768) bf16; `k4_ch48_ms` .. `k4_ch384_ms`: the channel scans (8,
c, 8) fp32) and K4c at the S1 step's latent (8, 64, 768) fp32
(`k4c_latent_ms`) and channel scan (8, 96, 8) (`k4c_ch96_ms`), laid out
as the model passes them (CUDA-event medians, each call queued behind a
device sleep, as `tools.race` times), and the served
forward of MambaSISR6 (seeded random weights, 8 bf16 tiles of 128x128;
host-clock ms per forward, median of `FORWARDS` after one warm-up). The
last line is the per-tree median of every number over its processes.

With `--digests` each tree prints instead the sha256 of K1's outputs
(y of `oss_scan_fused_fwd`, y and the carries of K1c) on seeded cases
(`digests`) and of K3's du, ddelta, dB and dC on seeded cases that fit
one of its segments (`k3_digests`; fed by the plain carries,
`selective_scan_carries_ref` on the card, so that they hold K3 alone), and
the last line says which cases differ: a change that must leave K1's or K3's bits as they were is
checked this way. `DIGESTS_FILE` and `K3_DIGESTS_FILE` keep the recorded
builds' digests (their `made_on` names the build) for `chip_smoke.py`
and a CUDA test to hold the current build to; a change that rightly
changes K1's bits records them anew from this tree's row, after K1
passes every check against its plain version.

Only names that every checkout of the port has are used, so this file runs
against older trees: it is run by path, never imported from the other tree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPS = 15
FORWARDS = 6
HOLD_CYCLES = 1_000_000   # as tools.HOLD_CYCLES: about 0.5 ms of device sleep
# K1's digest cases (b, d, L): the serve and train shapes of a direction
# pair, a width that is no multiple of 4 and a ragged L, the widest pair
DIGEST_SHAPES = ((2, 48, 4096), (2, 96, 1000), (1, 202, 300), (2, 256, 64))
DIGESTS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "k1_digests.json")
# K3's digest cases (b, L, D, G, N, dtype, with D skip, bias and softplus):
# each within one segment of K3 (the F2 recipe's shape first; a ragged L
# below a chunk; N over a pass of 16 states; 32 chunks walked in one block)
K3_DIGEST_CASES = ((2, 40, 16, 2, 16, "float32", False),
                   (2, 20, 16, 2, 16, "float32", True),
                   (2, 64, 48, 2, 16, "float32", True),
                   (2, 64, 48, 2, 16, "bfloat16", True),
                   (1, 64, 24, 4, 200, "float32", True),
                   (8, 1024, 1152, 2, 16, "float32", True))
K3_DIGESTS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "k3_digests.json")


def _cases(torch):
    """(name, call) of each kernel, its inputs drawn from seeded generators
    as phase 3 draws them."""
    from vmambair_torch.ops import cuda_effn, cuda_scan
    gen = torch.Generator().manual_seed(0)
    dev = "cuda"
    c, hid = 48, int(48 * 2.66)
    k2 = (
        (0.5 * torch.randn(8, c, 128, 128, generator=gen)).to(dev,
                                                              torch.bfloat16),
        (1 + 0.1 * torch.randn(c, generator=gen)).to(dev),
        (0.1 * torch.randn(c, generator=gen)).to(dev),
        ((torch.rand(2 * hid, c, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
        ((torch.rand(2 * hid, 3, 3, generator=gen) * 2 - 1) / 3).to(dev),
        ((torch.rand(c, hid, generator=gen) * 2 - 1) / hid ** 0.5).to(dev))
    cg = torch.Generator(device=dev).manual_seed(0)
    c = 96

    def r(*shape):
        return torch.rand(*shape, generator=cg, device=dev) * 2 - 1
    k5 = ((0.5 * torch.randn(8, c, 128, 128, generator=cg, device=dev)
           ).to(torch.bfloat16), 1 + 0.1 * r(c), 0.1 * r(c),
          r(2 * c, c) / c ** 0.5, r(2 * c) / c ** 0.5, r(c, 3, 3) / 3,
          r(c) / 3)
    d, N, R, L = 96, 16, 6, 4096
    dt = torch.exp(torch.rand(2, d, generator=gen)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    fused = (
        torch.randn(8, 2, d, L, generator=gen).to(dev),
        ((torch.rand(2, R + 2 * N, d, generator=gen) * 2 - 1)
         / d ** 0.5).to(dev),
        ((torch.rand(2, d, R, generator=gen) * 2 - 1) / R ** 0.5).to(dev),
        (dt + torch.log(-torch.expm1(-dt))).to(dev),
        -torch.arange(1, N + 1.0).expand(2, d, N).contiguous().to(dev),
        torch.ones(2, d, device=dev))
    _, car = cuda_scan.oss_scan_fused_fwd_carries(*fused)
    s, _ = cuda_scan.fused_scan_inputs(*fused)
    dy = torch.randn(8, 2 * d, L, generator=gen).to(dev).transpose(1, 2)
    # K1 at phase 3's serve shape: (8, 2, 48, 16384) bf16, R = 3
    d, R = 48, 3
    dt = torch.exp(torch.rand(2, d, generator=gen)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    k1 = (torch.randn(8, 2, d, 16384, generator=gen).to(dev, torch.bfloat16),
          ((torch.rand(2, R + 2 * N, d, generator=gen) * 2 - 1)
           / d ** 0.5).to(dev),
          ((torch.rand(2, d, R, generator=gen) * 2 - 1) / R ** 0.5).to(dev),
          (dt + torch.log(-torch.expm1(-dt))).to(dev),
          -torch.arange(1, N + 1.0).expand(2, d, N).contiguous().to(dev),
          torch.ones(2, d, device=dev))
    # K1 at the served forward's widest shape: (8, 2, 96, 16384) bf16
    d, R = 96, 6
    dt = torch.exp(torch.rand(2, d, generator=gen)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    k1w = (torch.randn(8, 2, d, 16384, generator=gen).to(dev,
                                                          torch.bfloat16),
           ((torch.rand(2, R + 2 * N, d, generator=gen) * 2 - 1)
            / d ** 0.5).to(dev),
           ((torch.rand(2, d, R, generator=gen) * 2 - 1) / R ** 0.5).to(dev),
           (dt + torch.log(-torch.expm1(-dt))).to(dev),
           -torch.arange(1, N + 1.0).expand(2, d, N).contiguous().to(dev),
           torch.ones(2, d, device=dev))
    k3 = _k3_cases(torch, cuda_scan)
    k2s = _k2_cases(torch)
    k5s = _k5_cases(torch)
    k4s = _k4_cases(torch)
    # kprobe's transpose pair at the probe's (8, 16384, 96), bf16 and fp32
    from vmambair_torch.ops import cuda_probes
    u = torch.randn(8, 16384, 96, generator=cg, device=dev)
    ub = u.to(torch.bfloat16)
    # kprobe's projections at the same shape (RN = 38, R = 6)
    wxp = torch.randn(38, 96, generator=cg, device=dev)
    wdt = torch.randn(96, 6, generator=cg, device=dev)
    # K6 at the five MamberBlock shapes of a served forward (bf16) and of
    # the S1 step (fp32), the main ones first
    k6 = {}
    for name, c, hw, dt in (
            ("k6_ms", 96, 128, torch.bfloat16),
            ("k6_f32_ms", 96, 64, torch.float32),
            ("k6_48_ms", 48, 128, torch.bfloat16),
            ("k6_96_64_ms", 96, 64, torch.bfloat16),
            ("k6_192_ms", 192, 32, torch.bfloat16),
            ("k6_384_ms", 384, 16, torch.bfloat16),
            ("k6f_48_ms", 48, 64, torch.float32),
            ("k6f_96_32_ms", 96, 32, torch.float32),
            ("k6f_192_ms", 192, 16, torch.float32),
            ("k6f_384_ms", 384, 8, torch.float32)):
        k6[name] = (
            torch.randn(8, 2, c, hw * hw, generator=cg, device=dev).to(dt),
            torch.randn(8, c, hw, hw, generator=cg, device=dev).to(dt),
            1 + 0.1 * torch.randn(c, generator=cg, device=dev),
            0.1 * torch.randn(c, generator=cg, device=dev))
    return [
        ("k1_ms", lambda: cuda_scan.oss_scan_fused_fwd(*k1)),
        ("kprobe_t_ms", lambda: cuda_probes.probe_transpose(ub)),
        ("kprobe_t_f32_ms", lambda: cuda_probes.probe_transpose(u)),
        ("kprobe_p_ms", lambda: cuda_probes.probe_proj(ub, wxp, wdt)),
        ("kprobe_p_f32_ms", lambda: cuda_probes.probe_proj(u, wxp, wdt)),
        ("k1_96_ms", lambda: cuda_scan.oss_scan_fused_fwd(*k1w)),
        ("k1c_ms", lambda: cuda_scan.oss_scan_fused_fwd_carries(*fused)),
        ("k2_ms", lambda: cuda_effn.gdfn_residual_fwd(*k2)),
        ("k5_ms", lambda: cuda_effn.oss_front_fwd(*k5)),
        ("k3_ms", lambda: cuda_scan.selective_scan_bwd(
            *s, dy, car, delta_softplus=True))] + [
        (name, lambda a=a: cuda_effn.oss_tail_fwd(*a))
        for name, a in k6.items()] + [
        (name, lambda a=a: cuda_scan.selective_scan_bwd(
            *a, delta_softplus=True)) for name, a in k3] + [
        (name, lambda a=a: cuda_effn.gdfn_residual_fwd(*a))
        for name, a in k2s] + [
        (name, lambda a=a: cuda_effn.oss_front_fwd(*a))
        for name, a in k5s] + [
        (name, lambda f=f, a=a: f(*a, delta_softplus=True))
        for name, f, a in k4s]


def _k4_cases(torch):
    """(name, wrapper, its arguments) of K4 at the shapes of a served
    forward and of K4c at the S1 step's, from a generator of their own,
    laid out as the model passes them: B and C views of x_dbl, whose
    einsum (`models/oss.py`) leaves it in (group, b, L, R + 2N) order; u
    and delta for the latent direction pair (b, L, 2d) views of (b, 2d, L)
    buffers (u bf16 served, fp32 in the step), for the channel scans (8,
    c, 8) fp32 contiguous."""
    from vmambair_torch.ops import cuda_scan
    gen = torch.Generator().manual_seed(6)
    dev, N, out = "cuda", 16, []
    for name, L, D, dtype in (
            ("k4_latent_ms", 256, 768, torch.bfloat16),
            ("k4_ch48_ms", 48, 8, torch.float32),
            ("k4_ch96_ms", 96, 8, torch.float32),
            ("k4_ch192_ms", 192, 8, torch.float32),
            ("k4_ch384_ms", 384, 8, torch.float32),
            ("k4c_latent_ms", 64, 768, torch.float32),
            ("k4c_ch96_ms", 96, 8, torch.float32)):
        R = -(-D // 32)  # dt_rank of d = D / 2 channels to a direction
        M = R + 2 * N
        if D > 8:
            u = torch.randn(8, D, L, generator=gen).to(dev, dtype)
            delta = torch.randn(8, D, L, generator=gen).to(dev)
            u, delta = u.transpose(1, 2), delta.transpose(1, 2)
        else:
            u = torch.randn(8, L, D, generator=gen).to(dev, dtype)
            delta = torch.randn(8, L, D, generator=gen).to(dev)
        xdbl = torch.randn(2, 8, L, M, generator=gen).to(dev).permute(
            1, 2, 0, 3)
        a = (u, delta, -torch.exp(torch.rand(D, N, generator=gen) * 2).to(
                 dev), xdbl[..., R:R + N], xdbl[..., R + N:],
             torch.randn(D, generator=gen).to(dev),
             (torch.rand(D, generator=gen) * 2 - 3).to(dev))
        fn = (cuda_scan.selective_scan_fwd_carries if name.startswith("k4c")
              else cuda_scan.selective_scan_fwd)
        out.append((name, fn, a))
    return out


def _k2_cases(torch):
    """(name, K2's arguments) at the other shapes of a served forward
    (bf16) and at the S1 step's (fp32), from a generator of their own."""
    gen = torch.Generator().manual_seed(4)
    dev, out = "cuda", []
    for name, b, c, hw, dt in (
            ("k2_96_ms", 8, 96, 128, torch.bfloat16),
            ("k2_96_64_ms", 8, 96, 64, torch.bfloat16),
            ("k2_192_ms", 8, 192, 32, torch.bfloat16),
            ("k2_384_ms", 8, 384, 16, torch.bfloat16),
            ("k2f_48_ms", 8, 48, 64, torch.float32),
            ("k2f_96_ms", 8, 96, 64, torch.float32),
            ("k2f_96_32_ms", 8, 96, 32, torch.float32),
            ("k2f_192_ms", 8, 192, 16, torch.float32),
            ("k2f_384_ms", 8, 384, 8, torch.float32)):
        hid = int(c * 2.66)
        out.append((name, (
            (0.5 * torch.randn(b, c, hw, hw, generator=gen)).to(dev, dt),
            (1 + 0.1 * torch.randn(c, generator=gen)).to(dev),
            (0.1 * torch.randn(c, generator=gen)).to(dev),
            ((torch.rand(2 * hid, c, generator=gen) * 2 - 1)
             / c ** 0.5).to(dev),
            ((torch.rand(2 * hid, 3, 3, generator=gen) * 2 - 1) / 3).to(dev),
            ((torch.rand(c, hid, generator=gen) * 2 - 1)
             / hid ** 0.5).to(dev))))
    return out


def _k5_cases(torch):
    """(name, K5's arguments) at the other MamberBlock shapes of a served
    forward (bf16, E = C) and at the S1 step's five (fp32), drawn on the
    card from a generator of their own."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)

    def r(*shape):
        return torch.rand(*shape, generator=gen, device=dev) * 2 - 1
    out = []
    for name, b, c, hw, dt in (
            ("k5_48_ms", 8, 48, 128, torch.bfloat16),
            ("k5_96_64_ms", 8, 96, 64, torch.bfloat16),
            ("k5_192_ms", 8, 192, 32, torch.bfloat16),
            ("k5_384_ms", 8, 384, 16, torch.bfloat16),
            ("k5f_96_ms", 8, 96, 64, torch.float32),
            ("k5f_48_ms", 8, 48, 64, torch.float32),
            ("k5f_96_32_ms", 8, 96, 32, torch.float32),
            ("k5f_192_ms", 8, 192, 16, torch.float32),
            ("k5f_384_ms", 8, 384, 8, torch.float32)):
        out.append((name, (
            (0.5 * torch.randn(b, c, hw, hw, generator=gen, device=dev)
             ).to(dt), 1 + 0.1 * r(c), 0.1 * r(c), r(2 * c, c) / c ** 0.5,
            r(2 * c) / c ** 0.5, r(c, 3, 3) / 3, r(c) / 3)))
    return out


def _k3_cases(torch, cuda_scan):
    """(name, K3's arguments) at the S1 step's other shapes: K1c's inputs
    and carries on a direction pair (8, 2, d, L) fp32, K4c's on the latent
    and the channel scans, from a generator of their own."""
    gen = torch.Generator().manual_seed(3)
    dev, N, out = "cuda", 16, []
    for name, d, L in (("k3_48_ms", 48, 4096), ("k3_1024_ms", 96, 1024),
                       ("k3_256_ms", 192, 256)):
        R = -(-d // 16)
        dt = torch.exp(torch.rand(2, d, generator=gen)
                       * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        fused = (torch.randn(8, 2, d, L, generator=gen).to(dev),
                 ((torch.rand(2, R + 2 * N, d, generator=gen) * 2 - 1)
                  / d ** 0.5).to(dev),
                 ((torch.rand(2, d, R, generator=gen) * 2 - 1)
                  / R ** 0.5).to(dev),
                 (dt + torch.log(-torch.expm1(-dt))).to(dev),
                 -torch.arange(1, N + 1.0).expand(2, d, N).contiguous()
                 .to(dev), torch.ones(2, d, device=dev))
        _, car = cuda_scan.oss_scan_fused_fwd_carries(*fused)
        s, _ = cuda_scan.fused_scan_inputs(*fused)
        dy = torch.randn(8, 2 * d, L, generator=gen).to(dev).transpose(1, 2)
        out.append((name, (*s, dy, car)))
    for name, L, D in (("k3_latent_ms", 64, 768), ("k3_ch48_ms", 48, 8),
                       ("k3_ch96_ms", 96, 8), ("k3_ch192_ms", 192, 8),
                       ("k3_ch384_ms", 384, 8)):
        a = (torch.randn(8, L, D, generator=gen),
             torch.randn(8, L, D, generator=gen),
             -torch.exp(torch.rand(D, N, generator=gen) * 2),
             torch.randn(8, L, 2, N, generator=gen),
             torch.randn(8, L, 2, N, generator=gen),
             torch.randn(D, generator=gen),
             torch.rand(D, generator=gen) * 2 - 3)
        a = tuple(t.to(dev) for t in a)
        _, car = cuda_scan.selective_scan_fwd_carries(*a,
                                                      delta_softplus=True)
        dy = torch.randn(8, L, D, generator=gen).to(dev)
        out.append((name, (*a, dy, car)))
    return out


def _sha(t) -> str:
    import torch
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


def digests() -> dict:
    """label -> sha256 of the bytes of K1's y and of K1c's y and carries,
    for every DIGEST_SHAPES case in fp32 and bf16, forward and reverse,
    the inputs drawn on the host from a generator seeded per case (phase
    3's recipe of `chip_smoke.py`, with A = -exp(2 U(0, 1)) and a random
    D skip)."""
    import torch
    from vmambair_torch.ops import cuda_scan
    out = {}
    for b, d, L in DIGEST_SHAPES:
        for dt in ("float32", "bfloat16"):
            gen = torch.Generator().manual_seed(b * 100000 + d * 1000 + L)
            N, R = 16, -(-d // 16)
            dtb = torch.exp(torch.rand(2, d, generator=gen)
                            * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3))
            args = [torch.randn(b, 2, d, L, generator=gen).to(
                        "cuda", getattr(torch, dt)),
                    (torch.rand(2, R + 2 * N, d, generator=gen) * 2 - 1)
                    / d ** 0.5,
                    (torch.rand(2, d, R, generator=gen) * 2 - 1) / R ** 0.5,
                    dtb + torch.log(-torch.expm1(-dtb)),
                    -torch.exp(torch.rand(2, d, N, generator=gen) * 2),
                    torch.randn(2, d, generator=gen)]
            args[1:] = [a.to("cuda") for a in args[1:]]
            for rev in (False, True):
                key = f"({b},2,{d},{L}) {dt} rev={rev}"
                out[key] = _sha(cuda_scan.oss_scan_fused_fwd(
                    *args, reverse=rev))
                y, car = cuda_scan.oss_scan_fused_fwd_carries(
                    *args, reverse=rev)
                out[key + " K1c y"] = _sha(y)
                out[key + " K1c carries"] = _sha(car)
    return out


def k3_digests() -> dict:
    """label -> sha256 of the bytes of K3's du, ddelta, dB and dC for every
    K3_DIGEST_CASES case, forward and reverse, the inputs drawn on the host
    from a generator seeded per case (u, delta, dy as (b, L, D) views of (b,
    D, L) buffers, as the fused scans pass them), the carries the plain
    version's on the card (`selective_scan_carries_ref`): a source that no
    change to K4c moves."""
    import torch
    from vmambair_torch.ops import cuda_scan
    out = {}
    for b, L, D, G, N, dt, full in K3_DIGEST_CASES:
        gen = torch.Generator().manual_seed(b * 10 ** 7 + L * 10 ** 4 + D)
        dtype = getattr(torch, dt)

        def act():
            return torch.randn(b, D, L, generator=gen).to(
                "cuda", dtype).transpose(1, 2)
        u, delta = act(), act()
        A = -torch.exp(torch.rand(D, N, generator=gen)).to("cuda")
        B, C = (torch.randn(b, L, G, N, generator=gen).to("cuda", dtype)
                for _ in range(2))
        Dsk = torch.randn(D, generator=gen).to("cuda") if full else None
        bias = (torch.rand(D, generator=gen) - 2).to("cuda") if full \
            else None
        dy = act()
        for rev in (False, True):
            kw = dict(delta_softplus=full, reverse=rev)
            _, car = cuda_scan.selective_scan_carries_ref(
                u, delta, A, B, C, Dsk, bias, **kw)
            grads = cuda_scan.selective_scan_bwd(u, delta, A, B, C, Dsk, bias,
                                                 dy, car, **kw)
            key = f"K3 ({b},{L},{D}) G={G} N={N} {dt} full={full} rev={rev}"
            for name, g in zip(("du", "ddelta", "dB", "dC"),
                               (grads[0], grads[1], grads[3], grads[4])):
                out[f"{key} {name}"] = _sha(g)
    return out


def child() -> dict:
    """One tree's row: its kernels' and its served forward's times."""
    import numpy as np
    import torch
    from vmambair_torch.models import build_network
    from vmambair_torch.utils.upscaler import RestorationUpscaler
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("VMAMBAIR_OSS_FRONT", "VMAMBAIR_OSS_TAIL"):
        os.environ[k] = "0"
    row = {}
    cases = _cases(torch)
    for name, fn in cases:
        fn()
    torch.cuda.synchronize()
    events = []
    for r in range(REPS):
        for name, fn in (cases if r % 2 == 0 else cases[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            e0.record()
            fn()
            e1.record()
            events.append((name, e0, e1))
    torch.cuda.synchronize()
    for name, _ in cases:
        row[name] = statistics.median(
            a.elapsed_time(b) for n, a, b in events if n == name)
    del cases
    torch.cuda.empty_cache()
    net = build_network(dict(type="MambaSISR6", dtype=torch.bfloat16),
                        seed=0)
    ups = RestorationUpscaler(4, net, "cuda", tile=128, tile_pad=0,
                              pre_pad=0, tile_batch=8)
    img = np.random.RandomState(200).rand(512, 256, 3).astype(np.float32)
    ups.tile_process(img)
    times = []
    for _ in range(FORWARDS):
        t0 = time.perf_counter()
        ups.tile_process(img)
        times.append(1e3 * (time.perf_counter() - t0))
    row["serve_ms"] = statistics.median(times)
    row["serve_each"] = [round(t, 1) for t in times]
    return row


def _run_child(tag: str, tree: str, extra=()) -> dict:
    """This file's child row, run by path in `tree`'s checkout."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", *extra],
        cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
        capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"ab: the {tag} tree failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--digests", action="store_true",
                    help="K1's output digests of each tree, once each")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps({**digests(), **k3_digests()} if args.digests
                         else child()), flush=True)
        return
    if not args.other:
        ap.error("--other DIR is needed")
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = {"other": os.path.abspath(args.other), "this": this}
    if args.digests:
        rows = {tag: _run_child(tag, path, ["--digests"])
                for tag, path in trees.items()}
        for tag, row in rows.items():
            print(json.dumps(dict(tree=tag, digests=row)), flush=True)
        print(json.dumps(dict(differ=sorted(
            k for k in rows["this"] if rows["this"][k] != rows["other"].get(
                k)), cases=len(rows["this"]))))
        return
    order = []
    for _ in range(args.rounds):
        order += ["other", "this", "this", "other"]
    rows = {k: [] for k in trees}
    for tag in order:
        row = _run_child(tag, trees[tag])
        rows[tag].append(row)
        print(json.dumps(dict(tree=tag, **row)), flush=True)
    keys = [k for k in rows["this"][0] if k.endswith("_ms")]
    print(json.dumps({tag: {k: statistics.median(r[k] for r in rs)
                            for k in keys} for tag, rs in rows.items()}))


if __name__ == "__main__":
    main()
