"""Times two checkouts of the port on one card, interleaved: the kernels a
change touched, at `chip_smoke.py` phase 3's main shapes, and the served
forward of phase 5.

    python -m vmambair_torch.tools.ab --other DIR [--rounds 2]

DIR is another checkout of the repository (for example the parent commit,
unpacked with `git archive` into a directory that `.gitignore` lists). The
two trees run in turns, other, this, this, other, ... (`--rounds` pairs),
each in a process of its own that imports `vmambair_torch` from its tree
and builds that tree's kernels there. Each process prints one JSON row:
the card ms of K2 (8, 48, 128, 128) bf16, K5 (8, 96, 128, 128) bf16 and K3
on the fused scan's (8, 2, 96, 4096) fp32 inputs (CUDA-event medians, each
call queued behind a device sleep, as `tools.race` times), and the served
forward of MambaSISR6 (seeded random weights, 8 bf16 tiles of 128x128;
host-clock ms per forward, median of `FORWARDS` after one warm-up). The
last line is the per-tree median of every number over its processes.

Only names that every checkout of the port has are used, so this file runs
against older trees: it is run by path, never imported from the other tree.
"""

from __future__ import annotations

import argparse
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
    return [("k2_ms", lambda: cuda_effn.gdfn_residual_fwd(*k2)),
            ("k5_ms", lambda: cuda_effn.oss_front_fwd(*k5)),
            ("k3_ms", lambda: cuda_scan.selective_scan_bwd(
                *s, dy, car, delta_softplus=True))]


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child()), flush=True)
        return
    if not args.other:
        ap.error("--other DIR is needed")
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = {"other": os.path.abspath(args.other), "this": this}
    order = []
    for _ in range(args.rounds):
        order += ["other", "this", "this", "other"]
    rows = {k: [] for k in trees}
    for tag in order:
        env = dict(os.environ, PYTHONPATH=trees[tag])
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"],
            cwd=trees[tag], env=env, capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"ab: the {tag} tree failed:\n{out.stderr}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows[tag].append(row)
        print(json.dumps(dict(tree=tag, **row)), flush=True)
    keys = [k for k in rows["this"][0] if k.endswith("_ms")]
    print(json.dumps({tag: {k: statistics.median(r[k] for r in rs)
                            for k in keys} for tag, rs in rows.items()}))


if __name__ == "__main__":
    main()
