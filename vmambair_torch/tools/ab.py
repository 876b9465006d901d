"""Times two checkouts of the port on one card, interleaved: the kernels a
change touched, at `chip_smoke.py` phase 3's main shapes, and the served
forward of phase 5.

    python -m vmambair_torch.tools.ab --other DIR [--rounds 2]

DIR is another checkout of the repository (for example the parent commit,
unpacked with `git archive` into a directory that `.gitignore` lists). The
two trees run in turns, other, this, this, other, ... (`--rounds` pairs),
each in a process of its own that imports `vmambair_torch` from its tree
and builds that tree's kernels there. Each process prints one JSON row:
the card ms of K1 (8, 2, 48, 16384) bf16, K2 (8, 48, 128, 128) bf16, K5
(8, 96, 128, 128) bf16 and K3 on the fused scan's (8, 2, 96, 4096) fp32
inputs (CUDA-event medians, each call queued behind a device sleep, as
`tools.race` times), and the served
forward of MambaSISR6 (seeded random weights, 8 bf16 tiles of 128x128;
host-clock ms per forward, median of `FORWARDS` after one warm-up). The
last line is the per-tree median of every number over its processes.

With `--digests` each tree prints instead the sha256 of K1's outputs
(y of `oss_scan_fused_fwd`, y and the carries of K1c) on seeded cases
(`digests`), and the last line says which cases differ: a change that
must leave K1's bits as they were is checked this way. `DIGESTS_FILE`
keeps one tree's digests for `chip_smoke.py` to hold the current build to.

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
    return [("k1_ms", lambda: cuda_scan.oss_scan_fused_fwd(*k1)),
            ("k2_ms", lambda: cuda_effn.gdfn_residual_fwd(*k2)),
            ("k5_ms", lambda: cuda_effn.oss_front_fwd(*k5)),
            ("k3_ms", lambda: cuda_scan.selective_scan_bwd(
                *s, dy, car, delta_softplus=True))]


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
        print(json.dumps(digests() if args.digests else child()),
              flush=True)
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
