"""The step profiler and model-FLOPs utilisation.

The port's counterpart of `vmambair_tpu/utils/profiling.py` (:74-117),
on `torch.profiler`. In a training YAML:

    train:
      profile_dir: experiments/<name>/trace   # traces iters 10-12
      profile_start: 10                       # the window's first iter
      profile_iters: 3

`StepProfiler` records the CPU and, on a CUDA device, the card over the
window and writes a chrome trace (`trace.json`, with the rank in the name
at world > 1) and a table by kernel and operator (`by_class.txt`,
`event_totals`: the card's kernels and copies by device time first, then
the host's operators by host time) to `profile_dir`. A profiler that
cannot start raises: JAX's turns itself off quietly, which is not carried
over.

`mfu` divides by the NVIDIA H100 SXM's dense peaks (NVIDIA's data sheet,
at its 700 W limit): fp32 on the CUDA cores 67, TF32 on the tensor cores
495, bf16 989 TFLOP/s. The TPU's peaks are not carried over.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Tuple

import torch

logger = logging.getLogger("vmambair_torch")

# dense peak FLOP/s of one NVIDIA H100 SXM (NVIDIA's data sheet)
PEAK_FLOPS = {
    "h100_fp32": 67e12,
    "h100_tf32": 495e12,
    "h100_bf16": 989e12,
}


def mfu(step_flops: float, step_seconds: float,
        peak: str = "h100_bf16") -> float:
    """Model FLOPs utilisation: achieved FLOP/s over the card's peak."""
    return step_flops / step_seconds / PEAK_FLOPS[peak]


def event_totals(prof) -> List[Tuple[str, bool, int, float]]:
    """(name, on the card, calls, total ms) of what the finished
    torch.profiler `prof` recorded, summed by name straight from the
    profiler's raw events, the card's rows first, each part by total
    time. A kernel's or a copy's total is its device time, an operator's
    its host time with what it called (an operator called inside one of
    its own name counts at both levels); device-side ranges (user
    annotations) are left out. `key_averages` gives these sums after
    building the whole call tree, which takes about ten times as long
    (23-31 s for one full-width S1 step traced on an H100 machine)."""
    sums = {}
    for e in prof.profiler.kineto_results.events():
        card = e.device_type() == torch.autograd.DeviceType.CUDA
        if card and e.is_user_annotation():
            continue
        row = sums.setdefault((e.name(), card), [0, 0])
        row[0] += 1
        row[1] += e.duration_ns()
    return sorted(((name, card, n, ns / 1e6)
                   for (name, card), (n, ns) in sums.items()),
                  key=lambda r: (not r[1], -r[3]))


def totals_table(rows, limit: int = 60) -> str:
    """`event_totals` rows as text, the first `limit` of them."""
    lines = [f"{'Name':<80} {'Where':>5} {'Calls':>8} {'Total ms':>12}"]
    lines += [f"{name[:80]:<80} {'card' if card else 'host':>5} {n:>8} "
              f"{ms:>12.3f}" for name, card, n, ms in rows[:limit]]
    return "\n".join(lines) + "\n"


class StepProfiler:
    """Traces iterations start_iter .. start_iter + n_iters - 1 of a
    training loop: `step(current_iter)` before each iteration, `close()`
    after the loop (which also ends a window the run stopped inside)."""

    def __init__(self, logdir: Optional[str], start_iter: int = 10,
                 n_iters: int = 3, device="cuda"):
        self.logdir = logdir
        self.start_iter = start_iter
        self.end_iter = start_iter + n_iters
        self.cuda = torch.device(device).type == "cuda"
        self._prof = None
        self._t0 = 0.0

    def step(self, current_iter: int):
        if not self.logdir:
            return
        if current_iter == self.start_iter and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()  # raises where the profiler cannot start
            self._prof = prof
            self._t0 = time.time()
            logger.info("profiling iters %d-%d -> %s", self.start_iter,
                        self.end_iter - 1, self.logdir)
        elif current_iter == self.end_iter and self._prof is not None:
            self._write()

    def close(self):
        if self._prof is not None:
            self._write()

    def _write(self):
        if self.cuda:
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        sfx = ""
        if torch.distributed.is_initialized() and (
                torch.distributed.get_world_size() > 1):
            sfx = f"_rank{torch.distributed.get_rank()}"
        prof.export_chrome_trace(os.path.join(self.logdir,
                                              f"trace{sfx}.json"))
        rows = event_totals(prof)
        if self.cuda and not any(card and ms > 0 for _, card, _, ms in rows):
            raise RuntimeError(
                "StepProfiler: the trace holds no device time: the profiler "
                "did not record the card (CUPTI unavailable?)")
        with open(os.path.join(self.logdir, f"by_class{sfx}.txt"), "w") as f:
            f.write(totals_table(rows))
        logger.info("profiler trace (%d iters, %.2fs) written -> %s",
                    self.end_iter - self.start_iter, time.time() - self._t0,
                    self.logdir)
