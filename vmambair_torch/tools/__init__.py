"""The kernel-design probes, on an NVIDIA GPU: counterparts of the TPU
probes in the repository's `tools/` (`kseq.py`, `kvariants.py`, `kpeak.py`,
`keffn.py`, `kprobe.py`, `kldio.py`), with hand-written sm_90a kernels
(`ops/cuda_probes.py`, `ops/cuda_scan.py`'s K7), and of its range study
`kdualnum.py`.

    python -m vmambair_torch.tools.kvariants [names] [--device cuda|cpu]
    python -m vmambair_torch.tools.kseq [names] [--device cuda|cpu]
    python -m vmambair_torch.tools.kwalk [variants] [--device cuda|cpu]
    python -m vmambair_torch.tools.kpeak [--device cuda|cpu]
    python -m vmambair_torch.tools.keffn [--device cuda|cpu]
    python -m vmambair_torch.tools.kprobe [probes] [--device cuda|cpu]
    python -m vmambair_torch.tools.kldio [--device cuda|cpu]
    python -m vmambair_torch.tools.kdualnum [--device cuda|cpu]

Each probe checks every variant against its plain version before timing
it and prints one JSON row per variant (keffn: per shape; kldio: per
race piece). kwalk races design variants of csrc/scan_seq.cu, each the
shipped source with a few edits, against it. kdualnum prints the TPU tool's rows of the dual scan's
exponent range over one forward of the model. On `cuda` (the default) the times are
CUDA-event medians, every timed call on another input set than the call
before it, all variants interleaved in one process. On `cpu` the shapes
shrink (as the TPU probes' interpret modes shrink them) and the rows carry
the parity check only: the plain versions run there, and a CPU time is no
measure of the card.

This package imports neither JAX nor anything of the JAX package or of the
root `tools/`: it keeps its own copy of their shapes and input recipes.
"""

from __future__ import annotations

import torch

# H100 SXM rates from NVIDIA's data sheet: HBM bytes/s, fp32 FLOP/s outside
# the tensor cores, bf16 and TF32 dense tensor-core FLOP/s (chip_smoke.py's
# bounds use them too)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12
# a rate no data sheet gives: the SFU's nominal 16 exp2 per clock per SM
# (compute capability 9.0) at 132 SMs and 1.98 GHz
SFU_NOMINAL = 16 * 132 * 1.98e9


def device_of(name: str) -> torch.device:
    """The probes' device; `cuda` without a card raises (no fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu "
                           "for the parity checks on the plain versions)")
    return dev


def max_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """Largest absolute difference, and it over the reference's largest
    magnitude."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    return err, err / (ref.abs().max().item() + 1e-30)


# the bf16 envelope of a kernel's output around its plain version: rtol, atol
TOL = (3e-2, 5e-2)


def outside(got: torch.Tensor, ref: torch.Tensor, tol=TOL) -> torch.Tensor:
    """Where got is not finite or further from ref than atol + rtol |ref|."""
    rtol, atol = tol
    got, ref = got.float(), ref.float()
    return ~torch.isfinite(got) | ((got - ref).abs() > atol + rtol * ref.abs())


def check_envelope(name: str, got: torch.Tensor, ref: torch.Tensor,
                   tol=TOL) -> tuple[float, float]:
    """Raises, naming `name`, where got leaves ref's envelope (`outside`);
    else returns `max_err(got, ref)`."""
    bad = outside(got, ref, tol)
    if bad.any():
        raise RuntimeError(
            f"{name} off its plain version on {int(bad.sum())} of "
            f"{bad.numel()} elements (max abs err {max_err(got, ref)[0]:.3e},"
            f" rtol {tol[0]}, atol {tol[1]})")
    return max_err(got, ref)


# device cycles the card sleeps before each timed call (about 0.5 ms at
# 1.98 GHz): longer than any call's host-side launch path, so the call is
# queued before the card reaches it and its events time the card alone
HOLD_CYCLES = 1_000_000


def hold() -> None:
    """Keeps the card busy while the host queues what follows."""
    torch.cuda._sleep(HOLD_CYCLES)


def race(calls: dict, inputs: list, repeats: int) -> dict:
    """CUDA-event times (ms) of every call in `calls` (name -> fn(inputs)),
    interleaved: `repeats` rounds, each over all names, forward order in
    even rounds and backward in odd ones, one warm-up call each first.
    Consecutive calls take consecutive entries of `inputs` (a pool of input
    sets, rotated), so no call finds its inputs left in L2 by the call
    before it. Nothing synchronises between the timed calls, and each is
    queued behind a device sleep (`hold`), so the host runs ahead of the
    card and no call waits for its own launch, however short the call.
    Returns name -> list of ms."""
    names = list(calls)
    k = 0
    for name in names:
        calls[name](inputs[k % len(inputs)])
        k += 1
    events = []
    for r in range(repeats):
        for name in (names if r % 2 == 0 else names[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            inp = inputs[k % len(inputs)]
            k += 1
            hold()
            e0.record()
            calls[name](inp)
            e1.record()
            events.append((name, e0, e1))
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    for name, e0, e1 in events:
        times[name].append(e0.elapsed_time(e1))
    return times
