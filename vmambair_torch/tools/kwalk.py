"""The register walk's design variants (csrc/scan_seq.cu: K7 and kseq's
probes) raced against the shipped kernel on one card.

    python -m vmambair_torch.tools.kwalk [variants] [--device cuda|cpu]

Each variant is the shipped source with a few edits (`VARIANTS`: the
edits and what each tries), built alone by `nvcc` for sm_90a into
`build/kwalk/<name>/` (all builds started together) and loaded through
ctypes with `_build.SIGNATURES`. The calls go through the port's own
wrappers (`kvariants.run_seq` on DL views in windows of 8, K7 through
`kvariants.run_seq_ld`), with `_build.launch` pointed at the variant's
library for the call; the segment is the shipped rule's at every variant
(128 at the probe shape on the H100). At kvariants' probe shape (8,
16384, 2 x 96, N = 16), bf16, the model-realistic recipe: each variant's
y is held to the plain scan within the bf16 envelope, then all are raced
interleaved (`tools.race`, CUDA-event medians). One JSON row per variant:
its ms on both layouts, the ratio to the shipped kernel's, its largest
error, its own residency (`vmt_scan_seq_resident` at N = 16, window 8)
and the ptxas report of the (16 states, window 8) walks (registers and
spill bytes of pass 1 and pass 3); then the card's name and power limit.

On `cpu` (no `nvcc`, no card) it checks only that every variant's edits
apply to the current source, each exactly once, and prints the names.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess

import torch

from .. import _build
from ..ops import cuda_scan
from . import check_envelope, device_of, kvariants, race

BUILD_DIR = os.path.join(os.path.dirname(_build.DEFAULT_BUILD_DIR), "kwalk")
REPEATS = 15
POOL = 3

# the next window's raw bits held in registers while the current one is
# walked (the walks of at most 16 states; the register passes keep `stage`)
_FETCH = r"""
  uint32_t pu[WCAP], pd[WCAP], pb[EB], pc[EB];
  auto fetch = [&](int k, int lt) {
    const int t0 = first_pos(k), len = min(win, s0 + slen - t0);
    auto act = [&](uint32_t (&r)[WCAP], const void* p, int dt, bool lfast,
                   long long base, long long sx, long long sl) {
      const LaneMap m = act_map<WCAP>(lfast, lt);
      auto ok = [&](int e) {
        return m.x0 + m.xs * e < tc && m.t0 + m.ts * e < len;
      };
      ld_raw_step(r, p, dt, base + m.x0 * sx + (t0 + m.t0) * sl,
                  m.xs * sx + m.ts * sl, ok);
    };
    act(pu, a.u, a.u_dt, u_lfast, ub, a.su_d, a.su_l);
    act(pd, a.dl, a.d_dt, d_lfast, db, a.sd_d, a.sd_l);
    auto rows = [&](uint32_t (&r)[EB], const void* p, int dt, bool lfast,
                    long long base, long long sn, long long sl) {
      const LaneMap m = bc_map<NS, WCAP>(lfast, lt);
      auto ok = [&](int e) {
        return m.x0 + m.xs * e < N && m.t0 + m.ts * e < len;
      };
      ld_raw_step(r, p, dt, base + m.x0 * sn + (t0 + m.t0) * sl,
                  m.xs * sn + m.ts * sl, ok);
    };
    rows(pb, a.Bm, a.b_dt, b_lfast, bb, a.sb_n, a.sb_l);
    if (WRITE_Y) rows(pc, a.Cm, a.c_dt, c_lfast, cb, a.sc_n, a.sc_l);
  };
  auto put = [&](int k, int lt) {
    const int t0 = first_pos(k), len = min(win, s0 + slen - t0);
    auto act = [&](float* w, const uint32_t (&r)[WCAP], int dt,
                   bool lfast) {
      const LaneMap m = act_map<WCAP>(lfast, lt);
#pragma unroll
      for (int e = 0; e < WCAP; ++e) {
        if (m.x0 + m.xs * e < tc && m.t0 + m.ts * e < len) {
          w[(m.t0 + m.ts * e) * SEQ_TP + m.x0 + m.xs * e] = raw_f32(r[e], dt);
        }
      }
    };
    act(u_s, pu, a.u_dt, u_lfast);
    act(d_s, pd, a.d_dt, d_lfast);
    auto rows = [&](float* w, const uint32_t (&r)[EB], int dt, bool lfast) {
      const LaneMap m = bc_map<NS, WCAP>(lfast, lt);
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        if (m.x0 + m.xs * e < N && m.t0 + m.ts * e < len) {
          w[(m.t0 + m.ts * e) * np + m.x0 + m.xs * e] = raw_f32(r[e], dt);
        }
      }
    };
    rows(b_s, pb, a.b_dt, b_lfast);
    if (WRITE_Y) rows(c_s, pc, a.c_dt, c_lfast);
  };

  for (int k = 0; k < nwin; ++k) {"""

_STAGE_PF = """    if constexpr (PASSES) {
      stage(k, lt);
    } else {
      if (k == 0) fetch(0, lt);
      put(k, lt);
      if (k + 1 < nwin) fetch(k + 1, lt);  // in flight during the walk
    }
"""

# 2^x on the FMA pipe (Cephes' exp2f: x = i + f, |f| <= 1/2, 2^f = 1 + f
# P(f)); x <= 0 here (delta > 0, A < 0), clamped at -126
_EXP2_FMA = """__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float i = rintf(x), f = x - i;
  float p = 1.535336188319500e-4f;
  p = fmaf(p, f, 1.339887440266574e-3f);
  p = fmaf(p, f, 9.618437357674640e-3f);
  p = fmaf(p, f, 5.550332471162809e-2f);
  p = fmaf(p, f, 2.402264791363012e-1f);
  p = fmaf(p, f, 6.931472028550421e-1f);
  return fmaf(p, f, 1.f) * __int_as_float(((int)i + 127) << 23);
}

// softplus, linear above 20"""

_MINB = "constexpr int SEQ_MIN_BLOCKS = 16;"

# name -> (what it tries, [(text in the shipped source, its replacement)])
VARIANTS = {
    "shipped": ("the shipped kernel", []),
    "prefetch": (
        "the next window's raw bits loaded into registers before the "
        "current window is walked, in flight during its walk",
        [("\n  for (int k = 0; k < nwin; ++k) {", _FETCH),
         ("    stage(k, lt);\n", _STAGE_PF)]),
    "minb20": ("__launch_bounds__ for 20 resident warps an SM (fewer "
               "registers a thread)",
               [(_MINB, _MINB.replace("16", "20"))]),
    "minb24": ("__launch_bounds__ for 24 resident warps an SM",
               [(_MINB, _MINB.replace("16", "24"))]),
    "minb32": ("__launch_bounds__ for 32 resident warps an SM",
               [(_MINB, _MINB.replace("16", "32"))]),
    "exp2_fma": (
        "half of each position's exp2s by a polynomial on the FMA pipe, "
        "half on the SFU",
        [("// softplus, linear above 20", _EXP2_FMA),
         ("ex[j] = exp2_ftz(dv * a2[j]);",
          "ex[j] = j < NS / 2 ? exp2_ftz(dv * a2[j]) : "
          "exp2_fma(dv * a2[j]);")]),
}


def source(name: str, text: str) -> str:
    """The shipped source `text` with the variant's edits, each of which
    must match exactly once."""
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"kwalk {name}: {old[:40]!r} matches "
                             f"{text.count(old)} times in scan_seq.cu")
        text = text.replace(old, new)
    return text


def build(names: list) -> dict:
    """Builds every variant at once; name -> (library, nvcc's output)."""
    with open(os.path.join(_build.CSRC, "scan_seq.cu")) as f:
        text = f.read()
    nvcc = _build.find_nvcc()
    cmds, libs = [], []
    for name in names:
        out = os.path.join(BUILD_DIR, name)
        os.makedirs(out, exist_ok=True)
        cu = os.path.join(out, "scan_seq.cu")
        with open(cu, "w") as f:
            f.write(source(name, text))
        libs.append(os.path.join(out, "libkwalk.so"))
        cmds.append([nvcc, *_build.NVCC_FLAGS, *_build.LINK_FLAGS, "-I",
                     _build.CSRC, cu, "-o", libs[-1]])
    built = {}
    for name, lib, (_, rc, log) in zip(names, libs,
                                       _build._run_all(cmds)):
        if rc != 0:
            raise RuntimeError(f"kwalk {name}: nvcc failed ({rc}):\n{log}")
        dll = ctypes.CDLL(lib)
        for fn in ("vmt_scan_seq_fwd", "vmt_scan_seq_resident"):
            getattr(dll, fn).argtypes = _build.SIGNATURES[fn]
            getattr(dll, fn).restype = ctypes.c_int
        built[name] = (dll, log)
    return built


def ptxas(log: str) -> dict:
    """Registers and spill bytes (stores + loads) of the (16 states,
    window 8) walks, pass 1 and pass 3, from nvcc's -Xptxas -v output."""
    out = {}
    for walk, flag in (("pass1", "Lb0EEEv"), ("pass3", "Lb1EEEv")):
        m = re.search(r"scan_seq_kernelILi16ELi8ELb0E" + flag +
                      r".*?(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads\s*ptxas info\s*: Used (\d+) registers", log,
                      re.S)
        if m:
            out[f"regs_{walk}"] = int(m.group(3))
            out[f"spill_bytes_{walk}"] = int(m.group(1)) + int(m.group(2))
    return out


def through(dll, fn):
    """fn(), with the wrappers' launches going to the library `dll`."""
    def launch(name, device, *args):
        with torch.cuda.device(device):
            err = getattr(dll, name)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        _build.check(err, name)

    saved = _build.launch
    _build.launch = launch
    try:
        return fn()
    finally:
        _build.launch = saved


def _inputs(seed: int, dev) -> dict:
    inp = kvariants.make_inputs(kvariants.Shape(**kvariants.SHAPE), seed,
                                dev, "real")
    for k in ("u", "delta", "Bm", "Cm", "u_ld", "delta_ld"):
        inp[k] = inp[k].to(torch.bfloat16)
    return inp


def run(names: list, device) -> list:
    if device.type != "cuda":
        with open(os.path.join(_build.CSRC, "scan_seq.cu")) as f:
            text = f.read()
        for name in names:
            source(name, text)
        return [{"variant": n, "edits_apply": True} for n in names]
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    names = ["shipped"] + [n for n in names if n != "shipped"]
    built = build(names)
    # the shipped rule's segment for every variant: the residency asked of
    # the shipped library first (and kept by seq_resident's cache)
    through(built["shipped"][0],
            lambda: cuda_scan.seq_resident(device, 16, 8))
    pool = [_inputs(7 + i, device) for i in range(POOL)]
    ref = kvariants.run_reference(pool[0])
    layouts = {"dl_w8": lambda i: kvariants.run_seq(i, False, 8),
               "k7": lambda i: kvariants.run_seq_ld(i)}
    rows, calls = {}, {}
    for name in names:
        dll, log = built[name]
        res = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(dll.vmt_scan_seq_resident(
                16, 8, ctypes.addressof(res), None), name)
        row = {"variant": name, "what": VARIANTS[name][0],
               "resident_warps": res.value, **ptxas(log)}
        for lay, fn in layouts.items():
            got = through(dll, lambda fn=fn: fn(pool[0]))
            row[f"{lay}_max_abs_err"] = check_envelope(
                f"kwalk {name} {lay}", got, ref)[0]
            calls[f"{name} {lay}"] = (
                lambda i, dll=dll, fn=fn: through(dll, lambda: fn(i)))
        rows[name] = row
    times = race(calls, pool, REPEATS)
    for name, row in rows.items():
        for lay in layouts:
            row[f"{lay}_ms"] = statistics.median(times[f"{name} {lay}"])
            row[f"{lay}_vs_shipped"] = (
                row[f"{lay}_ms"] / statistics.median(times[f"shipped {lay}"]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return [*rows.values(), {"card": card.strip()}]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.names, device_of(args.device)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
