"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Every `csrc/*.cu` is compiled by its own `nvcc` for Hopper (`sm_90a`), all
of them at once, and the objects are linked into one shared library with
a plain C interface. The library lands in a build
directory keyed by a hash of the sources and the flags, so an unchanged
checkout builds once. The default directory is `build/vmambair_torch/` at
the repository root (listed in `.gitignore`); `VMAMBAIR_TORCH_BUILD_DIR`
overrides it. A missing `nvcc` or a failed build raises.

It also holds the rules the kernel wrappers share at the ctypes boundary:
tensors all on the CPU go to the plain version, all on CUDA go to the
kernel, any mix raises (`on_cpu`); a kernel wrapper has no backward, so on
CUDA it raises where autograd would need one (`no_grad_needed`; the
autograd Functions call the wrappers with grad mode off); activations are
fp32 or bf16 (`dtype_code`); small parameters pass as contiguous fp32
(`f32`); a launch runs with its tensors' device current, on that device's
current stream, and raises on a CUDA error (`launch`).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
DEFAULT_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "vmambair_torch",
)
CUDA_HOME_DEFAULT = "/usr/local/cuda"
LIB_NAME = "libvmambair_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# argument types of each exported C function (pointers and the stream as
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int)
SIGNATURES = {
    "vmt_oss_scan_fused_fwd": [
        _P, _I, _P, _P, _P, _P, _P, _P,          # u, dt, y, wxp..Ds
        _P,                                      # carries (K1c) or None
        _P,                                      # work (scratch)
        _I, _I, _I, _I, _I, _I,                  # B G D L N R
        _I, _I, _I, _P,                          # seg rev sp stream
    ],
    "vmt_oss_scan_fused_ld_fwd": [
        _P, _I, _P, _P, _P, _P, _P, _P,          # u, dt, y, wxp..Ds
        _P,                                      # work (scratch)
        _I, _I, _I, _I, _I, _I,                  # B G D L N R
        _I, _I, _I, _P,                          # seg rev sp stream
    ],
    "vmt_selective_scan_fwd": [
        _P, _I, _LL, _LL, _LL,                   # u (B, L, D)
        _P, _I, _LL, _LL, _LL,                   # delta (B, L, D)
        _P,                                      # A
        _P, _I, _LL, _LL, _LL, _LL,              # B (B, L, G, N)
        _P, _I, _LL, _LL, _LL, _LL,              # C (B, L, G, N)
        _P, _P,                                  # Dskip, bias
        _P, _I, _LL, _LL, _LL,                   # y (B, D, L)
        _P,                                      # carries (K4c) or None
        _P,                                      # work (scratch) or None
        _P, _P,                                  # h0, hlast or None
        _I, _I, _I, _I, _I, _I,                  # B L D G N seg
        _I, _I, _P,                              # rev sp stream
    ],
    "vmt_selective_scan_bwd": [
        _P, _I, _LL, _LL, _LL,                   # u (B, L, D)
        _P, _I, _LL, _LL, _LL,                   # delta (B, L, D)
        _P,                                      # A
        _P, _I, _LL, _LL, _LL, _LL,              # B (B, L, G, N)
        _P, _I, _LL, _LL, _LL, _LL,              # C (B, L, G, N)
        _P, _P,                                  # Dskip, bias
        _P, _I, _LL, _LL, _LL,                   # dy (B, L, D)
        _P, _P, _P, _P, _P, _P, _P, _P,          # carries, du .. dbias
        _P,                                      # work (scratch) or None
        _I, _I, _I, _I, _I, _I,                  # B L D G N T
        _I, _I, _I, _P,                          # seg rev sp stream
    ],
    "vmt_scan_seq_fwd": [
        _P, _I, _LL, _LL, _LL, _LL,              # u (b, g, l, d)
        _P, _I, _LL, _LL, _LL, _LL,              # delta (b, g, l, d)
        _P,                                      # A
        _P, _I, _LL, _LL, _LL, _LL,              # B (b, g, l, n)
        _P, _I, _LL, _LL, _LL, _LL,              # C (b, g, l, n)
        _P, _P,                                  # Dskip, bias
        _P, _I, _LL, _LL, _LL, _LL,              # y (b, g, l, d)
        _P,                                      # work (scratch) or None
        _I, _I, _I, _I, _I,                      # B G L Dg N
        _I, _I, _I, _I, _P,                      # win seg rev sp stream
    ],
    "vmt_scan_seq_resident": [
        _I, _I, _P, _P,                          # N win out stream
    ],
    "vmt_scan_lpar_fwd": [
        _P, _I, _LL, _LL, _LL, _LL,              # u (b, g, l, d)
        _P, _I, _LL, _LL, _LL, _LL,              # delta (b, g, l, d)
        _P,                                      # A
        _P, _I, _LL, _LL, _LL, _LL,              # B (b, g, l, n)
        _P, _I, _LL, _LL, _LL, _LL,              # C (b, g, l, n)
        _P, _P,                                  # Dskip, bias
        _P, _I, _LL, _LL, _LL, _LL,              # y (b, g, l, d)
        _P, _P, _P,                              # hend, aend, hin
        _I, _I, _I, _I, _I, _I, _I, _I, _P,      # B G L Dg N seg rev sp stream
    ],
    "vmt_scan_combined_fwd": [
        _P, _I, _LL, _LL, _LL, _LL,              # u (b, g, l, d)
        _P, _I, _LL, _LL, _LL, _LL,              # delta (b, g, l, d)
        _P,                                      # A
        _P, _I, _LL, _LL, _LL, _LL,              # B (b, g, l, n)
        _P, _I, _LL, _LL, _LL, _LL,              # C (b, g, l, n)
        _P, _P,                                  # Dskip, bias
        _P, _I, _LL, _LL, _LL, _LL,              # y (b, g, l, d)
        _P, _P, _P, _P, _P, _P,                  # y2 hend aend hin rtot rdec
        _I, _I, _I, _I, _I, _I, _I, _I, _P,      # B G L Dg N seg rev sp stream
    ],
    "vmt_scan_stack_fwd": [
        _P, _I, _LL, _LL, _LL, _LL,              # u (b, g, l, d)
        _P, _I, _LL, _LL, _LL, _LL,              # delta (b, g, l, d)
        _P,                                      # A
        _P, _I, _LL, _LL, _LL, _LL,              # B (b, g, l, n)
        _P, _I, _LL, _LL, _LL, _LL,              # C (b, g, l, n)
        _P, _P,                                  # Dskip, bias
        _P, _I, _LL, _LL, _LL, _LL,              # y (b, g, l, d)
        _P, _P, _P,                              # hend, aend, hin
        _I, _I, _I, _I, _I,                      # B G L Dg N
        _I, _I, _I, _I,                          # seg sub a_bf16 last_bf16
        _I, _I, _P,                              # rev sp stream
    ],
    "vmt_scan_dual_fwd": [
        _P, _I, _LL, _LL, _LL, _LL,              # u (b, g, l, d)
        _P, _I, _LL, _LL, _LL, _LL,              # delta (b, g, l, d)
        _P,                                      # A
        _P, _I, _LL, _LL, _LL, _LL,              # B (b, g, l, n)
        _P, _I, _LL, _LL, _LL, _LL,              # C (b, g, l, n)
        _P, _P,                                  # Dskip, bias
        _P, _I, _LL, _LL, _LL, _LL,              # y (b, g, l, d)
        _I, _I, _I, _I, _I,                      # B G L Dg N
        _I, _I, _I, _I, _I,                      # sub blk form mid zbf16
        _I, _I, _P,                              # rev sp stream
    ],
    "vmt_peak": [
        _I, _P, _I, _P, _LL, _I, _I, _P,         # probe x dt y rows lanes rep st
    ],
    "vmt_gdfn_residual_fwd": [
        _P, _P, _P, _P, _P, _P, _P,              # x, y, lnw, lnb, packed w
        _I, _I, _I, _I, _I, _I, _F, _P,          # B C H W hp cls eps stream
    ],
    "vmt_gdfn_residual_f32_fwd": [
        _P, _P, _P, _P, _P,                      # x, y, lnw, lnb, wimg
        _I, _I, _I, _I, _I, _I, _I, _F, _P,      # B C H W hp cls split eps st
    ],
    "vmt_gdfn_tanh_nhwc_fwd": [
        _P, _P, _P, _P, _P, _P, _P,              # x, y, lnw, lnb, packed w
        _I, _I, _I, _I, _I, _I, _F, _P,          # B C H W hp cls eps stream
    ],
    "vmt_gdfn_f32_pack": [
        _P, _P, _P, _P, _I, _I, _I, _P,          # w_in w_dw w_out wimg C hid
    ],                                           # cls stream
    "vmt_gdfn_f32_resident": [
        _I, _I, _I, _I, _P, _P,                  # cls C split nhwc out stream
    ],
    "vmt_gdfn_tanh_nhwc_f32_fwd": [
        _P, _P, _P, _P, _P,                      # x, y, lnw, lnb, wimg
        _I, _I, _I, _I, _I, _I, _I, _F, _P,      # B C H W hp cls split eps st
    ],
    "vmt_probe_transpose": [
        _P, _I, _P, _LL, _I, _P,                 # u dt y rows D stream
    ],
    "vmt_probe_proj": [
        _P, _I, _P, _P, _P,                      # u dt y wxp wdt
        _LL, _I, _I, _I, _P,                     # rows D RN R stream
    ],
    "vmt_oss_front_fwd": [
        _P, _P, _P, _P, _P, _P, _P,              # x xs z lnw lnb win_p aux_p
        _I, _I, _I, _I, _I, _I, _F, _P,          # B C E H W cls eps stream
    ],
    "vmt_oss_front_f32_fwd": [
        _P, _P, _P, _P, _P, _P,                  # x xs z lnw lnb wimg
        _I, _I, _I, _I, _I, _I, _F, _P,          # B C E H W cls eps stream
    ],
    "vmt_oss_front_f32_pack": [
        _P, _P, _P, _P, _P,                      # w_in b_in w_dw b_dw wimg
        _I, _I, _I, _P,                          # C E cls stream
    ],
    "vmt_oss_tail_fwd": [
        _P, _I, _P, _I, _P, _P, _P,              # y dty z dtz out lnw lnb
        _I, _I, _I, _I, _I, _F, _P,              # B D H W split eps stream
    ],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda; raises."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(os.path.join(CUDA_HOME_DEFAULT, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{CUDA_HOME_DEFAULT}/bin): the CUDA kernels cannot be built"
    )


def nvcc_commands(nvcc: str, out_dir: str,
                  lib_path: str) -> tuple[list[list[str]], list[str]]:
    """One compile command per source (its object in `out_dir`) and the
    link command that joins the objects into `lib_path`."""
    compiles, objs = [], []
    for src in sources():
        obj = os.path.join(out_dir, os.path.basename(src)[:-3] + ".o")
        compiles.append([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj])
        objs.append(obj)
    return compiles, [nvcc, *LINK_FLAGS, "-o", lib_path, *objs]


def _run_all(cmds: list[list[str]]) -> list[tuple]:
    """Starts every command at once, waits for all of them; returns
    (command, return code, output) for each, in order. (A process whose
    output pipe fills waits until its turn to be read; none waits on
    another.)"""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    out = []
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        out.append((cmd, proc.returncode, text))
    return out


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(build_dir: str | None = None) -> str:
    """Compiles the kernels unless this source hash is already built;
    returns the library's path. The compiler's report (registers, shared
    memory, spills from `-Xptxas -v`) is kept beside it as `build.log`."""
    root = build_dir or os.environ.get(
        "VMAMBAIR_TORCH_BUILD_DIR", DEFAULT_BUILD_DIR)
    out_dir = os.path.join(root, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib):
        return lib
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    # objects, log and library go to a directory of this build's own, so
    # that two processes building the same hash at once never share a
    # file; the finished library and log are then moved in place whole
    tmp = tempfile.mkdtemp(dir=out_dir)
    tmp_lib = os.path.join(tmp, LIB_NAME)
    compiles, link = nvcc_commands(nvcc, tmp, tmp_lib)
    results = _run_all(compiles)
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([link])
    log = os.path.join(tmp, "build.log")
    with open(log, "w") as f:
        for cmd, _, text in results:
            f.write(" ".join(cmd) + "\n" + text)
    os.replace(log, os.path.join(out_dir, "build.log"))
    failed = [(cmd, rc, text) for cmd, rc, text in results if rc != 0]
    if not failed:
        os.replace(tmp_lib, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(cmd)} ({rc}):\n{text}" for cmd, rc, text in failed))
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Builds (if needed) and loads the kernels, with typed signatures."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raises if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    """The C interface's code for an activation dtype; raises for others."""
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    return _DTYPE_CODE[t.dtype]


def f32(t: torch.Tensor) -> torch.Tensor:
    """Small parameter tensors go to the kernel as contiguous fp32."""
    return t.detach().to(torch.float32).contiguous()


def on_cpu(*ts) -> bool:
    """True when every given tensor is on the CPU, False when every one is
    on CUDA; raises for a mix (None entries are skipped)."""
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(devs)}: expected all on cpu or "
                     "all on cuda")


def grad_needed(*ts) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def no_grad_needed(name: str, *ts) -> None:
    """Raises when a kernel wrapper, which has no backward, is asked for a
    result that autograd would need to differentiate: the kernel's output
    would otherwise come back detached and the gradient be lost."""
    if grad_needed(*ts):
        raise RuntimeError(
            f"{name}: a kernel wrapper has no backward; call the "
            "differentiable entry point (or run under torch.no_grad())")


def launch(name: str, device: torch.device, *args) -> None:
    """Calls the exported C function `name` with `args` and the current
    stream of `device`, with `device` made the current one (the runtime
    launches on the current device), and raises on a CUDA error."""
    fn = getattr(load_library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, name)
