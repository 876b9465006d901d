"""Selective-scan entry points: the CUDA kernels K1/K1c, K4/K4c, K3 and
K7, their plain versions, and the autograd Functions that join them.

Counterpart of the dispatch surface of `vmambair_tpu/ops/pallas_scan.py`
(`oss_scan_fused` :1405, `selective_scan` :1428, `fused_scan_supported`
:1237, the custom VJPs `_make_vjp_op` :984 and `_make_fused_vjp_op`
:1263).

Two layers:

- Kernel wrappers, one launch each, each counting its launches in its
  `launches` attribute: `oss_scan_fused_fwd` (K1), `oss_scan_fused_fwd_carries`
  (K1c), `selective_scan_fwd` (K4), `selective_scan_fwd_carries` (K4c),
  `selective_scan_fwd_state` (K4 from an entering state, giving its last
  state: the sequence-parallel scan's passes), `selective_scan_bwd` (K3),
  `selective_scan_ld_fwd` (K7, the channels-last scan). A tensor on the
  CPU goes to the plain version (`*_ref`,
  `selective_scan_bwd_ref`); a CUDA tensor goes to the kernel
  (`csrc/oss_scan_fused.cu`, `csrc/selective_scan.cu`,
  `csrc/selective_scan_bwd.cu`, `csrc/scan_seq.cu`), or the call raises. A
  wrapper has no backward: on CUDA it raises where autograd would need one.
  K7 is wired into no entry point, as JAX wires `_scan_kernel_ld` nowhere.
- The differentiable entry points `selective_scan` and `oss_scan_fused`.
  Without a gradient to record they make one forward launch (K4, K1).
  Otherwise they run an autograd Function: the forward saves the fp32
  state entering each chunk of `CARRY_CHUNK` positions (K4c, K1c), and the
  backward recomputes each chunk from it (K3). The fused op's projection
  recompute and its cotangents stay einsums around K3, as in JAX
  (:1363-1399). On the CPU the same Functions run on the plain versions.

On CUDA every scan goes to a kernel: the JAX thresholds (`min_l=512`, the
`% 8` channel tiling, the channel scan left to XLA) were set by the TPU's
grid overhead and tiling, and eager PyTorch fuses nothing.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import dtype_code, f32, grad_needed, no_grad_needed, on_cpu
from .selective_scan import selective_scan_bwd_ref, selective_scan_chunked

MAX_SCAN_N = 256
MAX_SEQ_N = 16    # states in registers in csrc/scan_seq.cu and scan_lpar.cu
MAX_SEQ_WIN = 16  # positions to a shared-memory window of scan_seq.cu
# K7's window: scan_seq.cu at 16 positions spills its prefetch registers
# (440 bytes in the ptxas report for sm_90a), at 8 it does not
K7_WIN = 8
MAX_FUSED_D = 256
MAX_FUSED_N = 32  # states in registers of K1's passes 1 and 3
# grids one K1 / K1c call launches: the projection, the segments, their
# combine, the segments again (csrc/oss_scan_fused.cu)
K1_GRIDS = 4
# positions per chunk of the kernels (CH in csrc/common.cuh): the carries
# of K1c/K4c and the chunks K3 recomputes from them must agree on it
CARRY_CHUNK = 32
K3_TILE = 8  # at most this many channels to a K3 block (K3_TMAX in C)
K3_MIN_SEG = 64  # K3 cuts no segment shorter than two chunks


def fused_scan_supported(d: int, N: int) -> bool:
    """Whether a spatial direction pair of width d takes K1 (the rest take
    K4), as `fused_scan_supported` decides it in JAX: the in-kernel
    projection contracts over all d, so d stays at most 256; K1's scan
    passes keep a channel's states in registers, so N stays at most 32."""
    return d <= MAX_FUSED_D and N <= MAX_FUSED_N


def n_chunks(L: int) -> int:
    return -(-L // CARRY_CHUNK)


# -- K4 / K4c: the plain grouped scan ------------------------------------------

def selective_scan_ref(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, reverse=False, out_dtype=None):
    """Plain version of `selective_scan_fwd` (chunked, fp32 state)."""
    y = selective_scan_chunked(u, delta, A, B, C, D, delta_bias,
                               delta_softplus, reverse=reverse)
    return y.to(out_dtype or u.dtype)


def selective_scan_carries_ref(u, delta, A, B, C, D=None, delta_bias=None,
                               delta_softplus=False, reverse=False,
                               out_dtype=None):
    """Plain version of `selective_scan_fwd_carries`: y and the fp32 state
    entering each chunk of CARRY_CHUNK positions, (B, D, n_chunks, N)."""
    y, carries = selective_scan_chunked(
        u, delta, A, B, C, D, delta_bias, delta_softplus,
        chunk_size=CARRY_CHUNK, reverse=reverse, return_carries=True)
    return y.to(out_dtype or u.dtype), carries


def _scan_shapes(u, delta, A, B, C, name):
    bsz, L, dim = u.shape
    G, N = B.shape[2], A.shape[1]
    if delta.shape != u.shape or B.shape != (bsz, L, G, N) or (
            C.shape != B.shape) or A.shape != (dim, N):
        raise ValueError(f"{name}: shapes do not agree: u {tuple(u.shape)} "
                         f"delta {tuple(delta.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)}")
    if dim % G or N > MAX_SCAN_N:
        raise ValueError(f"{name}: D={dim} G={G} N={N} not taken by the "
                         f"kernel (D % G == 0, N <= {MAX_SCAN_N})")
    return bsz, L, dim, G, N


def k4_segment(b: int, D: int, G: int, L: int) -> int:
    """Positions to a segment of K4 (`csrc/selective_scan.cu`). One segment
    of 1024 where L fits it: K4 then runs pass 3 alone from a zero state,
    one grid without scratch (every call of the model's main path: the
    latent pairs at L = 256 and 64, the channel scans at L = C <= 384).
    Else K1's rule (`k1_segment`) on its grid of G groups of D / G
    channels."""
    return 1024 if L <= 1024 else k1_segment(b, G, D // G, L)


def k4_workspace(b: int, D: int, L: int, N: int, seg: int) -> int:
    """fp32 scratch of a K4 call over more than one segment, in floats:
    each segment's end state, its decay and its entering state, (b, D,
    ceil(L / seg), N) each. None is needed within one segment."""
    return 3 * b * D * -(-L // seg) * N


def selective_scan_state_ref(u, delta, A, B, C, D=None, delta_bias=None,
                             delta_softplus=False, reverse=False,
                             out_dtype=None, h0=None):
    """Plain version of `selective_scan_fwd_state`: y and the fp32 last
    state (B, D, N), from the entering state h0 (zeros where None)."""
    y, last = selective_scan_chunked(
        u, delta, A, B, C, D, delta_bias, delta_softplus, reverse=reverse,
        h0=h0, return_last_state=True)
    return y.to(out_dtype or u.dtype), last


def _launch_k4(u, delta, A, B, C, D, delta_bias, softplus, reverse,
               out_dtype, carries, h0=None, hlast=None):
    bsz, L, dim, G, N = _scan_shapes(u, delta, A, B, C, "selective_scan")
    for name, t in (("h0", h0), ("hlast", hlast)):
        if t is not None and (t.shape != (bsz, dim, N) or t.dtype !=
                              torch.float32 or not t.is_contiguous()):
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)} "
                             f"{t.dtype}; the kernel takes contiguous fp32 "
                             f"{(bsz, dim, N)}")
    y = torch.empty(bsz, dim, L, dtype=out_dtype or u.dtype, device=u.device)
    seg = k4_segment(bsz, dim, G, L)
    state = h0 is not None or hlast is not None
    work = (torch.empty(k4_workspace(bsz, dim, L, N, seg),
                        dtype=torch.float32, device=u.device)
            if L > seg or state else None)
    A32 = f32(A)
    D32 = None if D is None else f32(D)
    b32 = None if delta_bias is None else f32(delta_bias)
    _build.launch(
        "vmt_selective_scan_fwd", u.device,
        u.data_ptr(), dtype_code(u, "u"), *u.stride(),
        delta.data_ptr(), dtype_code(delta, "delta"), *delta.stride(),
        A32.data_ptr(),
        B.data_ptr(), dtype_code(B, "B"), *B.stride(),
        C.data_ptr(), dtype_code(C, "C"), *C.stride(),
        None if D32 is None else D32.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        y.data_ptr(), dtype_code(y, "out"), *y.stride(),
        None if carries is None else carries.data_ptr(),
        None if work is None else work.data_ptr(),
        None if h0 is None else h0.data_ptr(),
        None if hlast is None else hlast.data_ptr(),
        bsz, L, dim, G, N, seg, int(bool(reverse)), int(bool(softplus)),
    )
    return y.transpose(1, 2)


def selective_scan_fwd(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, reverse=False, out_dtype=None):
    """K4: grouped selective scan, forward. u, delta (B, L, D); A (D, N)
    fp32; B, C (B, L, G, N); D, delta_bias (D,). Returns y (B, L, D) in
    `out_dtype` (default: u's dtype). Inputs may be strided views; on CUDA
    the result is a (B, L, D) view of a (B, D, L) buffer. On CUDA one call
    is one grid where L fits a segment of `k4_segment`, else three (the
    segments from zero, their combine, the segments again), and counts
    one launch."""
    args = (u, delta, A, B, C, D, delta_bias)
    if on_cpu(*args):
        return selective_scan_ref(*args, delta_softplus, reverse, out_dtype)
    no_grad_needed("selective_scan_fwd", *args)
    y = _launch_k4(*args, delta_softplus, reverse, out_dtype, None)
    selective_scan_fwd.launches += 1
    return y


def selective_scan_fwd_carries(u, delta, A, B, C, D=None, delta_bias=None,
                               delta_softplus=False, reverse=False,
                               out_dtype=None):
    """K4c: `selective_scan_fwd` that also returns the fp32 state entering
    each chunk of CARRY_CHUNK positions, (B, D, n_chunks, N), indexed by
    the chunk's position in L (for reverse scans too)."""
    args = (u, delta, A, B, C, D, delta_bias)
    if on_cpu(*args):
        return selective_scan_carries_ref(*args, delta_softplus, reverse,
                                          out_dtype)
    no_grad_needed("selective_scan_fwd_carries", *args)
    bsz, L, dim = u.shape
    carries = torch.empty(bsz, dim, n_chunks(L), A.shape[1],
                          dtype=torch.float32, device=u.device)
    y = _launch_k4(*args, delta_softplus, reverse, out_dtype, carries)
    selective_scan_fwd_carries.launches += 1
    return y, carries


def selective_scan_fwd_state(u, delta, A, B, C, D=None, delta_bias=None,
                             delta_softplus=False, reverse=False,
                             out_dtype=None, h0=None):
    """K4's state form: `selective_scan_fwd` from the entering state h0
    (B, D, N) fp32 (zeros where None), also returning the fp32 last state
    (B, D, N), the state after the scan's last position (position 0 when
    reverse). On CUDA one call is always three grids (the segments from
    zero, their combine from h0, which writes the last state, the segments
    again), within one segment too, and counts one launch. No backward:
    on CUDA it raises where autograd would record the call."""
    args = (u, delta, A, B, C, D, delta_bias)
    if on_cpu(*args, h0):
        return selective_scan_state_ref(*args, delta_softplus, reverse,
                                        out_dtype, h0)
    no_grad_needed("selective_scan_fwd_state", *args, h0)
    bsz, L, dim = u.shape
    hlast = torch.empty(bsz, dim, A.shape[1], dtype=torch.float32,
                        device=u.device)
    y = _launch_k4(*args, delta_softplus, reverse, out_dtype, None,
                   None if h0 is None else h0.contiguous(), hlast)
    selective_scan_fwd_state.launches += 1
    return y, hlast


selective_scan_fwd.launches = 0
selective_scan_fwd_carries.launches = 0
selective_scan_fwd_state.launches = 0


# -- K7 and the scans on (b, g, l, d) views -----------------------------------

def bl_flat(t):
    """A (b, g, l, x) view -> (b, l, g*x), the inverse of `_gld`."""
    b, G, L, x = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, L, G * x)


def scan_views_ref(u, delta, A, B, C, D, delta_bias, softplus, reverse):
    """Plain version of the view-addressed scans (csrc/scan_seq.cu,
    csrc/scan_lpar.cu): u, delta (b, g, l, d) views, B, C (b, g, l, n)
    views of any strides. Returns y as a (b, g, l, d) view in u's dtype."""
    y = selective_scan_chunked(bl_flat(u), bl_flat(delta), A,
                               B.permute(0, 2, 1, 3), C.permute(0, 2, 1, 3),
                               D, delta_bias, softplus, reverse=reverse)
    return _gld(y, u.shape[1])


def view_shapes(name, u, delta, A, B, C, y):
    """Checks the (b, g, l, d) / (b, g, l, n) views a view-addressed kernel
    takes; returns (B, G, L, Dg, N)."""
    bsz, G, L, dg = u.shape
    N = A.shape[1]
    if delta.shape != u.shape or y.shape != u.shape or A.shape != (
            G * dg, N) or B.shape != (bsz, G, L, N) or C.shape != B.shape:
        raise ValueError(f"{name}: shapes do not agree: u {tuple(u.shape)} "
                         f"delta {tuple(delta.shape)} y {tuple(y.shape)} A "
                         f"{tuple(A.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)}")
    if N > MAX_SEQ_N:
        raise ValueError(f"{name}: N={N} over the kernel's {MAX_SEQ_N} "
                         "register states")
    return bsz, G, L, dg, N


def launch_views(name, u, delta, A, B, C, D, delta_bias, y, softplus,
                 reverse, extra, buffers=()):
    """Launches the exported C function `name` of a view-addressed scan
    (`vmt_scan_seq_fwd`, `vmt_scan_lpar_fwd`, `vmt_scan_combined_fwd`,
    `vmt_scan_stack_fwd`) on CUDA tensors; y is written in place. `extra`
    is the tuple of the kernel's own sizes ((win,), (seg,), ...);
    `buffers` the further tensors it writes (a second output, scratch),
    passed as pointers after y's."""
    bsz, G, L, dg, N = view_shapes(name, u, delta, A, B, C, y)
    A32 = f32(A)
    D32 = None if D is None else f32(D)
    b32 = None if delta_bias is None else f32(delta_bias)
    _build.launch(
        name, u.device,
        u.data_ptr(), dtype_code(u, "u"), *u.stride(),
        delta.data_ptr(), dtype_code(delta, "delta"), *delta.stride(),
        A32.data_ptr(),
        B.data_ptr(), dtype_code(B, "B"), *B.stride(),
        C.data_ptr(), dtype_code(C, "C"), *C.stride(),
        None if D32 is None else D32.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        y.data_ptr(), dtype_code(y, "out"), *y.stride(),
        *(t.data_ptr() for t in buffers),
        bsz, G, L, dg, N, *extra, int(bool(reverse)), int(bool(softplus)),
    )


def _gld(t, G):
    """(b, l, g*d) -> its (b, g, l, d) view."""
    b, L, dim = t.shape
    return t.view(b, L, G, dim // G).permute(0, 2, 1, 3)


def selective_scan_ld_ref(u, delta, A, B, C, D=None, delta_bias=None,
                          delta_softplus=False, reverse=False, out_dtype=None):
    """Plain version of `selective_scan_ld_fwd`: the chunked scan, as a
    contiguous (B, L, D)."""
    return selective_scan_ref(u, delta, A, B, C, D, delta_bias,
                              delta_softplus, reverse, out_dtype).contiguous()


def selective_scan_ld_fwd(u, delta, A, B, C, D=None, delta_bias=None,
                          delta_softplus=False, reverse=False, out_dtype=None):
    """K7: the grouped selective scan, channels last (JAX
    `_build_pallas_fwd_ld`, pallas_scan.py:557). u, delta (B, L, D); A
    (D, N) fp32, N <= 16; B, C any strided view of (B, L, G, N); D,
    delta_bias (D,). Returns a contiguous y (B, L, D) in `out_dtype`
    (default: u's dtype). On CUDA: the sequential register scan of
    csrc/scan_seq.cu in windows of K7_WIN positions."""
    args = (u, delta, A, B, C, D, delta_bias)
    if on_cpu(*args):
        return selective_scan_ld_ref(*args, delta_softplus, reverse,
                                     out_dtype)
    no_grad_needed("selective_scan_ld_fwd", *args)
    bsz, L, dim, G, N = _scan_shapes(u, delta, A, B, C, "selective_scan_ld")
    y = torch.empty(bsz, L, dim, dtype=out_dtype or u.dtype, device=u.device)
    launch_views("vmt_scan_seq_fwd", _gld(u, G), _gld(delta, G), A,
                 B.permute(0, 2, 1, 3), C.permute(0, 2, 1, 3), D, delta_bias,
                 _gld(y, G), delta_softplus, reverse, (K7_WIN,))
    selective_scan_ld_fwd.launches += 1
    return y


selective_scan_ld_fwd.launches = 0


# -- K3: the scan backward -----------------------------------------------------

def k3_tile(dg: int) -> int:
    """Channels to a K3 block (one warp each): the largest divisor of the
    group's width dg up to K3_TILE. It sets the layout of the dB/dC
    partials, (B, D / T, N, L), and so the order of their sum."""
    return max(t for t in range(1, min(dg, K3_TILE) + 1) if dg % t == 0)


def k3_segment(b: int, D: int, T: int, L: int) -> int:
    """Positions to a segment of K3. One segment of 1024 where L fits it
    and its grid, b * (D / T) blocks of T warps, gives each of the H100's
    132 SMs two: K3 then runs only its main pass, from dh = 0, and spares
    pass 1 and the combine. Else 1024, halved down to K3_MIN_SEG (64)
    while the grid, b * (D / T) * ceil(L / seg) blocks, has fewer than
    1056 (8 to each SM)."""
    tiles = b * (D // T)
    seg = 1024
    if L <= seg and tiles >= 264:
        return seg
    while seg > K3_MIN_SEG and tiles * -(-L // seg) < 1056:
        seg //= 2
    return seg


def k3_workspace(b: int, D: int, L: int, N: int, seg: int) -> int:
    """fp32 scratch of a K3 call over more than one segment, in floats:
    each segment's handed-on dh, its decay and its entering dh, (b, D,
    ceil(L / seg), N) each."""
    return 3 * b * D * -(-L // seg) * N


def selective_scan_bwd(u, delta, A, B, C, D, delta_bias, dy, carries, *,
                       delta_softplus=False, reverse=False):
    """K3: the gradients of `sum(y * dy)` for y = selective_scan(u, delta,
    A, B, C, D, delta_bias), recomputing each chunk from `carries`, the
    output of K4c/K1c on the same inputs. Returns (du, ddelta, dA, dB, dC,
    dD, dbias) in fp32, shaped as the inputs (du, ddelta as (B, L, D) views
    of (B, D, L) buffers); ddelta is the gradient of the raw delta; dD and
    dbias are None where D and delta_bias are. On CUDA one call is one to
    three grids (`csrc/selective_scan_bwd.cu`: the segments from zero and
    their combine where L spans more than one segment of `k3_segment`,
    then the main pass) and counts one launch."""
    args = (u, delta, A, B, C, D, delta_bias)
    if on_cpu(*args, dy, carries):
        return selective_scan_bwd_ref(*args, dy,
                                      delta_softplus=delta_softplus,
                                      reverse=reverse)
    no_grad_needed("selective_scan_bwd", *args, dy, carries)
    bsz, L, dim, G, N = _scan_shapes(u, delta, A, B, C, "selective_scan_bwd")
    if dy.shape != u.shape:
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)} != u "
                         f"{tuple(u.shape)}")
    if carries.shape != (bsz, dim, n_chunks(L), N) or (
            carries.dtype != torch.float32) or not carries.is_contiguous():
        raise ValueError(
            f"selective_scan_bwd: carries {tuple(carries.shape)} "
            f"{carries.dtype}; the kernels' chunk of {CARRY_CHUNK} needs "
            f"contiguous fp32 {(bsz, dim, n_chunks(L), N)}")
    dg = dim // G
    T = k3_tile(dg)
    seg = k3_segment(bsz, dim, T, L)
    nseg = -(-L // seg)
    dev = u.device
    du = torch.empty(bsz, dim, L, device=dev)
    ddl = torch.empty(bsz, dim, L, device=dev)
    dBp = torch.empty(bsz, dim // T, N, L, device=dev)
    dCp = torch.empty(bsz, dim // T, N, L, device=dev)
    dAp = torch.empty(bsz, nseg, dim, N, device=dev)
    dDp = torch.empty(bsz, nseg, dim, device=dev)
    dbp = torch.empty(bsz, nseg, dim, device=dev)
    work = (torch.empty(k3_workspace(bsz, dim, L, N, seg), device=dev)
            if nseg > 1 else None)
    A32 = f32(A)
    D32 = None if D is None else f32(D)
    b32 = None if delta_bias is None else f32(delta_bias)
    _build.launch(
        "vmt_selective_scan_bwd", dev,
        u.data_ptr(), dtype_code(u, "u"), *u.stride(),
        delta.data_ptr(), dtype_code(delta, "delta"), *delta.stride(),
        A32.data_ptr(),
        B.data_ptr(), dtype_code(B, "B"), *B.stride(),
        C.data_ptr(), dtype_code(C, "C"), *C.stride(),
        None if D32 is None else D32.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        dy.data_ptr(), dtype_code(dy, "dy"), *dy.stride(),
        carries.data_ptr(), du.data_ptr(), ddl.data_ptr(), dBp.data_ptr(),
        dCp.data_ptr(), dAp.data_ptr(), dDp.data_ptr(), dbp.data_ptr(),
        None if work is None else work.data_ptr(),
        bsz, L, dim, G, N, T, seg, int(bool(reverse)),
        int(bool(delta_softplus)),
    )
    selective_scan_bwd.launches += 1
    # partials: channel tiles of a group, then batch and segment (as
    # `_scan_bwd_dl`)
    dB = dBp.view(bsz, G, dg // T, N, L).sum(2).permute(0, 3, 1, 2)
    dC = dCp.view(bsz, G, dg // T, N, L).sum(2).permute(0, 3, 1, 2)
    return (du.transpose(1, 2), ddl.transpose(1, 2),
            dAp.view(bsz * nseg, dim, N).sum(0), dB, dC,
            None if D is None else dDp.view(bsz * nseg, dim).sum(0),
            None if delta_bias is None else dbp.view(bsz * nseg, dim).sum(0))


selective_scan_bwd.launches = 0


# -- K1 / K1c: the projection-fused direction-pair scan -------------------------

def oss_scan_fused_ref(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, *,
                       softplus=True, reverse=False):
    """Plain version of `oss_scan_fused_fwd`: the projection einsums, then
    the chunked scan (JAX's `xla_equiv`, :1287)."""
    b, g, d, l = u2.shape
    args, _ = fused_scan_inputs(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds)
    y = selective_scan_ref(*args, delta_softplus=softplus, reverse=reverse)
    return y.reshape(b, l, g, d).permute(0, 2, 3, 1).to(u2.dtype)


def oss_scan_fused_carries_ref(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, *,
                               softplus=True, reverse=False):
    """Plain version of `oss_scan_fused_fwd_carries`: y and the fp32 state
    entering each chunk, (B, G*D, n_chunks, N)."""
    b, g, d, l = u2.shape
    args, _ = fused_scan_inputs(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds)
    y, carries = selective_scan_carries_ref(*args, delta_softplus=softplus,
                                            reverse=reverse)
    return y.reshape(b, l, g, d).permute(0, 2, 3, 1).to(u2.dtype), carries


def k1_segment(b: int, g: int, d: int, L: int) -> int:
    """Positions to a segment of K1's scan passes: 1024 (the L-parallel
    scan's best at the served forward's widest shape, PERF.md), halved
    down to 256 while the grid, b * g * ceil(d / 4) * ceil(L / seg)
    blocks of 4 warps, has fewer than 1056 (8 to each of the H100's 132
    SMs)."""
    seg = 1024
    while seg > 256 and b * g * -(-d // 4) * -(-L // seg) < 1056:
        seg //= 2
    return seg


def k1_workspace(b: int, g: int, d: int, L: int, N: int, seg: int) -> int:
    """fp32 scratch of one K1 call, in floats: x_dbl's B and C rows (b, g,
    2N, L), delta (b, g, d, L), and the segments' end states, decays and
    entering states (b, g*d, ceil(L / seg), N) each."""
    return b * g * L * (2 * N + d) + 3 * b * g * d * -(-L // seg) * N


def launch_k1(name, u, y, weights, pointers, sizes, reverse, softplus):
    """Launches K1's exported C function `name` (`vmt_oss_scan_fused_fwd`
    or kldio's `vmt_oss_scan_fused_ld_fwd`) on contiguous CUDA tensors u
    and y, with its scratch. `weights`: the five fp32 parameter tensors;
    `pointers`: what the function takes after them (K1: the carries'
    pointer or None; kldio's: nothing); `sizes`: (b, g, d, L, N, R)."""
    b, g, d, L, N, R = sizes
    seg = k1_segment(b, g, d, L)
    work = torch.empty(k1_workspace(b, g, d, L, N, seg), dtype=torch.float32,
                       device=u.device)
    _build.launch(
        name, u.device, u.data_ptr(), dtype_code(u, "u"), y.data_ptr(),
        *(w.data_ptr() for w in weights), *pointers, work.data_ptr(),
        b, g, d, L, N, R, seg, int(bool(reverse)), int(bool(softplus)))


def k1_sizes(name, u, g, d, x_proj_w, dt_proj_w, dt_bias, A, Ds):
    """(N, R) of K1's parameters for G = g groups of d channels; raises
    where they disagree or K1 does not take them."""
    N, R = A.shape[2], dt_proj_w.shape[2]
    if x_proj_w.shape != (g, R + 2 * N, d) or dt_proj_w.shape != (g, d, R) \
            or dt_bias.shape != (g, d) or A.shape != (g, d, N) \
            or Ds.shape != (g, d):
        raise ValueError(f"{name}: parameter shapes do not agree with u "
                         f"{tuple(u.shape)}")
    if not fused_scan_supported(d, N):
        raise ValueError(f"{name}: D={d} N={N} not taken by the kernel "
                         f"(D <= {MAX_FUSED_D}, N <= {MAX_FUSED_N})")
    return N, R


def _launch_k1(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, softplus, reverse,
               with_carries):
    b, g, d, l = u2.shape
    N, R = k1_sizes("oss_scan_fused", u2, g, d, x_proj_w, dt_proj_w,
                    dt_bias, A, Ds)
    u2 = u2.contiguous()
    y = torch.empty_like(u2)
    carries = torch.empty(b, g * d, n_chunks(l), N, dtype=torch.float32,
                          device=u2.device) if with_carries else None
    ws = [f32(t) for t in (x_proj_w, dt_proj_w, dt_bias, A, Ds)]
    launch_k1("vmt_oss_scan_fused_fwd", u2, y, ws,
              (None if carries is None else carries.data_ptr(),),
              (b, g, d, l, N, R), reverse, softplus)
    return y, carries


def oss_scan_fused_fwd(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, *,
                       softplus=True, reverse=False):
    """K1: projection-fused selective scan of G direction layouts, in the
    kernel's layout (JAX's `dl=True` form). u2 (B, G, D, L); x_proj_w
    (G, R+2N, D); dt_proj_w (G, D, R); dt_bias (G, D); A (G, D, N) (already
    -exp(A_log)); Ds (G, D). Returns y (B, G, D, L) in u2's dtype. On CUDA
    one call is K1_GRIDS grids (the projection, then the segmented scan)
    and counts one launch."""
    args = (u2, x_proj_w, dt_proj_w, dt_bias, A, Ds)
    if on_cpu(*args):
        return oss_scan_fused_ref(*args, softplus=softplus, reverse=reverse)
    no_grad_needed("oss_scan_fused_fwd", *args)
    y, _ = _launch_k1(*args, softplus, reverse, False)
    oss_scan_fused_fwd.launches += 1
    return y


def oss_scan_fused_fwd_carries(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, *,
                               softplus=True, reverse=False):
    """K1c: `oss_scan_fused_fwd` that also returns the fp32 state entering
    each chunk, (B, G*D, n_chunks, N): the layout of K4c's carries."""
    args = (u2, x_proj_w, dt_proj_w, dt_bias, A, Ds)
    if on_cpu(*args):
        return oss_scan_fused_carries_ref(*args, softplus=softplus,
                                          reverse=reverse)
    no_grad_needed("oss_scan_fused_fwd_carries", *args)
    out = _launch_k1(*args, softplus, reverse, True)
    oss_scan_fused_fwd_carries.launches += 1
    return out


oss_scan_fused_fwd.launches = 0
oss_scan_fused_fwd_carries.launches = 0


# -- the differentiable entry points -------------------------------------------

class _SelectiveScan(torch.autograd.Function):
    """K4c forward, K3 backward (JAX `_make_vjp_op`)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, softplus, reverse,
                out_dtype):
        y, carries = selective_scan_fwd_carries(
            u, delta, A, B, C, D, delta_bias, softplus, reverse, out_dtype)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, carries)
        ctx.flags = (softplus, reverse)
        return y

    @staticmethod
    def backward(ctx, dy):
        *ins, carries = ctx.saved_tensors
        softplus, reverse = ctx.flags
        grads = selective_scan_bwd(*ins, dy, carries,
                                   delta_softplus=softplus, reverse=reverse)
        return (*(None if g is None else g.to(t.dtype)
                  for g, t in zip(grads, ins)), None, None, None)


class _OssScanFused(torch.autograd.Function):
    """K1c forward; K3 backward between the projection recompute and the
    projection cotangents (JAX `_make_fused_vjp_op`, :1341-1399)."""

    @staticmethod
    def forward(ctx, u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, softplus,
                reverse):
        y, carries = oss_scan_fused_fwd_carries(
            u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, softplus=softplus,
            reverse=reverse)
        ctx.save_for_backward(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds,
                              carries)
        ctx.flags = (softplus, reverse)
        return y

    @staticmethod
    def backward(ctx, gy):
        u2, xw, dw, db, A, Ds, carries = ctx.saved_tensors
        softplus, reverse = ctx.flags
        b, g, d, l = u2.shape
        N = A.shape[2]
        uf, xwf, dwf = u2.float(), xw.float(), dw.float()
        scan_args, dts_r = fused_scan_inputs(u2, xw, dw, db, A, Ds)
        du, ddel, dA, dB, dC, dD, dbias = selective_scan_bwd(
            *scan_args, _bld(gy), carries, delta_softplus=softplus,
            reverse=reverse)
        ddel_g = ddel.transpose(1, 2).reshape(b, g, d, l)
        ddw = torch.einsum("bgdl,bgrl->gdr", ddel_g, dts_r)
        ddts_r = torch.einsum("gdr,bgdl->bgrl", dwf, ddel_g)
        dx_dbl = torch.cat([ddts_r, dB.permute(0, 2, 3, 1),
                            dC.permute(0, 2, 3, 1)], 2)  # (b, g, R+2N, l)
        du2 = du.transpose(1, 2).reshape(b, g, d, l) + torch.einsum(
            "gcd,bgcl->bgdl", xwf, dx_dbl)
        dxw = torch.einsum("bgcl,bgdl->gcd", dx_dbl, uf)
        return (du2.to(u2.dtype), dxw.to(xw.dtype), ddw.to(dw.dtype),
                dbias.reshape(g, d).to(db.dtype),
                dA.reshape(g, d, N).to(A.dtype),
                dD.reshape(g, d).to(Ds.dtype), None, None)


def _bld(t):
    """(b, g, c, l) -> a (b, l, g*c) view of its (b, g*c, l) form."""
    return t.reshape(t.shape[0], -1, t.shape[-1]).transpose(1, 2)


def fused_scan_inputs(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds):
    """The projections K1 fuses, in plain PyTorch (fp32): the arguments of
    the scan inside `oss_scan_fused` (u, the raw delta, A, B, C, D, bias;
    u, delta, B, C as (b, l, .) views of the kernel's (b, ., l) layout),
    and the projected dt rows (b, g, R, l). The plain fused scan runs on
    them, and the backward recomputes them (JAX :1363-1367) for K3 and the
    projection cotangents."""
    b, g, d, l = u2.shape
    N, R = A.shape[2], dt_proj_w.shape[2]
    x_dbl = torch.einsum("gcd,bgdl->bgcl", x_proj_w.float(), u2.float())
    dts_r = x_dbl[:, :, :R]
    draw = torch.einsum("gdr,bgrl->bgdl", dt_proj_w.float(), dts_r)
    return (_bld(u2), _bld(draw), A.reshape(g * d, N),
            x_dbl[:, :, R:R + N].permute(0, 3, 1, 2),
            x_dbl[:, :, R + N:].permute(0, 3, 1, 2), Ds.reshape(-1),
            dt_bias.reshape(-1)), dts_r


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus=False, reverse=False, out_dtype=None):
    """Grouped selective scan, differentiable. Layouts as
    `selective_scan_fwd`. Without a gradient to record: one K4 launch (the
    plain version on the CPU); otherwise K4c forward and K3 backward."""
    args = (u, delta, A, B, C, D, delta_bias)
    if grad_needed(*args):
        return _SelectiveScan.apply(*args, bool(delta_softplus),
                                    bool(reverse), out_dtype)
    return selective_scan_fwd(*args, delta_softplus, reverse, out_dtype)


def oss_scan_fused(u2, x_proj_w, dt_proj_w, dt_bias, A, Ds, *,
                   softplus=True, reverse=False):
    """Projection-fused direction-pair scan, differentiable. Layouts as
    `oss_scan_fused_fwd`. Without a gradient to record: one K1 launch (the
    plain version on the CPU); otherwise K1c forward and K3 backward."""
    args = (u2, x_proj_w, dt_proj_w, dt_bias, A, Ds)
    if grad_needed(*args):
        return _OssScanFused.apply(*args, bool(softplus), bool(reverse))
    return oss_scan_fused_fwd(*args, softplus=softplus, reverse=reverse)
