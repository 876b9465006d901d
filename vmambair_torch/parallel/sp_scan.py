"""Sequence-parallel selective scan over a process group.

The port's counterpart of `vmambair_tpu/parallel/sp_scan.py`: the sequence
axis L is cut into one contiguous shard per rank, each rank scans its
shard, and the shards' carries are joined exactly:

1. pass 1: the shard from a zero state -> its last state S_r (K4's state
   form, `cuda_scan.selective_scan_fwd_state`);
2. the shard's transition is the affine map h_out = P_r h_in + S_r with
   P_r = exp(A sum_shard(delta)) (in (0, 1], fp32); the state entering
   shard r is the fold of the maps of shards 0 .. r - 1 from zero. JAX
   composes them with a log-step ppermute chain (:35-56); here every rank
   all-gathers the world's (P, S) pairs, (B, D, N) each, and folds them in
   rank order, which is as exact and moves a few KB;
3. pass 2: the shard again from that entering state, writing y.

On the CPU the plain chunked scan with `h0` runs both passes. There is no
backward: a call that autograd would record raises (the sp backward is
left for later, K3 from an entering state and the last state's
cotangent).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .._build import grad_needed
from ..ops.cuda_scan import selective_scan_fwd_state


def _entering_state(S: torch.Tensor, P: torch.Tensor, group) -> torch.Tensor:
    """The state entering this rank's shard: the fold of the earlier
    ranks' maps (P, S), h <- P h + S from zero, in rank order."""
    world = dist.get_world_size(group)
    me = dist.get_rank(group)
    pair = torch.stack([P, S])
    parts = [torch.empty_like(pair) for _ in range(world)]
    dist.all_gather(parts, pair, group=group)
    h = torch.zeros_like(S)
    for r in range(me):
        h = parts[r][0] * h + parts[r][1]
    return h


def selective_scan_sp(u, delta, A, B, C, D=None, delta_bias=None,
                      delta_softplus: bool = False, *, group=None):
    """The scan of this rank's L shard, joined with the other ranks'
    (JAX's `selective_scan_sp`, :59-117). Layouts as `selective_scan`:
    u, delta (batch, Ls, dim) of the shard; A (dim, N) fp32; B, C (batch,
    Ls, G, N); D, delta_bias (dim,). Returns the shard's y in u's dtype.
    `group`: the process group (the default group where None); a forward
    scan, shard r holding positions r Ls .. (r + 1) Ls - 1."""
    if grad_needed(u, delta, A, B, C, D, delta_bias):
        raise RuntimeError(
            "selective_scan_sp: the sequence-parallel scan has no backward "
            "yet; run it under torch.no_grad()")
    # pass 1: from zero, for the shard's last state
    _, S = selective_scan_fwd_state(u, delta, A, B, C, None, delta_bias,
                                    delta_softplus)
    df = delta.float()
    if delta_bias is not None:
        df = df + delta_bias.float()
    if delta_softplus:
        df = F.softplus(df)
    P = torch.exp(A.float()[None] * df.sum(1)[..., None])  # (batch, dim, N)
    h0 = _entering_state(S, P, group)
    # pass 2: from the state the earlier shards hand on
    y, _ = selective_scan_fwd_state(u, delta, A, B, C, D, delta_bias,
                                    delta_softplus, h0=h0)
    return y


def sharded_scan(u, delta, A, B, C, D=None, delta_bias=None,
                 delta_softplus: bool = False, reverse: bool = False, *,
                 group=None):
    """A whole-sequence scan (every rank holds all of L) run sequence-
    parallel: each rank takes its contiguous shard of L, `selective_scan_sp`
    scans it, and the shards' y are all-gathered back to the full L. A
    reverse scan runs on the flipped sequence, as JAX runs it
    (`pallas_scan.py:1463`). L must divide by the group's size. Returns y
    (batch, L, dim) in u's dtype."""
    world = dist.get_world_size(group)
    me = dist.get_rank(group)
    L = u.shape[1]
    if L % world:
        raise ValueError(f"sharded_scan: L {L} does not divide over {world} "
                         "ranks")
    if reverse:
        u, delta, B, C = (t.flip(1) for t in (u, delta, B, C))
    ls = L // world
    shard = slice(me * ls, (me + 1) * ls)
    y = selective_scan_sp(u[:, shard], delta[:, shard], A, B[:, shard],
                          C[:, shard], D, delta_bias, delta_softplus,
                          group=group)
    if world > 1:
        # gathered along L in (batch, dim, Ls) rows, the kernel's layout
        yt = y.transpose(1, 2).contiguous()
        parts = [torch.empty_like(yt) for _ in range(world)]
        dist.all_gather(parts, yt, group=group)
        y = torch.cat(parts, 2).transpose(1, 2)
    return y.flip(1) if reverse else y


def sp_scan_supported(L: int, group: Optional[dist.ProcessGroup]) -> bool:
    """JAX's rule (:1452): the sp path needs a group and an L that divides
    over it; otherwise the scan takes the normal path."""
    return group is not None and L % dist.get_world_size(group) == 0
