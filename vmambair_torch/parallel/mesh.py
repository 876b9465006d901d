"""Process groups: data parallelism and the sequence-parallel group.

The port's counterpart of `vmambair_tpu/parallel/mesh.py`. JAX trains on
one controller over a mesh whose `data` axis shards the batch; here each
rank is a process with one device, as in the reference trainer (8-process
NCCL DDP), and `torch.distributed` joins them: NCCL for a CUDA device,
gloo for the CPU.

`init_distributed(launcher, device)` reads the launcher's environment:
`pytorch` (torchrun: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) or `slurm` (SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID, with
MASTER_ADDR and MASTER_PORT from the environment). A launcher named
without its variables raises; a failed init is not caught. Each rank takes
`cuda:LOCAL_RANK`.

Without an initialised group every helper here acts as world 1: rank 0,
no collective.

The sequence-parallel group (`set_default_sp_group`, `default_sp_group`,
`use_sp_group`; JAX's `set_default_sp_mesh` and friends, :37-57) is the
group that `scan_impl: "sp"` models shard their spatial scans over; the
models carry no group argument, so the caller installs it around them.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

LAUNCHER_ENV = {
    "pytorch": {"rank": "RANK", "world": "WORLD_SIZE",
                "local": "LOCAL_RANK"},
    "slurm": {"rank": "SLURM_PROCID", "world": "SLURM_NTASKS",
              "local": "SLURM_LOCALID"},
}

# the group `scan_impl: "sp"` shards over: module state set by the caller
# (the CLI) around a forward, as JAX's ambient sp mesh
_DEFAULT_SP: Optional[dist.ProcessGroup] = None


def init_distributed(launcher: str, device="cuda") -> torch.device:
    """Joins the process group of `launcher` ("pytorch" or "slurm") and
    returns this rank's device: `cuda:LOCAL_RANK` (made current) for a
    CUDA `device`, the CPU otherwise. NCCL for CUDA, gloo for the CPU."""
    if launcher not in LAUNCHER_ENV:
        raise ValueError(f"launcher {launcher!r}: pytorch or slurm")
    names = dict(LAUNCHER_ENV[launcher], addr="MASTER_ADDR",
                 port="MASTER_PORT")
    missing = [v for v in names.values() if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"launcher {launcher}: the environment lacks "
            f"{', '.join(missing)} (run under torchrun for pytorch, srun "
            "with MASTER_ADDR and MASTER_PORT set for slurm)")
    env = {k: os.environ[v] for k, v in names.items()}
    rank, world = int(env["rank"]), int(env["world"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env["local"]))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{env['addr']}:{env['port']}", rank=rank,
        world_size=world, device_id=dev if dev.type == "cuda" else None)
    return dev


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """The reference's `master_only` rank: 0."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def local_batch_slice(global_batch: int, world: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """The contiguous rows of a global batch this rank feeds (JAX's
    `local_batch_slice`, :127, and the rows `P("data")` gives a device)."""
    world = world_size() if world is None else world
    index = rank() if index is None else index
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"over {world} ranks")
    per = global_batch // world
    return slice(index * per, (index + 1) * per)


def all_gather_batch(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' slices of a batch, joined along dim 0 in rank order: the
    global batch on every rank (t itself at world 1)."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, 0)


def on_global_batch(fn, *ts):
    """The global-batch rule: `fn` runs on the ranks' slices gathered into
    the global batch (rank order), so that a random draw over the batch
    sees what JAX's single controller sees; every rank draws the same from
    its equally seeded generator. Returns this rank's contiguous rows of
    each of fn's outputs (a tuple)."""
    outs = fn(*(all_gather_batch(t) for t in ts))
    rows = local_batch_slice(outs[0].shape[0])
    return tuple(o[rows] for o in outs)


def reduce_log_dict(log: Dict) -> Dict:
    """The logged losses' mean over the ranks (each a loss of the rank's
    slice, so the mean is the global batch's); other entries as they are.
    One all-reduce; nothing at world 1."""
    keys = [k for k, v in log.items() if torch.is_tensor(v)]
    if world_size() == 1 or not keys:
        return log
    stacked = torch.stack([log[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(stacked)
    stacked /= world_size()
    out = type(log)(log)
    out.update(zip(keys, stacked.unbind()))
    return out


def set_default_sp_group(group: Optional[dist.ProcessGroup]) -> None:
    """Installs (or clears, with None) the group `scan_impl: "sp"` uses."""
    global _DEFAULT_SP
    _DEFAULT_SP = group


def default_sp_group() -> Optional[dist.ProcessGroup]:
    return _DEFAULT_SP


@contextlib.contextmanager
def use_sp_group(group: dist.ProcessGroup):
    """Scopes a sequence-parallel group: a `scan_impl: "sp"` model applied
    inside shards its spatial scans' L over `group`."""
    global _DEFAULT_SP
    prev = _DEFAULT_SP
    _DEFAULT_SP = group
    try:
        yield
    finally:
        _DEFAULT_SP = prev
