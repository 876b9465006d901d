"""Worlds of CPU processes for the data- and sequence-parallel tests.

`run_world(fn, world, tmp_path, *args)` starts `world` spawned processes,
each joining a gloo group through a `file://` store under `tmp_path` (no
port), runs `fn(rank, world, *args)` in each, and returns the ranks'
results in rank order; a rank that fails, or a world that outlasts
`timeout` seconds, fails the caller. The functions the tests hand it live
here, in a module that imports no JAX, so that a spawned process imports
only torch and the port.
"""

from __future__ import annotations

import multiprocessing
import os
import pathlib
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = 120

TINY_G = {"type": "OSSNet", "dim": 8, "num_blocks": [1, 1, 1, 1],
          "num_refinement_blocks": 1, "scale": 4, "use_bias": False,
          "ln_bias": True}
TINY_D = {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 8}


def rel(a, b):
    """The largest difference over the reference's largest entry."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def sr_opt(tmp_path):
    """A tiny S1 `MambaSISRModel` with mixup, EMA, Adam and a milestone at
    step 2, at `num_gpu: 2`."""
    return {"name": "t_ddp", "model_type": "MambaSISRModel",
            "is_train": True, "scale": 4, "num_gpu": 2, "manual_seed": 0,
            "network_g": dict(TINY_G, scan_impl="xla"),
            "path": {"models": str(tmp_path),
                     "training_states": str(tmp_path)},
            "train": {"total_iter": 10, "ema_decay": 0.999,
                      "mixup": True,
                      "optim_g": {"type": "Adam", "lr": 2e-3,
                                  "weight_decay": 0, "betas": [0.9, 0.99]},
                      "scheduler": {"type": "MultiStepLR",
                                    "milestones": [2], "gamma": 0.5},
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                                    "reduction": "mean"}},
            "val": {"window_size": 8}}


def tiny_train_opt(data, exp, total_iter, num_gpu=1):
    """A tiny S1 YAML's options (OSSNet dim 8; batch 2 per rank, 32x32
    GT crops; no validation) on 4 seeded 48x48 / 12x12 PNG pairs written
    under `data`, the experiment under `exp`."""
    from vmambair_torch.utils.img_util import imwrite

    rng = np.random.RandomState(4)
    for i in range(4):
        gt = (rng.rand(48, 48, 3) * 255).astype(np.uint8)
        lq = gt.reshape(12, 4, 12, 4, 3).mean((1, 3)).round().astype(
            np.uint8)
        imwrite(gt, os.path.join(data, "gt", f"{i}.png"))
        imwrite(lq, os.path.join(data, "lq", f"{i}.png"))
    return {"name": "tiny", "model_type": "MambaSISRModel", "scale": 4,
            "num_gpu": num_gpu, "manual_seed": 0,
            "datasets": {"train": {
                "name": "train", "type": "PairedImageDataset",
                "dataroot_gt": os.path.join(data, "gt"),
                "dataroot_lq": os.path.join(data, "lq"),
                "io_backend": {"type": "disk"}, "gt_size": 32,
                "use_hflip": True, "use_rot": True, "num_worker_per_gpu": 1,
                "batch_size_per_gpu": 2, "dataset_enlarge_ratio": 1}},
            "network_g": dict(TINY_G),
            "path": {"experiments_root": str(exp)},
            "train": {"ema_decay": 0.999,
                      "optim_g": {"type": "Adam", "lr": 2e-4,
                                  "betas": [0.9, 0.99]},
                      "total_iter": total_iter,
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0}},
            "val": {"window_size": 8},
            "logger": {"print_freq": 1, "save_checkpoint_freq": 100,
                       "use_tb_logger": False}}


def _entry(fn, rank, world, store, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def run_world(fn, world, tmp_path, *args, timeout=TIMEOUT):
    ctx = multiprocessing.get_context("spawn")
    out = pathlib.Path(tempfile.mkdtemp(prefix=f"world{world}_",
                                        dir=tmp_path))
    store = out / "store"
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(store), str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"ranks {alive} still running after {timeout} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    res = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def numpy_tree(x):
    """Tensors -> numpy arrays, through dicts, lists and tuples."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return type(x)((k, numpy_tree(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(numpy_tree(v) for v in x)
    return x


# -- the sequence-parallel scan ------------------------------------------------

def sp_scan_case(rank, world, arrays):
    """`sharded_scan` of the whole sequence on every rank (the shard scan,
    the gather of y), forward and reverse: the full y of each as numpy."""
    from vmambair_torch.parallel.sp_scan import sharded_scan

    u, delta, A, B, C, D, bias = (torch.from_numpy(a) for a in arrays)
    with torch.no_grad():
        return [sharded_scan(u, delta, A, B, C, D, bias, True, rev).numpy()
                for rev in (False, True)]


def sp_net_case(rank, world, net_opt, x):
    """A `scan_impl: "sp"` net's forward with the world's group installed,
    and the same weights' forward without it (the normal path); and the
    sharded scans the first made, by L."""
    from vmambair_torch.models import build_network, oss
    from vmambair_torch.parallel import use_sp_group

    calls = []
    sharded = oss.sharded_scan

    def counted(u, *a, **k):
        calls.append(u.shape[1])
        return sharded(u, *a, **k)

    oss.sharded_scan = counted
    net = build_network(dict(net_opt, scan_impl="sp"), device="cpu", seed=3)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        with use_sp_group(dist.group.WORLD):
            y_sp = net(xt)
        y = net(xt)
    return y_sp.numpy(), y.numpy(), sorted(calls)


# -- data-parallel training ----------------------------------------------------

def num_gpu_case(rank, world):
    """`resolve_num_gpu` of "auto", None, the world size, one more, and 1:
    the value, or the message it raises."""
    from vmambair_torch.utils import options

    out = {}
    for n in ("auto", None, world, world + 1, 1):
        try:
            out[n] = options.resolve_num_gpu(n)
        except ValueError as e:
            out[n] = str(e)
    return out


class Replay:
    """A host generator that hands out recorded mixup draws in order: the
    Beta weights and permutations the JAX run drew (jax.random and numpy
    cannot give the same numbers from one seed)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def beta(self, a, b):
        return self.draws[0][0]

    def permutation(self, n):
        lam, perm = self.draws.pop(0)
        assert len(perm) == n
        return np.asarray(perm)


def train_steps_case(rank, world, opt, state, batches, draws=None,
                     keys=("lq", "gt")):
    """Builds the port's model of `opt` on the CPU (under DDP: a group is
    up), loads `state` (net_g and, where the model has them, net_g_ema and
    net_d), and takes one step per global batch on this rank's rows.
    Returns the logs, the nets' state dicts and the model's class name."""
    from vmambair_torch.parallel import local_batch_slice
    from vmambair_torch.train import build_model

    torch.manual_seed(0)
    m = build_model(opt, device="cpu")
    for name in ("net_g", "net_g_ema", "net_d"):
        if getattr(m, name, None) is not None and name in state:
            getattr(m, name).load_state_dict(
                {k: torch.from_numpy(v) for k, v in state[name].items()})
    if draws is not None:
        m.host_rng = Replay(draws)
    logs, grads = [], []
    for it, batch in enumerate(batches, 1):
        rows = local_batch_slice(len(batch[keys[0]]), world, rank)
        m.feed_data({k: (v[rows] if k in keys else v)
                     for k, v in batch.items()})
        m.optimize_parameters(it)
        logs.append(m.get_current_log())
        grads.append({f"{name}.{k}": p.grad.detach().numpy().copy()
                      for name in ("net_g", "net_d")
                      if getattr(m, name, None) is not None
                      for k, p in getattr(m, name).named_parameters()
                      if p.grad is not None})
    nets = {name: numpy_tree(getattr(m, name).state_dict())
            for name in ("net_g", "net_g_ema", "net_d")
            if getattr(m, name, None) is not None}
    return {"logs": logs, "grads": grads, "nets": nets,
            "type": type(m).__name__,
            "ddp": type(m.train_g).__name__}
