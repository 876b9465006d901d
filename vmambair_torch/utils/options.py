"""YAML options: the reference's config schema.

The port's copy of `vmambair_tpu/utils/options.py`. `parse_options` reads
the YAML (importing `yaml` only there: a caller that builds the options
dict itself, as `chip_smoke.py` does, needs no YAML parser) and takes the
reference's flags plus `--device`; `finalize_options` and `dict2str` work
on dicts alone. `--launcher pytorch|slurm` joins the launcher's process
group before the options are finalised (`parallel.init_distributed`: NCCL
on the card, gloo on the CPU, each rank on `cuda:LOCAL_RANK`), and
`num_gpu` resolves to the world size. A `.json` options file is read with
`json` (JSON is a subset of YAML), so that a machine without a YAML
parser can still train from a file.
"""

from __future__ import annotations

import argparse
import ast
import json
import random
import shutil
import time
from pathlib import Path
from typing import Any, Dict


def set_nested(d: dict, keys: str, value: str):
    """`a:b:c` = value, the value read as a Python literal where it is
    one (`--force_yml train:total_iter=100`)."""
    ks = keys.split(":")
    cur = d
    for k in ks[:-1]:
        cur = cur.setdefault(k, {})
    try:
        v: Any = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        v = value
    cur[ks[-1]] = v


def parse_options(root_path: str, is_train: bool = True, argv=None):
    """`-opt <yaml> [--launcher ...] [--auto_resume] [--debug]
    [--local_rank N] [--force_yml k:v=x ...] [--device cuda|cpu]`. With a
    launcher, joins its process group first; `opt["device"]` is then this
    rank's device."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to YAML (or JSON)")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"],
                        default="none",
                        help="data-parallel launcher: torchrun (pytorch) "
                        "or srun (slurm)")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="override options, e.g. train:total_iter=100")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device, e.g. cuda or cpu")
    args = parser.parse_args(argv)

    with open(args.opt, "r") as f:
        if args.opt.endswith(".json"):
            opt = json.load(f)
        else:
            import yaml

            opt = yaml.safe_load(f)
    for entry in args.force_yml or ():
        keys, value = entry.split("=", 1)
        set_nested(opt, keys.strip(), value.strip())
    opt["auto_resume"] = args.auto_resume
    opt["is_train"] = is_train
    opt["opt_path"] = args.opt
    opt["device"] = args.device
    opt["launcher"] = args.launcher
    if args.launcher != "none":
        from ..parallel import init_distributed

        opt["device"] = str(init_distributed(args.launcher, args.device))
    if args.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]
    return finalize_options(opt, root_path, is_train)


def resolve_num_gpu(num_gpu) -> int:
    """The reference's `num_gpu` (int, "auto" or absent) -> the world size
    (1 without a process group): "auto" or absent means the world size;
    an int must equal it."""
    from ..parallel import world_size

    world = world_size()
    if num_gpu in (None, "auto", 0):
        return world
    if int(num_gpu) != world:
        raise ValueError(
            f"num_gpu {num_gpu} differs from the world size {world}: launch "
            f"{num_gpu} ranks (torchrun --nproc_per_node {num_gpu} ... "
            "--launcher pytorch) or set num_gpu: auto")
    return world


def finalize_options(opt: Dict, root_path: str, is_train: bool = True):
    """Fills in the seed, the datasets' phase and scale, `num_gpu` and the
    experiment (or results) directory tree, on a plain dict."""
    opt.setdefault("is_train", is_train)
    if opt.get("manual_seed") is None:
        opt["manual_seed"] = random.randint(1, 10000)
    opt["num_gpu"] = resolve_num_gpu(opt.get("num_gpu"))
    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        if "scale" in opt:
            dataset["scale"] = opt["scale"]

    root = Path(root_path)
    opt.setdefault("path", {})
    if is_train:
        exp_root = Path(opt["path"].get("experiments_root")
                        or root / "experiments" / opt["name"])
        opt["path"]["experiments_root"] = str(exp_root)
        opt["path"]["models"] = str(exp_root / "models")
        opt["path"]["training_states"] = str(exp_root / "training_states")
        opt["path"]["log"] = str(exp_root)
        opt["path"]["visualization"] = str(exp_root / "visualization")
        if "debug" in opt["name"]:
            if opt.setdefault("val", {}) is not None:
                opt["val"]["val_freq"] = 8
            opt.setdefault("logger", {})
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = Path(opt["path"].get("results_root")
                            or root / "results" / opt["name"])
        opt["path"]["results_root"] = str(results_root)
        opt["path"]["log"] = str(results_root)
        opt["path"]["visualization"] = str(results_root / "visualization")
    return opt


def copy_opt_file(opt_path: str, experiments_root: str):
    """Copies the option file into the experiment directory."""
    dst = Path(experiments_root) / Path(opt_path).name
    Path(experiments_root).mkdir(parents=True, exist_ok=True)
    if dst.exists():
        dst = dst.with_name(
            f"{Path(opt_path).stem}_{time.strftime('%Y%m%d_%H%M%S')}.yml")
    shutil.copyfile(opt_path, dst)


def dict2str(opt: dict, indent: int = 1) -> str:
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent * 2) + f"{k}:[" + dict2str(v, indent + 1)
            msg += " " * (indent * 2) + "]\n"
        else:
            msg += " " * (indent * 2) + f"{k}: {v}\n"
    return msg
