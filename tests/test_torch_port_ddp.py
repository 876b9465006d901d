"""Data-parallel training of the port against JAX's mesh, on the CPU.

The S1 `SRModel` step with mixup on and the deraining `ImageCleanModel`
step (AdamW, the clip): 2 steps at world 2 (gloo processes, each rank
feeding its 2 rows of global batches of 4) against JAX's model with
`num_gpu: 2` on a 2-device mesh of the conftest's virtual CPU devices,
from the same weights, within 2e-3 relative (`test_torch_port_train.py`'s
bar); the mixup draws are JAX's, recomputed from its step's key and handed
to the port's mixup in order (jax.random and numpy cannot draw alike from
a seed); the ranks' weights bit-equal. The channel scans' conv_cout.bias
has an exact gradient of 0, which Adam turns into steps of up to lr each
way from rounding noise: it is held to the sum of the learning rates, as
in the single-device tests. The worlds against world 1, the torchrun
entry point and `num_gpu` are in `test_torch_port_ddp_worlds.py`.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from torch_dist_cases import (numpy_tree, rel, run_world, sr_opt,
                              train_steps_case)
from vmambair_tpu.train import build_model as jax_build_model
from vmambair_torch.utils.convert import jax_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _derain_opt(tmp_path):
    with open(os.path.join(ROOT, "options", "Deraining_mamber33.yml")) as f:
        y = yaml.safe_load(f)
    train = dict(y["train"], total_iter=8)
    train["scheduler"] = dict(train["scheduler"], periods=[2, 6])
    return {"name": "t_ddp_derain", "model_type": y["model_type"],
            "is_train": True, "scale": 1, "num_gpu": 2, "manual_seed": 0,
            "network_g": dict(y["network_g"], scan_impl="xla", dim=8,
                              num_blocks=[1, 1, 1, 1],
                              num_refinement_blocks=1),
            "path": {"models": str(tmp_path),
                     "training_states": str(tmp_path)},
            "train": train, "val": dict(y["val"])}


def _sr_batches(rng):
    return [{"lq": rng.rand(4, 8, 8, 3).astype(np.float32),
             "gt": rng.rand(4, 32, 32, 3).astype(np.float32)}
            for _ in range(2)]


def _derain_batches(rng):
    out = []
    for _ in range(2):
        gt = rng.rand(4, 24, 24, 3).astype(np.float32)
        lq = np.clip(gt + 0.3 * (rng.rand(*gt.shape) > 0.9), 0, 1)
        out.append({"lq": lq.astype(np.float32), "gt": gt})
    return out


def _jax_mixup_draw(jm, n, alpha):
    """The (Beta weight, permutation) JAX's next step draws for mixup,
    recomputed eagerly from the model's key along the step's splits
    (`optimize_parameters`, the step, `mixup_batch`)."""
    _, step_rng = jax.random.split(jm.rng)
    _, k = jax.random.split(step_rng)
    k1, k2 = jax.random.split(k)
    return (float(jax.random.beta(k1, alpha, alpha)),
            np.asarray(jax.random.permutation(k2, n)))


@pytest.mark.parametrize("kind", ["sr_mixup", "image_clean"])
def test_steps_at_world_2_match_jax_on_a_2_device_mesh(tmp_path, kind):
    opt = (sr_opt if kind == "sr_mixup" else _derain_opt)(tmp_path)
    rng = np.random.RandomState(7)
    batches = (_sr_batches if kind == "sr_mixup" else _derain_batches)(rng)
    draws = []
    jm = jax_build_model(opt)
    assert jm.mixup == (kind == "sr_mixup")
    assert jm.mesh.devices.size == 2
    sd = jax_to_torch(jax.tree_util.tree_map(np.asarray,
                                             jm.params["params"]))
    state = {"net_g": numpy_tree(sd)}
    if jm.params_ema is not None:
        state["net_g_ema"] = state["net_g"]
    jax_logs, lr_sum = [], 0.0
    for it, batch in enumerate(batches, 1):
        if jm.mixup:
            draws.append(_jax_mixup_draw(jm, 4, jm.mixup_beta))
        jm.feed_data(batch)
        jm.optimize_parameters(it)
        jax_logs.append(float(jm.log_dict["l_pix"]))
        lr_sum += float(jm.log_dict["lr"])
    res = run_world(train_steps_case, 2, tmp_path, opt, state, batches,
                    draws or None)
    r0 = res[0]
    assert r0["ddp"] == "DistributedDataParallel"
    assert r0["type"] == "ImageRestorationModel"
    for step, lj in enumerate(jax_logs):
        lt = r0["logs"][step]["l_pix"]
        assert abs(lt - lj) <= 2e-3 * abs(lj), (step, lt, lj)
    trees = [("net_g", jm.params)]
    if jm.params_ema is not None:
        trees.append(("net_g_ema", jm.params_ema))
    moved = 0
    for name, tree in trees:
        ref = numpy_tree(jax_to_torch(jax.tree_util.tree_map(
            np.asarray, tree["params"])))
        for k, v in r0["nets"][name].items():
            if k.endswith("conv_cout.bias"):
                assert np.abs(v - ref[k]).max() <= lr_sum, (name, k)
                continue
            assert rel(v, ref[k]) <= 2e-3, (name, k, rel(v, ref[k]))
            moved += rel(v, state["net_g"][k]) > 1e-4
    assert moved  # the comparison is not of the init
    for name, net in r0["nets"].items():
        for k, v in net.items():
            assert np.array_equal(v, res[1]["nets"][name][k]), (name, k)
    assert r0["logs"] == res[1]["logs"]
