"""The port's training and test pipelines on CPU at a tiny size, and the
chop inference of `SRModel.test` against the JAX package's.

A tiny OSSNet trains on a seeded paired PNG dataset written by the port's
encoder: 6 iterations with validation (PSNR-Y) and checkpoints at 3 and 6,
auto-resume to 8, `test_pipeline` on the checkpoint, and `train_torch.py
-opt` in a subprocess. The validation forward with `val.tile` is held
against JAX's `SRModel.test_tiled` from the same weights within 3e-5.
"""

import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from vmambair_tpu.train import build_model as jax_build_model
from vmambair_torch.train import build_model
from vmambair_torch.train import pipeline
from vmambair_torch.utils.convert import jax_to_torch
from vmambair_torch.utils.img_util import imread, imwrite
from vmambair_torch.utils.options import finalize_options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"type": "OSSNet", "dim": 8, "num_blocks": [1, 1, 1, 1],
        "num_refinement_blocks": 1, "scale": 4}

torch.set_num_threads(1)


def _write_pairs(root, split, n, lq_hw):
    rng = np.random.RandomState(len(split) + n)
    h, w = lq_hw
    for i in range(n):
        gt = (rng.rand(4 * h, 4 * w, 3) * 255).astype(np.uint8)
        lq = gt.reshape(h, 4, w, 4, 3).mean((1, 3)).round().astype(np.uint8)
        imwrite(gt, os.path.join(root, split, "gt", f"{i}.png"))
        imwrite(lq, os.path.join(root, split, "lq", f"{i}.png"))
    return {"name": split, "type": "PairedImageDataset",
            "dataroot_gt": os.path.join(root, split, "gt"),
            "dataroot_lq": os.path.join(root, split, "lq"),
            "io_backend": {"type": "disk"}}


def _train_opt(data, exp, total_iter):
    train = dict(data["train"], gt_size=32, use_hflip=True, use_rot=True,
                 num_worker_per_gpu=1, batch_size_per_gpu=2,
                 dataset_enlarge_ratio=1)
    return {
        "name": "tiny", "model_type": "MambaSISRModel", "scale": 4,
        "num_gpu": 1, "manual_seed": 0,
        "datasets": {"train": train, "val_1": dict(data["val"])},
        "network_g": dict(TINY),
        "path": {"experiments_root": exp, "param_key_g": "params_ema"},
        "train": {"ema_decay": 0.999,
                  "optim_g": {"type": "Adam", "lr": 2e-4,
                              "betas": [0.9, 0.99]},
                  "scheduler": {"type": "MultiStepLR", "milestones": [50],
                                "gamma": 0.5},
                  "total_iter": total_iter,
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0}},
        "val": {"window_size": 8, "val_freq": 3, "save_img": True,
                "metrics": {"psnr": {"type": "calculate_psnr",
                                     "crop_border": 4,
                                     "test_y_channel": True}}},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 3,
                   "use_tb_logger": False}}


def _log(exp, prefix):
    with open(sorted(glob.glob(os.path.join(exp, prefix + "*.log")))[-1]) \
            as f:
        return f.read()


def test_train_resume_test_pipelines_on_cpu(tmp_path):
    data = {"train": _write_pairs(str(tmp_path), "train", 4, (12, 12)),
            "val": _write_pairs(str(tmp_path), "val", 2, (9, 7))}
    exp = str(tmp_path / "exp")
    model = pipeline.train_pipeline(str(tmp_path), finalize_options(
        _train_opt(data, exp, 6), str(tmp_path)), device="cpu")
    log = _log(exp, "train_")
    losses = [float(x.split("l_pix: ")[1].split()[0])
              for x in log.splitlines() if "l_pix: " in x]
    psnr = [float(x.rsplit("psnr: ", 1)[1]) for x in log.splitlines()
            if "# psnr: " in x]
    assert len(losses) == 6 and np.isfinite(losses).all()
    # before step 1, at 3, at 6 and after the loop
    assert len(psnr) == 4 and np.isfinite(psnr).all()
    assert sorted(os.listdir(os.path.join(exp, "models"))) == [
        "net_g_3.pth", "net_g_6.pth"]
    assert sorted(os.listdir(os.path.join(exp, "training_states"))) == [
        "3.state", "6.state"]
    assert model.timers["iter"].count == 6
    sr = imread(os.path.join(exp, "visualization", "0", "0_6.png"))
    assert sr.shape == (36, 28, 3)

    opt = finalize_options(_train_opt(data, exp, 8), str(tmp_path))
    opt["auto_resume"] = True
    pipeline.train_pipeline(str(tmp_path), opt, device="cpu")
    assert "Resuming training from epoch 3, iter 6." in _log(exp, "train_")
    assert os.path.isfile(os.path.join(exp, "models", "net_g_8.pth"))

    res = str(tmp_path / "results")
    test_opt = finalize_options({
        "name": "t", "model_type": "MambaSISRModel", "scale": 4,
        "manual_seed": 0, "network_g": dict(TINY),
        "datasets": {"test_1": dict(data["val"])},
        "path": {"results_root": res, "param_key_g": "params_ema",
                 "pretrain_network_g": os.path.join(exp, "models",
                                                    "net_g_8.pth")},
        "val": {"window_size": 8, "metrics": {
            "psnr": {"type": "calculate_psnr", "crop_border": 4}}}},
        str(tmp_path), is_train=False)
    pipeline.test_pipeline(str(tmp_path), test_opt, device="cpu")
    assert "Results [val]: {'psnr': " in _log(res, "test_")
    for i in range(2):
        out = imread(os.path.join(res, "visualization", "val", f"{i}.png"))
        assert out.shape == (36, 28, 3)


def test_train_torch_cli_reads_yaml(tmp_path):
    """`train_torch.py -opt x.yml --device cpu --force_yml ...` in a
    subprocess: parse_options, then two steps and a checkpoint."""
    data = {"train": _write_pairs(str(tmp_path), "train", 2, (8, 8)),
            "val": _write_pairs(str(tmp_path), "val", 1, (8, 8))}
    exp = str(tmp_path / "exp")
    opt = _train_opt(data, exp, 4)
    opt["datasets"]["train"]["gt_size"] = 32
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(opt))
    subprocess.run([sys.executable, os.path.join(ROOT, "train_torch.py"),
                    "-opt", str(path), "--device", "cpu", "--force_yml",
                    "train:total_iter=2", "val:val_freq=0"], check=True,
                   cwd=str(tmp_path), capture_output=True,
                   env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert os.listdir(os.path.join(exp, "models")) == ["net_g_2.pth"]
    assert os.path.isfile(os.path.join(exp, "tiny.yml"))


def test_validation_tile_matches_jax_test_tiled():
    """`val.tile` runs chop inference in both frameworks (JAX's
    `SRModel.test` -> `test_tiled`, the port's `test` -> `test_tiled`):
    the same output from the same weights, at a size that takes ragged
    edge tiles and a halo."""
    opt = {"name": "t", "model_type": "MambaSISRModel", "scale": 4,
           "num_gpu": 1, "manual_seed": 0, "is_train": False,
           "network_g": dict(TINY, scan_impl="xla"),
           "val": {"window_size": 8, "tile": 8, "tile_pad": 4}}
    jm = jax_build_model(opt)
    m = build_model(opt, device="cpu")
    m.net_g.load_state_dict(jax_to_torch(
        jax.tree_util.tree_map(np.asarray, jm.params["params"])))
    lq = np.random.RandomState(5).rand(1, 13, 10, 3).astype(np.float32)
    jm.feed_data({"lq": lq})
    jm.test()
    m.feed_data({"lq": lq})
    m.test()
    assert m.output.shape == (1, 3, 52, 40)
    np.testing.assert_allclose(m.output.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jm.output), rtol=3e-5, atol=3e-5)
    untiled = dict(opt, val={"window_size": 8})
    m2 = build_model(untiled, device="cpu")
    m2.net_g.load_state_dict(m.net_g.state_dict())
    m2.feed_data({"lq": lq})
    m2.test()
    # without the tile the forward sees the whole image: another output
    assert not torch.allclose(m2.output, m.output, atol=1e-4)


def test_put_batch_keeps_device_tensors():
    m = build_model({"model_type": "SRModel", "scale": 4,
                     "network_g": dict(TINY)}, device="cpu")
    lq = np.random.RandomState(0).rand(2, 8, 6, 3).astype(np.float32)
    batch = m.put_batch({"lq": lq, "lq_path": ["a"]})
    assert batch["lq"].shape == (2, 3, 8, 6) and batch["lq_path"] == ["a"]
    assert m.put_batch(batch)["lq"] is batch["lq"]
    m.feed_data(batch)
    assert m.lq is batch["lq"] and m.gt is None


@pytest.mark.parametrize("key", ["profile_dir"])
def test_profiler_option_raises(tmp_path, monkeypatch, key):
    """`train.profile_dir` traces with torch.profiler (its window and
    files: `test_torch_port_profiling_cli.py`); a profiler that cannot
    start raises out of the pipeline, where JAX's turns itself off."""
    class Refusing:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("profiler refused")

    data = {"train": _write_pairs(str(tmp_path), "train", 4, (12, 12)),
            "val": _write_pairs(str(tmp_path), "val", 2, (9, 7))}
    opt = finalize_options(_train_opt(data, str(tmp_path / "exp"), 2),
                           str(tmp_path))
    opt["val"]["val_freq"] = 0
    opt["train"].update({key: str(tmp_path / "trace"), "profile_start": 1,
                         "profile_iters": 1})
    monkeypatch.setattr(torch.profiler, "profile", Refusing)
    with pytest.raises(RuntimeError, match="profiler refused"):
        pipeline.train_pipeline(str(tmp_path), opt, device="cpu")


def test_progressive_schedule_matches_jax():
    """The deraining (patch, batch) stages draw the same sub-batch and
    crop as JAX's for the same seed, stage by stage."""
    from vmambair_tpu.train.pipeline import ProgressiveSchedule as Jax

    ds = {"iters": [2, 2, 2], "gt_sizes": [16, 24, 32],
          "mini_batch_sizes": [4, 3, 2], "gt_size": 32}
    rng = np.random.RandomState(0)
    batch = {"lq": rng.rand(4, 8, 8, 3).astype(np.float32),
             "gt": rng.rand(4, 32, 32, 3).astype(np.float32), "k": [1]}
    ours, ref = pipeline.ProgressiveSchedule(ds, 4), Jax(ds, 4)
    r1, r2 = np.random.RandomState(11), np.random.RandomState(11)
    for it in range(1, 8):
        a, b = ours.apply(batch, it, r1), ref.apply(batch, it, r2)
        for k in ("lq", "gt"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=(it, k))
    assert a["gt"].shape == (2, 32, 32, 3) and a["k"] == [1]
    assert not pipeline.ProgressiveSchedule({}, 4).enabled


def test_entry_points_default_to_cuda(tmp_path):
    from vmambair_torch.utils.options import parse_options

    path = tmp_path / "o.yml"
    path.write_text(yaml.safe_dump({"name": "o", "manual_seed": 1}))
    opt = parse_options(str(tmp_path), argv=["-opt", str(path)])
    assert opt["device"] == "cuda" and pipeline._device(opt, None) == "cuda"
    assert pipeline._device({}, None) == "cuda"
    assert pipeline._device(opt, "cpu") == "cpu"
