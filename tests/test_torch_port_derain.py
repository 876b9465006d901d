"""The port's deraining harness against the JAX package's, on the CPU:
the YAMLs' stages and runs here; the nets, the `.ckpt` and the
`ImageCleanModel` steps in `test_torch_port_derain_nets.py`.

- the progressive (patch, batch) stages of `options/Deraining_mamber33.yml`
  at each iteration where they change, against JAX's;
- `train_torch.py -opt options/Deraining_mamber33.yml` and `test_torch.py
  -opt options/test_Deraining_mamber33.yml` on the CPU, with the data
  roots, the width and depth, the patch and batch sizes, the iterations
  and the experiments root forced: two progressive stages, validation on
  whole images, then the five test sets from the run's checkpoint (the
  YAML's `.ckpt` stem, read from the `.pth` beside it);
- `chip_smoke.py`'s deraining recipes against the two YAMLs.
"""

import os

import numpy as np
import pytest
import torch

from vmambair_torch.models import build_network
from vmambair_torch.utils.img_util import imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)
DEPTH = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1}


def _yaml(name):
    import yaml

    with open(os.path.join(ROOT, "options", name)) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("it", [1, 92000, 92001, 156001, 220001, 284000,
                                284001, 348001, 396000])
def test_progressive_stages_of_the_yaml_match_jax(it):
    """The YAML's six (patch, batch) stages at their boundaries: the same
    sub-batch and crop as JAX's ProgressiveSchedule from the same seed,
    out of the loader's 8 x 384x384 pairs."""
    from vmambair_torch.train.pipeline import ProgressiveSchedule
    from vmambair_tpu.train.pipeline import ProgressiveSchedule as Jax

    ds = _yaml("Deraining_mamber33.yml")["datasets"]["train"]
    rng = np.random.RandomState(it % 997)
    batch = {"lq": rng.rand(8, 384, 384, 3).astype(np.float32)}
    batch["gt"] = batch["lq"] * 0.5
    got = ProgressiveSchedule(ds, 1).apply(batch, it,
                                           np.random.RandomState(it))
    ref = Jax(ds, 1).apply(batch, it, np.random.RandomState(it))
    stage = int(np.searchsorted(np.cumsum(ds["iters"]), it))
    size, b = ds["gt_sizes"][stage], ds["mini_batch_sizes"][stage]
    assert got["lq"].shape == (b, size, size, 3)
    for k in ("lq", "gt"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _rain_pairs(folder, sizes, seed):
    """Clean images and rainy copies (seeded bright streaks) as PNGs."""
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(sizes):
        gt = (rng.rand(h, w, 3) * 200).astype(np.uint8)
        lq = gt.copy()
        lq[rng.rand(h, w) > 0.93] = 250
        imwrite(gt, str(folder / "target" / f"{i}.png"))
        imwrite(lq, str(folder / "input" / f"{i}.png"))


def test_deraining_yamls_through_train_and_test_torch(tmp_path):
    """`train_torch.py` and `test_torch.py` as a user runs them (`-opt`,
    `--device cpu`, `--force_yml`) on the two shipped YAMLs, with the data
    roots, width, depth, patch and batch sizes, iterations and roots
    forced: two progressive stages (16x16 x 2, then 24x24 x 1, from
    loader batches of 2 x 32x32, one training image smaller than that:
    the pad), validation on whole images whose sides are no multiple of
    8 (the reflect pad to the window), a checkpoint; then the five test
    sets from the YAML's `.ckpt` stem, which the `.pth` of the run
    stands in for."""
    from vmambair_torch.train.pipeline import test_pipeline, train_pipeline

    _rain_pairs(tmp_path / "train", [(40, 36), (30, 44), (36, 36)], 0)
    _rain_pairs(tmp_path / "val", [(21, 27), (16, 19)], 1)
    tiny = ["network_g:dim=8", "network_g:num_blocks=[1,1,1,1]",
            "network_g:num_refinement_blocks=1"]
    train = [f"datasets:train:dataroot_gt={tmp_path / 'train' / 'target'}",
             f"datasets:train:dataroot_lq={tmp_path / 'train' / 'input'}",
             f"datasets:val:dataroot_gt={tmp_path / 'val' / 'target'}",
             f"datasets:val:dataroot_lq={tmp_path / 'val' / 'input'}",
             "datasets:train:gt_size=32", "datasets:train:gt_sizes=[16,24]",
             "datasets:train:mini_batch_sizes=[2,1]",
             "datasets:train:iters=[1,1]",
             "datasets:train:batch_size_per_gpu=2",
             "datasets:train:num_worker_per_gpu=1", "train:total_iter=2",
             "val:val_freq=2", "logger:print_freq=1",
             "logger:save_checkpoint_freq=2", "logger:use_tb_logger=False",
             f"path:experiments_root={tmp_path / 'exp'}"]

    def argv(yml, *force):
        return ["-opt", os.path.join(ROOT, "options", yml), "--device",
                "cpu", "--force_yml", *force]

    m = train_pipeline(ROOT, argv=argv("Deraining_mamber33.yml", *tiny,
                                       *train))
    assert type(m).__name__ == "ImageRestorationModel"
    assert type(m.net_g).__name__ == "OSSNet" and m.net_g.scale == 1
    assert m.net_g.tail_kind == "conv_residual"
    assert isinstance(m.optimizer, torch.optim.AdamW) and m.grad_clip == 0.01
    log = next((tmp_path / "exp").glob("train_*.log")).read_text()
    assert "Progressive stage 1: gt_size 16, batch 2" in log
    assert "Progressive stage 2: gt_size 24, batch 1" in log
    assert log.count("l_pix:") == 2
    # pre-train, at 2 and at the end: PSNR-Y and SSIM-Y on whole images
    assert log.count("# psnr:") == 3 and log.count("# ssim:") == 3
    models = tmp_path / "exp" / "models"
    assert (models / "net_g_2.pth").exists()
    assert (tmp_path / "exp" / "training_states" / "2.state").exists()

    test_sets = []
    for n in range(1, 6):
        test_sets += [
            f"datasets:test_{n}:dataroot_gt={tmp_path / 'val' / 'target'}",
            f"datasets:test_{n}:dataroot_lq={tmp_path / 'val' / 'input'}"]
    m = test_pipeline(ROOT, argv=argv(
        "test_Deraining_mamber33.yml", *tiny, *test_sets,
        f"path:pretrain_network_g={models / 'net_g_2.ckpt'}",
        f"path:results_root={tmp_path / 'res'}"))
    log = next((tmp_path / "res").glob("test_*.log")).read_text()
    for name in ("Rain100L", "Rain100H", "Test100", "Test1200", "Test2800"):
        assert f"Results [{name}]" in log, name
    assert "net_g_2.ckpt does not exist: loading" in log
    assert len(list((tmp_path / "res").rglob("*.png"))) == 10
    assert m.output.shape == (1, 3, 16, 19)
    # the evaluation net is the trained one
    trained = torch.load(models / "net_g_2.pth")["params"]
    for k, v in m.net_g.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_chip_smoke_derain_recipes_are_the_yamls():
    """`chip_smoke.py` carries the two deraining YAMLs as dicts (the card's
    machine need not have a YAML parser): equal to the YAMLs, and the
    launches it holds each step and forward to are the dispatch's
    prediction for the full-size Mamber33 (built, not run)."""
    import chip_smoke

    assert chip_smoke.DERAIN_RECIPE == dict(
        _yaml("Deraining_mamber33.yml"), is_train=True)
    assert chip_smoke.DERAIN_TEST_RECIPE == _yaml(
        "test_Deraining_mamber33.yml")
    net = build_network(chip_smoke.DERAIN_RECIPE["network_g"], device="cpu")
    for train, want in ((True, chip_smoke.DERAIN_STEP),
                        (False, chip_smoke.DERAIN_FWD)):
        got = chip_smoke.expected_launches(net, train=train)
        assert {k: v for k, v in got.items() if v} == want
