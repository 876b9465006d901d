"""End-to-end training and test pipelines of the port.

Counterpart of `vmambair_tpu/train/pipeline.py`: options -> resume ->
directories -> loggers -> loaders -> model -> prefetchers -> the loop
{learning rate, feed, optimize, log, save, validate}, plus the deraining
trainer's progressive (patch, batch) schedule. Both pipelines run on
`device`, the card unless the caller (or `--device`) asks for the CPU.

Timing: `time` in the log is the mean period of an iteration (from the
end of one training step to the end of the next, validation and saving
left out); on CUDA a step returns before the card finishes, and the period
over many iterations still counts the card's time, since the host can run
only so far ahead. `data_time` is the part of it spent waiting for the
next batch. The pipeline leaves both timers on the model as `model.timers`.

Data parallelism (`--launcher pytorch|slurm`; `parse_options` joins the
group): each rank loads its slice of the sampler's indices, so the ranks'
batches make the global one in the reference's sample order (a run at
world N is not world 1's order; parity is held at the step); rank 0 alone
makes the directories, writes the log file and TensorBoard, saves and
validates, while the others wait at a barrier; the group is destroyed at
the end. `train.profile_dir` traces iterations `profile_start` (10) ..
+ `profile_iters` (3) with `utils.profiling.StepProfiler`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from ..data import (
    DevicePrefetcher,
    InfinitePrefetcher,
    build_dataloader,
    build_dataset,
)
from ..parallel import (
    barrier,
    destroy_distributed,
    is_main_process,
    rank,
    world_size,
)
from ..utils.logger import (
    MessageLogger,
    get_env_info,
    get_root_logger,
    init_tb_logger,
)
from ..utils.misc import (
    AvgTimer,
    check_resume,
    find_latest_state,
    make_exp_dirs,
    set_random_seed,
)
from ..utils.options import copy_opt_file, dict2str, parse_options
from ..utils.profiling import StepProfiler
from . import build_model

logger = logging.getLogger("vmambair_torch")


def create_train_val_dataloaders(opt: Dict[str, Any]):
    train_loader, val_loaders = None, []
    total_iters = int(opt["train"]["total_iter"])
    for phase, dataset_opt in (opt.get("datasets") or {}).items():
        if phase == "train":
            dataset_opt = dict(dataset_opt)
            dataset_opt.setdefault("num_gpu", opt["num_gpu"])
            train_set = build_dataset(dataset_opt)
            train_loader, _ = build_dataloader(
                train_set, dataset_opt, num_replicas=world_size(),
                rank=rank(), seed=opt["manual_seed"])
            per_epoch = max(1, len(train_loader))
            logger.info("Training stats: %d images, %d iters/epoch, %d "
                        "epochs for %d total iters.", len(train_set),
                        per_epoch, -(-total_iters // per_epoch), total_iters)
        elif phase.split("_")[0] == "val":
            val_set = build_dataset(dict(dataset_opt))
            val_loader, _ = build_dataloader(val_set, dict(dataset_opt))
            val_loaders.append(val_loader)
    return train_loader, val_loaders


class ProgressiveSchedule:
    """Deraining progressive learning: at iteration thresholds `iters`,
    switch to (gt_size, batch) stages by subsampling and cropping the
    loaded max-size batch (NHWC numpy)."""

    def __init__(self, train_ds_opt: Dict[str, Any], scale: int):
        self.enabled = "iters" in train_ds_opt
        if not self.enabled:
            return
        self.iters = np.cumsum(train_ds_opt["iters"]).tolist()
        self.gt_sizes = list(train_ds_opt["gt_sizes"])
        self.batch_sizes = list(train_ds_opt["mini_batch_sizes"])
        self.gt_size = int(train_ds_opt["gt_size"])
        self.scale = scale
        self._logged = set()

    def apply(self, batch: Dict[str, Any], current_iter: int,
              rng: np.random.RandomState):
        if not self.enabled:
            return batch
        stage = next((i for i, t in enumerate(self.iters)
                      if current_iter <= t), len(self.iters) - 1)
        if stage not in self._logged:
            logger.info("Progressive stage %d: gt_size %d, batch %d",
                        stage + 1, self.gt_sizes[stage],
                        self.batch_sizes[stage])
            self._logged.add(stage)
        mini_gt, mini_b = self.gt_sizes[stage], self.batch_sizes[stage]
        lq, gt = batch["lq"], batch["gt"]
        idx = rng.choice(lq.shape[0], size=min(mini_b, lq.shape[0]),
                         replace=False)
        lq, gt = lq[idx], gt[idx]
        s = self.scale
        lq_size = mini_gt // s
        h, w = lq.shape[1:3]
        if h > lq_size and w > lq_size:
            top = rng.randint(0, h - lq_size + 1)
            left = rng.randint(0, w - lq_size + 1)
            lq = lq[:, top:top + lq_size, left:left + lq_size]
            gt = gt[:, top * s:(top + lq_size) * s,
                    left * s:(left + lq_size) * s]
        out = dict(batch)
        out["lq"], out["gt"] = np.ascontiguousarray(lq), \
            np.ascontiguousarray(gt)
        return out


def _device(opt: Dict[str, Any], device: Optional[str]) -> str:
    return device or opt.get("device") or "cuda"


def train_pipeline(root_path: str, opt: Optional[Dict[str, Any]] = None,
                   argv=None, device: Optional[str] = None):
    """Trains as `options/*.yml` says (`opt` a finalized options dict, or
    parsed from `argv`); returns the model."""
    if opt is None:
        opt = parse_options(root_path, is_train=True, argv=argv)
    try:
        return _train(root_path, opt, _device(opt, device))
    finally:
        if opt.get("launcher", "none") != "none":
            destroy_distributed()


def _train(root_path: str, opt: Dict[str, Any], device: str):
    main = is_main_process()
    set_random_seed(int(opt["manual_seed"]))

    # auto-resume: resolve the state and point pretrain_network_g at the
    # checkpoint of its iteration before the model is built
    resume_state_path = (opt.get("path") or {}).get("resume_state")
    if opt.get("auto_resume") and not resume_state_path:
        resume_state_path = find_latest_state(
            opt["path"]["training_states"])
    if resume_state_path:
        opt["path"]["resume_state"] = resume_state_path
        check_resume(opt, int(os.path.splitext(
            os.path.basename(resume_state_path))[0]))
    elif main:
        make_exp_dirs(opt)
    barrier()

    get_root_logger(
        log_level=logging.INFO if main else logging.WARNING,
        log_file=os.path.join(opt["path"]["log"], f"train_{opt['name']}_"
                              f"{int(time.time())}.log") if main else None)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    if opt.get("opt_path") and main:
        copy_opt_file(opt["opt_path"], opt["path"]["experiments_root"])
    tb_logger = None
    if (opt.get("logger") or {}).get("use_tb_logger") and main:
        tb_logger = init_tb_logger(
            os.path.join(root_path, "tb_logger", opt["name"]))
    if world_size() > 1:
        logger.info("Data parallel over %d ranks", world_size())

    train_loader, val_loaders = create_train_val_dataloaders(opt)
    model = build_model(opt, device=device)

    start_epoch, current_iter = 0, 0
    if resume_state_path:
        rs = model.resume_training(resume_state_path)
        start_epoch, current_iter = rs["epoch"], rs["iter"]
        logger.info("Resuming training from epoch %d, iter %d.", start_epoch,
                    current_iter)

    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    progressive = ProgressiveSchedule(opt["datasets"]["train"],
                                      int(opt.get("scale", 1)))
    prog_rng = np.random.RandomState(int(opt["manual_seed"]) + 11)
    # batch N+1's copy to the device is issued while step N runs; the
    # progressive crops apply before it, with the step that consumes it
    base_iter = current_iter
    prefetcher = DevicePrefetcher(
        InfinitePrefetcher(train_loader, start_epoch), model.put_batch,
        model.device, transform=(lambda batch, seq: progressive.apply(
            batch, base_iter + seq, prog_rng)))

    total_iters = int(opt["train"]["total_iter"])
    log_opt = opt.get("logger") or {}
    print_freq = int(log_opt.get("print_freq", 100))
    save_freq = int(log_opt.get("save_checkpoint_freq", 10 ** 9))
    val_freq = int((opt.get("val") or {}).get("val_freq", 0) or 0)
    save_img = bool((opt.get("val") or {}).get("save_img", False))
    iter_timer, data_timer = AvgTimer(), AvgTimer()
    model.timers = {"iter": iter_timer, "data": data_timer}
    profiler = StepProfiler(opt["train"].get("profile_dir"),
                            int(opt["train"].get("profile_start", 10)),
                            int(opt["train"].get("profile_iters", 3)),
                            device=model.device)
    start_time = time.time()

    def validate():
        # rank 0 evaluates (the bare nets: no collective); the others wait
        if main:
            for val_loader in val_loaders:
                model.validation(val_loader, current_iter, tb_logger,
                                 save_img)
        barrier()

    def save(epoch):
        if main:
            model.save(epoch, current_iter)
        barrier()

    # validation before the first step exercises the evaluation path, as
    # the reference trainer does
    if val_freq and current_iter == 0:
        logger.info("Pre-train validation at iter 0.")
        validate()

    logger.info("Start training from iter %d", current_iter)
    iter_timer.tic()
    try:
        while current_iter < total_iters:
            data_timer.tic()
            batch = prefetcher.next()
            data_timer.toc()
            current_iter += 1
            profiler.step(current_iter)
            model.feed_data(batch)
            model.optimize_parameters(current_iter)
            iter_timer.toc()

            paused = False
            if current_iter % print_freq == 0 and main:
                log_vars = {"epoch": prefetcher.epoch, "iter": current_iter,
                            "time": iter_timer.get_avg_time(),
                            "data_time": data_timer.get_avg_time()}
                log_vars.update(model.get_current_log())
                msg_logger(log_vars)
            if current_iter % save_freq == 0:
                logger.info("Saving models and training states.")
                save(prefetcher.epoch)
                paused = True
            if val_freq and current_iter % val_freq == 0:
                validate()
                paused = True
            if paused:  # saving and validation are not iteration time
                iter_timer.tic()
    finally:
        profiler.close()
        prefetcher.close()
    logger.info("End of training. Time consumed: %.1fs; ms per iter %.1f, "
                "data ms per iter %.1f", time.time() - start_time,
                1e3 * iter_timer.get_avg_time(),
                1e3 * data_timer.get_avg_time())
    logger.info("Save the latest model.")
    save(prefetcher.epoch)
    if val_freq:
        validate()
    return model


def test_pipeline(root_path: str, opt: Optional[Dict[str, Any]] = None,
                  argv=None, device: Optional[str] = None):
    """Evaluates `path.pretrain_network_g` on every dataset of the options
    (`test.py`); returns the model."""
    if opt is None:
        opt = parse_options(root_path, is_train=False, argv=argv)
    device = _device(opt, device)
    set_random_seed(int(opt["manual_seed"]))
    os.makedirs(opt["path"]["log"], exist_ok=True)
    get_root_logger(log_file=os.path.join(
        opt["path"]["log"], f"test_{opt['name']}_{int(time.time())}.log"))
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted((opt.get("datasets") or {}).items()):
        test_set = build_dataset(dict(dataset_opt))
        test_loader, _ = build_dataloader(test_set, dict(dataset_opt))
        logger.info("Number of test images in %s: %d",
                    dataset_opt.get("name"), len(test_set))
        test_loaders.append(test_loader)

    model = build_model(opt, device=device)
    for test_loader in test_loaders:
        logger.info("Testing %s...", test_loader.name)
        metrics = model.validation(
            test_loader, current_iter=opt["name"],
            save_img=bool((opt.get("val") or {}).get("save_img", True)))
        logger.info("Results [%s]: %s", test_loader.name, metrics)
    return model
