#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines and timings; any failed check exits
non-zero, and without a CUDA device the script stops before any result:

1. probe  - torch/CUDA versions, the card, its capability and power limit;
2. build  - compiles `vmambair_torch/csrc/*.cu` with nvcc for sm_90a;
3. kernels vs plain - each kernel at the main paths' shapes against its
   plain PyTorch version on the same inputs on the card. The forwards (K1,
   K4, K2): fp32 within the reference CUDA envelope (rtol 6e-4, atol
   2e-3), bf16 within 3e-2 / 5e-2. The carry-saving forwards (K1c, K4c):
   y equal to K1's / K4's, carries within the fp32 envelope. The scan
   backward (K3): all seven outputs within 5x the fp32 envelope (rtol
   3e-3, atol 1e-2), on fp32 and on bf16 inputs. Times from CUDA events
   (median of repeats; a plain version whose reference call took over
   50 ms timed once) for the kernel and the plain version, beside the
   least time the card could take (bound) at the case's shapes. K1 at the
   four shapes of a served forward ((8,2,96,16384), (8,2,48,16384),
   (8,2,96,4096), (8,2,192,1024)), K2 at the five of a served forward
   in bf16 ((8,96,128,128) first, the main shape; its tensor-core route)
   and the five of the S1 step in fp32 ((8,48,64,64), (8,96,64,64),
   (8,96,32,32), (8,192,16,16), (8,384,8,8); its split-TF32 route), each
   beside its plain version (the cuDNN composite), K1c at the S1 step's
   (8,2,96,4096) and (8,2,48,4096) fp32 and K3 at every fp32 shape of
   the S1 step (the
   fused scans (8,4096,192), (8,4096,96), (8,1024,192), (8,256,384) both
   ways, the latent (8,64,768) both ways, the channel scans (8,c,8)) are
   timed in every row, each with its bound and its share of it, and K3's
   device ms per grid at each shape by torch.profiler; K2 also at the
   CUDA tests' ragged shapes (every width class, C no multiple of 16, H
   and W no multiple of the tiles, odd W); K5 at the five MamberBlock
   shapes of a served forward in bf16 ((8,96,128,128) first) and the five
   of the S1 step in fp32 ((8,48,64,64), (8,96,64,64), (8,96,32,32),
   (8,192,16,16), (8,384,8,8); its split-TF32 route, also held to the
   fp32 bar of its CPU model, rtol = atol = 1e-5), each timed beside its
   plain version, and at ragged shapes (every width class, E != C, C up
   to 704, odd W, batch 1), bf16 and fp32; two K5 calls at each fp32 step
   shape give the same bits, its packing kernel its plain version's, and
   a single-pass TF32 control misses the fp32 bar; K6 at the same five
   bf16 and five fp32 shapes, each timed beside its plain version, and at
   ragged shapes (the CUDA tests', partial tiles, D up to 768, a 1x1
   image) in each dtype pair and at views that start an odd number of
   elements into their buffers (its edge path); K3 also over a
   ragged L in many segments, reverse, and in ragged segments, forward;
   two K1 and two K1c calls on the same inputs at (8,2,96,16384) bf16,
   forward and reverse, and two K2 calls at (8,96,128,128) bf16 and
   (8,96,64,64) fp32 must give the same bits, and K3's du, ddelta, dB
   and dC on the seeded cases of `tools.ab` that fit one of its segments
   (fed by the plain carries) the bits recorded from its build
   (`vmambair_torch/tools/k3_digests.json`). K4 is timed at every shape
   of a served forward (the latent pair (8,256,768) bf16 both ways, the
   channel scans (8,c,8) fp32, c = 48, 96, 192, 384) and K4c at the S1
   step's (the latent (8,64,768) both ways and the same channel scans,
   fp32), each beside its plain version, its bound and an empty kernel's
   launch (`torch.cuda._sleep(0)`, the practical floor at these sizes);
   both at the CUDA tests' ragged shapes too (L no multiple of 8, 32 or
   256, several segments, N below and over a pass of 16 states, 3
   channels to a group), bf16 and fp32. For RealSR (MambaRealSR11): K4,
   K4c and K3 at the direct channel scans (9, c, 2), c = 48, 96, 192,
   384 (one channel to each of two groups), K4c and K3 at the latent
   (9,64,768) both ways, and K1c, K3 and K2 (fp32) at every batch-9 shape
   of its S1 step, each timed beside its bound. For deraining (Mamber33,
   fp32): K1c and K3 at the stage-1 step's fused shapes (8 x 128x128),
   K4c and K3 at its latent (8,256,768) and at the conv2 channel scans
   (8,c,4), K2 at its five shapes; stage 6 (1 x 384x384): K1c at
   (1,2,48,147456) and (1,2,96,147456), K4c and K3 at the latent
   (1,2304,768) over several segments, the channel scans (1,c,4) (K4
   too), K2 at (1,48,384,384); a whole-image evaluation: K1 at
   (1,2,96,262144) and K4 at (1,4096,768) (a 512x512 image), K2 at a
   481x321 image's padded (1,48,328,488) and (1,384,41,61); each timed
   beside its plain version and its bound; K4's state form (the
   sequence-parallel passes: from an entering state, with the last state)
   at phase 7f's level-1 shape (1,65536,96) fp32 (64 segments) and at the
   latent (8,256,768) bf16, each way, y in its dtype's envelope and the
   last state in fp32's, each timed beside its plain version and bound;
4. model  - MambaSISR6 widths at depth [1,1,1,1] + 1, one batch of 8
   128x128 tiles in fp32, kernels vs the plain path, within 1e-3;
4b. model gradients - the same depth, fp32, 8 x 64x64 LQ, L1 loss: every
   parameter's gradient through the kernels against the plain path on the
   card within 2e-3 of its largest entry, and every scan and GDFN
   parameter's gradient non-zero and finite; then the same at
   MambaRealSR11's widths (direct channel scans) on 9 x 64x64 LQ;
5. serve  - full-size MambaSISR6 (bf16 activations, fp32 weights, seeded
   weights) answers 3 requests of a 512x256 image through
   `RestorationUpscaler.tile_process` (tile 128, tile_pad 0, tile_batch 8:
   one batch of 8 tiles each), then one untimed `enhance` of a uint8
   image of the same size with `outscale=3.5` (the Lanczos-4 resize on the
   card); checks the output shapes, mode, finiteness and that each kernel
   launched exactly as often as the dispatch predicts for the 4 forwards;
   then a torch.profiler table of one more request is printed (top rows)
   and written to `chiprun_out/serve_profile.txt`, and K2's and K4's
   launches in that request by shape, each times phase 3's ms at the
   shape, against the profiler's K2 and K4 classes; after the race (below) one request with K5
   and K6 on is profiled the same way (`serve_front_tail_profile.txt`),
   with K5's launches by shape against the profiler's K5 class;
6. train  - full-size MambaSISR6 through `build_model` with the recipe of
   `options/MambaSISR15_x4.yml` (L1, Adam 2e-4 (0.9, 0.99), EMA 0.999,
   MultiStepLR), fp32, on one fixed seeded batch of 8 64x64 LQ / 256x256
   GT: 1 warm-up step and 5 timed steps (ms per step, GT MP/s, peak
   memory), the launches of every step against the dispatch's
   prediction, finite losses falling from step 1 to step 6; save, resume
   into a new model, one more step on each: the same step; a
   torch.profiler table of one step in `OUT_DIR/train_profile.txt`, and
   K2's, K3's and K4c's launches in that step by shape, each times phase
   3's ms at the shape, against the profiler's K2, K3 and K4 classes.
7. pipeline - `train_pipeline` with both OSS switches on (K5, K6) at the
   full size of the recipe, on a synthetic paired PNG dataset written by
   the port's encoder into `build/chip_smoke_data/` (16 pairs of 480x480
   GT / 120x120 LQ, 2 validation pairs, one with a 61x45 LQ): 8 steps,
   validation with PSNR-Y at iters 0, 4, 8 and the end, checkpoints at 4
   and 8, the launches of the whole run against the dispatch's prediction;
   auto-resume to iter 10; `test_pipeline`; `inference_torch.py --device
   cuda` on the validation LQ, outputs read back at 4x; ms per iteration
   and data ms per iteration from the pipeline's timers.
7b. gan - the S2 GAN stage with the recipe of
   `options/MambaSISR15GAN_x4.yml` at full width (MambaSISR6, the
   64-feature `UNetDiscriminatorSN` with skips, seeded VGG19 with the
   YAML's layer weights; L1 + perceptual + vanilla GAN, two Adams 1e-4
   (0.9, 0.99), EMA 0.999), fp32, on phase 6's batch of 8 64x64 LQ /
   256x256 GT. G starts from a checkpoint of a seeded G, saved by
   `save_network` and loaded through `pretrain_network_g` with
   `param_key_g: params_ema`. 1 warm-up and 5 timed iterations of
   `optimize_parameters` (ms per iteration, GT MP/s, the G and D steps'
   ms by CUDA events, peak memory), each checked: the launches equal the
   dispatch's prediction for a training step (K1c, K4c, K3, K2) and
   nothing else, every logged value finite, every spectral norm's u
   moved; G's and D's parameters moved over the run. A torch.profiler
   table of one iteration (`OUT_DIR/gan_profile.txt`) by class, with
   the idle share and the device ms of G, D and VGG19 apart (a kernel
   goes to the module whose forward, or whose forward's autograd node,
   launched it). One gated iteration (`net_d_init_iters` ahead): G's
   no-grad forward (K1, K4, K2) and no change to G or its EMA. Card
   against CPU at MambaSISR6's widths, depth [1,1,1,1] + 1 (D and VGG19
   at full width), 2 x 32x32 LQ / 128x128 GT, through the kernels on the
   card and through the plain versions on the CPU from the same weights,
   u and batch: d loss / d output at the card's output (pixel, GAN and
   perceptual terms up to conv2_2; VGG19's deeper max-pools and ReLUs
   are kinks that the paths' 1e-6 roundings cross, so the recipe's five
   layers are printed) within 2e-3 of its largest entry, G's backward of
   one upstream gradient within 2e-3 of each tensor's largest entry,
   then one iteration each, every D gradient within 2e-3 of its largest
   entry, every logged loss within 1e-3 (the iteration's G gradients
   printed). Then
   `train_pipeline` with the GAN recipe on phase 7's PNGs: 2 iterations,
   validation (PSNR-Y), net_g, net_d and the state at 2, auto-resume
   to 3, the launches of both runs against the prediction.
7c. realsr - both RealSR stages of MambaRealSR11 at full size (dim 48,
   blocks [6,2,2,1] + 6, the recipes of `options/mambaSR11_x4.yml` and
   `options/mambaSR11GAN_x4.yml`: 9 x 400x400 GT crops from
   `RealESRGANDataset` over 12 synthetic PNGs in
   `build/chip_smoke_realsr/` (9 of 480x480: the crop; 3 smaller: the
   pad), the two-order synthesis to 256x256 GT / 64x64 LQ, queue 180,
   fp32). The synthesis on the card against the same synthesis on the
   CPU from the same draws and noise samples (3 seeds): the GT crops
   equal, the USM sharpener's hard mask flipping only at ties and its
   output within 1e-5 outside the flips' footprints, at most 2% of the
   LQ's elements off (JPEG's rounds and the uint8 grid), at most 0.5% by
   more than one uint8 step. 1 warm-up and 5 timed S1 steps (feed +
   optimize: ms, GT MP/s, the synthesis's device and host ms, the queue's
   ms, peak memory), each step's launches against the dispatch's
   prediction (K1c 52, K4c 29, K3 81, K2 27); the full queue's shuffle
   and swap; a profiled step with K1c, K2, K3 and K4c by shape; 1 warm-up
   and 3 timed GAN iterations from the S1 checkpoint's EMA (G / D step
   ms), one of them profiled (G / D / VGG19), D alone at batch 8, 9 and
   16; `train_pipeline` with the S1 recipe (3 iterations, validation on
   phase 7's pairs) and with the GAN recipe from its checkpoint (2
   iterations), their launches against the prediction.
7d. derain - the deraining harness of Mamber33 at full size (dim 48,
   blocks [3,5,7,9] + 2, conv2 channel scans, the recipe of
   `options/Deraining_mamber33.yml`: AdamW 3e-4 with a global-norm clip
   of 0.01, the cyclic cosine schedule, L1, fp32) on synthetic clean /
   rainy PNG pairs written by the port's encoder into
   `build/chip_smoke_derain/` (12 training pairs, 9 of 480x480 and 3
   smaller than 384 on a side: the pad; evaluation pairs of 481x321 and
   512x512). Loader batches of 8 x 384x384 through the progressive
   schedule: each of the six stages after a warm-up step of its own
   (stages 1 and 6 three timed steps, the others one): ms per step, GT
   MP/s, peak memory, each step's launches (K1c 64, K4c 59, K3 123, K2
   41, nothing else), finite losses; one stage-1 and one stage-2 step
   profiled by class, stage 1's K1c, K2, K3 and K4c by shape (launches
   times phase 3's ms against the profiler's class); `test` on each
   whole evaluation image (the reflect pad to the window, the forward,
   the crop), best of 2 after a first call, and its peak memory.
   `train_pipeline` on the recipe
   with iters [2,1,1,1,1,1] (every stage once), validation (PSNR-Y, SSIM-Y)
   on the two whole images before, at 7 and after, a checkpoint at 7,
   an auto-resume to 8; `test_pipeline` with the recipe of
   `options/test_Deraining_mamber33.yml`, its five sets on the evaluation
   pairs, from the run's checkpoint; each evaluation forward K1 64, K4
   59, K2 41; ms and data ms per iteration. The kernels against the plain
   path at Mamber33's and Mamber32's widths and the dual-pixel Mamber33's
   (six channels in), depth [1,1,1,1] + 1: the forward on 2 x 64x64 and
   on one 40x56 image within 1e-3, every gradient within 2e-3 of its
   largest entry. Two `train_pipeline` iterations of that depth on each
   task dataset (Gaussian denoising, 16-bit dual-pixel defocus, deblur).
7e. metrics - the learned metrics in whole-image validation:
   `test_pipeline` with the seeded full-width MambaRealSR11 (the
   network_g of `options/mambaSR11GAN_x4.yml`) on 4 synthetic pairs of
   128x128 LQ / 512x512 GT written by the port's encoder into
   `build/chip_smoke_metrics/`, `val.metrics` psnr and ssim (Y, crop 4),
   lpips, dists and niqe (crop 4): the launches (K1 52, K4 29, K2 27 per
   forward, nothing else), the reported keys (lpips_uncalibrated and
   dists_uncalibrated on the seeded VGG16), peak memory; the first
   forward again (batch 1, the launches of one) against the plain path,
   the fp32 SR output within 1e-3; each metric again
   on the card on the saved SR images (ms per 512x512 image, its mean
   equal to the logged value), LPIPS and DISTS against the CPU on the
   same uint8 images within 1e-4 of the CPU's value plus 1e-6, NIQE within
   1e-3 with its gamma argmins equal but at ties (reported); InceptionV3
   pool3 of the 4 SR and 4 GT images resized to 299 with a seeded `.npz`,
   card against CPU within 1e-4 of the largest feature, its ms per batch
   of 8, and the FID of SR against GT (scipy on the host) against the
   exact distance of those 4 + 4 features (the rank-3 identity) within
   1e-4 relative.
7f. distributed - data parallelism and the sequence-parallel scan at
   world 1 over NCCL (one card), in one torchrun of one rank
   (`python -m torch.distributed.run --standalone --nproc_per_node 1
   chip_smoke.py --rank OUT TRAIN_ARGS --then INFER_ARGS`, the rank
   running `train_torch.py`'s code on TRAIN_ARGS, then
   `inference_torch.py --sp`'s on INFER_ARGS over the same group): the S1
   pipeline of full-width MambaSISR6 under `--launcher pytorch` for 2
   iterations on phase 7's PNGs, its launches (K1c 98, K4c 52, K2 50, K3
   150 a step, as predicted), its iteration 2 traced by the step profiler
   (`train.profile_dir`; the table in `OUT_DIR/ddp_step_profile.txt`), its
   checkpoint without a `module.` prefix; then DDP and plain steps in
   turns on phase 6's batch, each from the pipeline's final state (ms of
   each), the DDP step held against the plain one: l_pix within 1e-5
   relative, each gradient within 1e-4 of its tensor's largest entry,
   each tensor's update within 1e-2 of the plain update (L2; a skipped
   update stands at 1); `inference_torch.py --sp` on one 256x256 LQ at
   full width from that checkpoint: launches as
   `expected_launches(sp=True)` predicts (K4's state form 4 a block, K4
   for the channel scans, K2, no K1), the output PNG within one grey
   level of the normal path's, the forward's ms beside the normal one's,
   and its device ms by class;
8. probes - the scan-design probes (`vmambair_torch/tools/`) at
   MambaSISR6's full-resolution scan (B=8 tiles of 128x128, L=16384, G=2
   groups x 96 channels, N=16; kvariants' model-realistic recipe): K7
   (`selective_scan_ld_fwd`), `scan_seq` and `scan_lpar` against the plain
   scan, bf16 (3e-2 / 5e-2) and fp32 (6e-4 / 2e-3), forward and reverse,
   on DL, channels-last and kseq views; kvariants' v16 (`scan_combined`,
   y and the chunk-local reverse y2), v3 and v10 (`scan_stack_ab`,
   `scan_stack_b`) in bf16 against their plain versions (the bf16
   envelope; the stacks' error against the exact scan printed beside),
   and the stacks again with each position's last composition in bf16
   (`last_bf16`, the TPU's rounding), checked, then raced against the
   default and lpar_1024; the
   five kpeak probes at REP 64 against their plain versions (fp32 within a
   relative 1e-5, bf16 the envelope); then, counts reset, the probe path
   through the tools' entry points: kvariants' race against K4 and
   lpar_1024 (v16 against twice lpar_1024's time, the stacks against
   once), kseq with and without its relayout, kpeak's rates, each kernel's
   launches against what the tools scheduled. Every scan's bound gains
   its exp2 term (one SFU exp2 per (b, l, d, n)), phase 3's rows included,
   at the larger of the SFU's nominal rate and the measured exp rate, both
   printed. 8c: kvariants' 15 separated-exponent names (the matmul dual
   v22-v26 and the cumsum form v4, csrc/scan_dual.cu) once each at the
   probe shape, their first 2048 positions against their plain versions
   (the bf16 envelope) under the model-realistic recipe, where each must
   also sit inside the exact scan's envelope, and under the hot default
   one, where their distance from the exact scan is printed (v4, which
   overflows there, compared where it and its plain version are finite);
   one name per kernel timed beside its plain version. The race of 8b
   runs the 15 names too.
9. keffn and kprobe - keffn's fused GDFN (`gdfn_tanh_nhwc`, K2's kernel
   with a tanh gate on NHWC images) at the TPU probe's five level shapes
   (8 x 128x128x48, 128x128x96, 64x64x96, 32x32x192, 16x16x384) and
   kprobe's transpose pair and projections at (8, 16384, 96), bf16 and
   fp32, against their plain versions (the forward envelope; the
   transpose pair bit-equal, as is the library call `u * 1.000001` timed
   beside it; the projections in fp32 also within 1e-5 of the plain
   version's largest entry, which a single-pass TF32 control misses, and
   timed in both dtypes beside their bounds); then, counts reset, the two
   tools' entry points: keffn's
   race against the cuDNN composite and K2 on NCHW copies, kprobe's
   against its bound, each kernel's launches against what the tools
   scheduled.
10. kldio and kdualnum - kldio's kernel (`ld_fused`, K1 with its
   channels-last layout policy) at the TPU probe's shape (8, 2, 16384, 96)
   against its plain version, forward and reverse, bf16 and fp32 (the
   forward envelope), and K1's own (channels-first) policy bit-identical
   to the recorded build on 48 seeded cases of K1 and K1c
   (`vmambair_torch/tools/k1_digests.json`); then, counts reset, kldio's
   race (the production op with its two copies, the kernel, K1 alone on
   a channels-first copy, the bound and each row's share of it) with its
   launches against what the tool scheduled, and kdualnum's rows on the
   full-width MambaSISR6 at 48x48, its forward's launches against the
   dispatch's prediction.

The OSS switches (`VMAMBAIR_OSS_FRONT`, `VMAMBAIR_OSS_TAIL`) are off except
where a phase turns them on: phase 3 holds K5 and K6 against their plain
versions (fp32 and bf16, the forward envelope), phases 4 and 4b run once
with them off and once on, and phase 5 races served forwards with them off
and on (interleaved, 6 of each; K5 and K6 once per MamberBlock when on,
never when off). fp32 matrix products and convolutions run in full fp32
(TF32 off). The second-to-last lines are a JSON object of the kernels
(for K1-K6 the launches in the serve, train, pipeline, GAN, RealSR,
deraining, metrics and distributed phases, for K4's state form those of
the distributed phase,
for the probe kernels those of the probe paths of phases 8 to 10, which
must be at least one each; a launch is one call of the kernel's wrapper, which for K1, K1c and
`ld_fused` is four grids and for `scan_lpar`, `scan_combined` and the
stacks three, `grids_per_launch` in its entry;
max error, times and bound from phases 3 and 8-10) and the card's name and
power limit from nvidia-smi; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vmambair_torch import _build
from vmambair_torch.models import MamberBlock, build_network
from vmambair_torch.ops import cuda_effn, cuda_probes, cuda_scan
from vmambair_torch.tools import (BF16_TC_FLOPS, FP32_FLOPS, HBM_BPS,
                                  SFU_NOMINAL, TF32_TC_FLOPS, ab, hold,
                                  kdualnum, keffn, kldio, kpeak, kprobe, kseq,
                                  kvariants)
from vmambair_torch.train import build_model
from vmambair_torch.train.checkpoint import save_network
from vmambair_torch.train.pipeline import test_pipeline, train_pipeline
from vmambair_torch.utils.img_util import imread, imwrite
from vmambair_torch.utils.options import finalize_options
from vmambair_torch.utils.profiling import event_totals, totals_table
from vmambair_torch.utils.upscaler import RestorationUpscaler

PALLAS = "vmambair_tpu/ops/pallas_scan.py"
KERNELS = {
    "oss_scan_fused": dict(
        fn=cuda_scan.oss_scan_fused_fwd,
        source="vmambair_torch/csrc/oss_scan_fused.cu",
        replaces=f"{PALLAS}:1112", path="model",
        grids_per_launch=cuda_scan.K1_GRIDS),
    "oss_scan_fused_carries": dict(
        fn=cuda_scan.oss_scan_fused_fwd_carries,
        source="vmambair_torch/csrc/oss_scan_fused.cu",
        replaces=f"{PALLAS}:1161", path="model",
        grids_per_launch=cuda_scan.K1_GRIDS),
    "selective_scan": dict(
        fn=cuda_scan.selective_scan_fwd,
        source="vmambair_torch/csrc/selective_scan.cu",
        replaces=f"{PALLAS}:74", path="model"),
    "selective_scan_carries": dict(
        fn=cuda_scan.selective_scan_fwd_carries,
        source="vmambair_torch/csrc/selective_scan.cu",
        replaces=f"{PALLAS}:401", path="model"),
    # K4's state form: the sequence-parallel scan's passes (phase 7f)
    "selective_scan_state": dict(
        fn=cuda_scan.selective_scan_fwd_state,
        source="vmambair_torch/csrc/selective_scan.cu",
        replaces=f"{PALLAS}:74", path="sp"),
    "selective_scan_bwd": dict(
        fn=cuda_scan.selective_scan_bwd,
        source="vmambair_torch/csrc/selective_scan_bwd.cu",
        replaces=f"{PALLAS}:694", path="model"),
    "gdfn_residual_fused": dict(
        fn=cuda_effn.gdfn_residual_fwd,
        source="vmambair_torch/csrc/gdfn.cu",
        replaces="vmambair_tpu/ops/pallas_effn.py:119", path="model"),
    "oss_front_fused": dict(
        fn=cuda_effn.oss_front_fwd,
        source="vmambair_torch/csrc/oss_front.cu",
        replaces="vmambair_tpu/ops/pallas_effn.py:269", path="model"),
    "oss_tail_fused": dict(
        fn=cuda_effn.oss_tail_fwd,
        source="vmambair_torch/csrc/oss_tail.cu",
        replaces="vmambair_tpu/ops/pallas_effn.py:444", path="model"),
    # phase 8's kernels: K7 and the scan-design probes
    "selective_scan_ld": dict(
        fn=cuda_scan.selective_scan_ld_fwd,
        source="vmambair_torch/csrc/scan_seq.cu",
        replaces=f"{PALLAS}:493", path="probe"),
    "scan_seq": dict(
        fn=cuda_probes.scan_seq,
        source="vmambair_torch/csrc/scan_seq.cu",
        replaces="tools/kseq.py:75", path="probe"),
    "scan_lpar": dict(
        fn=cuda_probes.scan_lpar,
        source="vmambair_torch/csrc/scan_lpar.cu",
        replaces="tools/kvariants.py:85", path="probe",
        grids_per_launch=cuda_probes.SCAN_LPAR_GRIDS),
    "scan_combined": dict(
        fn=cuda_probes.scan_combined,
        source="vmambair_torch/csrc/scan_lpar.cu",
        replaces="tools/kvariants.py:710", path="probe",
        grids_per_launch=cuda_probes.SCAN_LPAR_GRIDS),
    "scan_stack_ab": dict(
        fn=cuda_probes.scan_stack_ab,
        source="vmambair_torch/csrc/scan_stack_bf16.cu",
        replaces="tools/kvariants.py:122", path="probe",
        grids_per_launch=cuda_probes.SCAN_LPAR_GRIDS),
    "scan_stack_b": dict(
        fn=cuda_probes.scan_stack_b,
        source="vmambair_torch/csrc/scan_stack_bf16.cu",
        replaces="tools/kvariants.py:326", path="probe",
        grids_per_launch=cuda_probes.SCAN_LPAR_GRIDS),
    "peak_fma_fp32": dict(
        fn=cuda_probes.peak_fma_fp32, source="vmambair_torch/csrc/peak.cu",
        replaces="tools/kpeak.py:56", probe="fma_fp32", path="probe"),
    "peak_fma_bf16": dict(
        fn=cuda_probes.peak_fma_bf16, source="vmambair_torch/csrc/peak.cu",
        replaces="tools/kpeak.py:56", probe="fma_bf16", path="probe"),
    "peak_exp": dict(
        fn=cuda_probes.peak_exp, source="vmambair_torch/csrc/peak.cu",
        replaces="tools/kpeak.py:69", probe="exp_fp32", path="probe"),
    "peak_roll": dict(
        fn=cuda_probes.peak_roll, source="vmambair_torch/csrc/peak.cu",
        replaces="tools/kpeak.py:76", probe="roll+add_fp32", path="probe"),
    "peak_shift": dict(
        fn=cuda_probes.peak_shift, source="vmambair_torch/csrc/peak.cu",
        replaces="tools/kpeak.py:83", probe="concatshift+add_fp32",
        path="probe"),
    # phase 8c's kernels: kvariants' separated-exponent scans
    "scan_dual_v22": dict(
        fn=cuda_probes.scan_dual_v22,
        source="vmambair_torch/csrc/scan_dual.cu",
        replaces="tools/kvariants.py:784", path="probe"),
    "scan_dual_v24": dict(
        fn=cuda_probes.scan_dual_v24,
        source="vmambair_torch/csrc/scan_dual.cu",
        replaces="tools/kvariants.py:863", path="probe"),
    "scan_dual_v26": dict(
        fn=cuda_probes.scan_dual_v26,
        source="vmambair_torch/csrc/scan_dual.cu",
        replaces="tools/kvariants.py:955", path="probe"),
    "scan_cumsum": dict(
        fn=cuda_probes.scan_cumsum,
        source="vmambair_torch/csrc/scan_dual.cu",
        replaces="tools/kvariants.py:151", path="probe"),
    # phase 9's kernels: keffn's fused GDFN and kprobe's relayout probes
    "gdfn_tanh_nhwc": dict(
        fn=cuda_probes.gdfn_tanh_nhwc, source="vmambair_torch/csrc/gdfn.cu",
        replaces="tools/keffn.py:46", path="probe"),
    "probe_transpose": dict(
        fn=cuda_probes.probe_transpose,
        source="vmambair_torch/csrc/probe_io.cu",
        replaces="tools/kprobe.py:45", path="probe"),
    "probe_proj": dict(
        fn=cuda_probes.probe_proj, source="vmambair_torch/csrc/probe_io.cu",
        replaces="tools/kprobe.py:79", path="probe"),
    # phase 10's kernel: kldio's channels-last fused scan
    "ld_fused": dict(
        fn=cuda_probes.ld_fused,
        source="vmambair_torch/csrc/oss_scan_fused.cu",
        replaces="tools/kldio.py:62", path="probe",
        grids_per_launch=cuda_scan.K1_GRIDS),
}
# `path`: where a kernel's launches are counted, the model's paths (serve,
# train, pipeline), the sequence-parallel path of phase 7f, or the probe
# paths of phases 8 to 10
MODEL_KERNELS = tuple(n for n, k in KERNELS.items()
                      if k["path"] in ("model", "sp"))
# K1's (b, d, L) in a served forward of 8 128x128 tiles: decoder_level1
# and refinement (60 launches), encoder_level1 (30), levels 2 and 3 (4 each)
K1_SERVE_SHAPES = ((8, 96, 16384), (8, 48, 16384), (8, 96, 4096),
                   (8, 192, 1024))
# K2's (b, c, h, w) in a served forward of 8 128x128 tiles (decoder_level1
# and refinement 30 launches, encoder_level1 15, the lower levels 2, 2 and
# 1) and in the S1 step on 8 64x64 crops (the same blocks)
K2_SERVE_SHAPES = ((8, 96, 128, 128), (8, 48, 128, 128), (8, 96, 64, 64),
                   (8, 192, 32, 32), (8, 384, 16, 16))
K2_STEP_SHAPES = ((8, 48, 64, 64), (8, 96, 64, 64), (8, 96, 32, 32),
                  (8, 192, 16, 16), (8, 384, 8, 8))
# the CUDA tests' K2 shapes (`tests/test_torch_port_cuda.py`,
# GDFN_SHAPES): every width class, C no multiple of 16 or of its class's
# width, H and W no multiple of the tiles, an odd W, batch 1
K2_RAGGED_SHAPES = ((2, 48, 13, 19), (2, 96, 8, 8), (2, 384, 5, 7),
                    (1, 192, 13, 19), (1, 40, 9, 33), (1, 72, 17, 10),
                    (2, 136, 7, 11), (1, 264, 6, 10), (1, 20, 30, 2))
# K5's (b, c, h) at the five MamberBlock shapes of a served forward (E = C,
# square images; the first, 30 of the 50 blocks, is the main shape), and
# its ragged (b, c, e, h, w): the CUDA tests' shapes, then every width
# class with E != C, C no multiple of 16, H and W no multiple of the tiles,
# an odd W, batch 1, a 1x1 image and the widest C the route takes
K5_SERVE_SHAPES = ((8, 96, 128), (8, 48, 128), (8, 96, 64), (8, 192, 32),
                   (8, 384, 16))
# K5's (b, c, h) at the S1 step's five MamberBlock shapes with the switch
# on (fp32, E = C; (8, 96, 64), 30 of the 50 blocks, the main one)
K5_STEP_SHAPES = ((8, 48, 64), (8, 96, 64), (8, 96, 32), (8, 192, 16),
                  (8, 384, 8))
K5_RAGGED_SHAPES = ((2, 48, 48, 13, 19), (2, 96, 100, 8, 8),
                    (2, 384, 384, 5, 7), (2, 20, 70, 3, 33),
                    (1, 40, 52, 9, 33), (1, 72, 72, 17, 10),
                    (1, 136, 72, 7, 11), (1, 200, 200, 16, 16),
                    (1, 264, 136, 6, 10), (1, 640, 64, 5, 8),
                    (1, 704, 704, 6, 10), (1, 20, 20, 30, 2),
                    (2, 96, 96, 1, 1))
# K6's ragged (b, d, h, w): the CUDA tests' shapes (13 x 19, 9 x 16 and 5
# x 7 on the edge path), partial tiles on the 16-byte route (24 x 40), the
# widest D (a cluster of 16), a D of no width class's multiple, a 1 x 1
# image
K6_RAGGED_SHAPES = ((2, 48, 13, 19), (2, 96, 16, 16), (2, 192, 9, 16),
                    (2, 384, 5, 7), (2, 96, 24, 40), (1, 768, 16, 16),
                    (2, 200, 8, 24), (1, 40, 8, 8), (2, 96, 1, 1))
# the CUDA tests' K4 / K4c shapes past the main path's (`tests/
# test_torch_port_cuda.py`, K4_CASES): (b, L, D, G, N, layout), an L no
# multiple of 8, 32 or 256, L over several segments, N below a pass of 16
# and over it (passes), 3 channels to a group, on the model's views (a
# latent pair's or a channel scan's)
K4_RAGGED_SHAPES = ((2, 77, 8, 2, 16, "channel"), (2, 77, 6, 2, 5, "pair"),
                    (2, 3001, 8, 2, 16, "channel"),
                    (1, 2100, 6, 2, 40, "pair"),
                    (2, 77, 96, 4, 200, "pair"),
                    (1, 300, 24, 2, 200, "channel"),
                    (2, 256, 64, 2, 16, "pair"))
# the RealSR S1 step (options/mambaSR11_x4.yml: MambaRealSR11, 9 x 64x64
# LQ / 256x256 GT): K1c's (b, d, L) (decoder_level1 and refinement 24
# launches, encoder_level1 12, levels 2 and 3 8 each), K2's (b, c, h, w)
# (12 / 6 / 4 / 4 / 1 by level) and the direct channel scans' widths, each
# a (9, c, 2) scan with one channel to each of its two groups
K1C_REALSR_SHAPES = ((9, 96, 4096), (9, 48, 4096), (9, 96, 1024),
                     (9, 192, 256))
K2_REALSR_SHAPES = ((9, 96, 64, 64), (9, 48, 64, 64), (9, 96, 32, 32),
                    (9, 192, 16, 16), (9, 384, 8, 8))
DIRECT_WIDTHS = (48, 96, 192, 384)
# Mamber33's deraining step (options/Deraining_mamber33.yml, fp32): K1c's
# (b, d, L) at stage 1, 8 x 128x128 (level 1: encoder 3 blocks at 48,
# decoder and refinement 5 at 96; level 2 10 blocks, level 3 14; 2 pairs
# each), and at stage 6's level 1, 1 x 384x384; K2's (b, c, h, w) at
# stage 1 (3 / 5 / 10 / 14 / 9 launches), at stage 6's level 1, and a
# 481x321 evaluation image's padded level 1 and latent (488x328)
DERAIN_K1C_SHAPES = ((8, 96, 16384), (8, 48, 16384), (8, 96, 4096),
                     (8, 192, 1024), (1, 48, 147456), (1, 96, 147456))
DERAIN_K2_SHAPES = ((8, 48, 128, 128), (8, 96, 128, 128), (8, 96, 64, 64),
                    (8, 192, 32, 32), (8, 384, 16, 16), (1, 48, 384, 384),
                    (1, 48, 328, 488), (1, 384, 41, 61))
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
# K2's and K5's fp32 routes past the envelope: their split-TF32 products
# keep fp32's accuracy, so they are held to the fp32 bar of their CPU
# models (tests/test_torch_port_k2_tiles.py, test_torch_port_k5_tiles.py),
# which a single-pass TF32 product misses (`k2f_control`)
K2F_TOL = (1e-5, 1e-5)
BWD_TOL = (3e-3, 1e-2)
GRAD_BAR = 2e-3
OUT_DIR = "chiprun_out"
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores and bf16 dense tensor-core FLOP/s (HBM_BPS, FP32_FLOPS,
# BF16_TC_FLOPS, shared with the probes)
# rates no data sheet gives: bf16x2 FMA on the CUDA cores at twice the fp32
# rate; the SFU's nominal exp2 rate (SFU_NOMINAL, shared with the probes).
# The exp2 term of every bound divides by the larger of that and the ex2
# rate phase 8 measures, so that no bound rests on a rate below the card's.
BF16X2_FLOPS = 2 * FP32_FLOPS
# the S1 recipe of options/MambaSISR15_x4.yml (the script reads no YAML:
# the card's machine need not have a YAML parser)
RECIPE = {
    "name": "MambaSISR15_x4", "model_type": "MambaSISRModel", "scale": 4,
    "manual_seed": 0, "is_train": True,
    "network_g": {"type": "MambaSISR6", "inp_channels": 3,
                  "out_channels": 3, "dim": 48,
                  "num_blocks": [15, 1, 1, 1], "num_refinement_blocks": 15,
                  "ffn_expansion_factor": 2.66, "bias": False,
                  "LayerNorm_type": "WithBias"},
    "train": {"ema_decay": 0.999,
              "optim_g": {"type": "Adam", "lr": 2e-4, "weight_decay": 0,
                          "betas": [0.9, 0.99]},
              "scheduler": {"type": "MultiStepLR",
                            "milestones": [50000, 70000], "gamma": 0.5},
              "total_iter": 100000, "warmup_iter": -1,
              "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                            "reduction": "mean"}},
    "val": {"window_size": 8},
}
SCAN_PARAMS = ("x_proj_weight", "dt_projs_weight", "dt_projs_bias",
               "A_logs", "Ds", "xc_proj_weight", "dtc_projs_weight",
               "dtc_projs_bias", "Ac_logs", "Dsc")
GDFN_PARAMS = ("ffn.project_in.weight", "ffn.dwconv.weight",
               "ffn.project_out.weight", "norm2.body.weight",
               "norm2.body.bias")
# parameters K5 (norm1 .. conv2d) and K6 (out_norm) take
FRONT_TAIL_PARAMS = ("attn.in_conv.weight", "attn.in_conv.bias",
                     "attn.conv2d.weight", "attn.conv2d.bias",
                     "attn.out_norm.body.weight", "attn.out_norm.body.bias",
                     "norm1.body.weight", "norm1.body.bias")
SWITCHES = ("VMAMBAIR_OSS_FRONT", "VMAMBAIR_OSS_TAIL")


def expected_launches(net, train: bool = False, sp: bool = False) -> dict:
    """Kernel launches of one forward (train: one training step), as the
    port's dispatch routes it: per MamberBlock two spatial pair scans (K1
    when the width is at most 256, else K4), one channel scan (K4) and one
    GDFN (K2), and with the switches on one OSS front (K5) and one OSS
    tail (K6). A training step takes the carry-saving forwards (K1c, K4c)
    instead of K1 and K4, and one scan backward (K3) per scan; K2, K5 and
    K6 have no backward kernel. sp: a `scan_impl: "sp"` forward whose
    every L divides over the group: each spatial pair scan is two launches
    of K4's state form (`parallel/sp_scan.py`'s passes), no K1."""
    out = dict.fromkeys(KERNELS, 0)
    sfx = "_carries" if train else ""
    for m in net.modules():
        if not isinstance(m, MamberBlock):
            continue
        wide = not cuda_scan.fused_scan_supported(m.attn.d_inner,
                                                  m.attn.d_state)
        if sp:
            out["selective_scan_state"] += 4
        else:
            out[("selective_scan" if wide else "oss_scan_fused")
                + sfx] += 2
        out["selective_scan" + sfx] += 1
        if train:
            out["selective_scan_bwd"] += 3
        if not m.use_bias and m.ln_bias:
            out["gdfn_residual_fused"] += 1
        if m.ln_bias and cuda_effn.oss_front_supported():
            out["oss_front_fused"] += 1
        if cuda_effn.oss_tail_supported():
            out["oss_tail_fused"] += 1
    return out


@contextlib.contextmanager
def oss_switches(on: bool):
    """Turns K5 and K6 on (or off) for the phase inside."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    os.environ.update({k: "1" if on else "0" for k in SWITCHES})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_launches():
    for k in KERNELS.values():
        k["fn"].launches = 0


def launches() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


# phase 3 times a plain version once where its reference call took longer
# than this (s), and takes the median of 3 below it
PLAIN_ONCE_S = 0.05


def time_ms(fn, reps=5, warm=True) -> float:
    """Median over `reps` of CUDA-event time, after one warm-up call (none
    with `warm=False`, where the caller has just made it); each call
    queued behind a device sleep (`tools.hold`), so that a call shorter
    than its host-side launch path is timed on the card alone."""
    if warm:
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        hold()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def check_close(name, got, ref, rtol, atol) -> float:
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise SystemExit(f"FAIL {name}: shape {tuple(got.shape)} vs "
                         f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err = err.max().item()
    if bad.any():
        raise SystemExit(
            f"FAIL {name}: {int(bad.sum())} of {bad.numel()} elements off "
            f"(max abs err {max_err:.3e}, rtol {rtol}, atol {atol})")
    return max_err


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved, fp32_ops, bf16_mma=0, exp2=0, tf32_mma=0) -> dict:
    """The terms of the least time the card could take for a call: the
    bytes over the HBM rate and the operations over their peak rates (ms),
    and the count of SFU exp2s, whose term `finish_bound` adds once phase 8
    has measured the ex2 rate to set beside the nominal one."""
    return dict(bytes_ms=bytes_moved / HBM_BPS * 1e3,
                ops_ms=(fp32_ops / FP32_FLOPS + bf16_mma / BF16_TC_FLOPS
                        + tf32_mma / TF32_TC_FLOPS) * 1e3, exp2=exp2)


def finish_bound(terms, ex2_rate=None) -> dict:
    """The largest of the bound's terms: bytes, operations, and (given the
    ex2 rate, per second: the larger of the nominal and the measured one)
    the exp2s."""
    t_o = terms["ops_ms"]
    if terms["exp2"] and ex2_rate:
        t_o = max(t_o, terms["exp2"] / ex2_rate * 1e3)
    t_b = terms["bytes_ms"]
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


# -- phase 1 + 2 ---------------------------------------------------------------

def probe():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    cap = torch.cuda.get_device_capability(0)
    print(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[probe] device {torch.cuda.get_device_name(0)} capability {cap} "
          f"count {torch.cuda.device_count()}")
    print(f"[probe] nvidia-smi: {nvidia_smi_line()}")
    if cap != (9, 0):
        raise SystemExit(f"FAIL probe: capability {cap}; the kernels are "
                         "built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build():
    t0 = time.perf_counter()
    _build.load_library()
    lib = _build.build()
    print(f"[build] {lib} in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        for line in f:
            if "Used" in line or "spill" in line or "Compiling" in line:
                print("[build] " + line.strip())


# -- phase 3: kernels vs plain -------------------------------------------------

def _fused_case(b, d, L, dtype, gen):
    N, R = 16, -(-d // 16)
    dev = "cuda"
    dt = torch.exp(torch.rand(2, d, generator=gen)
                   * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    args = (
        torch.randn(b, 2, d, L, generator=gen).to(dev, dtype),
        ((torch.rand(2, R + 2 * N, d, generator=gen) * 2 - 1)
         / d ** 0.5).to(dev),
        ((torch.rand(2, d, R, generator=gen) * 2 - 1) / R ** 0.5).to(dev),
        (dt + torch.log(-torch.expm1(-dt))).to(dev),
        -torch.arange(1, N + 1.0).expand(2, d, N).contiguous().to(dev),
        torch.ones(2, d, device=dev),
    )
    return args


def _scan_case(b, L, d, dtype, gen, n_groups=2, N=16, lifted=True):
    """Inputs laid out as the model passes them: for the latent pairs u,
    delta views of (B, 2D, L) buffers and B, C views of x_dbl, the
    model's einsums' own outputs; for the channel scan u and delta
    contiguous (B, L, 8) and B, C views of x_dbl's (B, 2, L, M) (M = R +
    2N, R = 1)."""
    dev = "cuda"
    dg = d // n_groups
    A = -torch.exp(torch.rand(d, N, generator=gen) * 2).to(dev)
    Dsk = torch.randn(d, generator=gen).to(dev)
    bias = (torch.rand(d, generator=gen) * 2 - 3).to(dev)
    if lifted:  # the projections as `models/oss.py` runs them
        R = -(-dg // 16)
        u2 = torch.randn(b, n_groups, dg, L, generator=gen).to(dev, dtype)
        xpw = ((torch.rand(n_groups, R + 2 * N, dg, generator=gen) * 2 - 1)
               / dg ** 0.5).to(dev)
        dtw = ((torch.rand(n_groups, dg, R, generator=gen) * 2 - 1)
               / R ** 0.5).to(dev)
        x_dbl = torch.einsum("bgdl,gcd->bgcl", u2.float(), xpw)
        dts = torch.einsum("bgrl,gdr->bgdl", x_dbl[:, :, :R], dtw)
        u = u2.reshape(b, d, L).transpose(1, 2)
        delta = dts.reshape(b, d, L).transpose(1, 2)
        Bm = x_dbl[:, :, R:R + N].permute(0, 3, 1, 2)
        Cm = x_dbl[:, :, R + N:].permute(0, 3, 1, 2)
    else:
        u = torch.randn(b, L, d, generator=gen).to(dev, dtype)
        delta = torch.randn(b, L, d, generator=gen).to(dev)
        xdbl = torch.randn(b, n_groups, L, 1 + 2 * N, generator=gen).to(
            dev).transpose(1, 2)
        Bm, Cm = xdbl[..., 1:1 + N], xdbl[..., 1 + N:]
    return (u, delta, A, Bm, Cm, Dsk, bias)


def _k4_ragged_case(b, L, D, G, N, layout, dtype, gen):
    """K4's inputs at a ragged shape, u in `dtype`: a latent pair's views
    ("pair": u, delta (b, L, D) views of (b, D, L), B and C views of
    x_dbl's (b, G, R + 2N, L)) or a channel scan's ("channel": u, delta
    contiguous, B and C views of x_dbl's (b, G, L, R + 2N)), R = 3."""
    dev, R = "cuda", 3
    M = R + 2 * N
    if layout == "pair":
        u = torch.randn(b, D, L, generator=gen).to(dev, dtype).transpose(1, 2)
        delta = torch.randn(b, D, L, generator=gen).to(dev).transpose(1, 2)
        xdbl = torch.randn(b, G, M, L, generator=gen).to(dev).permute(
            0, 3, 1, 2)
    else:
        u = torch.randn(b, L, D, generator=gen).to(dev, dtype)
        delta = torch.randn(b, L, D, generator=gen).to(dev)
        xdbl = torch.randn(b, G, L, M, generator=gen).to(dev).transpose(1, 2)
    return (u, delta, -torch.exp(torch.rand(D, N, generator=gen) * 2).to(
                dev), xdbl[..., R:R + N], xdbl[..., R + N:],
            torch.randn(D, generator=gen).to(dev),
            (torch.rand(D, generator=gen) * 2 - 3).to(dev))


def _gdfn_case(b, c, hw, dtype, gen, w=None):
    """K2's inputs at (b, c, hw, w or hw), hid = int(2.66 c)."""
    hid = int(c * 2.66)
    dev = "cuda"
    return (
        (0.5 * torch.randn(b, c, hw, w or hw, generator=gen)).to(dev, dtype),
        (1 + 0.1 * torch.randn(c, generator=gen)).to(dev),
        (0.1 * torch.randn(c, generator=gen)).to(dev),
        ((torch.rand(2 * hid, c, generator=gen) * 2 - 1) / c ** 0.5).to(dev),
        ((torch.rand(2 * hid, 3, 3, generator=gen) * 2 - 1) / 3).to(dev),
        ((torch.rand(c, hid, generator=gen) * 2 - 1) / hid ** 0.5).to(dev),
    )


def _front_case(b, c, hw, dtype, gen, e=None, w=None):
    """K5's inputs at (b, c, hw, w or hw) with E = e or C, drawn on the
    card."""
    e = e or c

    def r(*shape):
        return torch.rand(*shape, generator=gen, device="cuda") * 2 - 1
    return ((0.5 * torch.randn(b, c, hw, w or hw, generator=gen,
                               device="cuda")).to(dtype),
            1 + 0.1 * r(c), 0.1 * r(c), r(2 * e, c) / c ** 0.5,
            r(2 * e) / c ** 0.5, r(e, 3, 3) / 3, r(e) / 3)


def _tail_case(b, d, h, w, dtype, gen, zdtype=None, offset=0):
    """K6's inputs: the scans' (B, 2, D, L) sum and the SiLU gate (in
    zdtype, by default y's); `offset` > 0: y and z views that start that
    many elements into buffers of their own (not 16-byte aligned)."""
    def view(shape, t):
        n = math.prod(shape)
        buf = torch.empty(n + offset, dtype=t.dtype, device="cuda")
        buf[offset:] = t.flatten()
        return buf[offset:].view(shape)

    y = torch.randn(b, 2, d, h * w, generator=gen, device="cuda").to(dtype)
    z = F.silu(torch.randn(b, d, h, w, generator=gen, device="cuda")).to(
        zdtype or dtype)
    if offset:
        y, z = view(y.shape, y), view(z.shape, z)
    return (y, z, 1 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
            0.1 * torch.randn(d, generator=gen, device="cuda"))


def _front_bound(args):
    """JAX's count (pallas_effn.py:322): B H W (4 C E + 18 E), the in_conv
    products on the tensor cores, in bf16 for bf16 inputs and as three
    TF32 products for fp32 (the split); x read, xs and z written once."""
    x, w_dw = args[0], args[5]
    b, c, h, w = x.shape
    e = w_dw.shape[0]
    px = b * h * w
    mma, other = px * 4 * c * e, px * 18 * e
    by = nbytes(x) + 2 * px * e * x.element_size() + nbytes(*args[1:])
    if x.dtype == torch.bfloat16:
        return bound(by, other, mma)
    return bound(by, other, tf32_mma=3 * mma)


def _tail_bound(args):
    """y read, z read and out written once; 10 flops per element."""
    y, z = args[0], args[1]
    return bound(nbytes(y) + 2 * nbytes(z) + nbytes(*args[2:]),
                 10 * z.numel())


def _fused_bound(args, carries=False):
    u2 = args[0]
    b, g, d, L = u2.shape
    N, R = args[4].shape[2], args[2].shape[2]
    el = b * g * d * L
    by = 2 * nbytes(u2) + nbytes(*args[1:])
    if carries:
        by += b * g * d * cuda_scan.n_chunks(L) * N * 4
    ops = 10 * el * N + 2 * el * (2 * R + 2 * N)
    return bound(by, ops, exp2=el * N)


def _scan_bound(args, out_dtype, carries=False):
    u, delta, A, Bm, Cm, _, _ = args
    b, L, d = u.shape
    N = A.shape[1]
    by = (nbytes(*args) + b * L * d * torch.finfo(out_dtype).bits // 8)
    if carries:
        by += b * d * cuda_scan.n_chunks(L) * N * 4
    return bound(by, 10 * b * L * d * N, exp2=b * L * d * N)


def _state_bound(args, out_dtype):
    """K4's bound, with the entering state read and the last state
    written once (fp32, (b, D, N) each)."""
    b, _, d = args[0].shape
    terms = _scan_bound(args, out_dtype)
    terms["bytes_ms"] += 2 * b * d * args[2].shape[1] * 4 / HBM_BPS * 1e3
    return terms


def _bwd_bound(args, dy):
    u, delta, A, Bm, Cm, _, _ = args
    b, L, d = u.shape
    N = A.shape[1]
    # inputs and carries read once; du, ddelta, dA, dB, dC, dD, dbias
    # written once (fp32)
    by = (nbytes(*args, dy) + b * d * cuda_scan.n_chunks(L) * N * 4
          + 4 * (2 * b * L * d + 2 * b * L * Bm.shape[2] * N + d * N + 2 * d))
    return bound(by, 24 * b * L * d * N, exp2=b * L * d * N)


def _gdfn_bound(args):
    """K2's count, keffn's (`keffn.work`): x read and y written once, the
    weights once; the projections on the tensor cores, in bf16 for bf16
    and as three TF32 products each for fp32."""
    x, w_out = args[0], args[5]
    b, c, h, w = x.shape
    return _gdfn_work_bound((b, h, w, c), x.dtype, w_out.shape[1])


def _gdfn_work_bound(shape, dtype, hid=None):
    by, fp32_ops, bf16_mma, tf32_mma = keffn.work(shape, dtype, hid)
    return bound(by, fp32_ops, bf16_mma, tf32_mma=tf32_mma)


def kernels_vs_plain() -> tuple[dict, dict]:
    """Each case: (kernel name, label, dtype, kernel call, plain call,
    compare(got, ref) -> max error, bound). The first case of each kernel
    is its main-path shape: its times go into the kernels line. Returns
    those stats and the card ms by shape of K2 (by (b, c, h, w, dtype), at
    every shape of a served forward and of the S1 step), of K5 (the same
    key, at every shape of a served forward) and of K3 (by (b, L, D, G,
    reverse), at the S1 step's shapes), for the accounts of phases 5 and
    6."""
    gen = torch.Generator().manual_seed(0)
    stats = {name: dict(max_abs_err=0.0, ms=None, plain_ms=None,
                        bound_ms=None, bound_by=None, library_ms=None)
             for name in KERNELS}
    cases = []

    def fwd_cmp(label, dtype):
        return lambda got, ref: check_close(label, got, ref, *TOL[dtype])

    def k2_cmp(label, dtype):
        if dtype != torch.float32:
            return fwd_cmp(label, dtype)
        return lambda got, ref: max(
            check_close(label, got, ref, *TOL[dtype]),
            check_close(label + " (fp32 bar)", got, ref, *K2F_TOL))

    def pair_cmp(label, dtype, c):
        # fp32 (K5's split-TF32 route): the envelope, and the fp32 bar at
        # the models' widths (C <= 384; wider, two fp32 sums of C products
        # part by more than the bar)
        tols = [TOL[dtype]] + ([K2F_TOL] if dtype == torch.float32
                               and c <= 384 else [])
        return lambda got, ref: max(
            check_close(f"{label} {n}", g, r, *t)
            for n, g, r in zip(("xs", "z"), got, ref) for t in tols)

    def carries_cmp(label, kernel_y):
        def cmp(got, ref):
            y, car = got
            if not torch.equal(y, kernel_y()):
                raise SystemExit(f"FAIL {label}: y differs from the "
                                 "no-carry kernel's")
            return check_close(label + " carries", car, ref[1],
                               *TOL[torch.float32])
        return cmp

    def bwd_cmp(label):
        def cmp(got, ref):
            names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
            return max(check_close(f"{label} {n}", g, r, *BWD_TOL)
                       for n, g, r in zip(names, got, ref))
        return cmp

    def add(name, label, dtype, kern, plain, cmp, bnd, timed=False,
            key=None, plain_timed=False):
        cases.append((name, label, dtype, kern, plain, cmp, bnd, timed, key,
                      plain_timed))

    # serve: K1, K4, K2 (bf16 first: the serve dtype); K1 at the four
    # shapes of a served forward, each bf16 row timed
    for dtype in (torch.bfloat16, torch.float32):
        for (b, d, L) in K1_SERVE_SHAPES:
            for rev in (False, True):
                a = _fused_case(b, d, L, dtype, gen)
                lab = f"({b},2,{d},{L}) rev={rev}"
                add("oss_scan_fused", lab, dtype,
                    lambda a=a, r=rev: cuda_scan.oss_scan_fused_fwd(
                        *a, reverse=r),
                    lambda a=a, r=rev: cuda_scan.oss_scan_fused_ref(
                        *a, reverse=r),
                    fwd_cmp(f"K1 {lab} {dtype}", dtype), _fused_bound(a),
                    timed=dtype == torch.bfloat16)
        for rev in (False, True):
            a = _scan_case(8, 256, 768, dtype, gen)
            lab = f"latent (8,256,768) G=2 rev={rev}"
            add("selective_scan", lab, dtype,
                lambda a=a, r=rev: cuda_scan.selective_scan_fwd(
                    *a, delta_softplus=True, reverse=r),
                lambda a=a, r=rev: cuda_scan.selective_scan_ref(
                    *a, delta_softplus=True, reverse=r),
                fwd_cmp(f"K4 {lab} {dtype}", dtype), _scan_bound(a, dtype),
                timed=dtype == torch.bfloat16,
                key=(8, 256, 768, 2, rev, dtype), plain_timed=True)
        # K2 at every shape of a served forward (bf16, the first its main
        # shape) and of the S1 step (fp32), each timed beside its plain
        # version, the cuDNN composite; then the CUDA tests' ragged shapes
        for (b, c, h, w) in (K2_SERVE_SHAPES if dtype == torch.bfloat16
                             else K2_STEP_SHAPES):
            a = _gdfn_case(b, c, h, dtype, gen, w)
            lab = f"({b},{c},{h},{w})"
            add("gdfn_residual_fused", lab, dtype,
                lambda a=a: cuda_effn.gdfn_residual_fwd(*a),
                lambda a=a: cuda_effn.gdfn_residual_ref(*a),
                k2_cmp(f"K2 {lab} {dtype}", dtype), _gdfn_bound(a),
                timed=True, key=(b, c, h, w, dtype), plain_timed=True)
        for (b, c, h, w) in K2_RAGGED_SHAPES:
            a = _gdfn_case(b, c, h, dtype, gen, w)
            lab = f"ragged ({b},{c},{h},{w})"
            add("gdfn_residual_fused", lab, dtype,
                lambda a=a: cuda_effn.gdfn_residual_fwd(*a),
                lambda a=a: cuda_effn.gdfn_residual_ref(*a),
                k2_cmp(f"K2 {lab} {dtype}", dtype), _gdfn_bound(a))
    # K5 at the five MamberBlock shapes of a served forward (bf16, the
    # first, 30 of the 50 blocks, the main shape) and of the S1 step (fp32,
    # its split-TF32 route), each timed beside its plain version; K6 at the
    # served shapes; then K5 at the ragged shapes
    cgen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for (b, c, hw) in (K5_SERVE_SHAPES if dtype == torch.bfloat16
                           else K5_STEP_SHAPES):
            lab = f"({b},{c},{hw},{hw})"
            a = _front_case(b, c, hw, dtype, cgen)
            add("oss_front_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_front_fwd(*a),
                lambda a=a: cuda_effn.oss_front_ref(*a),
                pair_cmp(f"K5 {lab} {dtype}", dtype, c), _front_bound(a),
                timed=True, key=(b, c, hw, hw, dtype), plain_timed=True)
        # K6 likewise at the served forward's (bf16) and the S1 step's
        # (fp32) shapes, each timed; then its ragged shapes in each dtype
        # pair, and views at an odd offset (the edge path)
        for (b, c, hw) in (K5_SERVE_SHAPES if dtype == torch.bfloat16
                           else K5_STEP_SHAPES):
            lab = f"({b},{c},{hw},{hw})"
            a = _tail_case(b, c, hw, hw, dtype, cgen)
            add("oss_tail_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_tail_fwd(*a),
                lambda a=a: cuda_effn.oss_tail_ref(*a),
                fwd_cmp(f"K6 {lab} {dtype}", dtype), _tail_bound(a),
                timed=True, key=(b, c, hw, hw, dtype), plain_timed=True)
        zdts = ((dtype, torch.bfloat16) if dtype == torch.float32
                else (dtype,))
        for (b, c, h, w), zdt, off in (
                [(s_, zd, 0) for s_ in K6_RAGGED_SHAPES for zd in zdts]
                + [((2, 96, 16, 16), dtype, 1), ((1, 48, 8, 24), dtype, 3)]):
            a = _tail_case(b, c, h, w, dtype, cgen, zdt, off)
            lab = (f"ragged ({b},{c},{h},{w}) z {str(zdt)[6:]}"
                   + (f" offset {off}" if off else "") + ", y")
            add("oss_tail_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_tail_fwd(*a),
                lambda a=a: cuda_effn.oss_tail_ref(*a),
                fwd_cmp(f"K6 {lab} {dtype}", zdt), _tail_bound(a))
        for (b, c, e, h, w) in K5_RAGGED_SHAPES:
            a = _front_case(b, c, h, dtype, cgen, e, w)
            lab = f"ragged ({b},{c},{h},{w}) E={e}"
            add("oss_front_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_front_fwd(*a),
                lambda a=a: cuda_effn.oss_front_ref(*a),
                pair_cmp(f"K5 {lab} {dtype}", dtype, c), _front_bound(a))
    # K4 at the channel scans of a served forward (fp32, each timed)
    for c in (48, 96, 192, 384):
        a = _scan_case(8, c, 8, torch.float32, gen, lifted=False)
        lab = f"channel scan (8,{c},8) G=2"
        add("selective_scan", lab, torch.float32,
            lambda a=a: cuda_scan.selective_scan_fwd(*a, delta_softplus=True),
            lambda a=a: cuda_scan.selective_scan_ref(*a, delta_softplus=True),
            fwd_cmp(f"K4 {lab}", torch.float32),
            _scan_bound(a, torch.float32), timed=True,
            key=(8, c, 8, 2, False, torch.float32), plain_timed=True)
    # train: K1c, K4c, K3 at the S1 step's shapes (fp32 first: the
    # training dtype), K3 fed by the carries of the forward it follows
    for dtype in (torch.float32, torch.bfloat16):
        for (b, d, L) in ((8, 96, 4096), (8, 48, 4096), (8, 96, 1024),
                          (8, 192, 256)):
            for rev in (False, True):
                a = _fused_case(b, d, L, dtype, gen)
                lab = f"({b},2,{d},{L}) rev={rev}"
                add("oss_scan_fused_carries", lab, dtype,
                    lambda a=a, r=rev: cuda_scan.oss_scan_fused_fwd_carries(
                        *a, reverse=r),
                    lambda a=a, r=rev: cuda_scan.oss_scan_fused_carries_ref(
                        *a, reverse=r),
                    carries_cmp(f"K1c {lab} {dtype}",
                                lambda a=a, r=rev: cuda_scan
                                .oss_scan_fused_fwd(*a, reverse=r)),
                    _fused_bound(a, carries=True),
                    timed=dtype == torch.float32 and L == 4096)
                _, car = cuda_scan.oss_scan_fused_fwd_carries(*a, reverse=rev)
                s, _ = cuda_scan.fused_scan_inputs(*a)
                dy = torch.randn(b, 2 * d, L, generator=gen).to(
                    "cuda", dtype).transpose(1, 2)
                add("selective_scan_bwd", f"fused {lab}", dtype,
                    lambda s=s, dy=dy, c=car, r=rev: cuda_scan
                    .selective_scan_bwd(*s, dy, c, delta_softplus=True,
                                        reverse=r),
                    lambda s=s, dy=dy, r=rev: cuda_scan
                    .selective_scan_bwd_ref(*s, dy, delta_softplus=True,
                                            reverse=r),
                    bwd_cmp(f"K3 fused {lab} {dtype}"), _bwd_bound(s, dy),
                    timed=dtype == torch.float32,
                    key=(b, L, 2 * d, 2, rev))
        # K3 over a ragged L in 65 segments of 64, reverse, and in 8
        # segments of 128 (the last of 104 positions), forward
        for (b, d, L, rev) in ((2, 48, 4100, True), (8, 96, 1000, False)):
            a = _fused_case(b, d, L, dtype, gen)
            _, car = cuda_scan.oss_scan_fused_fwd_carries(*a, reverse=rev)
            s, _ = cuda_scan.fused_scan_inputs(*a)
            dy = torch.randn(b, 2 * d, L, generator=gen).to(
                "cuda", dtype).transpose(1, 2)
            seg = cuda_scan.k3_segment(b, 2 * d, cuda_scan.k3_tile(d), L)
            lab = f"fused ({b},2,{d},{L}) rev={rev} in {-(-L // seg)} segments"
            add("selective_scan_bwd", lab, dtype,
                lambda s=s, dy=dy, c=car, r=rev: cuda_scan
                .selective_scan_bwd(*s, dy, c, delta_softplus=True,
                                    reverse=r),
                lambda s=s, dy=dy, r=rev: cuda_scan.selective_scan_bwd_ref(
                    *s, dy, delta_softplus=True, reverse=r),
                bwd_cmp(f"K3 {lab} {dtype}"), _bwd_bound(s, dy))
        scans = [(f"latent (8,64,768) G=2 rev={rev}", rev,
                  _scan_case(8, 64, 768, dtype, gen)) for rev in (False, True)]
        scans += [(f"channel scan (8,{c},8) G=2", False,
                   _scan_case(8, c, 8, dtype, gen, lifted=False))
                  for c in (48, 96, 192, 384)]
        for lab, rev, a in scans:
            add("selective_scan_carries", lab, dtype,
                lambda a=a, r=rev: cuda_scan.selective_scan_fwd_carries(
                    *a, delta_softplus=True, reverse=r),
                lambda a=a, r=rev: cuda_scan.selective_scan_carries_ref(
                    *a, delta_softplus=True, reverse=r),
                carries_cmp(f"K4c {lab} {dtype}",
                            lambda a=a, r=rev: cuda_scan.selective_scan_fwd(
                                *a, delta_softplus=True, reverse=r)),
                _scan_bound(a, dtype, carries=True),
                timed=dtype == torch.float32,
                key=(*a[0].shape, a[3].shape[2], rev, dtype),
                plain_timed=True)
            _, car = cuda_scan.selective_scan_fwd_carries(
                *a, delta_softplus=True, reverse=rev)
            dy = torch.randn(a[0].shape, generator=gen).to("cuda", dtype)
            add("selective_scan_bwd", lab, dtype,
                lambda a=a, dy=dy, c=car, r=rev: cuda_scan.selective_scan_bwd(
                    *a, dy, c, delta_softplus=True, reverse=r),
                lambda a=a, dy=dy, r=rev: cuda_scan.selective_scan_bwd_ref(
                    *a, dy, delta_softplus=True, reverse=r),
                bwd_cmp(f"K3 {lab} {dtype}"), _bwd_bound(a, dy),
                timed=dtype == torch.float32,
                key=(*a[0].shape, a[3].shape[2], rev))

    # RealSR (MambaRealSR11): the direct channel scans (9, c, 2), K4 (its
    # gated and validation forwards), K4c and K3 from its carries; K1c,
    # K3 (both ways) and K2 at the S1 step's batch-9 shapes; fp32, timed
    f32 = torch.float32
    rs_scans = [(f"direct channel scan (9,{c},2) G=2", False,
                 _scan_case(9, c, 2, f32, gen, lifted=False))
                for c in DIRECT_WIDTHS]
    rs_scans += [(f"latent (9,64,768) G=2 rev={rev}", rev,
                  _scan_case(9, 64, 768, f32, gen)) for rev in (False, True)]
    for lab, rev, a in rs_scans:
        key = (*a[0].shape, a[3].shape[2], rev)
        if "direct" in lab:
            add("selective_scan", lab, f32,
                lambda a=a: cuda_scan.selective_scan_fwd(
                    *a, delta_softplus=True),
                lambda a=a: cuda_scan.selective_scan_ref(
                    *a, delta_softplus=True),
                fwd_cmp(f"K4 {lab}", f32), _scan_bound(a, f32), timed=True,
                key=(*key, f32), plain_timed=True)
        add("selective_scan_carries", lab, f32,
            lambda a=a, r=rev: cuda_scan.selective_scan_fwd_carries(
                *a, delta_softplus=True, reverse=r),
            lambda a=a, r=rev: cuda_scan.selective_scan_carries_ref(
                *a, delta_softplus=True, reverse=r),
            carries_cmp(f"K4c {lab}",
                        lambda a=a, r=rev: cuda_scan.selective_scan_fwd(
                            *a, delta_softplus=True, reverse=r)),
            _scan_bound(a, f32, carries=True), timed=True, key=(*key, f32),
            plain_timed=True)
        _, car = cuda_scan.selective_scan_fwd_carries(
            *a, delta_softplus=True, reverse=rev)
        dy = torch.randn(a[0].shape, generator=gen).to("cuda")
        add("selective_scan_bwd", lab, f32,
            lambda a=a, dy=dy, c=car, r=rev: cuda_scan.selective_scan_bwd(
                *a, dy, c, delta_softplus=True, reverse=r),
            lambda a=a, dy=dy, r=rev: cuda_scan.selective_scan_bwd_ref(
                *a, dy, delta_softplus=True, reverse=r),
            bwd_cmp(f"K3 {lab}"), _bwd_bound(a, dy), timed=True, key=key,
            plain_timed=True)
    for (b, d, L) in K1C_REALSR_SHAPES:
        for rev in (False, True):
            a = _fused_case(b, d, L, f32, gen)
            lab = f"({b},2,{d},{L}) rev={rev}"
            add("oss_scan_fused_carries", lab, f32,
                lambda a=a, r=rev: cuda_scan.oss_scan_fused_fwd_carries(
                    *a, reverse=r),
                lambda a=a, r=rev: cuda_scan.oss_scan_fused_carries_ref(
                    *a, reverse=r),
                carries_cmp(f"K1c {lab}",
                            lambda a=a, r=rev: cuda_scan
                            .oss_scan_fused_fwd(*a, reverse=r)),
                _fused_bound(a, carries=True), timed=True)
            _, car = cuda_scan.oss_scan_fused_fwd_carries(*a, reverse=rev)
            s_, _ = cuda_scan.fused_scan_inputs(*a)
            dy = torch.randn(b, 2 * d, L, generator=gen).to(
                "cuda").transpose(1, 2)
            add("selective_scan_bwd", f"fused {lab}", f32,
                lambda s=s_, dy=dy, c=car, r=rev: cuda_scan
                .selective_scan_bwd(*s, dy, c, delta_softplus=True,
                                    reverse=r),
                lambda s=s_, dy=dy, r=rev: cuda_scan
                .selective_scan_bwd_ref(*s, dy, delta_softplus=True,
                                        reverse=r),
                bwd_cmp(f"K3 fused {lab}"), _bwd_bound(s_, dy), timed=True,
                key=(b, L, 2 * d, 2, rev))
    for (b, c, h, w) in K2_REALSR_SHAPES:
        a = _gdfn_case(b, c, h, f32, gen, w)
        lab = f"({b},{c},{h},{w})"
        add("gdfn_residual_fused", lab, f32,
            lambda a=a: cuda_effn.gdfn_residual_fwd(*a),
            lambda a=a: cuda_effn.gdfn_residual_ref(*a),
            k2_cmp(f"K2 {lab} {f32}", f32), _gdfn_bound(a), timed=True,
            key=(b, c, h, w, f32), plain_timed=True)

    # Deraining (Mamber33, fp32): K1c and K3 at the stage-1 step's fused
    # shapes (8 x 128x128), K4c and K3 at its latent pair and at the conv2
    # channel scans (b, c, 4), K2 at its five shapes; stage 6 (1 x
    # 384x384): K1c at level 1, K4c / K3 at the latent (1,2304,768) over
    # several segments, the channel scans at batch 1, K2 at (1,48,384,384);
    # a whole-image evaluation: K1 and K4 at a 512x512 image's level 1 and
    # latent, K4 at (1,c,4), K2 at a 481x321 image's padded level 1 and
    # latent; each timed beside its plain version and its bound
    for (b, d, L) in DERAIN_K1C_SHAPES:
        for rev in (False, True):
            a = _fused_case(b, d, L, f32, gen)
            lab = f"derain ({b},2,{d},{L}) rev={rev}"
            add("oss_scan_fused_carries", lab, f32,
                lambda a=a, r=rev: cuda_scan.oss_scan_fused_fwd_carries(
                    *a, reverse=r),
                lambda a=a, r=rev: cuda_scan.oss_scan_fused_carries_ref(
                    *a, reverse=r),
                carries_cmp(f"K1c {lab}",
                            lambda a=a, r=rev: cuda_scan
                            .oss_scan_fused_fwd(*a, reverse=r)),
                _fused_bound(a, carries=True), timed=True,
                key=None if rev else (b, d, L), plain_timed=not rev)
            if b == 1:  # stage 6's level 1: K1c alone
                continue
            _, car = cuda_scan.oss_scan_fused_fwd_carries(*a, reverse=rev)
            s_, _ = cuda_scan.fused_scan_inputs(*a)
            dy = torch.randn(b, 2 * d, L, generator=gen).to(
                "cuda").transpose(1, 2)
            add("selective_scan_bwd", f"fused {lab}", f32,
                lambda s=s_, dy=dy, c=car, r=rev: cuda_scan
                .selective_scan_bwd(*s, dy, c, delta_softplus=True,
                                    reverse=r),
                lambda s=s_, dy=dy, r=rev: cuda_scan
                .selective_scan_bwd_ref(*s, dy, delta_softplus=True,
                                        reverse=r),
                bwd_cmp(f"K3 fused {lab}"), _bwd_bound(s_, dy), timed=True,
                key=(b, L, 2 * d, 2, rev), plain_timed=not rev)
    dr_scans = [(f"derain latent ({b},{L},768) G=2 rev={rev}", rev,
                 _scan_case(b, L, 768, f32, gen))
                for b, L in ((8, 256), (1, 2304)) for rev in (False, True)]
    dr_scans += [(f"derain channel scan ({b},{c},4) G=2", False,
                  _scan_case(b, c, 4, f32, gen, lifted=False))
                 for b in (8, 1) for c in DIRECT_WIDTHS]
    for lab, rev, a in dr_scans:
        key = (*a[0].shape, a[3].shape[2], rev)
        if "channel" in lab and a[0].shape[0] == 1:  # the evaluation's
            add("selective_scan", lab, f32,
                lambda a=a: cuda_scan.selective_scan_fwd(
                    *a, delta_softplus=True),
                lambda a=a: cuda_scan.selective_scan_ref(
                    *a, delta_softplus=True),
                fwd_cmp(f"K4 {lab}", f32), _scan_bound(a, f32), timed=True,
                key=(*key, f32), plain_timed=True)
        add("selective_scan_carries", lab, f32,
            lambda a=a, r=rev: cuda_scan.selective_scan_fwd_carries(
                *a, delta_softplus=True, reverse=r),
            lambda a=a, r=rev: cuda_scan.selective_scan_carries_ref(
                *a, delta_softplus=True, reverse=r),
            carries_cmp(f"K4c {lab}",
                        lambda a=a, r=rev: cuda_scan.selective_scan_fwd(
                            *a, delta_softplus=True, reverse=r)),
            _scan_bound(a, f32, carries=True), timed=True, key=(*key, f32),
            plain_timed=True)
        _, car = cuda_scan.selective_scan_fwd_carries(
            *a, delta_softplus=True, reverse=rev)
        dy = torch.randn(a[0].shape, generator=gen).to("cuda")
        add("selective_scan_bwd", lab, f32,
            lambda a=a, dy=dy, c=car, r=rev: cuda_scan.selective_scan_bwd(
                *a, dy, c, delta_softplus=True, reverse=r),
            lambda a=a, dy=dy, r=rev: cuda_scan.selective_scan_bwd_ref(
                *a, dy, delta_softplus=True, reverse=r),
            bwd_cmp(f"K3 {lab}"), _bwd_bound(a, dy), timed=True, key=key,
            plain_timed=True)
    for rev in (False, True):
        a = _fused_case(1, 96, 512 * 512, f32, gen)
        lab = f"derain evaluation (1,2,96,{512 * 512}) rev={rev}"
        add("oss_scan_fused", lab, f32,
            lambda a=a, r=rev: cuda_scan.oss_scan_fused_fwd(*a, reverse=r),
            lambda a=a, r=rev: cuda_scan.oss_scan_fused_ref(*a, reverse=r),
            fwd_cmp(f"K1 {lab}", f32), _fused_bound(a), timed=True,
            plain_timed=not rev)
        a = _scan_case(1, 4096, 768, f32, gen)
        lab = f"derain evaluation latent (1,4096,768) G=2 rev={rev}"
        add("selective_scan", lab, f32,
            lambda a=a, r=rev: cuda_scan.selective_scan_fwd(
                *a, delta_softplus=True, reverse=r),
            lambda a=a, r=rev: cuda_scan.selective_scan_ref(
                *a, delta_softplus=True, reverse=r),
            fwd_cmp(f"K4 {lab}", f32), _scan_bound(a, f32), timed=True,
            key=(1, 4096, 768, 2, rev, f32), plain_timed=True)
    for (b, c, h, w) in DERAIN_K2_SHAPES:
        a = _gdfn_case(b, c, h, f32, gen, w)
        lab = f"derain ({b},{c},{h},{w})"
        add("gdfn_residual_fused", lab, f32,
            lambda a=a: cuda_effn.gdfn_residual_fwd(*a),
            lambda a=a: cuda_effn.gdfn_residual_ref(*a),
            k2_cmp(f"K2 {lab} {f32}", f32), _gdfn_bound(a), timed=True,
            key=(b, c, h, w, f32), plain_timed=True)

    # K4 and K4c at the CUDA tests' ragged shapes, both ways, fp32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        for (b, L, D, G, N, lay) in K4_RAGGED_SHAPES:
            for rev in (False, True):
                a = _k4_ragged_case(b, L, D, G, N, lay, dtype, gen)
                lab = f"ragged ({b},{L},{D}) G={G} N={N} {lay} rev={rev}"
                add("selective_scan", lab, dtype,
                    lambda a=a, r=rev: cuda_scan.selective_scan_fwd(
                        *a, delta_softplus=True, reverse=r),
                    lambda a=a, r=rev: cuda_scan.selective_scan_ref(
                        *a, delta_softplus=True, reverse=r),
                    fwd_cmp(f"K4 {lab} {dtype}", dtype),
                    _scan_bound(a, dtype))
                add("selective_scan_carries", lab, dtype,
                    lambda a=a, r=rev: cuda_scan.selective_scan_fwd_carries(
                        *a, delta_softplus=True, reverse=r),
                    lambda a=a, r=rev: cuda_scan.selective_scan_carries_ref(
                        *a, delta_softplus=True, reverse=r),
                    carries_cmp(f"K4c {lab} {dtype}",
                                lambda a=a, r=rev: cuda_scan
                                .selective_scan_fwd(*a, delta_softplus=True,
                                                    reverse=r)),
                    _scan_bound(a, dtype, carries=True))

    # K4's state form (phase 7f's sequence-parallel passes), from a random
    # entering state: first at the sp spatial shape of 7f's forward (a
    # 256x256 LQ's level-1 pair, (1, 65536, 96) fp32 in 64 segments: the
    # main path's), then at the latent (8,256,768) bf16, each way; y in
    # its dtype's envelope and the last state in fp32's, each timed
    def state_cmp(label, dtype):
        return lambda got, ref: max(
            check_close(f"{label} y", got[0], ref[0], *TOL[dtype]),
            check_close(f"{label} last state", got[1], ref[1],
                        *TOL[torch.float32]))

    for (b, L, d, dtype) in ((1, 65536, 96, f32),
                             (8, 256, 768, torch.bfloat16)):
        for rev in (False, True):
            a = _scan_case(b, L, d, dtype, gen)
            h0 = torch.randn(b, d, 16, generator=gen).to("cuda")
            lab = f"sp ({b},{L},{d}) G=2 rev={rev}"
            add("selective_scan_state", lab, dtype,
                lambda a=a, h=h0, r=rev: cuda_scan.selective_scan_fwd_state(
                    *a, delta_softplus=True, reverse=r, h0=h),
                lambda a=a, h=h0, r=rev: cuda_scan.selective_scan_state_ref(
                    *a, delta_softplus=True, reverse=r, h0=h),
                state_cmp(f"K4 state {lab} {dtype}", dtype),
                _state_bound(a, dtype), timed=True, plain_timed=True)

    k3_calls = {}
    shape_ms = {"K1c": {}, "K2": {}, "K3": {}, "K4": {}, "K4c": {},
                "K5": {}, "K6": {}}
    by_name = {"oss_scan_fused_carries": "K1c",
               "selective_scan_bwd": "K3", "selective_scan": "K4",
               "selective_scan_carries": "K4c", "oss_front_fused": "K5",
               "gdfn_residual_fused": "K2", "oss_tail_fused": "K6"}
    # the practical floor of a call at K4's smallest shapes, whose bound
    # is a fraction of a microsecond: an empty kernel's launch (the same
    # CUDA-event timing, behind the same device sleep)
    empty_ms = time_ms(lambda: torch.cuda._sleep(0), reps=21)
    print(f"[kernels] an empty kernel's launch (torch.cuda._sleep(0)): "
          f"{empty_ms:.4f} ms")
    for (name, label, dtype, kern, plain, cmp, bnd, timed, key,
         plain_timed) in cases:
        got = kern()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain()
        torch.cuda.synchronize()
        # the reference call warms the plain version up; one timed call
        # where it takes over PLAIN_ONCE_S, three below
        plain_reps = 1 if time.perf_counter() - t0 > PLAIN_ONCE_S else 3
        err = cmp(got, ref)
        del got, ref
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        line = (f"[kernels] {name} {label} {str(dtype)[6:]}: max abs err "
                f"{err:.3e}")
        ms = None
        if st["ms"] is None:  # the first case: the main path's shape
            st["ms"] = time_ms(kern)
            st["plain_ms"] = time_ms(plain, plain_reps, warm=False)
            st["terms"] = bnd
            ms = st["ms"]
            line += (f"; kernel {st['ms']:.4f} ms, plain "
                     f"{st['plain_ms']:.4f} ms")
            line += bound_share(bnd, st["ms"])
        elif timed:
            ms = time_ms(kern)
            line += f"; kernel {ms:.4f} ms"
            if plain_timed:
                line += (f", plain "
                         f"{time_ms(plain, plain_reps, warm=False):.4f} ms")
            line += bound_share(bnd, ms)
        if key is not None and ms is not None:
            shape_ms[by_name[name]][key] = ms
            if name == "selective_scan_bwd":
                k3_calls[key] = kern
        if ms is not None and by_name.get(name, "").startswith("K4"):
            line += f"; {ms / empty_ms:.2f} empty launches"
        print(line)
    k3_grids(k3_calls)
    del cases, k3_calls
    k1_deterministic(gen)
    k2_deterministic(gen)
    k2f_control(gen)
    k5f_checks(cgen)
    k3_recorded_bits()
    torch.cuda.empty_cache()
    return stats, shape_ms


def k3_grids(calls):
    """K3's device ms per grid at each timed shape of the S1 step: one
    call under torch.profiler (the segments, their combine, the main pass,
    and the wrapper's sums of the partials)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    for key, kern in calls.items():
        kern()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            kern()
            torch.cuda.synchronize()
        rows = {}
        for r in prof.key_averages():
            if r.device_type != torch.autograd.DeviceType.CUDA:
                continue
            k = next((g for g in ("selective_scan_bwd_seg_kernel",
                                  "selective_scan_bwd_combine",
                                  "selective_scan_bwd_kernel")
                      if g in r.key), "sums of the partials")
            rows[k] = rows.get(k, 0.0) + r.self_device_time_total / 1e3
        b, L, D, G, rev = key
        print(f"[kernels] K3 ({b},{L},{D}) G={G} rev={rev} per grid (ms): "
              + ", ".join(f"{k} {v:.4f}" for k, v in rows.items()))


def k3_recorded_bits():
    """K3's du, ddelta, dB and dC on the seeded cases of `tools.ab` that
    fit one of its segments, fed by the plain carries: the bits recorded
    from its build."""
    with open(ab.K3_DIGESTS_FILE) as f:
        want = json.load(f)
    got = ab.k3_digests()
    differ = sorted(k for k in want["digests"]
                    if got.get(k) != want["digests"][k])
    if differ or got.keys() != want["digests"].keys():
        raise SystemExit(f"FAIL K3 within one segment: {len(differ)} of "
                         f"{len(want['digests'])} digests differ from the "
                         f"recorded build: {differ}")
    print(f"[kernels] K3 within one segment: all {len(got)} seeded outputs "
          f"bit-identical to the recorded build ({want['made_on']})")


def bound_share(bnd, ms) -> str:
    """A row's bound, its exp2 term at the SFU's nominal rate (the kernels
    line's takes the larger of that and phase 8's measured rate), and the
    share of it that the kernel's time reaches."""
    fb = finish_bound(bnd, SFU_NOMINAL)
    return (f", bound {fb['bound_ms']:.4f} ms ({fb['bound_by']}"
            + ("; exp2 at the nominal rate" if bnd["exp2"] else "")
            + f"), {fb['bound_ms'] / ms:.4f} of it")


def k1_deterministic(gen):
    """Two K1 calls and two K1c calls (forward and reverse) on the same
    inputs at the served forward's widest shape give the same bits."""
    a = _fused_case(8, 96, 16384, torch.bfloat16, gen)
    for rev in (False, True):
        if not torch.equal(cuda_scan.oss_scan_fused_fwd(*a, reverse=rev),
                           cuda_scan.oss_scan_fused_fwd(*a, reverse=rev)):
            raise SystemExit(f"FAIL K1 (8,2,96,16384) rev={rev}: two calls "
                             "gave different bits")
        (y1, c1), (y2, c2) = (cuda_scan.oss_scan_fused_fwd_carries(
            *a, reverse=rev) for _ in range(2))
        if not (torch.equal(y1, y2) and torch.equal(c1, c2)):
            raise SystemExit(f"FAIL K1c (8,2,96,16384) rev={rev}: two calls "
                             "gave different bits")
    print("[kernels] K1 and K1c at (8,2,96,16384) bf16, forward and reverse: "
          "two calls each, the same bits")


def k2_deterministic(gen):
    """Two K2 calls on the same inputs give the same bits: at the served
    forward's main shape (the bf16 route), at the S1 step's (the fp32
    route, one block a tile) and at the step's three levels where the fp32
    route splits the hidden channels over a cluster (its members' partial
    tiles summed in rank order); and the fp32 route's packing kernel gives
    its plain version's bits."""
    cases = [(K2_SERVE_SHAPES[0], torch.bfloat16)] + [
        (shape, torch.float32) for shape in K2_STEP_SHAPES[1:]]
    for (b, c, h, w), dtype in cases:
        a = _gdfn_case(b, c, h, dtype, gen, w)
        if not torch.equal(cuda_effn.gdfn_residual_fwd(*a),
                           cuda_effn.gdfn_residual_fwd(*a)):
            raise SystemExit(f"FAIL K2 ({b},{c},{h},{w}) {dtype}: two calls "
                             "gave different bits")
    splits = [f"({b},{c},{h},{w}) " + str(cuda_effn.k2f_plan(
        b, c, h, w, int(2.66 * c), "cuda")[2])
        for (b, c, h, w) in K2_STEP_SHAPES]
    # the fp32 route's packing kernel against its plain version, bit for bit
    for (b, c, h, w) in K2_STEP_SHAPES:
        _, _, _, w_in, w_dw, w_out = _gdfn_case(b, c, 1, torch.float32, gen)
        hid = w_out.shape[1]
        cls = cuda_effn.k2f_class(c)
        want = cuda_effn.pack_gdfn_f32_weights(w_in, w_dw, w_out, cls)
        got = torch.full_like(want, float("nan"))
        _build.launch("vmt_gdfn_f32_pack", got.device, w_in.data_ptr(),
                      w_dw.data_ptr(), w_out.data_ptr(), got.data_ptr(), c,
                      hid, cls)
        if not torch.equal(got, want):
            raise SystemExit(f"FAIL K2 fp32 packing C={c}: not the plain "
                             "version's bits")
    print("[kernels] K2 at (8,96,128,128) bf16 and at the S1 step's "
          "(8,96,64,64), (8,96,32,32), (8,192,16,16), (8,384,8,8) fp32: two "
          "calls each, the same bits; the fp32 packing kernel at the step's "
          "five widths, its plain version's bits; the fp32 route's blocks "
          "per tile: " + ", ".join(splits))
    # the card's count behind those splits (`cuda_effn._resident`)
    dev = torch.device("cuda")
    print("[kernels] K2 fp32 clusters of 2 / 4 / 8 blocks the card holds at "
          "once: " + "; ".join(
              f"class {cls} (C {c}) " + " / ".join(
                  str(cuda_effn._resident(dev, False, cls, c, s))
                  for s in (2, 4, 8))
              for cls, c in ((0, 48), (1, 96), (2, 192), (3, 384))))


def _tf32_rn(t):
    """fp32 rounded to TF32's 10 mantissa bits, to nearest (ties away)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def gdfn_single_tf32(x, ln_w, ln_b, w_in, w_dw, w_out, eps=1e-5):
    """The control for K2's fp32 bar: the plain version with both 1x1
    projections' operands rounded to TF32 and their products summed in
    fp32, the result of a single-pass TF32 kernel (or of a split-TF32 one
    that drops the lo terms). TF32 off, so cuDNN adds it in fp32."""
    zn = cuda_effn._layer_norm(x, ln_w, ln_b, eps)
    hid = w_out.shape[1]
    y = F.conv2d(_tf32_rn(zn), _tf32_rn(w_in)[:, :, None, None])
    y = F.conv2d(y, w_dw[:, None], padding=1, groups=2 * hid)
    g = F.gelu(y[:, :hid]) * y[:, hid:]
    return x + F.conv2d(_tf32_rn(g), _tf32_rn(w_out)[:, :, None, None])


def k2f_control(gen):
    """K2's fp32 bar (K2F_TOL) can tell a single-pass TF32 result from
    the plain fp32 one: at each of the S1 step's shapes, the control
    (`gdfn_single_tf32`) must miss it."""
    rows = []
    for (b, c, h, w) in K2_STEP_SHAPES:
        a = _gdfn_case(b, c, h, torch.float32, gen, w)
        ref = cuda_effn.gdfn_residual_ref(*a)
        err = (gdfn_single_tf32(*a) - ref).abs()
        off = (err > K2F_TOL[1] + K2F_TOL[0] * ref.abs()).float().mean()
        if off.item() == 0:
            raise SystemExit(f"FAIL K2 fp32 bar at ({b},{c},{h},{w}): the "
                             "single-pass TF32 control passes it")
        rows.append(f"({b},{c},{h},{w}) max abs err {err.max().item():.3e},"
                    f" {off.item():.4f} of the elements off")
    print(f"[kernels] K2 fp32 bar (rtol {K2F_TOL[0]}, atol {K2F_TOL[1]}): "
          "the single-pass TF32 control misses it at every step shape: "
          + "; ".join(rows))


def front_single_tf32(x, ln_w, ln_b, w_in, b_in, w_dw, b_dw, eps=1e-5):
    """The control for K5's fp32 bar: the plain version with the in_conv's
    operands rounded to TF32 (a single-pass TF32 kernel's result)."""
    e = w_dw.shape[0]
    zn = cuda_effn._layer_norm(x, ln_w, ln_b, eps)
    pxz = F.conv2d(_tf32_rn(zn), _tf32_rn(w_in)[:, :, None, None], b_in)
    xs = F.conv2d(pxz[:, :e], w_dw[:, None], b_dw, padding=1, groups=e)
    return F.silu(xs), F.silu(pxz[:, e:])


def k5f_checks(gen):
    """K5's fp32 route: two calls give the same bits at each of the S1
    step's shapes (the widest two split the channel tiles over blocks);
    its packing kernel gives its plain version's bits there and at the
    widest class's k-slices; the single-pass TF32 control misses the fp32
    bar at each step shape."""
    rows = []
    for (b, c, hw) in K5_STEP_SHAPES:
        a = _front_case(b, c, hw, torch.float32, gen)
        one, two = cuda_effn.oss_front_fwd(*a), cuda_effn.oss_front_fwd(*a)
        if not (torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])):
            raise SystemExit(f"FAIL K5 ({b},{c},{hw},{hw}) fp32: two calls "
                             "gave different bits")
        refs = cuda_effn.oss_front_ref(*a)
        off = []
        for g, r in zip(front_single_tf32(*a), refs):
            off.append((((g - r).abs() > K2F_TOL[1] + K2F_TOL[0] * r.abs())
                        .float().mean().item()))
        if max(off) == 0:
            raise SystemExit(f"FAIL K5 fp32 bar at ({b},{c},{hw},{hw}): the "
                             "single-pass TF32 control passes it")
        rows.append(f"({b},{c},{hw},{hw}) {off[0]:.4f} / {off[1]:.4f}")
    for c, e in [(c, c) for _, c, _ in K5_STEP_SHAPES] + [(704, 64),
                                                          (200, 40)]:
        _, _, _, w_in, b_in, w_dw, b_dw = _front_case(1, c, 1, torch.float32,
                                                      gen, e)
        cls = cuda_effn.k5f_class(c)
        want = cuda_effn.pack_front_f32_weights(w_in, b_in, w_dw, b_dw, cls)
        got = torch.full_like(want, float("nan"))
        wd = w_dw.reshape(e, 9).contiguous()
        _build.launch("vmt_oss_front_f32_pack", got.device, w_in.data_ptr(),
                      b_in.data_ptr(), wd.data_ptr(), b_dw.data_ptr(),
                      got.data_ptr(), c, e, cls)
        if not torch.equal(got, want):
            raise SystemExit(f"FAIL K5 fp32 packing C={c} E={e}: not the "
                             "plain version's bits")
    print("[kernels] K5 fp32 at the S1 step's shapes: two calls each, the "
          "same bits; its packing kernel at C 48 / 96 / 192 / 384, (704, "
          "64) and (200, 40), the plain version's bits; the single-pass "
          f"TF32 control off the fp32 bar (rtol {K2F_TOL[0]}, atol "
          f"{K2F_TOL[1]}) in this share of xs / z: " + "; ".join(rows))


# -- phase 4: the model, kernels vs plain --------------------------------------

def _bwd_ref_from_carries(*args, **kw):
    """The plain scan backward in the place of K3 (it needs no carries)."""
    *scan_args, dy, _carries = args
    return cuda_scan.selective_scan_bwd_ref(*scan_args, dy, **kw)


@contextlib.contextmanager
def plain_ops():
    """Routes every kernel wrapper to its plain version, on CUDA tensors
    too, for the comparison only: the forward entry points and the
    autograd Functions then run the plain path."""
    swaps = [
        (cuda_scan, "oss_scan_fused_fwd", cuda_scan.oss_scan_fused_ref),
        (cuda_scan, "oss_scan_fused_fwd_carries",
         cuda_scan.oss_scan_fused_carries_ref),
        (cuda_scan, "selective_scan_fwd", cuda_scan.selective_scan_ref),
        (cuda_scan, "selective_scan_fwd_carries",
         cuda_scan.selective_scan_carries_ref),
        (cuda_scan, "selective_scan_bwd", _bwd_ref_from_carries),
        (cuda_effn, "gdfn_residual_fwd", cuda_effn.gdfn_residual_ref),
        (cuda_effn, "oss_front_fwd", cuda_effn.oss_front_ref),
        (cuda_effn, "oss_tail_fwd", cuda_effn.oss_tail_ref),
    ]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _reduced_net(seed, arch="MambaSISR6"):
    return build_network(dict(type=arch, num_blocks=[1, 1, 1, 1],
                              num_refinement_blocks=1), seed=seed)


def model_vs_plain(fused: bool):
    """Phase 4; `fused`: with K5 and K6 on."""
    net = _reduced_net(1)
    x = torch.rand(8, 3, 128, 128, generator=torch.Generator().manual_seed(2)
                   ).cuda()
    with oss_switches(fused), torch.inference_mode():
        t0 = time.perf_counter()
        got = net(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with plain_ops():
            ref = net(x)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    assert got.shape == (8, 3, 512, 512), got.shape
    tag = "K5/K6 on" if fused else "K5/K6 off"
    err = check_close(f"model [1,1,1,1]+1 fp32 {tag}", got, ref, 1e-3, 1e-3)
    print(f"[model] MambaSISR6 widths, depth [1,1,1,1]+1, (8,3,128,128) "
          f"fp32, {tag}: max abs err {err:.3e} (tol 1e-3); kernels "
          f"{1e3 * (t1 - t0):.1f} ms, plain {1e3 * (t2 - t1):.1f} ms "
          "(first calls)")


def _grads(net, lq, gt):
    net.zero_grad(set_to_none=True)
    (net(lq) - gt).abs().mean().backward()
    torch.cuda.synchronize()
    return {k: p.grad.detach().clone() for k, p in net.named_parameters()}


def model_grads_vs_plain(fused: bool, arch="MambaSISR6", b=8):
    """Phase 4b at `arch`'s widths on b 64x64 LQ; `fused`: with K5 and K6
    on (their parameters' gradients then come through the recompute
    backward of their Functions)."""
    net = _reduced_net(3, arch)
    g = torch.Generator().manual_seed(4)
    gt = torch.rand(b, 3, 256, 256, generator=g)
    lq = torch.nn.functional.avg_pool2d(gt, 4).cuda()
    grads_vs_plain(net, lq, gt.cuda(), f"{arch} widths", fused)
    del net
    torch.cuda.empty_cache()


def grads_vs_plain(net, lq, gt, label, fused=False):
    """Every parameter's L1 gradient through the kernels against the plain
    path on the card, within GRAD_BAR of its largest entry; every scan and
    GDFN (and with `fused` K5 / K6) parameter's gradient non-zero and
    finite; the launches the dispatch predicts for a step."""
    with oss_switches(fused):
        want = expected_launches(net, train=True)
        reset_launches()
        t0 = time.perf_counter()
        got = _grads(net, lq, gt)
        t1 = time.perf_counter()
        counts = launches()
        if counts != want:
            raise SystemExit(f"FAIL model grads: launches {counts}, "
                             f"predicted {want}")
        with plain_ops():
            ref = _grads(net, lq, gt)
        t2 = time.perf_counter()
    top = max(r.abs().max().item() for r in ref.values())
    worst, checked = (0.0, ""), 0
    for k, gk in got.items():
        r = ref[k]
        if not torch.isfinite(gk).all():
            raise SystemExit(f"FAIL model grads: {k} not finite")
        if k.endswith("conv_cout.bias"):
            # a shift of every channel before a mean-subtracting LayerNorm:
            # its exact gradient is 0, both sides must show only rounding
            if max(gk.abs().max().item(), r.abs().max().item()) > 1e-5 * top:
                raise SystemExit(f"FAIL model grads: {k} not ~0")
            continue
        rel = (gk - r).abs().max().item() / r.abs().max().item()
        worst = max(worst, (rel, k))
        checked += 1
        if rel > GRAD_BAR:
            raise SystemExit(f"FAIL model grads: {k} rel err {rel:.3e} > "
                             f"{GRAD_BAR}")
    groups = SCAN_PARAMS + GDFN_PARAMS + (FRONT_TAIL_PARAMS if fused
                                          else ())
    kernel_params = [k for k in got if k.rsplit(".", 1)[-1] in SCAN_PARAMS
                     or k.endswith(GDFN_PARAMS)
                     or (fused and k.endswith(FRONT_TAIL_PARAMS))]
    zero = [k for k in kernel_params if not got[k].abs().max() > 0]
    n_blocks = sum(isinstance(m, MamberBlock) for m in net.modules())
    if zero or len(kernel_params) != n_blocks * len(groups):
        raise SystemExit(f"FAIL model grads: zero gradients at {zero} "
                         f"({len(kernel_params)} kernel tensors)")
    tag = "K5/K6 on" if fused else "K5/K6 off"
    print(f"[grads] {label}, depth [1,1,1,1]+1, "
          f"{'x'.join(map(str, lq.shape))} LQ, L1, fp32, {tag}: {checked} "
          f"parameter tensors within {GRAD_BAR} of their largest entry "
          f"(worst {worst[0]:.3e} at {worst[1]}); {len(kernel_params)} "
          f"scan/GDFN{'/front/tail' if fused else ''} tensors with "
          f"non-zero finite gradients; launches {_nonzero(counts)}; kernels "
          f"{1e3 * (t1 - t0):.1f} ms, plain {1e3 * (t2 - t1):.1f} ms (first "
          "calls)")
    del got, ref


# -- phase 5: serve ------------------------------------------------------------

def serve(shape_ms) -> dict:
    net = build_network(dict(type="MambaSISR6", dtype=torch.bfloat16),
                        seed=0)
    ups = RestorationUpscaler(4, net, "cuda", tile=128, tile_pad=0,
                              pre_pad=0, tile_batch=8)
    predicted = expected_launches(net)
    print(f"[serve] predicted launches per forward: {predicted}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for i in range(3):
        img = np.random.RandomState(100 + i).rand(512, 256, 3).astype(
            np.float32)
        t0 = time.perf_counter()
        out = ups.tile_process(img)
        times.append(time.perf_counter() - t0)
        if out.shape != (2048, 1024, 3):
            raise SystemExit(f"FAIL serve: output shape {out.shape}")
        if not np.isfinite(out).all():
            raise SystemExit("FAIL serve: non-finite output")
        print(f"[serve] request {i}: {1e3 * times[-1]:.1f} ms, "
              f"{out.shape[0] * out.shape[1] / times[-1] / 1e6:.3f} MP/s "
              f"out, mean {out.mean():.4f}")
    # untimed: enhance with outscale (uint8 in, the resize on the card)
    img = (np.random.RandomState(103).rand(512, 256, 3) * 255).astype(
        np.uint8)
    out, mode = ups.enhance(img, outscale=3.5)
    if out.shape != (1792, 896, 3) or mode != "RGB" or out.dtype != np.uint8:
        raise SystemExit(f"FAIL serve: enhance(outscale=3.5) gave "
                         f"{out.shape} {out.dtype} {mode}")
    print(f"[serve] enhance(outscale=3.5) of a 512x256 uint8 image: "
          f"{out.shape} {mode}, mean {out.mean():.2f}")
    counts = launches()
    want = {k: 4 * v for k, v in predicted.items()}
    print(f"[serve] launches in 3 requests and the enhance: {counts} "
          f"(predicted {want})")
    if counts != want:
        raise SystemExit("FAIL serve: launch counts differ from the "
                         "dispatch's prediction")
    steady = statistics.median(times[1:])
    print(f"[serve] ms per forward (median of requests 1-2, one batch of "
          f"8 tiles): {1e3 * steady:.1f}; output MP/s "
          f"{2048 * 1024 / steady / 1e6:.3f}; first request "
          f"{1e3 * times[0]:.1f} ms; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
          f"{nvidia_smi_line()}")
    tally, k4_tally = {}, {}
    with k2_shapes(tally), k4_shapes("selective_scan_fwd", k4_tally):
        by_class = profile("serve", lambda: ups.tile_process(
            np.random.RandomState(7).rand(512, 256, 3).astype(np.float32)))
    shape_account("serve", "K2", "forward", tally, shape_ms["K2"],
                  by_class.get("K2 GDFN", 0.0))
    shape_account("serve", "K4", "forward", k4_tally, shape_ms["K4"],
                  by_class.get("K4/K4c scan", 0.0))
    raced = race(ups, net)
    tally, tally6 = {}, {}
    with oss_switches(True), k5_shapes(tally), k6_shapes(tally6):
        by_class = profile("serve_front_tail", lambda: ups.tile_process(
            np.random.RandomState(7).rand(512, 256, 3).astype(np.float32)))
    shape_account("serve", "K5", "forward with K5/K6 on", tally,
                  shape_ms["K5"], by_class.get("K5 OSS front", 0.0))
    shape_account("serve", "K6", "forward with K5/K6 on", tally6,
                  shape_ms["K6"], by_class.get("K6 OSS tail", 0.0))
    return {k: counts[k] + raced[k] for k in counts}


def race(ups, net, rounds=6) -> dict:
    """The served forward with K5/K6 off against on, in turns (off, on, on,
    off, ...), `rounds` of each in this process: every forward's launches
    against the prediction (K5 and K6 once per MamberBlock when on, never
    when off), the two medians, and the largest difference between the two
    outputs. Returns the launches of all the forwards."""
    img = np.random.RandomState(200).rand(512, 256, 3).astype(np.float32)
    n_blocks = sum(isinstance(m, MamberBlock) for m in net.modules())
    times, outs = {False: [], True: []}, {}
    total = dict.fromkeys(KERNELS, 0)
    for i in range(rounds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            with oss_switches(on):
                want = expected_launches(net)
                reset_launches()
                t0 = time.perf_counter()
                outs[on] = ups.tile_process(img)
                times[on].append(time.perf_counter() - t0)
                got = launches()
            if got != want or any(got[k] != (n_blocks if on else 0) for k
                                  in ("oss_front_fused", "oss_tail_fused")):
                raise SystemExit(f"FAIL race: K5/K6 {'on' if on else 'off'}"
                                 f" launches {got}, predicted {want}")
            for k, v in got.items():
                total[k] += v
    off, on = (1e3 * statistics.median(times[k]) for k in (False, True))
    every = {k: [round(1e3 * t, 1) for t in v] for k, v in times.items()}
    diff = np.abs(outs[True] - outs[False]).max()
    print(f"[race] served forward (8 bf16 tiles of 128x128), median of "
          f"{rounds} each, in turns: K5/K6 off {off:.1f} ms, on {on:.1f} ms "
          f"({off / on:.3f}x); all off {every[False]}, all on "
          f"{every[True]}; launches per "
          f"forward K5 {n_blocks} / K6 {n_blocks} on, 0 off; max |out on - "
          f"out off| {diff:.3e}; card {nvidia_smi_line()}")
    return total


# device kernels by class, for the "where the time goes" tables: the
# first class whose key is in the kernel's name takes it
KERNEL_CLASSES = (
    # K3's grids: selective_scan_bwd_seg_kernel, _combine, _kernel
    ("K3 scan backward", ("selective_scan_bwd",)),
    ("K1/K1c fused scan", ("oss_scan_fused", "OssFusedScan")),
    # K4's grids: seg_scan_kernel and seg_scan_combine of its policy
    ("K4/K4c scan", ("SelectiveScanFwd",)),
    # the fp32 route's packing kernel (k2f::pack_kernel) runs before each
    # of its launches
    ("K2 GDFN", ("gdfn_f32_kernel", "gdfn_mma_kernel",
                 "k2f::pack_kernel")),
    # the fp32 route's packing kernel (k5f::pack_kernel) runs before each
    # of its launches
    ("K5 OSS front", ("oss_front_f32_kernel", "oss_front_mma_kernel",
                      "k5f::pack_kernel")),
    ("K6 OSS tail", ("oss_tail_kernel",)),
    # cuDNN's FFT algorithms among them: their transforms, pointwise
    # products and complex (cf32) GEMMs
    ("convolutions", ("fprop", "dgrad", "wgrad", "conv", "implicit",
                      "cudnn", "winograd", "fft", "complex", "cf32")),
    ("matrix products (einsums)", ("gemm", "xmma", "cutlass", "splitK")),
    ("optimizer (Adam, EMA)", ("multi_tensor", "adam", "lerp")),
    ("collectives (NCCL)", ("nccl",)),
    ("copies", ("Memcpy", "Memset", "copy")),
)


def device_breakdown(rows) -> dict:
    """Device time (ms) of the profiled kernels and copies (the card's
    rows of `event_totals`), by class."""
    out = {}
    for name, card, _, ms in rows:
        if card:
            cls = next((c for c, keys in KERNEL_CLASSES
                        if any(k in name for k in keys)),
                       "elementwise and reductions")
            out[cls] = out.get(cls, 0.0) + ms
    return out


def profile(name, fn, extra=None):
    """A torch.profiler table of one call of fn (`event_totals`: top rows
    printed, all in chiprun_out/<name>_profile.txt) and its device time by
    class against the host clock around the call; `extra(prof)`, if
    given, adds lines of its own to both."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = event_totals(prof)
    table = totals_table(rows)
    by_class = device_breakdown(rows)
    busy = sum(by_class.values())
    summary = (f"[{name}] device time by class (ms): " + ", ".join(
        f"{c} {v:.1f}" for c, v in sorted(by_class.items(),
                                          key=lambda kv: -kv[1]))
        + f"; device sum {busy:.1f} ms of {wall:.1f} ms on the host clock "
        f"under the profiler (idle {100 * (1 - busy / wall):.1f}%)")
    if extra is not None:
        summary += "\n" + extra(prof)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{name}_profile.txt"), "w") as f:
        f.write(table + "\n" + summary + "\n")
    print("\n".join(table.splitlines()[:25]))
    print(summary)
    return by_class


# -- phase 6: train ------------------------------------------------------------

def _train_batch():
    """One seeded S1 pair: 8 256x256 GT crops and their 4x box-downsampled
    64x64 LQ, NHWC float32 as the data layer hands them over."""
    gt = np.random.RandomState(0).rand(8, 256, 256, 3).astype(np.float32)
    lq = gt.reshape(8, 64, 4, 64, 4, 3).mean((2, 4))
    return {"lq": lq, "gt": gt}


def train(shape_ms) -> dict:
    # checkpoints go to the git-ignored build/, not to the output directory
    root = os.path.join("build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    opt = dict(RECIPE, path={"models": os.path.join(root, "models"),
                             "training_states": os.path.join(root, "state")})
    model = build_model(opt)
    predicted = expected_launches(model.net_g, train=True)
    print(f"[train] predicted launches per step: {predicted}")
    batch = _train_batch()
    model.feed_data(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times, before = [], [], launches()
    for it in range(1, 7):  # step 1 warms up, steps 2-6 are timed
        t0 = time.perf_counter()
        model.optimize_parameters(it)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(model.get_current_log()["l_pix"])
        now = launches()
        step = {k: now[k] - before[k] for k in now}
        before = now
        if step != predicted:
            raise SystemExit(f"FAIL train: step {it} launches {step}, "
                             f"predicted {predicted}")
        if not np.isfinite(losses[-1]):
            raise SystemExit(f"FAIL train: step {it} loss {losses[-1]}")
        print(f"[train] step {it}: {1e3 * times[-1]:.1f} ms, l_pix "
              f"{losses[-1]:.6f}, lr {model.log_dict['lr']:g}")
    counts = launches()
    if not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL train: loss did not fall: {losses}")
    step_ms = 1e3 * statistics.median(times[1:])
    print(f"[train] ms per step (median of steps 2-6): {step_ms:.1f}; GT "
          f"MP/s {8 * 256 * 256 / step_ms / 1e3:.3f}; first step "
          f"{1e3 * times[0]:.1f} ms; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
          f"{nvidia_smi_line()}")

    # save, resume into a new model, one more step on each: the same step
    model.save(epoch=0, current_iter=6)
    other = build_model(dict(opt, manual_seed=1))
    other.load_net_g(os.path.join(root, "models", "net_g_6.pth"))
    st = other.resume_training(os.path.join(root, "state", "6.state"))
    if st != {"iter": 6, "epoch": 0}:
        raise SystemExit(f"FAIL train: resumed state {st}")
    torch.backends.cudnn.deterministic = True
    step7 = []
    for m in (model, other):
        m.feed_data(batch)
        m.optimize_parameters(7)
        step7.append(m.get_current_log()["l_pix"])
    torch.backends.cudnn.deterministic = False
    worst = 0.0
    for a, b in ((model.net_g, other.net_g),
                 (model.net_g_ema, other.net_g_ema)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            worst = max(worst, (v - w).abs().max().item())
    if step7[0] != step7[1] or worst > 1e-6:
        raise SystemExit(f"FAIL train: resumed step differs: losses "
                         f"{step7}, max weight difference {worst:.3e}")
    print(f"[train] save + resume: step 7 loss {step7[0]:.6f} on both, "
          f"max weight/EMA difference {worst:.3e}")
    del other
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    k2_tally, k3_tally, k4_tally = {}, {}, {}
    with k2_shapes(k2_tally), k3_shapes(k3_tally), k4_shapes(
            "selective_scan_fwd_carries", k4_tally):
        by_class = profile("train", lambda: model.optimize_parameters(8))
    shape_account("train", "K2", "step", k2_tally, shape_ms["K2"],
                  by_class.get("K2 GDFN", 0.0))
    shape_account("train", "K4c", "step", k4_tally, shape_ms["K4c"],
                  by_class.get("K4/K4c scan", 0.0))
    shape_account("train", "K3", "step", k3_tally, shape_ms["K3"],
                  by_class.get("K3 scan backward", 0.0))
    return counts


@contextlib.contextmanager
def counted_shapes(module, name, key, tally):
    """Counts the calls of `module.name` by `key(*args, **kw)` into
    `tally`, through a stand-in for the wrapper in its module (the
    autograd Functions look it up there at each call). The wrapper counts
    its launches on the name it looks up, the stand-in while it is in
    place, so the count passes through it and back."""
    real = getattr(module, name)

    def counted(*args, **kw):
        k = key(*args, **kw)
        tally[k] = tally.get(k, 0) + 1
        return real(*args, **kw)

    counted.launches = real.launches
    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, real)
        real.launches = counted.launches


def k2_shapes(tally):
    """K2's calls by (b, c, h, w, dtype)."""
    return counted_shapes(cuda_effn, "gdfn_residual_fwd",
                          lambda x, *a, **kw: (*x.shape, x.dtype), tally)


def k5_shapes(tally):
    """K5's calls by (b, c, h, w, dtype)."""
    return counted_shapes(cuda_effn, "oss_front_fwd",
                          lambda x, *a, **kw: (*x.shape, x.dtype), tally)


def k6_shapes(tally):
    """K6's calls by (b, d, h, w, dtype) of z."""
    return counted_shapes(cuda_effn, "oss_tail_fwd",
                          lambda y, z, *a, **kw: (*z.shape, z.dtype), tally)


def _k4_key(u, delta, A, B, C, D=None, delta_bias=None,
            delta_softplus=False, reverse=False, out_dtype=None):
    return (*u.shape, B.shape[2], bool(reverse), u.dtype)


def k4_shapes(name, tally):
    """K4's or K4c's calls (`name`: its wrapper) by (b, L, D, G, reverse,
    u's dtype)."""
    return counted_shapes(cuda_scan, name, _k4_key, tally)


def k3_shapes(tally):
    """K3's calls by (b, L, D, G, reverse)."""
    return counted_shapes(
        cuda_scan, "selective_scan_bwd",
        lambda u, delta, A, B, *a, reverse=False, **kw: (
            *u.shape, B.shape[2], bool(reverse)), tally)


def shape_account(phase, kernel, per, tally, ms_by_shape, profiled_ms):
    """A kernel's launches in one forward or step by shape, each times
    phase 3's card ms at that shape (CUDA events, one call alone), against
    the device ms of the profiler's class of the kernel in the same run."""
    total, parts = 0.0, []
    for key, n in sorted(tally.items(), key=lambda kv: -kv[1]):
        shape = ", ".join(str(k)[6:] if isinstance(k, torch.dtype) else
                          f"rev={k}" if isinstance(k, bool) else str(k)
                          for k in key)
        ms = ms_by_shape.get(key)
        if ms is None:
            parts.append(f"({shape}): {n} x not timed")
            continue
        total += n * ms
        parts.append(f"({shape}): {n} x {ms:.4f} = {n * ms:.2f} ms")
    print(f"[{phase}] {kernel} per {per} by shape: " + "; ".join(parts)
          + f"; sum {total:.2f} ms against the profiler's {kernel} class "
          f"{profiled_ms:.2f} ms ({sum(tally.values())} launches); card "
          f"{nvidia_smi_line()}")


# -- phase 7: the pipeline ----------------------------------------------------

DATA = os.path.join("build", "chip_smoke_data")
PIPE = os.path.join("build", "chip_smoke_pipeline")


def _synthetic_image(rng, h, w) -> np.ndarray:
    """A seeded HWC uint8 image: smooth waves and a little noise."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, 3))
    for _ in range(4):
        f, phase = rng.uniform(2, 24, 2), rng.uniform(0, 2 * np.pi, 3)
        img += np.sin(2 * np.pi * (f[0] * yy + f[1] * xx)[..., None] + phase)
    img = 0.5 + 0.1 * img + 0.03 * rng.randn(h, w, 3)
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def write_dataset():
    """16 training pairs of 480x480 GT (the DF2K sub-image size) and their
    4x box-downsampled 120x120 LQ, and 2 validation pairs (120x120 and
    61x45 LQ), as PNG by the port's encoder."""
    shutil.rmtree(DATA, ignore_errors=True)
    rng = np.random.RandomState(0)
    sizes = [("train", f"{i:04d}", 120, 120) for i in range(16)] + [
        ("val", "v0", 120, 120), ("val", "v1", 61, 45)]
    for split, name, h, w in sizes:
        gt = _synthetic_image(rng, 4 * h, 4 * w)
        lq = gt.reshape(h, 4, w, 4, 3).mean((1, 3)).round().astype(np.uint8)
        imwrite(gt, os.path.join(DATA, split, "gt", f"{name}.png"))
        imwrite(lq, os.path.join(DATA, split, "lq", f"{name}.png"))


def _val_dataset() -> dict:
    return {"name": "synthetic val", "type": "PairedImageDataset",
            "dataroot_gt": os.path.join(DATA, "val", "gt"),
            "dataroot_lq": os.path.join(DATA, "val", "lq"),
            "io_backend": {"type": "disk"}}


def _pipeline_opt(total_iter: int, auto_resume: bool, root=PIPE) -> dict:
    """RECIPE with its datasets pointed at the synthetic PNGs, 8 steps,
    validation (PSNR-Y, crop 4) every 4, checkpoints every 4; the
    experiment under `root`."""
    train_ds = {"name": "synthetic DF2K", "type": "PairedImageDataset",
                "dataroot_gt": os.path.join(DATA, "train", "gt"),
                "dataroot_lq": os.path.join(DATA, "train", "lq"),
                "io_backend": {"type": "disk"}, "gt_size": 256,
                "use_hflip": True, "use_rot": True, "num_worker_per_gpu": 8,
                "batch_size_per_gpu": 8, "dataset_enlarge_ratio": 100}
    opt = json.loads(json.dumps(RECIPE))
    opt.update(num_gpu=1, auto_resume=auto_resume,
               datasets={"train": train_ds, "val_1": _val_dataset()},
               path={"experiments_root": os.path.join(root, "exp"),
                     "pretrain_network_g": None, "param_key_g": "params_ema",
                     "strict_load_g": True, "resume_state": None},
               logger={"print_freq": 1, "save_checkpoint_freq": 4,
                       "use_tb_logger": False})
    opt["train"]["total_iter"] = total_iter
    opt["val"] = {"window_size": 8, "val_freq": 4, "save_img": False,
                  "metrics": {"psnr": {"type": "calculate_psnr",
                                       "crop_border": 4,
                                       "test_y_channel": True}}}
    return finalize_options(opt, ".", is_train=True)


def _last_log(prefix: str) -> str:
    log_dir = os.path.join(PIPE, "exp")
    names = sorted(f for f in os.listdir(log_dir)
                   if f.startswith(prefix) and f.endswith(".log"))
    with open(os.path.join(log_dir, names[-1])) as f:
        return f.read()


def _numbers(log: str, key: str) -> list:
    return [float(line.rsplit(key, 1)[1].split()[0])
            for line in log.splitlines() if key in line]


def pipeline() -> dict:
    """Phase 7: train, validate, save, resume, test and serve through the
    pipeline's entry points with K5 and K6 on."""
    t0 = time.perf_counter()
    write_dataset()
    shutil.rmtree(PIPE, ignore_errors=True)
    print(f"[pipeline] dataset written in {time.perf_counter() - t0:.1f} s")
    with oss_switches(True):
        arch = build_network(dict(type="MambaSISR6"), device="cpu")
        fwd, step = (expected_launches(arch, train=t) for t in (False, True))
        del arch
        reset_launches()
        t1 = time.perf_counter()
        model = train_pipeline(".", _pipeline_opt(8, False), device="cuda")
        t2 = time.perf_counter()
        log = _last_log("train_")
        first = launches()
        # validation before step 1, at 4 and 8, and after the loop: 2
        # images each
        n_val = 2 * 4
        want = {k: 8 * step[k] + n_val * fwd[k] for k in KERNELS}
        if first != want:
            raise SystemExit(f"FAIL pipeline: launches {first}, predicted "
                             f"{want}")
        losses, psnrs = _numbers(log, "l_pix:"), _numbers(log, "# psnr:")
        if len(losses) != 8 or not np.isfinite(losses).all():
            raise SystemExit(f"FAIL pipeline: losses {losses}")
        if len(psnrs) != 4 or not np.isfinite(psnrs).all():
            raise SystemExit(f"FAIL pipeline: validation PSNR {psnrs}")
        exp = os.path.join(PIPE, "exp")
        for path in ("models/net_g_4.pth", "models/net_g_8.pth",
                     "training_states/8.state"):
            if not os.path.isfile(os.path.join(exp, path)):
                raise SystemExit(f"FAIL pipeline: no {path}")
        iter_ms = 1e3 * model.timers["iter"].get_avg_time()
        data_ms = 1e3 * model.timers["data"].get_avg_time()
        print(f"[pipeline] 8 steps of the recipe: l_pix "
              f"{[round(v, 5) for v in losses]}; validation PSNR-Y "
              f"{[round(v, 4) for v in psnrs]} dB (iters 0, 4, 8, end); ms "
              f"per iter {iter_ms:.1f}, data ms per iter {data_ms:.1f} (mean "
              f"of 8); run {t2 - t1:.1f} s; launches {first}; card "
              f"{nvidia_smi_line()}")
        del model

        # auto-resume to 10: steps 9 and 10, then validation
        reset_launches()
        model = train_pipeline(".", _pipeline_opt(10, True), device="cuda")
        log = _last_log("train_")
        resumed = launches()
        want = {k: 2 * step[k] + 2 * fwd[k] for k in KERNELS}
        if "Resuming training from epoch 0, iter 8." not in log \
                or resumed != want:
            raise SystemExit(f"FAIL pipeline: resume: launches {resumed} "
                             f"(predicted {want}); log:\n{log[-2000:]}")
        if not os.path.isfile(os.path.join(exp, "models", "net_g_10.pth")):
            raise SystemExit("FAIL pipeline: no net_g_10.pth")
        del model
        print(f"[pipeline] auto-resume at iter 8 to iter 10: launches "
              f"{resumed}")

        # test_pipeline on the validation pairs, then the inference CLI
        ckpt = os.path.join(exp, "models", "net_g_10.pth")
        res = os.path.join(PIPE, "results")
        opt = finalize_options({
            "name": "chip_smoke_test", "model_type": "MambaSISRModel",
            "scale": 4, "manual_seed": 0,
            "network_g": RECIPE["network_g"],
            "datasets": {"test_1": _val_dataset()},
            "path": {"results_root": res, "pretrain_network_g": ckpt,
                     "param_key_g": "params_ema"},
            "val": {"window_size": 8, "save_img": True,
                    "metrics": {"psnr": {"type": "calculate_psnr",
                                         "crop_border": 4,
                                         "test_y_channel": True}}},
        }, ".", is_train=False)
        reset_launches()
        test_pipeline(".", opt, device="cuda")
        tested = launches()
        if tested != {k: 2 * fwd[k] for k in KERNELS}:
            raise SystemExit(f"FAIL pipeline: test launches {tested}")
        lq_dir = os.path.join(DATA, "val", "lq")
        out_dir = os.path.join(PIPE, "cli")
        t3 = time.perf_counter()
        subprocess.run([sys.executable, "inference_torch.py", "--model_path",
                        ckpt, "--arch", "MambaSISR6", "-i", lq_dir, "-o",
                        out_dir, "--scale", "4", "--device", "cuda"],
                       check=True)
        t4 = time.perf_counter()
    for name in sorted(os.listdir(lq_dir)):
        stem = os.path.splitext(name)[0]
        lq = imread(os.path.join(lq_dir, name))
        for out in (os.path.join(res, "visualization", "synthetic val",
                                 name),
                    os.path.join(out_dir, f"{stem}_out.png")):
            img = imread(out)
            if img.shape != (4 * lq.shape[0], 4 * lq.shape[1], 3):
                raise SystemExit(f"FAIL pipeline: {out} is {img.shape} for "
                                 f"an LQ of {lq.shape}")
    print(f"[pipeline] test_pipeline and inference_torch.py --device cuda "
          f"(subprocess, {t4 - t3:.1f} s): outputs 4x their LQ; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: first[k] + resumed[k] + tested[k] for k in KERNELS}


# -- phase 7b: the GAN stage ---------------------------------------------------

GAN = os.path.join("build", "chip_smoke_gan")
# the S2 recipe of options/MambaSISR15GAN_x4.yml (G from an S1 checkpoint's
# EMA, L1 + VGG19 perceptual + vanilla GAN, UNetDiscriminatorSN, two Adams)
GAN_RECIPE = {
    "name": "MambaSISR15GAN_x4", "model_type": "MambaSISRGANModel",
    "scale": 4, "manual_seed": 0, "is_train": True,
    "network_g": RECIPE["network_g"],
    "network_d": {"type": "UNetDiscriminatorSN", "num_in_ch": 3,
                  "num_feat": 64, "skip_connection": True},
    "train": {"ema_decay": 0.999,
              "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0,
                          "betas": [0.9, 0.99]},
              "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0,
                          "betas": [0.9, 0.99]},
              "scheduler": {"type": "MultiStepLR", "milestones": [150000],
                            "gamma": 0.5},
              "total_iter": 300000, "warmup_iter": -1,
              "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                            "reduction": "mean"},
              "perceptual_opt": {
                  "type": "PerceptualLoss",
                  "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1,
                                    "conv3_4": 1, "conv4_4": 1,
                                    "conv5_4": 1},
                  "vgg_type": "vgg19", "use_input_norm": True,
                  "perceptual_weight": 1.0, "style_weight": 0,
                  "range_norm": False, "criterion": "l1"},
              "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                          "real_label_val": 1.0, "fake_label_val": 0.0,
                          "loss_weight": 1.0},
              "net_d_iters": 1, "net_d_init_iters": 0},
    "val": {"window_size": 8},
}
GAN_D_KEYS = {"l_d_real", "l_d_fake", "out_d_real", "out_d_fake", "lr"}
GAN_G_KEYS = {"l_g_pix", "l_g_percep", "l_g_gan"}


def _gan_opt(pretrain=None, network_g=None) -> dict:
    opt = json.loads(json.dumps(GAN_RECIPE))
    opt["network_g"].update(network_g or {})
    opt["path"] = {"models": os.path.join(GAN, "models"),
                   "training_states": os.path.join(GAN, "state"),
                   "pretrain_network_g": pretrain,
                   "param_key_g": "params_ema", "strict_load_g": True}
    return opt


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _copies(tensors) -> list:
    return [t.detach().clone() for t in tensors]


def _moved(before, after) -> bool:
    """Whether every tensor of `after` differs from its copy in `before`."""
    return all(not torch.equal(a, b) for a, b in zip(before, after))


def _still(net, before) -> list:
    """The parameters of `net` equal to their copies in `before`, but the
    channel scans' conv_cout.bias (its exact gradient is 0)."""
    return [k for (k, p), b in zip(net.named_parameters(), before)
            if torch.equal(p, b) and not k.endswith("conv_cout.bias")]


@contextlib.contextmanager
def step_events(model, log: list):
    """CUDA events around the model's G and D steps: (name, start, end)
    appended to `log` for each step taken."""
    for name in ("_g_step", "_d_step"):
        def run(*a, _fn=getattr(model, name), _name=name, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _fn(*a, **kw)
            e1.record()
            log.append((_name, e0, e1))
            return out
        setattr(model, name, run)
    try:
        yield
    finally:
        for name in ("_g_step", "_d_step"):
            delattr(model, name)


@contextlib.contextmanager
def module_ranges(mods: dict):
    """Each module's forward inside `record_function(tag)`, for
    `device_by_module`."""
    for tag, mod in mods.items():
        def run(*a, _fwd=mod.forward, _tag=tag, **kw):
            with torch.profiler.record_function(_tag):
                return _fwd(*a, **kw)
        mod.forward = run
    try:
        yield
    finally:
        for mod in mods.values():
            del mod.forward


def device_by_module(prof, tags) -> dict:
    """Device ms of the profiled kernels by module and class: a kernel
    belongs to the module whose tagged forward range holds the op that
    launched it, or, in the backward, to the module whose forward made
    the autograd node that launched it (the profiler's own link: the
    node's sequence number and forward thread). The rest is "other"
    (outside every range: the losses, Adam, EMA) or "backward" (a
    backward node whose forward is in no range)."""
    def owner(e, fwd=None):
        """The tag of e's forward range; in a backward (scope 1), that of
        the innermost backward function whose forward is known: a
        recompute inside a Function's backward goes to the Function."""
        in_bw = False
        while e is not None:
            if e.scope == 1:
                in_bw = True
                t = (fwd or {}).get((e.sequence_nr, e.fwd_thread))
                if t is not None:
                    return t
            elif not in_bw and e.name in tags:
                return e.name
            e = e.cpu_parent
        return "backward" if in_bw else None

    events = prof.events()
    fwd = {}
    for e in events:
        t = owner(e) if e.sequence_nr >= 0 else None
        if t in tags:
            fwd.setdefault((e.sequence_nr, e.thread), t)
    out = {}
    for e in events:
        if not e.kernels:
            continue
        t = owner(e, fwd) or "other"
        for k in e.kernels:
            cls = next((c for c, keys in KERNEL_CLASSES
                        if any(n in k.name for n in keys)),
                       "elementwise and reductions")
            row = out.setdefault(t, {})
            row[cls] = row.get(cls, 0.0) + k.duration / 1e3
    return out


def _by_module_lines(prof) -> str:
    rows = device_by_module(prof, ("G", "D", "VGG"))
    return "\n".join(
        f"[gan] device ms by module, {t}: " + ", ".join(
            f"{c} {v:.1f}" for c, v in sorted(row.items(),
                                              key=lambda kv: -kv[1]))
        + f" (sum {sum(row.values()):.1f})"
        for t, row in sorted(rows.items()))


def gan() -> dict:
    """Phase 7b: the S2 GAN stage at the recipe's full width. Returns the
    launches of its main path (the timed, profiled and gated iterations
    and the pipeline), not those of the card-against-CPU comparison."""
    t0 = time.perf_counter()
    shutil.rmtree(GAN, ignore_errors=True)
    # 1. G from an S1 checkpoint's EMA, through the recipe's load path
    seeded = build_network(GAN_RECIPE["network_g"], device="cpu", seed=7)
    ckpt = os.path.join(GAN, "s1", "net_g_s1.pth")
    save_network(ckpt, seeded.state_dict(), seeded.state_dict())
    model = build_model(_gan_opt(ckpt))
    for k, v in model.net_g.state_dict().items():
        if not torch.equal(v.cpu(), seeded.state_dict()[k]):
            raise SystemExit(f"FAIL gan: {k} not loaded from the checkpoint")
    del seeded
    step = expected_launches(model.net_g, train=True)
    fwd = expected_launches(model.net_g, train=False)
    print(f"[gan] predicted launches per G step: {_nonzero(step)}; per "
          f"gated iteration: {_nonzero(fwd)}")
    model.feed_data(_train_batch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # 2-3. 1 warm-up and 5 timed iterations, each checked
    nets = (model.net_g, model.net_d)
    start = [_copies(n.parameters()) for n in nets]
    events, times = [], []
    total = dict.fromkeys(KERNELS, 0)
    with step_events(model, events):
        for it in range(1, 7):
            u = _copies(m.weight_u for m in model.net_d.sn_convs())
            reset_launches()
            t1 = time.perf_counter()
            model.optimize_parameters(it)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            counts = launches()
            total = {k: total[k] + counts[k] for k in KERNELS}
            log = model.get_current_log()
            if counts != step:
                raise SystemExit(f"FAIL gan: iteration {it} launches "
                                 f"{counts}, predicted {step}")
            if set(log) != GAN_D_KEYS | GAN_G_KEYS or not all(
                    np.isfinite(v) for v in log.values()):
                raise SystemExit(f"FAIL gan: iteration {it} log {log}")
            if not _moved(u, (m.weight_u for m in model.net_d.sn_convs())):
                raise SystemExit(f"FAIL gan: iteration {it} left a "
                                 "spectral norm's u as it was")
            print(f"[gan] iteration {it}: {1e3 * times[-1]:.1f} ms; " +
                  ", ".join(f"{k} {v:.5f}" for k, v in log.items()))
    still = [k for n, before in zip(nets, start) for k in _still(n, before)]
    if still:
        raise SystemExit(f"FAIL gan: parameters that did not move: {still}")
    split = {"_g_step": [], "_d_step": []}
    for name, e0, e1 in events[2:]:  # after iteration 1's two steps
        split[name].append(e0.elapsed_time(e1))
    iter_ms = 1e3 * statistics.median(times[1:])
    print(f"[gan] ms per iteration (median of 2-6): {iter_ms:.1f}; GT MP/s "
          f"{8 * 256 * 256 / iter_ms / 1e3:.3f}; G step "
          f"{statistics.median(split['_g_step']):.1f} ms, D step "
          f"{statistics.median(split['_d_step']):.1f} ms (CUDA events); "
          f"first iteration {1e3 * times[0]:.1f} ms; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"per iteration {_nonzero(step)}; card {nvidia_smi_line()}")

    # the profiled iteration: classes, idle share, G / D / VGG split
    reset_launches()
    with module_ranges({"G": model.net_g, "D": model.net_d,
                        "VGG": model.cri_perceptual}):
        profile("gan", lambda: model.optimize_parameters(7),
                extra=_by_module_lines)
    counts = launches()
    if counts != step:
        raise SystemExit(f"FAIL gan: profiled launches {counts}")
    total = {k: total[k] + counts[k] for k in KERNELS}

    # 4. a gated iteration: G's no-grad forward, no G update
    model.net_d_init_iters = 8
    g_before = _copies(model.net_g.state_dict().values())
    ema_before = _copies(model.net_g_ema.state_dict().values())
    d_before = _copies(model.net_d.parameters())
    reset_launches()
    model.optimize_parameters(8)
    torch.cuda.synchronize()
    counts = launches()
    log = model.get_current_log()
    if counts != fwd or set(log) != GAN_D_KEYS:
        raise SystemExit(f"FAIL gan: gated iteration launches {counts} "
                         f"(predicted {fwd}), log {log}")
    if not all(torch.equal(a, b) for a, b in zip(
            g_before + ema_before, list(model.net_g.state_dict().values())
            + list(model.net_g_ema.state_dict().values()))) or not _moved(
                d_before, model.net_d.parameters()):
        raise SystemExit("FAIL gan: the gated iteration moved G or not D")
    total = {k: total[k] + counts[k] for k in KERNELS}
    print(f"[gan] gated iteration (net_d_init_iters 8): launches "
          f"{_nonzero(counts)}; "
          "G and its EMA unchanged, D moved")
    del model, start, g_before, ema_before, d_before
    torch.cuda.empty_cache()

    gan_card_vs_cpu()
    counts = gan_pipeline(ckpt, step, fwd)
    total = {k: total[k] + counts[k] for k in KERNELS}
    shutil.rmtree(GAN)
    print(f"[gan] phase 7b {time.perf_counter() - t0:.1f} s; launches "
          f"{_nonzero(total)}")
    return total


def _g_upstream(model, out, layers=None):
    """d (the G step's loss) / d out at `out`: pixel, perceptual (only
    its `layers`, if given) and GAN terms, D frozen, its u not stored."""
    out = out.detach().requires_grad_()
    vgg = model.cri_perceptual
    weights = vgg.layer_weights
    if layers is not None:
        vgg.layer_weights = {k: weights[k] for k in layers}
    try:
        total, _ = model._loss_terms(out, model.gt, prefix="l_g_")
    finally:
        vgg.layer_weights = weights
    model.net_d.requires_grad_(False)
    total = total + model.cri_gan(model.net_d(out), True, is_disc=False)
    model.net_d.requires_grad_(True)
    return torch.autograd.grad(total, out)[0]


def _rel_max(got, ref) -> float:
    return ((got.cpu() - ref).abs().max() / ref.abs().max()).item()


def _worst_grad(pairs, top) -> tuple:
    """The largest gradient error relative to its tensor's largest entry
    over (name, got, ref) triples; conv_cout.bias (exact gradient 0) must
    be ~0 on both sides instead (phase 4b's rule)."""
    worst, checked = (0.0, ""), 0
    for k, g, r in pairs:
        if g is None or r is None or not torch.isfinite(g).all():
            raise SystemExit(f"FAIL gan card vs CPU: {k} has no finite "
                             "gradient")
        g = g.cpu()
        if k.endswith("conv_cout.bias"):
            if max(g.abs().max().item(), r.abs().max().item()) > 1e-5 * top:
                raise SystemExit(f"FAIL gan card vs CPU: {k} not ~0")
            continue
        worst = max(worst, ((g - r).abs().max().item()
                            / r.abs().max().item(), k))
        checked += 1
    return worst, checked


def gan_card_vs_cpu():
    """5. The GAN step at reduced depth (MambaSISR6 widths, [1,1,1,1] + 1;
    D and VGG19 at full width), batch 2 of 32x32 LQ / 128x128 GT, through
    the kernels on the card and through the port's CPU path (the plain
    versions) from the same weights, u and batch.

    VGG19's max-pools and ReLUs are kinks: where the two paths' fp32
    roundings (a few 1e-6 of the features) put a window's two largest
    entries, or an activation and zero, in the other order, d loss / d
    output changes by a few percent of its largest entry over that
    position's receptive field. Past the second pool (conv3_4 onward)
    that happens on every input, with cuDNN or without it (its own
    algorithms add 1e-4 to 1e-3 at conv3_4), and moves G's gradients by a
    few 1e-3. So each part is held where it is well posed: G's forward
    within phase 4's 1e-3; d loss / d output at the card's output, card
    against CPU, of the pixel, GAN (through D) and perceptual terms up
    to conv2_2 within GRAD_BAR of its largest entry (the recipe's five
    layers printed); G's backward of one upstream gradient, kernels
    against CPU, every tensor within GRAD_BAR of its largest entry; then
    one iteration on each, every logged loss within 1e-3 relative (D's
    mean predictions within 1e-3 of max(|x|, 1)), every D gradient within
    GRAD_BAR of its largest entry, every u within GRAD_BAR; the
    iteration's G gradients printed."""
    t0 = time.perf_counter()
    opt = _gan_opt(network_g={"num_blocks": [1, 1, 1, 1],
                              "num_refinement_blocks": 1})
    card = build_model(opt)
    host = build_model(opt, device="cpu")
    for a, b in ((card.net_g, host.net_g), (card.net_g_ema, host.net_g_ema),
                 (card.net_d, host.net_d)):
        b.load_state_dict({k: v.cpu() for k, v in a.state_dict().items()})
    gt = np.random.RandomState(3).rand(2, 128, 128, 3).astype(np.float32)
    batch = {"lq": gt.reshape(2, 32, 4, 32, 4, 3).mean((2, 4)), "gt": gt}
    for m in (card, host):
        m.feed_data(batch)

    # G's forward, the upstream gradient at the card's output, G's backward
    out_c, out_h = card.net_g(card.lq), host.net_g(host.lq)
    fwd_err = check_close("gan G output card vs CPU", out_c.detach().cpu(),
                          out_h.detach(), 1e-3, 1e-3)
    shallow = ("conv1_2", "conv2_2")
    up_err = _rel_max(_g_upstream(card, out_c, shallow),
                      _g_upstream(host, out_c.detach().cpu(), shallow))
    up_c = _g_upstream(card, out_c)
    up_h = _g_upstream(host, out_c.detach().cpu())
    up_all = _rel_max(up_c, up_h)
    up_norm = ((up_c.cpu() - up_h).norm() / up_h.norm()).item()
    out_c.backward(up_c)
    out_h.backward(up_c.cpu())
    top = max(p.grad.abs().max().item() for p in host.net_g.parameters())
    (g_err, g_at), g_n = _worst_grad(
        ((k, p.grad, q.grad) for (k, p), q in zip(
            card.net_g.named_parameters(), host.net_g.parameters())), top)

    # one iteration on each from the same state
    logs = []
    for m in (card, host):
        m.optimize_parameters(1)
        logs.append(m.get_current_log())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    log_err = {k: abs(logs[0][k] - ref) / (abs(ref) if k.startswith("l")
                                           else max(abs(ref), 1.0))
               for k, ref in logs[1].items()}
    top_d = max(p.grad.abs().max().item() for p in host.net_d.parameters())
    (d_err, d_at), d_n = _worst_grad(
        ((k, p.grad, q.grad) for (k, p), q in zip(
            card.net_d.named_parameters(), host.net_d.parameters())), top_d)
    (it_err, it_at), _ = _worst_grad(
        ((k, p.grad, q.grad) for (k, p), q in zip(
            card.net_g.named_parameters(), host.net_g.parameters())), top)
    u_err = max((a.weight_u.cpu() - b.weight_u).abs().max().item()
                / b.weight_u.abs().max().item()
                for a, b in zip(card.net_d.sn_convs(), host.net_d.sn_convs()))
    print(f"[gan] card vs CPU, MambaSISR6 widths at [1,1,1,1]+1, D and VGG19 "
          f"at full width, 2 x 32x32 LQ / 128x128 GT: G output max abs err "
          f"{fwd_err:.3e} (tol 1e-3); d loss / d output at the card's "
          f"output, perceptual up to conv2_2: {up_err:.3e} of its largest "
          f"entry (bar {GRAD_BAR}); the recipe's five layers (printed): "
          f"{up_all:.3e} of its largest entry, {up_norm:.3e} in the L2 "
          f"norm; G's backward of the latter, {g_n} "
          f"tensors, worst {g_err:.3e} at {g_at} (bar {GRAD_BAR}); one "
          f"iteration: logged values within {max(log_err.values()):.2e} "
          f"(tol 1e-3), {d_n} D gradient tensors worst {d_err:.3e} at "
          f"{d_at}, u {u_err:.3e} (bar {GRAD_BAR}), G gradients (printed) "
          f"worst {it_err:.3e} at {it_at}; {1e3 * (t1 - t0):.0f} ms with "
          "the builds")
    bad = [k for k, v in log_err.items() if v > 1e-3]
    if bad or max(up_err, g_err, d_err, u_err) > GRAD_BAR:
        raise SystemExit(f"FAIL gan card vs CPU: logged {bad}, upstream "
                         f"{up_err:.3e}, G backward {g_err:.3e}, D "
                         f"{d_err:.3e}, u {u_err:.3e}")
    del card, host
    torch.cuda.empty_cache()


def _gan_pipeline_opt(total_iter: int, auto_resume: bool, ckpt: str):
    """The GAN recipe with its datasets pointed at phase 7's synthetic
    PNGs, validation (PSNR-Y) and checkpoints every 2 iterations."""
    opt = _pipeline_opt(total_iter, auto_resume,
                        root=os.path.join(GAN, "pipeline"))
    base = json.loads(json.dumps(GAN_RECIPE))
    base["train"]["total_iter"] = total_iter
    opt.update(name=base["name"], model_type=base["model_type"],
               network_d=base["network_d"], train=base["train"])
    opt["path"].update(pretrain_network_g=ckpt)
    opt["logger"]["save_checkpoint_freq"] = 2
    opt["val"]["val_freq"] = 2
    return opt


def gan_pipeline(ckpt: str, step: dict, fwd: dict) -> dict:
    """6. `train_pipeline` with the GAN recipe on phase 7's synthetic PNG
    pairs: 2 iterations, validation before, at 2 and at the end, net_g,
    net_d and the state at 2; then auto-resume takes iteration 3."""
    if not os.path.isdir(DATA):
        write_dataset()
    exp = os.path.join(GAN, "pipeline", "exp")
    reset_launches()
    model = train_pipeline(".", _gan_pipeline_opt(2, False, ckpt),
                           device="cuda")
    first = launches()
    names = sorted(f for f in os.listdir(exp) if f.startswith("train_"))
    with open(os.path.join(exp, names[-1])) as f:
        log = f.read()
    want = {k: 2 * step[k] + 3 * 2 * fwd[k] for k in KERNELS}
    psnrs = _numbers(log, "# psnr:")
    if first != want or len(psnrs) != 3 or "l_g_percep:" not in log:
        raise SystemExit(f"FAIL gan pipeline: launches {first} (predicted "
                         f"{want}), PSNR {psnrs}")
    for path in ("models/net_g_2.pth", "models/net_d_2.pth",
                 "training_states/2.state"):
        if not os.path.isfile(os.path.join(exp, path)):
            raise SystemExit(f"FAIL gan pipeline: no {path}")
    iter_ms = 1e3 * model.timers["iter"].get_avg_time()
    del model
    reset_launches()
    train_pipeline(".", _gan_pipeline_opt(3, True, ckpt), device="cuda")
    resumed = launches()
    names = sorted(f for f in os.listdir(exp) if f.startswith("train_"))
    with open(os.path.join(exp, names[-1])) as f:
        log = f.read()
    want = {k: step[k] + 2 * fwd[k] for k in KERNELS}
    if "Resuming training from epoch 0, iter 2." not in log \
            or resumed != want or not os.path.isfile(
                os.path.join(exp, "models", "net_d_3.pth")):
        raise SystemExit(f"FAIL gan pipeline: resume: launches {resumed} "
                         f"(predicted {want}); log:\n{log[-2000:]}")
    print(f"[gan] train_pipeline with the GAN recipe: 2 iterations, "
          f"validation PSNR-Y {[round(v, 4) for v in psnrs]} dB (iters 0, "
          f"2, end), ms per iteration {iter_ms:.1f}; net_g_2, net_d_2, "
          f"2.state written; auto-resume at 2 to 3")
    return {k: first[k] + resumed[k] for k in KERNELS}


# -- phase 7c: RealSR ----------------------------------------------------------

REALSR = os.path.join("build", "chip_smoke_realsr")
_KLIST = ["iso", "aniso", "generalized_iso", "generalized_aniso",
          "plateau_iso", "plateau_aniso"]
_KPROB = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]
# the S1 recipe of options/mambaSR11_x4.yml (degradation ranges, the
# RealESRGANDataset's kernel options, MambaRealSR11, L1, Adam 2e-4, EMA)
REALSR_RECIPE = {
    "name": "MambaRealSR11", "model_type": "MambaRealSR", "scale": 4,
    "manual_seed": 0, "is_train": True, "gt_usm": False, "l1_gt_usm": False,
    "resize_prob": [0.2, 0.7, 0.1], "resize_range": [0.15, 1.5],
    "gaussian_noise_prob": 0.5, "noise_range": [1, 30],
    "poisson_scale_range": [0.05, 3], "gray_noise_prob": 0.4,
    "jpeg_range": [30, 95], "second_blur_prob": 0.8,
    "resize_prob2": [0.3, 0.4, 0.3], "resize_range2": [0.3, 1.2],
    "gaussian_noise_prob2": 0.5, "noise_range2": [1, 25],
    "poisson_scale_range2": [0.05, 2.5], "gray_noise_prob2": 0.4,
    "jpeg_range2": [30, 95], "gt_size": 256, "queue_size": 180,
    "datasets": {"train": {
        "name": "DF2K+OST", "type": "RealESRGANDataset",
        "dataroot_gt": os.path.join(REALSR, "gt"), "meta_info": None,
        "io_backend": {"type": "disk"},
        "blur_kernel_size": 21, "kernel_list": _KLIST,
        "kernel_prob": _KPROB, "sinc_prob": 0.1, "blur_sigma": [0.2, 3],
        "betag_range": [0.5, 4], "betap_range": [1, 2],
        "blur_kernel_size2": 21, "kernel_list2": _KLIST,
        "kernel_prob2": _KPROB, "sinc_prob2": 0.1,
        "blur_sigma2": [0.2, 1.5], "betag_range2": [0.5, 4],
        "betap_range2": [1, 2], "final_sinc_prob": 0.8, "gt_size": 256,
        "crop_pad_size": 400, "use_hflip": True, "use_rot": False,
        "use_shuffle": True, "num_worker_per_gpu": 8,
        "batch_size_per_gpu": 9, "dataset_enlarge_ratio": 1}},
    "network_g": {"type": "MambaRealSR11", "inp_channels": 3,
                  "out_channels": 3, "dim": 48, "num_blocks": [6, 2, 2, 1],
                  "num_refinement_blocks": 6, "ffn_expansion_factor": 2.66,
                  "bias": False, "LayerNorm_type": "WithBias"},
    "path": {"pretrain_network_g": None, "param_key_g": "params_ema",
             "strict_load_g": True, "resume_state": None},
    "train": {"ema_decay": 0.999,
              "optim_g": {"type": "Adam", "lr": 2e-4, "weight_decay": 0,
                          "betas": [0.9, 0.99]},
              "scheduler": {"type": "MultiStepLR",
                            "milestones": [250000, 350000], "gamma": 0.5},
              "total_iter": 500000, "warmup_iter": -1,
              "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                            "reduction": "mean"}},
    "val": {"window_size": 8},
}


def _realsr_gan_recipe() -> dict:
    """The GAN recipe of options/mambaSR11GAN_x4.yml: the S1 recipe with
    the per-loss USM GT, the 64-feature UNetDiscriminatorSN with skips,
    L1 + VGG19 perceptual (l1) + vanilla GAN (weight 0.1), two Adams
    1e-4."""
    opt = json.loads(json.dumps(REALSR_RECIPE))
    opt.pop("gt_usm")
    opt.update(name="MambaRealSR11GAN", model_type="MambaRealSRGAN",
               l1_gt_usm=True, percep_gt_usm=True, gan_gt_usm=False,
               network_d=dict(GAN_RECIPE["network_d"]))
    t = opt["train"]
    t["optim_g"]["lr"] = 1e-4
    t["optim_d"] = {"type": "Adam", "lr": 1e-4, "weight_decay": 0,
                    "betas": [0.9, 0.99]}
    t["scheduler"]["milestones"] = [400000]
    t["total_iter"] = 400000
    t["perceptual_opt"] = dict(GAN_RECIPE["train"]["perceptual_opt"])
    t["gan_opt"] = dict(GAN_RECIPE["train"]["gan_opt"], loss_weight=0.1)
    t.update(net_d_iters=1, net_d_init_iters=0)
    return opt


def write_realsr_dataset():
    """12 GT PNGs: 9 of 480x480 (larger than crop_pad_size 400: the
    crop), 3 smaller on one side or both (352x384, 300x448, 448x320: the
    reflect-101 pad)."""
    shutil.rmtree(os.path.join(REALSR, "gt"), ignore_errors=True)
    rng = np.random.RandomState(3)
    sizes = [(480, 480)] * 9 + [(352, 384), (300, 448), (448, 320)]
    for i, (h, w) in enumerate(sizes):
        imwrite(_synthetic_image(rng, h, w),
                os.path.join(REALSR, "gt", f"{i:04d}.png"))


def _realsr_batches(n, seed=0) -> list:
    """n host batches of 9 from RealESRGANDataset over the PNGs, as the
    loader collates them."""
    from vmambair_torch.data import build_dataset
    from vmambair_torch.data.loader import default_collate

    ds = build_dataset(dict(REALSR_RECIPE["datasets"]["train"],
                            phase="train", scale=4))
    rng = random.Random(seed)
    return [default_collate([ds.__getitem__((9 * j + i) % len(ds), rng=rng)
                             for i in range(9)]) for j in range(n)]


class Replay:
    """A synthesis noise sampler that records its samples from a CPU
    generator on the first run and, after `replay_on(device)`, replays
    them copied to that device."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.seen, self.device = {}, None

    def replay_on(self, device):
        self.device = device

    def _take(self, tag, make):
        if self.device is None:
            self.seen[tag] = make()
        return self.seen[tag].to(self.device or "cpu")

    def normal(self, shape, tag):
        return self._take(tag, lambda: torch.randn(shape, generator=self.gen))

    def poisson(self, rate, tag):
        return self._take(tag, lambda: torch.poisson(rate, self.gen))


def draws_to(d, device):
    """The synthesis draws `d` with their per-image tensors on `device`."""
    for nd in (d.noise1, d.noise2):
        nd.sigma, nd.scale, nd.gray = (
            t.to(device) for t in (nd.sigma, nd.scale, nd.gray))
    d.q1, d.q2 = d.q1.to(device), d.q2.to(device)
    return d


def realsr_synthesis_vs_cpu(batch):
    """The synthesis on the card against the same synthesis on the CPU
    (fp32, TF32 off), with the same draws and noise samples, at full size
    (9 x 400x400 GT, the dataset's kernels), for 3 seeds: the GT crops
    equal, the USM GT under `usm_vs_cpu`'s rule, the LQ under the CPU
    tests' rule for
    JPEG's rounds and the uint8 grid (at most 2% of its elements differ
    from the CPU's, at most 0.5% by more than one uint8 step)."""
    from vmambair_torch.train import realesrgan_model as trm

    gt = torch.from_numpy(batch["gt"]).permute(0, 3, 1, 2).contiguous()
    kern = [torch.from_numpy(batch[k]) for k in trm.KERNEL_KEYS]
    off = far = n = 0
    for seed in range(3):
        d = trm.Synthesis(REALSR_RECIPE, 4, 256, seed, "cpu").draw(9, 400,
                                                                   400)
        sampler = Replay(seed)
        ref = trm.synthesize(gt, *kern, d, sampler, 4, 256)
        sampler.replay_on("cuda")
        got = trm.synthesize(gt.cuda(), *(k.cuda() for k in kern),
                             draws_to(d, "cuda"), sampler, 4, 256)
        if not torch.equal(got[0].cpu(), ref[0]):
            raise SystemExit("FAIL realsr synthesis: GT crops differ")
        flips, usm = usm_vs_cpu(gt, gt.cuda(), d.top * 4, d.left * 4,
                                got[1], ref[1])
        diff = (got[2].cpu() - ref[2]).abs()
        o, f = int((diff > 1e-6).sum()), int((diff > 1.5 / 255).sum())
        print(f"[realsr] synthesis card vs CPU, seed {seed} (s1 {d.s1:.3f} "
              f"m{d.m1}, {'gauss' if d.noise1.gaussian else 'poisson'}, "
              f"blur2 {d.blur2}, s2 {d.s2:.3f} m{d.m2}, "
              f"{'gauss' if d.noise2.gaussian else 'poisson'}, sinc first "
              f"{d.sinc_first}): {o} of {diff.numel()} LQ elements differ, "
              f"{f} by more than one uint8 step; USM mask flips {flips}, "
              f"USM GT off by {usm:.2e} outside their footprints")
        off, far, n = off + o, far + f, n + diff.numel()
    if off > 0.02 * n or far > 0.005 * n:
        raise SystemExit(f"FAIL realsr synthesis: {off} / {far} of {n}")
    print(f"[realsr] synthesis card vs CPU: {off / n:.5f} of the LQ "
          f"elements differ, {far / n:.5f} by more than one uint8 step")


def usm_vs_cpu(gt, gt_card, top, left, usm_card, usm_cpu):
    """The USM sharpener's hard mask (|residual| * 255 > 10) on the card
    against the CPU's: a mask element may flip only at a tie (|residual| *
    255 within 1e-3 of 10), and the sharpened GT crops (at (top, left))
    must agree within 1e-5 outside the 51x51 blur footprints of the
    flips. Returns (flips, the largest difference outside them)."""
    from vmambair_torch.ops import degradation as td

    def residual(x):
        return (x - td._gauss_blur(x, td.usm_kernel(50, x.device))).abs() \
            * 255.0
    r_cpu, r_card = residual(gt), residual(gt_card).cpu()
    flip = (r_cpu > 10.0) != (r_card > 10.0)
    if ((r_cpu[flip] - 10.0).abs() > 1e-3).any():
        raise SystemExit("FAIL realsr synthesis: the USM mask flips away "
                         "from its threshold")
    foot = F.max_pool2d(flip.float(), 51, 1, 25) > 0
    h, w = usm_cpu.shape[2:]
    foot = foot[:, :, top:top + h, left:left + w]
    off = (usm_card.cpu() - usm_cpu).abs()[~foot]
    worst = off.max().item() if off.numel() else 0.0
    if worst > 1e-5:
        raise SystemExit(f"FAIL realsr synthesis: USM GT off by {worst:.2e} "
                         "outside the footprints of its mask's flips")
    return int(flip.sum()), worst


@contextlib.contextmanager
def synth_timers(model, log: dict):
    """CUDA events and the host clock around the model's synthesis and its
    queue: appended to log["synth"] and log["queue"] as (start, end,
    host ms)."""
    real = {"synth": model.synthesis,
            "queue": model._dequeue_and_enqueue}

    def timed(name):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = real[name](*a, **kw)
            e1.record()
            log.setdefault(name, []).append(
                (e0, e1, 1e3 * (time.perf_counter() - t0)))
            return out
        return run

    model.synthesis = timed("synth")
    model._dequeue_and_enqueue = timed("queue")
    try:
        yield
    finally:
        model.synthesis = real["synth"]
        del model._dequeue_and_enqueue


def _med(log, name, idx):
    rows = log[name][1:]  # after the warm-up
    return statistics.median(r[0].elapsed_time(r[1]) if idx == 0 else r[2]
                             for r in rows)


def k1c_shapes(tally):
    """K1c's calls by (b, d, L) of one direction pair."""
    return counted_shapes(cuda_scan, "oss_scan_fused_fwd_carries",
                          lambda u2, *a, **kw: tuple(
                              u2.shape[i] for i in (0, 2, 3)), tally)


def realsr(shape_ms) -> dict:
    """Phase 7c: the RealSR stages of MambaRealSR11 at full size. Returns
    the launches of its main path (the timed steps and iterations and the
    two pipelines)."""
    t0 = time.perf_counter()
    shutil.rmtree(REALSR, ignore_errors=True)
    write_realsr_dataset()
    batches = _realsr_batches(7)
    print(f"[realsr] dataset written and 7 batches of 9 loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    realsr_synthesis_vs_cpu(batches[0])
    total = dict.fromkeys(KERNELS, 0)

    # the S1 step: feed (copies, synthesis, queue) and optimize
    opt = json.loads(json.dumps(REALSR_RECIPE))
    opt["path"].update(models=os.path.join(REALSR, "models"),
                       training_states=os.path.join(REALSR, "state"))
    model = build_model(opt)
    step = expected_launches(model.net_g, train=True)
    fwd = expected_launches(model.net_g, train=False)
    print(f"[realsr] predicted launches per S1 step: {_nonzero(step)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log, times, losses = {}, [], []
    with synth_timers(model, log):
        for it in range(1, 7):  # step 1 warms up, steps 2-6 are timed
            reset_launches()
            t1 = time.perf_counter()
            model.feed_data(batches[it])
            model.optimize_parameters(it)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            counts = launches()
            total = {k: total[k] + counts[k] for k in KERNELS}
            losses.append(model.get_current_log()["l_pix"])
            if counts != step or not np.isfinite(losses[-1]):
                raise SystemExit(f"FAIL realsr: step {it} launches "
                                 f"{counts} (predicted {step}), l_pix "
                                 f"{losses[-1]}")
            print(f"[realsr] step {it}: {1e3 * times[-1]:.1f} ms, l_pix "
                  f"{losses[-1]:.6f}")
    if tuple(model.lq.shape) != (9, 3, 64, 64) or tuple(
            model.gt_usm.shape) != (9, 3, 256, 256):
        raise SystemExit(f"FAIL realsr: lq {model.lq.shape}")
    step_ms = 1e3 * statistics.median(times[1:])
    print(f"[realsr] S1 step ms (feed + optimize, median of steps 2-6): "
          f"{step_ms:.1f}; GT MP/s {9 * 256 * 256 / step_ms / 1e3:.3f}; "
          f"synthesis device {_med(log, 'synth', 0):.2f} ms, host "
          f"{_med(log, 'synth', 2):.2f} ms; queue (filling) device "
          f"{_med(log, 'queue', 0):.3f} ms; first step "
          f"{1e3 * times[0]:.1f} ms; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
          f"{nvidia_smi_line()}")
    # the queue full: its shuffle and swap
    lq, pair = model.lq, torch.cat([model.gt, model.gt_usm], 1)
    while model._queue_ptr < model._queue_len:
        model._dequeue_and_enqueue(lq, pair)
    qlog = {}
    with synth_timers(model, qlog):
        for _ in range(4):
            model._dequeue_and_enqueue(lq, pair)
    torch.cuda.synchronize()
    print(f"[realsr] queue of {model._queue_len} full, shuffle and swap: "
          f"device {_med(qlog, 'queue', 0):.3f} ms, host "
          f"{_med(qlog, 'queue', 2):.3f} ms")
    # one step profiled, its launches by shape
    tallies = {"K1c": {}, "K2": {}, "K3": {}, "K4c": {}}
    reset_launches()
    with k1c_shapes(tallies["K1c"]), k2_shapes(tallies["K2"]), k3_shapes(
            tallies["K3"]), k4_shapes("selective_scan_fwd_carries",
                                      tallies["K4c"]):
        by_class = profile("realsr", lambda: (
            model.feed_data(batches[0]), model.optimize_parameters(7)))
    counts = launches()
    if counts != step:
        raise SystemExit(f"FAIL realsr: profiled launches {counts}")
    total = {k: total[k] + counts[k] for k in KERNELS}
    print(f"[realsr] K1c per step by (b, d, L): {tallies['K1c']}")
    shape_account("realsr", "K2", "step", tallies["K2"], shape_ms["K2"],
                  by_class.get("K2 GDFN", 0.0))
    shape_account("realsr", "K4c", "step", tallies["K4c"], shape_ms["K4c"],
                  by_class.get("K4/K4c scan", 0.0))
    shape_account("realsr", "K3", "step", tallies["K3"], shape_ms["K3"],
                  by_class.get("K3 scan backward", 0.0))
    ckpt = os.path.join(REALSR, "s1", "net_g_s1.pth")
    save_network(ckpt, model.net_g.state_dict(),
                 model.net_g_ema.state_dict())
    del model, lq, pair
    torch.cuda.empty_cache()

    # the GAN stage from the S1 checkpoint's EMA: G / D step ms
    gopt = _realsr_gan_recipe()
    gopt["path"].update(models=os.path.join(REALSR, "gan_models"),
                        training_states=os.path.join(REALSR, "gan_state"),
                        pretrain_network_g=ckpt)
    model = build_model(gopt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, times = [], []
    with step_events(model, events):
        for it in range(1, 5):  # iteration 1 warms up
            reset_launches()
            t1 = time.perf_counter()
            model.feed_data(batches[it])
            model.optimize_parameters(it)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            counts = launches()
            total = {k: total[k] + counts[k] for k in KERNELS}
            glog = model.get_current_log()
            if counts != step or set(glog) != GAN_D_KEYS | GAN_G_KEYS or \
                    not all(np.isfinite(v) for v in glog.values()):
                raise SystemExit(f"FAIL realsr gan: iteration {it} launches "
                                 f"{counts}, log {glog}")
            print(f"[realsr] GAN iteration {it}: {1e3 * times[-1]:.1f} ms; "
                  + ", ".join(f"{k} {v:.5f}" for k, v in glog.items()))
    split = {"_g_step": [], "_d_step": []}
    for name, e0, e1 in events[2:]:
        split[name].append(e0.elapsed_time(e1))
    iter_ms = 1e3 * statistics.median(times[1:])
    print(f"[realsr] GAN iteration ms (feed + optimize, median of 2-4): "
          f"{iter_ms:.1f}; GT MP/s {9 * 256 * 256 / iter_ms / 1e3:.3f}; G "
          f"step {statistics.median(split['_g_step']):.1f} ms, D step "
          f"{statistics.median(split['_d_step']):.1f} ms (CUDA events); "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
          f"{nvidia_smi_line()}")
    # one GAN iteration profiled: classes, idle share, G / D / VGG split
    reset_launches()
    with module_ranges({"G": model.net_g, "D": model.net_d,
                        "VGG": model.cri_perceptual}):
        profile("realsr_gan", lambda: (model.feed_data(batches[5]),
                                       model.optimize_parameters(5)),
                extra=_by_module_lines)
    counts = launches()
    if counts != step:
        raise SystemExit(f"FAIL realsr gan: profiled launches {counts}")
    total = {k: total[k] + counts[k] for k in KERNELS}
    d_by_batch(model.net_d)
    del model
    torch.cuda.empty_cache()

    counts = realsr_pipelines(step, fwd)
    total = {k: total[k] + counts[k] for k in KERNELS}
    shutil.rmtree(REALSR)
    print(f"[realsr] phase 7c {time.perf_counter() - t0:.1f} s; launches "
          f"{_nonzero(total)}")
    return total


def d_by_batch(net_d):
    """D's forward and backward (its u stored) alone on b x 256x256, b =
    8, 9, 16: CUDA-event medians, and at 9 the device kernels that take
    the most time under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    def run(x):
        net_d.zero_grad(set_to_none=True)
        net_d(x, update_stats=True).mean().backward()

    xs = {b: torch.rand(b, 3, 256, 256, device="cuda") for b in (8, 9, 16)}
    ms = {b: time_ms(lambda x=x: run(x), reps=3) for b, x in xs.items()}
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        run(xs[9])
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(),
                 key=lambda e: -e.self_device_time_total)[:3]
    print("[realsr] D forward + backward alone (ms): " + ", ".join(
        f"batch {b} {v:.1f}" for b, v in ms.items()) + "; at batch 9 "
        "the longest device kernels: " + "; ".join(
            f"{e.key[:70]} {e.self_device_time_total / 1e3:.1f} ms in "
            f"{e.count} launches" for e in top))
    net_d.zero_grad(set_to_none=True)


def realsr_pipelines(step, fwd) -> dict:
    """`train_pipeline` with the S1 recipe (3 iterations, validation on
    phase 7's pairs before, at 3 and at the end, a checkpoint at 3), then
    with the GAN recipe from that checkpoint's EMA (2 iterations, a
    checkpoint at 2)."""
    if not os.path.isdir(DATA):
        write_dataset()
    exp = {k: os.path.join(REALSR, k, "exp") for k in ("s1", "gan")}
    opt = json.loads(json.dumps(REALSR_RECIPE))
    opt["datasets"]["val_1"] = _val_dataset()
    opt["train"]["total_iter"] = 3
    opt.update(num_gpu=1, auto_resume=False,
               logger={"print_freq": 1, "save_checkpoint_freq": 3,
                       "use_tb_logger": False})
    opt["path"]["experiments_root"] = exp["s1"]
    opt["val"] = {"window_size": 8, "val_freq": 3, "save_img": False,
                  "metrics": {"psnr": {"type": "calculate_psnr",
                                       "crop_border": 4,
                                       "test_y_channel": True}}}
    reset_launches()
    model = train_pipeline(".", finalize_options(opt, ".", is_train=True),
                           device="cuda")
    s1 = launches()
    s1_ms = 1e3 * model.timers["iter"].get_avg_time()
    s1_data = 1e3 * model.timers["data"].get_avg_time()
    del model
    log = _last_log_in(exp["s1"])
    want = {k: 3 * step[k] + 3 * 2 * fwd[k] for k in KERNELS}
    psnrs = _numbers(log, "# psnr:")
    ckpt = os.path.join(exp["s1"], "models", "net_g_3.pth")
    if s1 != want or len(psnrs) != 3 or "Model [RealESRNetModel]" not in log \
            or not os.path.isfile(ckpt):
        raise SystemExit(f"FAIL realsr pipeline: launches {s1} (predicted "
                         f"{want}), PSNR {psnrs}")
    gopt = _realsr_gan_recipe()
    gopt["train"]["total_iter"] = 2
    gopt.update(num_gpu=1, auto_resume=False,
                logger={"print_freq": 1, "save_checkpoint_freq": 2,
                        "use_tb_logger": False})
    gopt["path"].update(experiments_root=exp["gan"], pretrain_network_g=ckpt)
    reset_launches()
    model = train_pipeline(".", finalize_options(gopt, ".", is_train=True),
                           device="cuda")
    gan = launches()
    gan_ms = 1e3 * model.timers["iter"].get_avg_time()
    del model
    log = _last_log_in(exp["gan"])
    want = {k: 2 * step[k] for k in KERNELS}
    if gan != want or "Model [RealESRGANModel]" not in log or \
            "l_g_percep:" not in log or not os.path.isfile(
                os.path.join(exp["gan"], "models", "net_d_2.pth")):
        raise SystemExit(f"FAIL realsr GAN pipeline: launches {gan} "
                         f"(predicted {want})")
    print(f"[realsr] train_pipeline, S1 recipe: 3 iterations, validation "
          f"PSNR-Y {[round(v, 4) for v in psnrs]} dB, ms per iteration "
          f"{s1_ms:.1f}, data ms {s1_data:.1f}; GAN recipe from its "
          f"net_g_3: 2 iterations, ms per iteration {gan_ms:.1f}")
    return {k: s1[k] + gan[k] for k in KERNELS}


def _last_log_in(log_dir: str) -> str:
    names = sorted(f for f in os.listdir(log_dir)
                   if f.startswith("train_") and f.endswith(".log"))
    with open(os.path.join(log_dir, names[-1])) as f:
        return f.read()


# -- phase 7d: deraining (Mamber33) --------------------------------------------

DERAIN = os.path.join("build", "chip_smoke_derain")
# options/Deraining_mamber33.yml (the script reads no YAML): Rain13K with
# six progressive (patch, batch) stages, Mamber33 at full size, AdamW with
# a global-norm clip, the cyclic cosine schedule, L1, no EMA
DERAIN_RECIPE = {
    "name": "Deraining_mamber33", "model_type": "ImageCleanModel",
    "scale": 1, "num_gpu": "auto", "manual_seed": 100, "is_train": True,
    "datasets": {
        "train": {"name": "TrainSet", "type": "Dataset_PairedImage",
                  "dataroot_gt": "datasets/Rain13K/target",
                  "dataroot_lq": "datasets/Rain13K/input",
                  "geometric_augs": True, "filename_tmpl": "{}",
                  "io_backend": {"type": "disk"}, "use_shuffle": True,
                  "num_worker_per_gpu": 8, "batch_size_per_gpu": 8,
                  "mini_batch_sizes": [8, 5, 3, 2, 1, 1],
                  "iters": [92000, 64000, 64000, 64000, 64000, 48000],
                  "gt_size": 384, "gt_sizes": [128, 160, 192, 256, 320, 384],
                  "dataset_enlarge_ratio": 1},
        "val": {"name": "ValSet", "type": "Dataset_PairedImage",
                "dataroot_gt": "datasets/test/Rain100L/target",
                "dataroot_lq": "datasets/test/Rain100L/input",
                "io_backend": {"type": "disk"}}},
    "network_g": {"type": "Mamber33", "inp_channels": 3, "out_channels": 3,
                  "dim": 48, "num_blocks": [3, 5, 7, 9],
                  "num_refinement_blocks": 2, "ffn_expansion_factor": 2.66,
                  "bias": False, "LayerNorm_type": "WithBias",
                  "dual_pixel_task": False},
    "path": {"pretrain_network_g": None, "strict_load_g": True,
             "resume_state": None},
    "train": {"total_iter": 396000, "warmup_iter": -1,
              "use_grad_clip": True, "grad_clip": 0.01,
              "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                            "periods": [144000, 288000],
                            "restart_weights": [1, 1],
                            "eta_mins": [0.0003, 0.000001]},
              "mixing_augs": {"mixup": False, "mixup_beta": 1.2,
                              "use_identity": True},
              "optim_g": {"type": "AdamW", "lr": 3e-4,
                          "weight_decay": 1e-4, "betas": [0.9, 0.999]},
              "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                            "reduction": "mean"}},
    "val": {"window_size": 8, "val_freq": 4000, "save_img": False,
            "rgb2bgr": True, "use_image": True, "max_minibatch": 8,
            "metrics": {k: {"type": f"calculate_{k}", "crop_border": 0,
                            "test_y_channel": True}
                        for k in ("psnr", "ssim")}},
    "logger": {"print_freq": 1000, "save_checkpoint_freq": 4000,
               "use_tb_logger": True},
}
# options/test_Deraining_mamber33.yml: the five test sets
DERAIN_TEST_SETS = ("Rain100L", "Rain100H", "Test100", "Test1200",
                    "Test2800")
DERAIN_TEST_RECIPE = {
    "name": "test_Deraining_mamber33", "model_type": "ImageCleanModel",
    "scale": 1, "num_gpu": 1, "manual_seed": 100,
    "datasets": {f"test_{i}": {
        "name": name, "type": "Dataset_PairedImage",
        "dataroot_gt": f"datasets/test/{name}/target",
        "dataroot_lq": f"datasets/test/{name}/input",
        "io_backend": {"type": "disk"}}
        for i, name in enumerate(DERAIN_TEST_SETS, 1)},
    "network_g": {k: v for k, v in DERAIN_RECIPE["network_g"].items()
                  if k != "dual_pixel_task"},
    "path": {"pretrain_network_g":
             "experiments/Deraining_mamber33/models/net_g_396000.ckpt",
             "param_key_g": "params", "strict_load_g": True},
    "val": {"window_size": 8, "save_img": True,
            "metrics": DERAIN_RECIPE["val"]["metrics"]},
}
# launches of one Mamber33 training step and one evaluation forward
# (41 MamberBlocks: 32 of width <= 256 take K1, the 9 latent ones K4 for
# their pairs; every channel scan K4)
DERAIN_STEP = {"oss_scan_fused_carries": 64, "selective_scan_carries": 59,
               "selective_scan_bwd": 123, "gdfn_residual_fused": 41}
DERAIN_FWD = {"oss_scan_fused": 64, "selective_scan": 59,
              "gdfn_residual_fused": 41}
# the progressive stages' first iterations (cumulative `iters` + 1)
DERAIN_STAGE_ITERS = (1, 92001, 156001, 220001, 284001, 348001)


def _rainy(gt, rng) -> np.ndarray:
    """gt with seeded slanted bright streaks."""
    h, w = gt.shape[:2]
    seeds = rng.rand(h, w) > 0.997
    streak = np.zeros((h, w), bool)
    for k in range(16):
        streak |= np.roll(np.roll(seeds, k, 0), k // 4, 1)
    out = gt.astype(np.float32)
    out[streak] = 0.4 * out[streak] + 0.6 * 235
    return out.round().astype(np.uint8)


def write_derain_dataset():
    """Paired clean / rainy PNGs: 12 training pairs (9 of 480x480; 3
    smaller than 384 on one side or both: the pad to gt_size), 2
    evaluation pairs (481x321, whose sides pad to 488x328, and 512x512);
    for the task datasets 3 16-bit dual-pixel triples (left, right, GT)
    of 160x144 and 3 clean 8-bit images."""
    shutil.rmtree(DERAIN, ignore_errors=True)
    rng = np.random.RandomState(7)
    sizes = {"train": [(480, 480)] * 9 + [(352, 480), (480, 300),
                                          (320, 320)],
             "test": [(321, 481), (512, 512)]}
    for split, hw in sizes.items():
        for i, (h, w) in enumerate(hw):
            gt = _synthetic_image(rng, h, w)
            imwrite(gt, os.path.join(DERAIN, split, "target", f"{i:04d}.png"))
            imwrite(_rainy(gt, rng),
                    os.path.join(DERAIN, split, "input", f"{i:04d}.png"))
    for i in range(3):
        gt = _synthetic_image(rng, 160, 144).astype(np.uint16) * 257
        imwrite(gt, os.path.join(DERAIN, "dp", "gt", f"{i}.png"))
        for k, shift in (("lqL", 1), ("lqR", -1)):
            imwrite(np.roll(gt, shift, 1) // 2 + gt // 2,
                    os.path.join(DERAIN, "dp", k, f"{i}.png"))
        imwrite(_synthetic_image(rng, 160, 144),
                os.path.join(DERAIN, "dn", f"{i}.png"))


def _derain_data(split) -> dict:
    return {"dataroot_gt": os.path.join(DERAIN, split, "target"),
            "dataroot_lq": os.path.join(DERAIN, split, "input")}


def _derain_batches(n, seed=0) -> list:
    """n loader batches of 8 x 384x384 pairs from the YAML's training
    dataset over the PNGs, as the loader collates them."""
    from vmambair_torch.data import build_dataset
    from vmambair_torch.data.loader import default_collate

    ds = build_dataset(dict(DERAIN_RECIPE["datasets"]["train"],
                            **_derain_data("train"), phase="train",
                            scale=1))
    rng = random.Random(seed)
    return [default_collate([ds.__getitem__((8 * j + i) % len(ds), rng=rng)
                             for i in range(8)]) for j in range(n)]


def _derain_opt(root) -> dict:
    opt = json.loads(json.dumps(DERAIN_RECIPE))
    opt["path"].update(models=os.path.join(root, "models"),
                       training_states=os.path.join(root, "state"))
    return opt


def derain(shape_ms) -> dict:
    """Phase 7d: the deraining harness of Mamber33 at full size. Returns
    the launches of its main path (the timed and profiled steps, the
    pipelines and the task datasets' runs)."""
    from vmambair_torch.train.pipeline import ProgressiveSchedule

    t0 = time.perf_counter()
    write_derain_dataset()
    batches = _derain_batches(4)
    print(f"[derain] dataset written and 4 batches of 8 x 384x384 loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    total = dict.fromkeys(KERNELS, 0)
    model = build_model(_derain_opt(DERAIN))
    step = expected_launches(model.net_g, train=True)
    fwd = expected_launches(model.net_g, train=False)
    if _nonzero(step) != DERAIN_STEP or _nonzero(fwd) != DERAIN_FWD:
        raise SystemExit(f"FAIL derain: predicted launches {_nonzero(step)}"
                         f" per step, {_nonzero(fwd)} per forward")
    print(f"[derain] launches per step {DERAIN_STEP}, per evaluation "
          f"forward {DERAIN_FWD}")
    prog = ProgressiveSchedule(DERAIN_RECIPE["datasets"]["train"], 1)
    prog_rng = np.random.RandomState(0)
    stage_ms = {}
    for stage, it0 in enumerate(DERAIN_STAGE_ITERS, 1):
        # a warm-up step of its own (a new shape), then timed steps
        n = 4 if stage in (1, 6) else 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for k in range(n):
            model.feed_data(prog.apply(batches[k], it0 + k, prog_rng))
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            model.optimize_parameters(it0 + k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            counts = launches()
            total = {key: total[key] + counts[key] for key in KERNELS}
            losses.append(model.get_current_log()["l_pix"])
            if counts != step or not np.isfinite(losses[-1]):
                raise SystemExit(f"FAIL derain: stage {stage} step {k} "
                                 f"launches {counts}, l_pix {losses[-1]}")
        b, _, hh, ww = model.lq.shape
        ms = 1e3 * statistics.median(times[1:])
        stage_ms[stage] = ms
        print(f"[derain] stage {stage} ({b} x {hh}x{ww}): ms per step "
              f"{ms:.1f} (median of {n - 1} after a warm-up of "
              f"{1e3 * times[0]:.1f}); GT MP/s {b * hh * ww / ms / 1e3:.3f};"
              f" l_pix {[round(v, 5) for v in losses]}; lr "
              f"{model.log_dict['lr']:.3e}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
              f"{nvidia_smi_line()}")
    # one step of stage 1 and one of stage 2 profiled, by class and shape
    for stage in (1, 2):
        it = DERAIN_STAGE_ITERS[stage - 1]
        reset_launches()
        model.feed_data(prog.apply(batches[0], it, prog_rng))
        model.optimize_parameters(it)  # the stage's shape warm again
        model.feed_data(prog.apply(batches[1], it, prog_rng))
        torch.cuda.synchronize()
        tallies = {"K1c": {}, "K2": {}, "K3": {}, "K4c": {}}
        with k1c_shapes(tallies["K1c"]), k2_shapes(tallies["K2"]), \
                k3_shapes(tallies["K3"]), k4_shapes(
                    "selective_scan_fwd_carries", tallies["K4c"]):
            by_class = profile(f"derain_stage{stage}",
                               lambda it=it: model.optimize_parameters(it))
        counts = launches()
        if counts != {key: 2 * step[key] for key in KERNELS}:
            raise SystemExit(f"FAIL derain: launches {counts} in a step "
                             "and its profiled one")
        total = {key: total[key] + counts[key] for key in KERNELS}
        if stage == 1:  # phase 3 timed stage 1's shapes
            for name, cls in (("K1c", "K1/K1c fused scan"),
                              ("K2", "K2 GDFN"), ("K4c", "K4/K4c scan"),
                              ("K3", "K3 scan backward")):
                shape_account("derain stage 1", name, "step", tallies[name],
                              shape_ms[name], by_class.get(cls, 0.0))
    # whole-image evaluation (`test`: reflect pad to the window, forward,
    # crop) of the two evaluation images
    reset_launches()
    for i in range(2):
        pair = {k: imread(os.path.join(DERAIN, "test", d, f"{i:04d}.png"),
                          float32=True)[None, :, :, ::-1]
                for k, d in (("lq", "input"), ("gt", "target"))}
        model.feed_data(pair)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.test()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        if tuple(model.output.shape) != tuple(model.lq.shape) or not \
                torch.isfinite(model.output).all():
            raise SystemExit(f"FAIL derain: test output {model.output.shape}")
        _, _, hh, ww = model.lq.shape
        print(f"[derain] whole-image evaluation of {ww}x{hh}: "
              f"{1e3 * min(times[1:]):.1f} ms (the first "
              f"{1e3 * times[0]:.1f}); max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counts = launches()
    if counts != {k: 6 * fwd[k] for k in KERNELS}:
        raise SystemExit(f"FAIL derain: evaluation launches {counts}")
    total = {key: total[key] + counts[key] for key in KERNELS}
    del model
    torch.cuda.empty_cache()
    counts = derain_pipelines(step, fwd)
    total = {k: total[k] + counts[k] for k in KERNELS}
    derain_vs_plain()
    counts = task_pipelines()
    total = {k: total[k] + counts[k] for k in KERNELS}
    shutil.rmtree(DERAIN)
    print(f"[derain] phase 7d {time.perf_counter() - t0:.1f} s; stage ms "
          f"{ {k: round(v, 1) for k, v in stage_ms.items()} }; launches "
          f"{_nonzero(total)}")
    return total


def derain_pipelines(step, fwd) -> dict:
    """`train_pipeline` with the deraining recipe on the PNGs (iters [2, 1,
    1, 1, 1, 1]: every stage; validation on the two whole evaluation
    images before the first step, at 7 and after the loop; a checkpoint
    at 7), an auto-resume to 8, then `test_pipeline` with the test
    recipe's five sets on the evaluation pairs, from that checkpoint."""
    exp = os.path.join(DERAIN, "exp")

    def opt_for(total_iter, auto_resume):
        opt = json.loads(json.dumps(DERAIN_RECIPE))
        opt["datasets"]["train"].update(_derain_data("train"),
                                        iters=[2, 1, 1, 1, 1, 1])
        opt["datasets"]["val"].update(_derain_data("test"))
        opt["train"]["total_iter"] = total_iter
        opt["val"]["val_freq"] = 7
        opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 7,
                         "use_tb_logger": False}
        opt["path"]["experiments_root"] = exp
        opt["auto_resume"] = auto_resume
        return finalize_options(opt, ".", is_train=True)

    reset_launches()
    model = train_pipeline(".", opt_for(7, False), device="cuda")
    first = launches()
    iter_ms = 1e3 * model.timers["iter"].get_avg_time()
    data_ms = 1e3 * model.timers["data"].get_avg_time()
    del model
    log = _last_log_in(exp)
    want = {k: 7 * step[k] + 3 * 2 * fwd[k] for k in KERNELS}
    psnrs = _numbers(log, "# psnr:")
    stages = [f"Progressive stage {i}: gt_size {g}, batch {b}" in log
              for i, (g, b) in enumerate(zip(
                  DERAIN_RECIPE["datasets"]["train"]["gt_sizes"],
                  DERAIN_RECIPE["datasets"]["train"]["mini_batch_sizes"]), 1)]
    if first != want or not all(stages) or len(psnrs) != 3 or not \
            np.isfinite(psnrs).all() or not os.path.isfile(
                os.path.join(exp, "models", "net_g_7.pth")):
        raise SystemExit(f"FAIL derain pipeline: launches {first} "
                         f"(predicted {want}), stages {stages}, PSNR {psnrs}")
    reset_launches()
    model = train_pipeline(".", opt_for(8, True), device="cuda")
    resumed = launches()
    del model
    log = _last_log_in(exp)
    want = {k: step[k] + 2 * fwd[k] for k in KERNELS}
    if resumed != want or "Resuming training from epoch" not in log:
        raise SystemExit(f"FAIL derain pipeline: resume launches {resumed} "
                         f"(predicted {want})")
    opt = json.loads(json.dumps(DERAIN_TEST_RECIPE))
    for ds in opt["datasets"].values():
        ds.update(_derain_data("test"))
    res = os.path.join(DERAIN, "results")
    opt["path"].update(pretrain_network_g=os.path.join(
        exp, "models", "net_g_8.pth"), results_root=res)
    reset_launches()
    t1 = time.perf_counter()
    test_pipeline(".", finalize_options(opt, ".", is_train=False),
                  device="cuda")
    test_s = time.perf_counter() - t1
    tested = launches()
    want = {k: 2 * len(DERAIN_TEST_SETS) * fwd[k] for k in KERNELS}
    outs = [imread(os.path.join(res, "visualization", name, f"{i:04d}.png"))
            for name in DERAIN_TEST_SETS for i in range(2)]
    if tested != want or [o.shape for o in outs[:2]] != [(321, 481, 3),
                                                         (512, 512, 3)]:
        raise SystemExit(f"FAIL derain test: launches {tested} (predicted "
                         f"{want}), outputs {[o.shape for o in outs[:2]]}")
    print(f"[derain] train_pipeline, the deraining recipe: 7 iterations "
          f"through the six stages, validation PSNR-Y "
          f"{[round(v, 4) for v in psnrs]} dB on the 481x321 and 512x512 "
          f"images (before, at 7, after); ms per iteration {iter_ms:.1f}, "
          f"data ms per iteration {data_ms:.1f}; auto-resume to 8; "
          f"test_pipeline over the five sets (10 whole images) "
          f"{test_s:.1f} s; launches {_nonzero(first)}, {_nonzero(resumed)}, "
          f"{_nonzero(tested)}")
    return {k: first[k] + resumed[k] + tested[k] for k in KERNELS}


def derain_vs_plain():
    """Mamber33's and Mamber32's widths at depth [1,1,1,1] + 1, fp32, and
    the dual-pixel Mamber33 (six channels in): the forward through the
    kernels against the plain path on the card within 1e-3 on 2 x 64x64
    and on one 40x56 image, every gradient within GRAD_BAR of its largest
    entry (`grads_vs_plain`)."""
    g = torch.Generator().manual_seed(6)
    for arch, kw in (("Mamber33", {}), ("Mamber32", {}),
                     ("Mamber33", {"inp_channels": 6,
                                   "dual_pixel_task": True})):
        net = build_network(dict(type=arch, num_blocks=[1, 1, 1, 1],
                                 num_refinement_blocks=1, **kw), seed=3)
        c = kw.get("inp_channels", 3)
        label = f"{arch} widths{' dual-pixel' if kw else ''}"
        errs = []
        for shape in ((2, c, 64, 64), (1, c, 40, 56)):
            x = torch.rand(shape, generator=g).cuda()
            with torch.inference_mode():
                got = net(x)
                with plain_ops():
                    ref = net(x)
            if got.shape != (shape[0], 3, *shape[2:]):
                raise SystemExit(f"FAIL derain vs plain: {got.shape}")
            errs.append(check_close(f"{label} {shape}", got, ref, 1e-3,
                                    1e-3))
        print(f"[derain] {label}, depth [1,1,1,1]+1, fp32: forward on "
              f"2x{c}x64x64 and 1x{c}x40x56 against the plain path, max abs "
              f"err {max(errs):.3e} (tol 1e-3)")
        lq = torch.rand(2, c, 64, 64, generator=g).cuda()
        grads_vs_plain(net, lq, torch.rand(2, 3, 64, 64, generator=g).cuda(),
                       label)
        del net
    torch.cuda.empty_cache()


def task_pipelines() -> dict:
    """Two `train_pipeline` iterations of Mamber33 at depth [1,1,1,1] + 1
    on each task dataset, from its PNGs through the port's codec:
    Gaussian denoising (in_ch 3, a random sigma), dual-pixel defocus
    (16-bit, six channels in, `dual_pixel_task`) and deblur."""
    common = {"gt_size": 64, "geometric_augs": True, "use_shuffle": True,
              "num_worker_per_gpu": 4, "batch_size_per_gpu": 4,
              "io_backend": {"type": "disk"}}
    cases = {
        "Dataset_GaussianDenoising": (
            {"dataroot_gt": os.path.join(DERAIN, "dn"), "in_ch": 3,
             "sigma_type": "random", "sigma_range": [0, 50]}, {}),
        "Dataset_DefocusDeblur_DualPixel_16bit": (
            {k: os.path.join(DERAIN, "dp", v) for k, v in (
                ("dataroot_lqL", "lqL"), ("dataroot_lqR", "lqR"),
                ("dataroot_gt", "gt"))},
            {"inp_channels": 6, "dual_pixel_task": True}),
        "DeblurPairedDataset": (_derain_data("train"), {}),
    }
    total = dict.fromkeys(KERNELS, 0)
    for name, (data, net_kw) in cases.items():
        opt = json.loads(json.dumps(DERAIN_RECIPE))
        opt.update(name=f"task_{name}", auto_resume=False,
                   logger={"print_freq": 1, "use_tb_logger": False})
        opt["datasets"] = {"train": dict(common, name=name, type=name,
                                         **data)}
        opt["network_g"].update(num_blocks=[1, 1, 1, 1],
                                num_refinement_blocks=1, **net_kw)
        opt["train"]["total_iter"] = 2
        opt["path"]["experiments_root"] = os.path.join(DERAIN, "task", name)
        reset_launches()
        model = train_pipeline(".", finalize_options(opt, ".",
                                                     is_train=True),
                               device="cuda")
        counts = launches()
        want = expected_launches(model.net_g, train=True)
        loss = model.get_current_log()["l_pix"]
        shape = tuple(model.lq.shape)
        del model
        if counts != {k: 2 * want[k] for k in KERNELS} or not np.isfinite(
                loss) or shape != (4, 3 * (1 + bool(net_kw)), 64, 64):
            raise SystemExit(f"FAIL derain task {name}: launches {counts}, "
                             f"l_pix {loss}, lq {shape}")
        total = {k: total[k] + counts[k] for k in KERNELS}
        print(f"[derain] task dataset {name}: 2 iterations, lq {shape}, "
              f"l_pix {loss:.5f}")
    return total


# -- phase 7e: the learned metrics -------------------------------------------

METRIC_DIR = os.path.join("build", "chip_smoke_metrics")
# the validation metrics of phase 7e: PSNR and SSIM on Y (crop 4), LPIPS and
# DISTS (the seeded VGG16: reported as <name>_uncalibrated), NIQE (crop 4)
METRIC_OPTS = {
    "psnr": {"type": "calculate_psnr", "crop_border": 4,
             "test_y_channel": True},
    "ssim": {"type": "calculate_ssim", "crop_border": 4,
             "test_y_channel": True},
    "lpips": {"type": "calculate_lpips"},
    "dists": {"type": "calculate_dists"},
    "niqe": {"type": "calculate_niqe", "crop_border": 4}}
METRIC_KEYS = {"psnr", "ssim", "lpips_uncalibrated", "dists_uncalibrated",
               "niqe"}
# whole-image validation of the seeded full-width MambaRealSR11 (the
# network_g of options/mambaSR11GAN_x4.yml) on 4 pairs of 128x128 LQ /
# 512x512 GT, through test_pipeline
METRIC_TEST_RECIPE = {
    "name": "metrics_MambaRealSR11", "model_type": "SRModel", "scale": 4,
    "num_gpu": 1, "manual_seed": 0,
    "datasets": {"test_1": {
        "name": "synthetic512", "type": "PairedImageDataset",
        "dataroot_gt": os.path.join(METRIC_DIR, "gt"),
        "dataroot_lq": os.path.join(METRIC_DIR, "lq"),
        "io_backend": {"type": "disk"}}},
    "network_g": REALSR_RECIPE["network_g"],
    "path": {"pretrain_network_g": None, "param_key_g": "params_ema",
             "strict_load_g": True,
             "results_root": os.path.join(METRIC_DIR, "results")},
    "val": {"window_size": 8, "save_img": True, "metrics": METRIC_OPTS}}
# card against CPU on the same uint8 images, fp32 with TF32 off: LPIPS and
# DISTS within 1e-4 of the CPU's value plus 1e-6; NIQE within 1e-3 of it,
# its gamma argmins equal but at ties (`niqe.argmin_flips`); Inception's
# pool3 features within 1e-4 of the largest feature
LEARNED_TOL = (1e-4, 1e-6)
NIQE_TOL = 1e-3
INCEPTION_TOL = 1e-4
# the validation's SR outputs (fp32, before quantising) through the kernels
# against the plain path: phase 4's fp32 model tolerance, abs and rel
SR_TOL = 1e-3
# FID of SR against GT (`calculate_fid`, scipy's sqrtm) against the exact
# distance of the same 4 + 4 features (`_fid_low_rank`), relative
FID_TOL = 1e-4


def write_metric_dataset():
    """4 pairs of 512x512 GT and their 4x box-downsampled 128x128 LQ, as
    PNG by the port's encoder."""
    shutil.rmtree(METRIC_DIR, ignore_errors=True)
    rng = np.random.RandomState(7)
    for i in range(4):
        gt = _synthetic_image(rng, 512, 512)
        lq = gt.reshape(128, 4, 128, 4, 3).mean((1, 3)).round().astype(
            np.uint8)
        imwrite(gt, os.path.join(METRIC_DIR, "gt", f"{i:04d}.png"))
        imwrite(lq, os.path.join(METRIC_DIR, "lq", f"{i:04d}.png"))


def _metric_ms(opt, pairs) -> tuple:
    """The metric of each (sr, gt) pair on the card, and the median host ms
    of a call (the call returns a float: the card has finished)."""
    from vmambair_torch.metrics import calculate_metric

    vals, ts = [], []
    for sr, gt in pairs:
        t0 = time.perf_counter()
        vals.append(calculate_metric(opt, sr, gt, device="cuda"))
        ts.append(1e3 * (time.perf_counter() - t0))
    return vals, statistics.median(ts)


def _fid_low_rank(f1: np.ndarray, f2: np.ndarray) -> float:
    """The Frechet distance of two Gaussians fitted to n samples each, for
    n below the dimension: with centred rows A, B, Sigma1 Sigma2 has the
    nonzero eigenvalues of (A B^T)(B A^T) / (n-1)^2, so the trace of its
    square root is the sum of A B^T's singular values over n-1."""
    a, b = f1.astype(np.float64), f2.astype(np.float64)
    n = len(a)
    ca, cb = a - a.mean(0), b - b.mean(0)
    diff = a.mean(0) - b.mean(0)
    return float(diff @ diff + ((ca * ca).sum() + (cb * cb).sum() - 2 *
                                np.linalg.svd(ca @ cb.T, compute_uv=False
                                              ).sum()) / (n - 1))


def _validation_vs_plain(net, per_forward) -> tuple[float, float]:
    """The first of the validation's forwards again, its 128x128 LQ read as
    the dataset reads it, through the kernels and through the plain path
    (the 4 forwards run at one shape, so one takes every kernel
    configuration of the path; the plain one takes ~9 s): the kernel
    forward launches what a validation forward predicts, and its SR output
    agrees with the plain one within SR_TOL. These launches are a
    comparison's and are not counted as the path's."""
    t0 = time.perf_counter()
    bgr = imread(os.path.join(METRIC_DIR, "lq", "0000.png"))
    lq = torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1])).permute(
        2, 0, 1)[None].cuda() / 255.0
    with torch.inference_mode():
        reset_launches()
        got = net(lq)
        counts = launches()
        if counts != per_forward:
            raise SystemExit(f"FAIL metrics: SR launches {counts} "
                             f"(predicted {per_forward})")
        with plain_ops():
            ref = net(lq)
    if got.shape != (1, 3, 512, 512):
        raise SystemExit(f"FAIL metrics: SR {tuple(got.shape)}")
    err = check_close("metrics SR against the plain path", got, ref, SR_TOL,
                      SR_TOL)
    return err, time.perf_counter() - t0


def metrics_phase() -> dict:
    """Phase 7e: the learned metrics in whole-image validation of the
    full-width MambaRealSR11. Returns the launches of its validation."""
    from vmambair_torch.metrics import calculate_metric, fid, inception
    from vmambair_torch.metrics import niqe as niqe_mod

    t0 = time.perf_counter()
    write_metric_dataset()
    opt = json.loads(json.dumps(METRIC_TEST_RECIPE))
    opt = finalize_options(opt, ".", is_train=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    model = test_pipeline(".", opt, device="cuda")
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t1
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_forward = expected_launches(model.net_g)
    want = {k: 4 * per_forward[k] for k in KERNELS}
    sr_err, sr_s = _validation_vs_plain(model.eval_net(), per_forward)
    del model
    with open(sorted(
            os.path.join(opt["path"]["log"], f)
            for f in os.listdir(opt["path"]["log"])
            if f.startswith("test_") and f.endswith(".log"))[-1]) as f:
        log = f.read()
    logged = {}
    for line in log.splitlines():
        if "Validation synthetic512\t # " in line:
            key, val = line.rsplit("# ", 1)[1].split(": ")
            logged[key] = float(val)
    if counts != want or set(logged) != METRIC_KEYS:
        raise SystemExit(f"FAIL metrics: launches {counts} (predicted "
                         f"{want}), reported keys {sorted(logged)}")
    vis = os.path.join(opt["path"]["visualization"], "synthetic512")
    pairs = [(imread(os.path.join(vis, f"{i:04d}.png")),
              imread(os.path.join(METRIC_DIR, "gt", f"{i:04d}.png")))
             for i in range(4)]
    if any(sr.shape != (512, 512, 3) for sr, _ in pairs):
        raise SystemExit("FAIL metrics: SR outputs "
                         f"{[sr.shape for sr, _ in pairs]}")
    print(f"[metrics] test_pipeline: 4 whole 128x128 -> 512x512 images of "
          f"the full-width MambaRealSR11 (seeded) with {sorted(METRIC_OPTS)}"
          f" in {val_s:.1f} s, max_memory_allocated {peak:.2f} GiB; "
          f"launches {_nonzero(counts)} (4 forwards); reported {logged}; "
          f"the first SR output again (batch 1) against the plain path: max "
          f"abs err {sr_err:.3e} (tol {SR_TOL}) in {sr_s:.1f} s")

    # each metric on the card (ms per image) against the CPU
    lines = []
    for name, mopt in METRIC_OPTS.items():
        key = next(k for k in METRIC_KEYS if k.startswith(name))
        card, ms = _metric_ms(mopt, pairs)
        if abs(float(np.mean(card)) - logged[key]) > 6e-5 + 1e-6 * abs(
                logged[key]):
            raise SystemExit(f"FAIL metrics: {key} {np.mean(card)} against "
                             f"the validation's {logged[key]}")
        line = f"{key} {np.mean(card):.6f}, {ms:.2f} ms per image"
        if mopt["type"] in ("calculate_lpips", "calculate_dists"):
            cpu = [calculate_metric(mopt, sr, gt, device="cpu")
                   for sr, gt in pairs]
            err = max(abs(a - b) for a, b in zip(card, cpu))
            if any(abs(a - b) > LEARNED_TOL[0] * abs(b) + LEARNED_TOL[1]
                   for a, b in zip(card, cpu)):
                raise SystemExit(f"FAIL metrics: {key} card {card} against "
                                 f"CPU {cpu} (tol {LEARNED_TOL})")
            line += f", card vs CPU max abs err {err:.2e}"
        lines.append(line)
    # NIQE: the score and the fits' argmins, card against CPU
    params = niqe_mod.pris_params()
    flips, rel = 0, 0.0
    for sr, _ in pairs:
        res = {}
        for dev in ("cuda", "cpu"):
            feats, fits = niqe_mod.niqe_features(
                niqe_mod.to_y(sr, 4, "y", dev), params["gaussian_window"])
            res[dev] = (niqe_mod.niqe_quality(
                feats.cpu().numpy(), params["mu_pris_param"],
                params["cov_pris_param"]), fits)
        n, at_ties = niqe_mod.argmin_flips(res["cuda"][1], res["cpu"][1])
        q_card, q_cpu = res["cuda"][0], res["cpu"][0]
        rel = max(rel, abs(q_card - q_cpu) / abs(q_cpu))
        flips += n
        if not at_ties or abs(q_card - q_cpu) > NIQE_TOL * abs(q_cpu):
            raise SystemExit(f"FAIL metrics: NIQE card {q_card} against CPU "
                             f"{q_cpu} (tol {NIQE_TOL}), {n} argmin flips, "
                             f"at ties: {at_ties}")
    lines.append(f"NIQE card vs CPU max rel err {rel:.2e} (tol {NIQE_TOL}), "
                 f"gamma argmin flips {flips} (each at a tie)")
    print("[metrics] " + "; ".join(lines))

    # Inception pool3 of the 4 SR and 4 GT images resized to 299, seeded
    # weights; the FID of SR against GT
    npz = inception.seeded_inception_npz(os.path.join(METRIC_DIR,
                                                      "inception.npz"))
    imgs = np.stack([im[..., ::-1] for pair in pairs for im in pair]
                    ).astype(np.float32) / 255.0
    card = fid.extract_inception_features(imgs, npz, batch=8)
    cpu = fid.extract_inception_features(imgs, npz, batch=8, device="cpu")
    err = float(np.abs(card - cpu).max())
    if card.shape != (8, 2048) or not np.isfinite(card).all() or \
            err > INCEPTION_TOL * float(np.abs(cpu).max()):
        raise SystemExit(f"FAIL metrics: Inception features {card.shape}, "
                         f"card vs CPU max abs err {err:.3e}")
    params_i = inception.load_inception_params(npz)
    x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2)
    inc_ms = time_ms(lambda: inception.inception_pool3(x, params_i), reps=3)
    t2 = time.perf_counter()
    fid_sr_gt = fid.calculate_fid(*fid.compute_statistics(card[0::2]),
                                  *fid.compute_statistics(card[1::2]))
    fid_s = time.perf_counter() - t2
    exact = _fid_low_rank(card[0::2], card[1::2])
    if abs(fid_sr_gt - exact) > FID_TOL * abs(exact):
        raise SystemExit(f"FAIL metrics: FID {fid_sr_gt} against the exact "
                         f"{exact} (tol {FID_TOL} relative)")
    print(f"[metrics] Inception pool3 (seeded .npz) of 4 SR + 4 GT images "
          f"512 -> 299: card vs CPU max abs err {err:.2e} (largest feature "
          f"{np.abs(cpu).max():.3f}, tol {INCEPTION_TOL} of it); "
          f"{inc_ms:.2f} ms per batch of 8 (CUDA events); FID of SR against "
          f"GT {fid_sr_gt:.6f} (card features; scipy's sqrtm {fid_s:.1f} s "
          f"on the host), the exact distance by the rank-3 identity "
          f"{exact:.6f} (tol {FID_TOL} relative); card {nvidia_smi_line()}")
    shutil.rmtree(METRIC_DIR)
    print(f"[metrics] phase 7e {time.perf_counter() - t0:.1f} s")
    return counts


# -- phase 7f: distributed -----------------------------------------------------

DIST = os.path.join("build", "chip_smoke_dist")
# torchrun of one rank, on a free port, of this script's rank mode
TORCHRUN = (sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1")
# the DDP step against the plain step from the same state on the same
# batch: the logged l_pix (relative), each gradient (of its tensor's
# largest entry; DDP's one-rank mean and cuDNN's nondeterministic sums),
# each tensor's update w - w0 (L2, relative to the plain update's: an
# update skipped stands at 1, halved at 0.5)
DDP_LOSS_BAR, DDP_GRAD_BAR, DDP_UPDATE_BAR = 1e-5, 1e-4, 1e-2


def _dist_opt(root: str) -> dict:
    """RECIPE's S1 options (a YAML's, before `parse_options`) on phase 7's
    synthetic PNGs: 2 iterations of batch 8 x 256x256 GT, no validation,
    the checkpoint at the end, `num_gpu: auto`; the experiment under
    `root`."""
    opt = json.loads(json.dumps(RECIPE))
    opt.update(num_gpu="auto", datasets={"train": {
        "name": "synthetic DF2K", "type": "PairedImageDataset",
        "dataroot_gt": os.path.join(DATA, "train", "gt"),
        "dataroot_lq": os.path.join(DATA, "train", "lq"),
        "io_backend": {"type": "disk"}, "gt_size": 256, "use_hflip": True,
        "use_rot": True, "num_worker_per_gpu": 8, "batch_size_per_gpu": 8,
        "dataset_enlarge_ratio": 100}},
        path={"experiments_root": os.path.join(root, "exp")},
        logger={"print_freq": 1, "save_checkpoint_freq": 100,
                "use_tb_logger": False})
    opt.pop("is_train")
    opt["train"]["total_iter"] = 2
    return opt


def _train_state(model) -> tuple:
    """Copies of what an S1 step changes: net_g's and the EMA's weights
    and the optimizer's state."""
    return ([p.detach().clone() for p in model.net_g.parameters()],
            [p.detach().clone() for p in model.net_g_ema.parameters()],
            copy.deepcopy(model.optimizer.state_dict()))


@torch.no_grad()
def _load_train_state(model, state):
    g, ema, optim = state
    for p, w in zip(model.net_g.parameters(), g):
        p.copy_(w)
    for p, w in zip(model.net_g_ema.parameters(), ema):
        p.copy_(w)
    # load_state_dict keeps the tensors it is given: hand it copies
    model.optimizer.load_state_dict(copy.deepcopy(optim))


def _ddp_vs_plain(steps: dict, w0: list, names: list) -> dict:
    """The DDP step against the plain step (each: l_pix, gradients,
    weights after): the l_pix's relative gap, each gradient's gap over
    its tensor's largest entry, each update's L2 gap over the plain
    update's. conv_cout.bias (a shift before a mean-subtracting
    LayerNorm: its exact gradient is 0) is held to 1e-5 of the largest
    gradient on both sides, and its update, Adam's scaled noise, is left
    out."""
    d, p = steps["ddp"], steps["plain"]
    top = max(g.abs().max().item() for g in p["grads"])
    grad, upd, zero, still = (0.0, ""), (0.0, ""), 0.0, []
    for k, gd, gp, wd, wp, w in zip(names, d["grads"], p["grads"],
                                    d["weights"], p["weights"], w0):
        if k.endswith("conv_cout.bias"):
            zero = max(zero, gd.abs().max().item() / top,
                       gp.abs().max().item() / top)
            continue
        gap, big = ((gd - gp).abs().max().item(), gp.abs().max().item())
        rel = gap / big if big else (float("inf") if gap else 0.0)
        grad = max(grad, (rel, k))
        step = (wp - w).norm().item()
        if step == 0:
            still.append(k)
            continue
        upd = max(upd, ((wd - wp).norm().item() / step, k))
    n_zero = sum(k.endswith("conv_cout.bias") for k in names)
    return {"l_pix": [d["l_pix"], p["l_pix"]],
            "loss_rel": abs(d["l_pix"] - p["l_pix"]) / abs(p["l_pix"]),
            "grad": grad, "update": upd, "zero": zero, "n_zero": n_zero,
            "still": still, "checked": len(names) - n_zero}


def _ddp_rank(argv: list) -> dict:
    """7f's data-parallel run in its rank: `train_torch.py`'s pipeline
    (`parse_options` with `--launcher pytorch` joins the NCCL group, then
    `train_pipeline`) with its launches counted and iteration 2 traced by
    the step profiler; then DDP steps and plain steps (the bare net, no
    all-reduce) in turns on phase 6's batch, each from the pipeline's
    final state and timed, the first of each kind held against the
    other (`_ddp_vs_plain`)."""
    from vmambair_torch.utils.options import parse_options

    opt = parse_options(".", is_train=True, argv=argv)
    opt.pop("launcher")  # the group outlives the pipeline: the sp run's
    reset_launches()
    model = train_pipeline(".", opt)
    torch.cuda.synchronize()
    counts = launches()
    model.feed_data(_train_batch())
    ddp = model.train_g
    state = _train_state(model)
    ms, steps = {"ddp": [], "plain": []}, {}
    for kind in ("ddp", "plain", "plain", "ddp", "ddp", "plain"):
        _load_train_state(model, state)
        model.train_g = ddp if kind == "ddp" else model.net_g
        before = launches()
        t0 = time.perf_counter()
        model.optimize_parameters(3)
        torch.cuda.synchronize()
        ms[kind].append(1e3 * (time.perf_counter() - t0))
        now = launches()
        step = {k: now[k] - before[k] for k in now}
        if step != expected_launches(model.net_g, train=True):
            raise SystemExit(f"FAIL distributed: {kind} step launches "
                             f"{step}")
        if kind not in steps:
            params = list(model.net_g.parameters())
            steps[kind] = {
                "l_pix": model.log_dict["l_pix"].item(),
                "grads": [q.grad.clone() for q in params],
                "weights": [q.detach().clone() for q in params]}
    names = [k for k, _ in model.net_g.named_parameters()]
    return {"launches": counts, "ms": ms,
            "step": _ddp_vs_plain(steps, state[0], names),
            "ddp": type(ddp).__name__,
            "world": torch.distributed.get_world_size(),
            "backend": torch.distributed.get_backend(),
            "iter_ms": 1e3 * model.timers["iter"].get_avg_time()}


def _sp_rank(argv: list) -> dict:
    """7f's sequence-parallel run in its rank, over the group that
    `_ddp_rank` joined: `inference_torch.py --sp`'s steps (the world's
    group installed, the `scan_impl: "sp"` net, the image through it,
    rank 0 writing it) with its launches counted; then 3 timed forwards
    of the same image and one profiled."""
    from vmambair_torch import inference
    from vmambair_torch.parallel import use_sp_group

    args = inference.parse_args(argv)
    with use_sp_group(torch.distributed.group.WORLD):
        ups = inference.build_upscaler(
            args, torch.device("cuda", torch.cuda.current_device()))
        reset_launches()
        inference.process(args, ups)
        torch.cuda.synchronize()
        counts = launches()
        img = imread(args.input, "color")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ups.enhance(img)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        by_class = profile("sp_forward", lambda: ups.enhance(img))
    return {"launches": counts, "ms": times, "by_class": by_class,
            "predicted": expected_launches(ups.model, sp=True),
            "world": torch.distributed.get_world_size()}


def rank_main(argv: list):
    """`chip_smoke.py --rank OUT.json TRAIN_ARGS... --then INFER_ARGS...`:
    the one rank of phase 7f under torchrun (one process start, one NCCL
    init): `_ddp_rank` on train_torch.py's arguments, then `_sp_rank` on
    inference_torch.py's; both results to OUT.json."""
    from vmambair_torch.parallel import destroy_distributed

    probe()
    out_path, rest = argv[0], argv[1:]
    cut = rest.index("--then")
    try:
        res = {"ddp": _ddp_rank(rest[:cut])}
        torch.cuda.empty_cache()
        res["sp"] = _sp_rank(rest[cut + 1:])
    finally:
        destroy_distributed()
    with open(out_path, "w") as f:
        json.dump(res, f)


def _ms_list(ms: list) -> str:
    return " / ".join(f"{t:.1f}" for t in ms)


def distributed() -> dict:
    """Phase 7f: the data-parallel S1 pipeline and then the
    sequence-parallel inference at world 1 over NCCL, in one torchrun of
    one rank (the card has one GPU), against the same work without a
    process group. Returns the launches of both runs."""
    t0 = time.perf_counter()
    if not os.path.isdir(DATA):
        write_dataset()
    shutil.rmtree(DIST, ignore_errors=True)
    os.makedirs(DIST)
    opt_path = os.path.join(DIST, "s1.json")
    trace = os.path.join(DIST, "trace")
    ddp_opt = _dist_opt(os.path.join(DIST, "ddp"))
    # the step profiler (train.profile_dir) traces iteration 2 on the card
    ddp_opt["train"].update(profile_dir=trace, profile_start=2,
                            profile_iters=1)
    with open(opt_path, "w") as f:
        json.dump(ddp_opt, f)
    # the sp run: inference_torch.py --sp on one 256x256 LQ at full width
    # from the DDP run's checkpoint
    lq_dir = os.path.join(DIST, "lq")
    imwrite(_synthetic_image(np.random.RandomState(5), 256, 256),
            os.path.join(lq_dir, "img.png"))
    ckpt = os.path.join(DIST, "ddp", "exp", "models", "net_g_2.pth")
    cli = ["--model_path", ckpt, "--arch", "MambaSISR6", "--network_opt",
           json.dumps(RECIPE["network_g"]), "-i",
           os.path.join(lq_dir, "img.png"), "--scale", "4", "--device",
           "cuda"]
    out = os.path.join(DIST, "rank.json")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    subprocess.run([*TORCHRUN, "chip_smoke.py", "--rank", out, "-opt",
                    opt_path, "--launcher", "pytorch", "--device", "cuda",
                    "--then", *cli, "-o", os.path.join(DIST, "sp_out"),
                    "--sp"], check=True, timeout=600)
    t2 = time.perf_counter()
    with open(out) as f:
        res = json.load(f)
    ddp, sp = res["ddp"], res["sp"]
    if ddp["ddp"] != "DistributedDataParallel" or ddp["world"] != 1 or (
            ddp["backend"] != "nccl"):
        raise SystemExit(f"FAIL distributed: {ddp['ddp']} at world "
                         f"{ddp['world']} over {ddp['backend']}")
    net = build_network(RECIPE["network_g"], device="cpu")
    per_step = expected_launches(net, train=True)
    if ddp["launches"] != {k: 2 * v for k, v in per_step.items()}:
        raise SystemExit(f"FAIL distributed: DDP pipeline launches "
                         f"{ddp['launches']}, predicted 2 x {per_step}")
    print(f"[distributed] torchrun (1 rank, NCCL) of train_torch.py's "
          f"pipeline, 2 S1 iterations of full-width MambaSISR6, then of "
          f"inference_torch.py --sp, in {t2 - t1:.1f} s: launches per step "
          f"{_nonzero(per_step)} (as predicted); ms per iteration "
          f"{ddp['iter_ms']:.1f}")
    if sorted(os.listdir(trace)) != ["by_class.txt", "trace.json"]:
        raise SystemExit(f"FAIL distributed: the step profiler wrote "
                         f"{os.listdir(trace)}")
    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.copy(os.path.join(trace, "by_class.txt"),
                os.path.join(OUT_DIR, "ddp_step_profile.txt"))
    with open(os.path.join(trace, "by_class.txt")) as f:
        print("[distributed] the step profiler's table of iteration 2 "
              f"(top rows; all in {OUT_DIR}/ddp_step_profile.txt):\n"
              + "".join(f.readlines()[:14]))
    saved = torch.load(ckpt, map_location="cpu")
    for key in ("params", "params_ema"):
        if saved[key].keys() != net.state_dict().keys():
            raise SystemExit(f"FAIL distributed: the DDP checkpoint's "
                             f"{key} keys differ from the bare net's")
    del saved
    st = ddp["step"]
    if (st["loss_rel"] > DDP_LOSS_BAR or st["grad"][0] > DDP_GRAD_BAR
            or st["update"][0] > DDP_UPDATE_BAR or st["still"]
            or st["zero"] > 1e-5):
        raise SystemExit(f"FAIL distributed: the DDP step against the "
                         f"plain step: {st}")
    dd, pl = (statistics.median(ddp["ms"][k]) for k in ("ddp", "plain"))
    print(f"[distributed] the DDP step against the plain step from the "
          f"pipeline's final state on phase 6's batch: l_pix "
          f"{st['l_pix'][0]:.7f} / {st['l_pix'][1]:.7f} (rel "
          f"{st['loss_rel']:.2e}, bar {DDP_LOSS_BAR}); {st['checked']} "
          f"gradients within {st['grad'][0]:.2e} of their largest entry "
          f"(worst at {st['grad'][1]}, bar {DDP_GRAD_BAR}); their updates "
          f"within {st['update'][0]:.2e} of the plain update's L2 norm "
          f"(worst at {st['update'][1]}, bar {DDP_UPDATE_BAR}; a skipped "
          f"update stands at 1); the {st['n_zero']} conv_cout.bias "
          f"gradients (exactly 0) within {st['zero']:.1e} of the largest "
          f"on both sides (bar 1e-5); the checkpoint without a "
          f"`module.` prefix; S1 step ms (median of 3, in turns from the "
          f"same state): DDP {dd:.1f}, plain {pl:.1f} ({dd / pl:.3f}x; "
          f"each: DDP {_ms_list(ddp['ms']['ddp'])}, plain "
          f"{_ms_list(ddp['ms']['plain'])}); "
          f"card {nvidia_smi_line()}")
    torch.cuda.empty_cache()

    if sp["launches"] != sp["predicted"] or sp["world"] != 1:
        raise SystemExit(f"FAIL distributed: sp launches {sp['launches']}, "
                         f"predicted {sp['predicted']}")
    from vmambair_torch import inference

    args = inference.parse_args(cli + ["-o", os.path.join(DIST, "out")])
    ups = inference.build_upscaler(args, torch.device("cuda"))
    reset_launches()
    inference.process(args, ups)
    plain = launches()
    img = imread(args.input, "color")
    times = []
    for _ in range(3):
        t5 = time.perf_counter()
        ups.enhance(img)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t5))
    got, ref = (imread(os.path.join(DIST, d, "img_out.png")).astype(int)
                for d in ("sp_out", "out"))
    grey = int(np.abs(got - ref).max())
    if got.shape != (1024, 1024, 3) or grey > 1:
        raise SystemExit(f"FAIL distributed: the sp output {got.shape} "
                         f"{grey} grey levels from the normal path's")
    print(f"[distributed] inference_torch.py --sp in the same rank, one "
          f"256x256 LQ at full width: launches "
          f"{_nonzero(sp['launches'])} (as predicted); output against the "
          f"normal path's ({_nonzero(plain)}): {grey} grey level(s) at "
          f"most (bar 1: the sharded and the fused scans' fp32 rounding); "
          f"forward ms (median of 3) sp "
          f"{statistics.median(sp['ms']):.1f}, normal "
          f"{statistics.median(times):.1f}; sp device ms by class "
          + ", ".join(f"{c} {v:.1f}" for c, v in sorted(
              sp["by_class"].items(), key=lambda kv: -kv[1]))
          + f"; phase {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(DIST, ignore_errors=True)
    return {k: ddp["launches"][k] + sp["launches"][k] for k in KERNELS}


# -- phase 8: the scan-design probes -------------------------------------------

PROBE_SHAPE = kvariants.Shape(**kvariants.SHAPE)
KSEQ_RACE = ("seq", "seq_win8", "seq_win16")
PEAK_KERNELS = {k["probe"]: name for name, k in KERNELS.items()
                if "probe" in k}


def _probe_inputs(dtype) -> tuple[dict, dict]:
    """kvariants' model-realistic inputs (post-softplus delta in [1e-3,
    0.1], A = -n) at the probe shape, in `dtype`, with their channels-last
    copies; and the same values in kseq's (G, L, 8, Dg) / (G, L, N, 8, 1)
    layout."""
    inp = kvariants.make_inputs(PROBE_SHAPE, 7, "cuda", "real")
    for k in ("u", "delta", "Bm", "Cm", "u_ld", "delta_ld"):
        inp[k] = inp[k].to(dtype)
    G = PROBE_SHAPE.G
    b, dim, L = inp["u"].shape
    kin = {k: inp[k] for k in ("A", "Dv", "bias")}
    for k in ("u", "delta"):
        kin[k] = inp[k].view(b, G, dim // G, L).permute(1, 3, 0, 2) \
            .contiguous()
    for k in ("Bm", "Cm"):
        kin[k] = inp[k].permute(1, 3, 2, 0).contiguous()[..., None]
    return inp, kin


def _scan_probe_cases(inp, kin, rev):
    """(kernel, label, call -> y as (B, DIM, L)) at the probe shape,
    through the tools' runners; the first of each kernel is its timed main
    case."""
    kv = kvariants

    def seq_kseq():  # (G, L, 8, Dg) -> (8, G*Dg, L)
        return kseq.run_seq(kin, 8, rev).permute(2, 0, 3, 1).flatten(1, 2)

    return [
        ("scan_seq", "DL win 8", lambda: kv.run_seq(inp, rev, 8)),
        ("scan_seq", "DL win 16", lambda: kv.run_seq(inp, rev, 16)),
        ("scan_seq", "DL win 1", lambda: kv.run_seq(inp, rev, 1)),
        ("scan_seq", "kseq (G,L,8,Dg) win 8", seq_kseq),
        ("selective_scan_ld", f"LD (K7, win {cuda_scan.K7_WIN})",
         lambda: kv.run_seq_ld(inp, rev)),
        ("scan_lpar", "DL seg 1024", lambda: kv.run_lpar(inp, rev, 1024)),
        ("scan_lpar", "DL seg 256", lambda: kv.run_lpar(inp, rev, 256)),
        ("scan_lpar", "DL seg 4096", lambda: kv.run_lpar(inp, rev, 4096)),
        ("scan_lpar", "LD seg 1024",
         lambda: kv.run_lpar(inp, rev, 1024, ld=True))]


def _probe_scan_bound(dtype) -> dict:
    """At the probe shape: u, delta, B, C (in `dtype`) and A, D, bias (fp32)
    read once, y written once; 10 fp32 operations and one exp2 per
    (b, l, d, n), as K4's bound."""
    s = PROBE_SHAPE
    el = s.B * s.L * s.dim * s.N
    act = 3 * s.B * s.L * s.dim + 2 * s.B * s.G * s.N * s.L
    by = act * torch.finfo(dtype).bits // 8 + 4 * s.dim * (s.N + 2)
    return bound(by, 10 * el, exp2=el)


def _combined_bound() -> dict:
    """v16 at the probe shape, bf16: u, delta, B, C read once, y and y2
    written once. The forward's 10 fp32 operations per (b, l, d, n), as
    K4's bound, and the reverse's own 4: its state FMA and its C h_rev
    FMA. The two directions share the decay's product and exp2 and
    x = delta u B: one exp2 per (b, l, d, n)."""
    s = PROBE_SHAPE
    el = s.B * s.L * s.dim * s.N
    act = 4 * s.B * s.L * s.dim + 2 * s.B * s.G * s.N * s.L
    return bound(2 * act + 4 * s.dim * (s.N + 2), (10 + 4) * el, exp2=el)


def _kvariants_cases(inp):
    """(kernel, label, call, plain, bound) of kvariants' v16, v3 and v10 at
    the probe shape, DL, through the tool's runners; calls and plain
    versions give (B, DIM, L), v16's a pair (y, y2)."""
    kv = kvariants
    chunk = PROBE_SHAPE.chunk
    v = kv.views(inp, torch.empty_like(inp["u"]), False)[:7]
    return [
        ("scan_combined", f"v16 chunk {chunk}",
         lambda: kv.run_combined(inp, chunk),
         lambda: tuple(kv.dl_of(t) for t in cuda_probes.scan_combined_ref(
             *v, chunk=chunk)), _combined_bound()),
        ("scan_stack_ab", f"v3 chunk {chunk}",
         lambda: kv.run_stack(inp, "ab", chunk),
         lambda: kv.ref_stack(inp, "ab", chunk),
         _probe_scan_bound(torch.bfloat16)),
        ("scan_stack_b", f"v10 sub {kv.V10_SUB}",
         lambda: kv.run_stack(inp, "b", chunk, kv.V10_SUB),
         lambda: kv.ref_stack(inp, "b", chunk, kv.V10_SUB),
         _probe_scan_bound(torch.bfloat16))]


def _peak_bound(name, x) -> dict:
    """x read and y written once; kpeak's operations per element and rep at
    REP = 64, over the fp32 rate (the bf16 FMA over twice it, the exp over
    the SFU's nominal rate, counted as fp32 time at that rate)."""
    _, probe, dtype, ops = cuda_probes.PEAK_PROBES[name]
    work = x.numel() * cuda_probes.PEAK_REP * ops
    if probe == "exp":
        work *= FP32_FLOPS / SFU_NOMINAL
    elif dtype == torch.bfloat16:
        work *= FP32_FLOPS / BF16X2_FLOPS
    return bound(2 * nbytes(x), work)


def kvariants_vs_plain(stats):
    """Phase 8a's kvariants v16, v3 and v10 at the probe shape in bf16 on
    the model-realistic recipe, against their plain versions (v16: y and
    y2); the stacks' distance from the exact scan printed beside. Times
    and bounds go into `stats`."""
    inp, _ = _probe_inputs(torch.bfloat16)
    rtol, atol = TOL[torch.bfloat16]
    exact = kvariants.run_reference(inp)
    for name, label, call, plain, bnd in _kvariants_cases(inp):
        got = call()
        torch.cuda.synchronize()
        ref = plain()
        pairs = (zip(("y", "y2"), got, ref) if isinstance(got, tuple)
                 else [("y", got, ref)])
        errs = [check_close(f"{name} {label} {what}", g, r, rtol, atol)
                for what, g, r in pairs]
        st = stats[name]
        st["max_abs_err"] = max(errs)
        st["ms"], st["plain_ms"] = time_ms(call), time_ms(plain, reps=3)
        st["terms"] = bnd
        line = (f"[probes] {name} {label} bf16: max abs err "
                f"{', '.join(f'{e:.3e}' for e in errs)} against the plain "
                f"version; kernel {st['ms']:.3f} ms, plain "
                f"{st['plain_ms']:.3f} ms")
        if not isinstance(got, tuple):
            # the stack's own rounding: its distance from the exact scan
            e = (got.float() - exact.float()).abs()
            off = int((e > atol + rtol * exact.float().abs()).sum())
            line += (f"; against the exact scan {e.max().item():.3e}, "
                     f"{off} of {e.numel()} off the envelope")
        print(line)
        del got, ref
    stacks_last_bf16(inp, stats)
    del inp, exact
    torch.cuda.empty_cache()


def stacks_last_bf16(inp, stats):
    """The bf16 stacks with each position's last composition in bf16, the
    TPU kernels' rounding (`last_bf16`), against the plain version at the
    probe shape, then raced against the default (that step in fp32) and
    lpar_1024 in one interleaved race: the cost of the step the default
    moves to fp32. Results go into the stacks' `stats` as *_last_bf16."""
    kv = kvariants
    chunk = PROBE_SHAPE.chunk
    rtol, atol = TOL[torch.bfloat16]
    calls = {"lpar_1024": lambda i: kv.run_lpar(i, seg=1024)}
    for name, stack, sub in (("scan_stack_ab", "ab", None),
                             ("scan_stack_b", "b", kv.V10_SUB)):
        got = kv.run_stack(inp, stack, chunk, sub, last_bf16=True)
        torch.cuda.synchronize()
        err = check_close(f"{name} last step bf16", got,
                          kv.ref_stack(inp, stack, chunk, sub), rtol, atol)
        stats[name]["max_abs_err_last_bf16"] = err
        print(f"[probes] {name} with the last step in bf16: max abs err "
              f"{err:.3e} against the plain version")
        del got
        for last in (False, True):
            calls[(name, last)] = (
                lambda i, stack=stack, sub=sub, last=last: kv.run_stack(
                    i, stack, chunk, sub, last_bf16=last))
    times = {k: statistics.median(v) for k, v in
             kv.race(calls, [inp], 9).items()}
    base = times.pop("lpar_1024")
    for (name, last), ms in times.items():
        if last:
            stats[name]["ms_last_bf16"] = ms
        print(f"[probes] {name} last step {'bf16' if last else 'fp32'}: "
              f"{ms:.4f} ms, {ms / base:.3f} of lpar_1024's {base:.4f} ms "
              f"(interleaved, 9 rounds); card {nvidia_smi_line()}")


def probe_kernels_vs_plain(stats):
    """Phase 8a: K7, scan_seq and scan_lpar at the probe shape (B=8,
    L=16384, G=2, D=96, N=16) against the plain scan, bf16 and fp32,
    forward and reverse, DL, LD and kseq views; kvariants' v16, v3 and v10
    (`kvariants_vs_plain`); the five peak probes at REP = 64 against their
    plain versions. Times and bounds of each kernel's first case go into
    `stats`."""
    for dtype in (torch.bfloat16, torch.float32):
        inp, kin = _probe_inputs(dtype)
        rtol, atol = TOL[dtype]
        for rev in (False, True):
            def plain(rev=rev):
                return kvariants.run_reference(inp, rev)

            ref = plain()
            torch.cuda.synchronize()
            for name, label, call in _scan_probe_cases(inp, kin, rev):
                got = call()
                torch.cuda.synchronize()
                tag = f"{name} {label} rev={rev} {str(dtype)[6:]}"
                err = check_close(tag, got, ref, rtol, atol)
                st = stats[name]
                st["max_abs_err"] = max(st["max_abs_err"], err)
                line = f"[probes] {tag}: max abs err {err:.3e}"
                if st["ms"] is None:
                    st["ms"] = time_ms(call)
                    st["plain_ms"] = time_ms(plain, reps=3)
                    st["terms"] = _probe_scan_bound(dtype)
                    line += (f"; kernel {st['ms']:.3f} ms, plain "
                             f"{st['plain_ms']:.3f} ms")
                print(line)
            del ref
        del inp, kin
        torch.cuda.empty_cache()
    kvariants_vs_plain(stats)
    for name, (fn, probe, dtype, _) in cuda_probes.PEAK_PROBES.items():
        x = kpeak.make_x((kpeak.GRID, kpeak.ROWS, kpeak.LANES), dtype, 0,
                         "cuda")
        got, ref = fn(x), cuda_probes.peak_ref(probe, x)
        torch.cuda.synchronize()
        rtol, atol = kpeak.TOL[dtype]
        err = check_close(f"peak {name}", got, ref, rtol, atol)
        st = stats[PEAK_KERNELS[name]]
        st.update(max_abs_err=err, ms=time_ms(lambda: fn(x)),
                  plain_ms=time_ms(lambda: cuda_probes.peak_ref(probe, x),
                                   reps=3),
                  terms=_peak_bound(name, x))
        print(f"[probes] peak {name} (16,1024,1024) REP 64: max abs err "
              f"{err:.3e} (rtol {rtol}, atol {atol}); kernel "
              f"{st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms")
        del x, got, ref


# one race name timed per TPU kernel function of csrc/scan_dual.cu
SEPARATED_TIMED = {"scan_dual_v22": "v22_dual_128_32",
                   "scan_dual_v24": "v25_mid_128_64",
                   "scan_dual_v26": "v26_midopt_128_64",
                   "scan_cumsum": "v4_128"}


def separated_vs_plain(stats, ex2_rate):
    """Phase 8c: each of kvariants' 15 separated-exponent names once at the
    probe shape (B 8, L 16384, 2 x 96 channels, N 16, bf16), its first
    PARITY_L positions held against its plain version on them (the scan is
    causal: they depend on nothing after), under the model-realistic
    recipe, where each must also sit inside the exact scan's envelope, and
    under the hot default one, where the clamps bind and the distance from
    the exact scan is printed as a finding (v4 overflows there: compared
    where the kernel and the plain version are both finite, both
    non-finite shares printed). Then one name per kernel is timed on the
    realistic recipe beside its plain version (full L), with the bound of
    every scan (one exp2 per (b, l, d, n), at `ex2_rate`) and beside it the
    design's own exp2 count (two: E and Z). Times and bounds go into
    `stats`."""
    kv = kvariants
    rtol, atol = TOL[torch.bfloat16]
    t0 = time.perf_counter()
    for recipe in ("real", "default"):
        inp = kv.make_inputs(PROBE_SHAPE, 7, "cuda", recipe)
        part = kv.sliced(inp, kv.PARITY_L)
        exact = kv.run_reference(part).float()
        for name in kv.SEPARATED:
            kernel = kv.sep_kernel(name)
            got = kv.run_sep(inp, name)[..., :kv.PARITY_L].float()
            torch.cuda.synchronize()
            ref = kv.ref_sep(part, name).float()
            tag = f"{name} ({kernel}) {recipe} recipe"
            line = f"[probes] {tag}: "
            g, r, e = got, ref, exact
            if name in kv.MAY_OVERFLOW:
                fin, fin_ref = torch.isfinite(got), torch.isfinite(ref)
                both = fin & fin_ref
                line += (f"non-finite {1 - fin.float().mean().item():.4%} "
                         f"(plain {1 - fin_ref.float().mean().item():.4%}), "
                         "compared where both are finite; ")
                if not both.any():
                    raise SystemExit(f"FAIL {tag}: no element where the "
                                     "kernel and the plain version are "
                                     "both finite")
                g, r, e = got[both], ref[both], exact[both]
            err = check_close(tag, g, r, rtol, atol)
            st = stats[kernel]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            line += f"max abs err {err:.3e} against the plain version"
            if recipe == "real":
                ex = check_close(f"{tag} against the exact scan", got,
                                 exact, rtol, atol)
                line += f"; inside the exact scan's envelope ({ex:.3e})"
            else:
                d = (g - e).abs()
                off = (~torch.isfinite(got) | ((got - exact).abs() > atol
                                               + rtol * exact.abs()))
                line += (f"; against the exact scan {d.max().item():.3e}, "
                         f"{off.float().mean().item():.4%} off its envelope")
            print(line)
            del got, ref
        del inp, part, exact
        torch.cuda.empty_cache()
    inp = kv.make_inputs(PROBE_SHAPE, 7, "cuda", "real")
    terms = _probe_scan_bound(torch.bfloat16)
    bnd = finish_bound(terms, ex2_rate)["bound_ms"]
    two = finish_bound(dict(terms, exp2=2 * terms["exp2"]),
                       ex2_rate)["bound_ms"]
    for kernel, name in SEPARATED_TIMED.items():
        st = stats[kernel]
        st["ms"] = time_ms(lambda: kv.run_sep(inp, name))
        st["plain_ms"] = time_ms(lambda: kv.ref_sep(inp, name), reps=3)
        st["terms"] = terms
        st["timed"] = name
        print(f"[probes] {kernel} {name} at (8,16384,192,N=16) bf16: kernel "
              f"{st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms; bound "
              f"{bnd:.4f} ms (one exp2 per element), {two:.4f} ms at the "
              f"design's two; card {nvidia_smi_line()}")
    del inp
    torch.cuda.empty_cache()
    print(f"[probes] phase 8c {time.perf_counter() - t0:.1f} s")


def probe_race() -> tuple[dict, float]:
    """Phase 8b, the probe path: kvariants' race (every variant, the
    model-realistic recipe), kseq's variants with and without the
    relayout, kpeak's rates, through the tools' entry points. Asserts that
    each kernel launched exactly as often as the tools scheduled. Returns
    the launches and the ex2 rate (per second) of every bound's exp2 term:
    the larger of the nominal and the measured one."""
    dev = torch.device("cuda")
    reset_launches()
    t0 = time.perf_counter()
    kv = kvariants.run(list(kvariants.VARIANTS), dev, delta="real")
    ks = kseq.run(list(KSEQ_RACE), dev)
    pk = kpeak.run(list(cuda_probes.PEAK_PROBES), dev)
    counts = launches()
    want = dict.fromkeys(KERNELS, 0)
    for row in kv:
        want[row["kernel"]] += row["launches"]
    want["scan_seq"] += sum(row["launches"] for row in ks)
    for row in pk:
        want[PEAK_KERNELS[row["probe"]]] += row["launches"]
    if counts != want:
        raise SystemExit(f"FAIL probes: launches {counts}, scheduled {want}")
    measured = next(r["t_ops_per_s"] for r in pk
                    if r["probe"] == "exp_fp32") * 1e12
    ex2_rate = max(SFU_NOMINAL, measured)
    bnd = finish_bound(_probe_scan_bound(torch.bfloat16), ex2_rate)
    card = nvidia_smi_line()
    for r in kv:
        b = (finish_bound(_combined_bound(), ex2_rate)
             if r["kernel"] == "scan_combined" else bnd)
        print(f"[race] kvariants {r['variant']}: {r['ms']:.3f} ms, "
              f"{r['gelem_per_s']:.1f} Gelem/s, {r['ms_over_k4']:.3f} of "
              f"k4's time, {r['ms_over_lpar_1024']:.3f} of lpar_1024's; "
              f"bound {b['bound_ms']:.4f} ms, "
              f"{b['bound_ms'] / r['ms']:.3f} of the time; "
              f"parity max abs err {r['max_abs_err']:.3e}"
              + (f" (y2 {r['y2_max_abs_err']:.3e})"
                 if "y2_max_abs_err" in r else "")
              + (f" (the exact scan {r['exact_max_abs_err']:.3e}, "
                 f"{r['exact_off_envelope']:.3%} off the envelope)"
                 if "exact_max_abs_err" in r else "")
              + (f" (non-finite {r['nonfinite_share']:.3%}, plain "
                 f"{r['plain_nonfinite_share']:.3%})"
                 if "nonfinite_share" in r else "")
              + f"; all {[round(t, 3) for t in r['all_ms']]}")
    rel = {r["variant"]: r["ms_over_lpar_1024"] for r in kv}
    print(f"[race] v16 over lpar_1024: {rel['v16_combined_128']:.3f} (a "
          f"combined pass can win below 2); v3, v10_128 over lpar_1024: "
          f"{rel['v3']:.3f}, {rel['v10_128']:.3f} (the bf16 stacks win "
          f"below 1); card {card}")
    print("[race] the separated-exponent scans over lpar_1024: "
          + ", ".join(f"{n} {rel[n]:.3f}" for n in kvariants.SEPARATED)
          + f" (the dual pays on the card below 1); card {card}")
    for r in ks:
        print(f"[race] kseq {r['variant']}: {r['ms']:.3f} ms, with the "
              f"relayout {r['ms_with_relayout']:.3f} ms, "
              f"{r['gelem_per_s']:.1f} Gelem/s; parity max abs err "
              f"{r['max_abs_err']:.3e}")
    for r in pk:
        sheet = r["datasheet_t_ops_per_s"]
        print(f"[race] kpeak {r['probe']}: {r['t_ops_per_s']:.2f} T-ops/s "
              f"at REP {r['rep']} ({r['ms']:.3f} ms, bytes "
              f"{100 * r['bytes_share']:.1f}% of it); data sheet "
              f"{sheet if sheet else 'none'}")
    print(f"[race] bound of every scan variant at (8,16384,192,N=16) bf16: "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; exp2 at "
          f"{ex2_rate:.4g}/s, the larger of the nominal "
          f"{SFU_NOMINAL:.4g}/s and the measured {measured:.4g}/s); "
          f"launches {({k: v for k, v in counts.items() if v})}; phase "
          f"{time.perf_counter() - t0:.1f} s; card {card}")
    return counts, ex2_rate


# -- phase 9: keffn and kprobe -------------------------------------------------

def keffn_kprobe_vs_plain(stats):
    """Phase 9a: keffn's kernel at the TPU probe's five level shapes and
    kprobe's two at (8, 16384, 96), bf16 and fp32, against their plain
    versions on the card (the forward envelope; the transpose pair bit for
    bit). The first case of each (bf16: 128x128x48, the probe shape) is
    timed beside its plain version and, for the transpose pair, the
    library call `u * 1.000001`, checked bit-equal to it first."""
    for dtype in (torch.bfloat16, torch.float32):
        for shape in keffn.SHAPES:
            B, H, W, C = shape
            params = keffn.make_params(C + H, C, "cuda")
            x = keffn.make_x(shape, dtype, 1, "cuda")

            def call(x=x, p=params):
                return cuda_probes.gdfn_tanh_nhwc(x, **p)

            def plain(x=x, p=params):
                return cuda_probes.gdfn_tanh_ref(x, **p)

            got = call()
            torch.cuda.synchronize()
            tag = f"gdfn_tanh_nhwc {shape} {str(dtype)[6:]}"
            err = check_close(tag, got, plain(), *TOL[dtype])
            st = stats["gdfn_tanh_nhwc"]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            line = f"[keffn] {tag}: max abs err {err:.3e}"
            if st["ms"] is None:
                st["ms"], st["plain_ms"] = time_ms(call), time_ms(plain,
                                                                  reps=3)
                st["terms"] = _gdfn_work_bound(shape, dtype)
                line += (f"; kernel {st['ms']:.3f} ms, plain "
                         f"{st['plain_ms']:.3f} ms")
            print(line)
            del x, got
        inp = kprobe.make_inputs(kprobe.SHAPE, 0, "cuda")
        inp["u"] = inp["u"].to(dtype)
        for name, probe in (("probe_transpose", "transpose_pair_in_kernel"),
                            ("probe_proj", "proj_in_kernel")):
            kern, plain = kprobe.calls(probe)
            got = kern(inp)
            torch.cuda.synchronize()
            ref = plain(inp)
            tag = (f"{name} {tuple(kprobe.SHAPE.values())} "
                   f"{str(dtype)[6:]}")
            if name == "probe_transpose":
                if not torch.equal(got, ref):
                    raise SystemExit(f"FAIL {tag}: not bit-equal to its "
                                     "plain version")
                err = 0.0
            else:
                err = check_close(tag, got, ref, *TOL[dtype])
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            line = f"[kprobe] {tag}: max abs err {err:.3e}"
            if name == "probe_proj" and dtype == torch.float32:
                line += proj_f32_checks(inp, got, ref)
            if name == "probe_proj" and st["ms"] is not None:
                # fp32: timed too, beside its own bound
                ms = time_ms(lambda: kern(inp))
                line += (f"; kernel {ms:.4f} ms, plain "
                         f"{time_ms(lambda: plain(inp), reps=3):.4f} ms"
                         + bound_share(bound(*kprobe.work(
                             probe, kprobe.SHAPE, dtype)), ms))
            if st["ms"] is None:
                st["ms"] = time_ms(lambda: kern(inp))
                st["plain_ms"] = time_ms(lambda: plain(inp), reps=3)
                st["terms"] = bound(*kprobe.work(probe, kprobe.SHAPE, dtype))
                line += (f"; kernel {st['ms']:.4f} ms, plain "
                         f"{st['plain_ms']:.4f} ms")
                if name == "probe_transpose":
                    if not torch.equal(kprobe.library(inp), ref):
                        raise SystemExit(f"FAIL {tag}: u * 1.000001 is not "
                                         "bit-equal to the function")
                    st["library_ms"] = time_ms(lambda: kprobe.library(inp))
                    line += (f", library u * 1.000001 (bit-equal) "
                             f"{st['library_ms']:.4f} ms")
            print(line)
            del got, ref
        del inp
    torch.cuda.empty_cache()


PROJ_F32_BAR = 1e-5  # probe_proj in fp32: of the plain version's largest


def proj_f32_checks(inp, got, ref) -> str:
    """probe_proj in fp32 against its plain version (cuBLAS in fp32,
    TF32 off) within PROJ_F32_BAR of the plain version's largest entry,
    and the single-pass control (u and W_xp cut to TF32, as one TF32
    product on the tensor cores reads them) off that bar."""
    top = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    if err > PROJ_F32_BAR * top:
        raise SystemExit(f"FAIL probe_proj fp32: {err:.3e} off the plain "
                         f"version, over {PROJ_F32_BAR} of its largest "
                         f"entry {top:.3e}")
    cut = cuda_probes.probe_proj_ref(_tf32_rn(inp["u"]), _tf32_rn(inp["wxp"]),
                                     inp["wdt"])
    ctl = (cut - ref).abs().max().item()
    if ctl <= PROJ_F32_BAR * top:
        raise SystemExit(f"FAIL probe_proj fp32: the single-pass control "
                         f"({ctl:.3e}) is within the bar; it shows nothing")
    return (f"; {err / top:.2e} of the largest entry {top:.3e} (bar "
            f"{PROJ_F32_BAR}); single-pass TF32 control {ctl / top:.2e}")


def keffn_kprobe_race() -> dict:
    """Phase 9b, the probe path of keffn and kprobe: their entry points on
    the card (parity at every shape, then the interleaved races), the
    launches reset before and read after, checked against what the tools
    report they scheduled. Returns the launches."""
    dev = torch.device("cuda")
    reset_launches()
    t0 = time.perf_counter()
    ke = keffn.run(dev)
    kp = kprobe.run(list(kprobe.PROBES), dev)
    counts = launches()
    want = dict.fromkeys(KERNELS, 0)
    want["gdfn_tanh_nhwc"] = sum(r["launches"] for r in ke)
    want["gdfn_residual_fused"] = sum(r["k2_launches"] for r in ke)
    want["probe_transpose"], want["probe_proj"] = (r["launches"] for r in kp)
    if counts != want:
        raise SystemExit(f"FAIL keffn/kprobe: launches {counts}, scheduled "
                         f"{want}")
    card = nvidia_smi_line()
    for r in ke:
        key = "x".join(str(v) for v in r["shape"][1:])
        t = {n: r[f"{key}_{n}_ms"] for n in keffn.RACE}
        print(f"[race] keffn {key} bf16: fused {t['fused']:.3f} ms, cuDNN "
              f"composite {t['composite']:.3f} ms "
              f"({t['fused'] / t['composite']:.2f}x), K2 on NCHW "
              f"{t['k2']:.3f} ms; bound {r[key + '_bound_ms']:.4f} ms "
              f"({r[key + '_bound_by']}); relerr {r[key + '_relerr']:.2e} "
              f"(composite {r[key + '_composite_relerr']:.2e}); card {card}")
    for r in kp:
        lib = r.get("library_ms")
        print(f"[race] kprobe {r['probe']}: {r['ms_per_call']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms_per_call']:.3f} of the time"
              + (f"; library u * 1.000001 {lib:.4f} ms" if lib else "")
              + (f"; all 38 rows' fp32 ops {r['rows38_ops_ms']:.4f} ms, "
                 f"the route's 40 rows on the tensor cores "
                 f"{r['rows40_tc_ms']:.4f} ms"
                 if "rows38_ops_ms" in r else "")
              + f"; max abs err {r['max_abs_err']:.3e}; card {card}")
    print(f"[race] keffn/kprobe launches "
          f"{({k: v for k, v in counts.items() if v})}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


# -- phase 10: kldio and kdualnum ----------------------------------------------

def kldio_vs_plain(stats):
    """Phase 10a: kldio's kernel at the TPU probe's shape against its plain
    version, forward and reverse, bf16 (the probe's dtype) and fp32, the
    forward envelope; the first case timed beside its plain version. Then
    K1 and K1c (the channels-first policy) on the seeded digest cases of
    `tools.ab`, held to the recorded build's digests."""
    st = stats["ld_fused"]
    for dtype in (torch.bfloat16, torch.float32):
        u2, *w = kldio.make_inputs(0, "cuda")
        u = u2.movedim(2, 1).contiguous().to(dtype)
        for rev in (False, True):
            def call(u=u, rev=rev):
                return cuda_probes.ld_fused(u, *w, reverse=rev)

            def plain(u=u, rev=rev):
                return cuda_probes.ld_fused_plain(u, *w, reverse=rev)

            got = call()
            torch.cuda.synchronize()
            tag = (f"ld_fused {tuple(u.shape)} rev={rev} "
                   f"{str(dtype)[6:]}")
            err = check_close(tag, got, plain(), *TOL[dtype])
            st["max_abs_err"] = max(st["max_abs_err"], err)
            line = f"[kldio] {tag}: max abs err {err:.3e}"
            if st["ms"] is None:
                st["ms"], st["plain_ms"] = time_ms(call), time_ms(plain,
                                                                  reps=3)
                by, ops, ex2 = kldio.work(dtype=dtype)
                st["terms"] = bound(by, ops, exp2=ex2)
                line += (f"; kernel {st['ms']:.3f} ms, plain "
                         f"{st['plain_ms']:.3f} ms")
            print(line)
            del got
        del u2, u
    with open(ab.DIGESTS_FILE) as f:
        want = json.load(f)
    got = ab.digests()
    differ = sorted(k for k in want["digests"]
                    if got.get(k) != want["digests"][k])
    if differ or got.keys() != want["digests"].keys():
        raise SystemExit(f"FAIL K1's channels-first policy: {len(differ)} "
                         f"of {len(want['digests'])} digests differ from "
                         f"the recorded build: {differ}")
    print(f"[kldio] K1 and K1c (channels-first policy): all {len(got)} "
          f"seeded outputs bit-identical to the recorded build "
          f"({want['made_on']})")
    torch.cuda.empty_cache()


def kldio_kdualnum_run(ex2_rate) -> dict:
    """Phase 10b/c, the probe path of kldio and kdualnum: kldio's entry
    point on the card (parity forward and reverse, then the race), its
    launches against what the tool reports it scheduled; kdualnum's rows
    on the full-width MambaSISR6 at 48x48, the forward's launches against
    the dispatch's prediction. Returns the launches of kldio."""
    dev = torch.device("cuda")
    reset_launches()
    t0 = time.perf_counter()
    rows = kldio.run(dev, ex2_rate)
    counts = launches()
    want = dict.fromkeys(KERNELS, 0)
    for r in rows:
        if "kernel" in r:
            want[r["kernel"]] += r["launches"]
    if counts != want:
        raise SystemExit(f"FAIL kldio: launches {counts}, scheduled {want}")
    card = nvidia_smi_line()
    bnd = rows[-1]
    for r in rows:
        if "rel_err" in r:
            print(f"[kldio] {r['piece']}: rel err {r['rel_err']:.3e} (the "
                  f"TPU probe's bar {kldio.PARITY_BAR})")
        elif r["piece"] != "bound":
            print(f"[race] kldio {r['piece']}: {r['ms']:.3f} ms, "
                  f"{r['bound_share']:.4f} of it the bound"
                  + (f"; speedup_vs_prod {r['speedup_vs_prod']:.3f}"
                     if "speedup_vs_prod" in r else "")
                  + f"; all {[round(t, 3) for t in r['all_ms']]}")
    print(f"[race] kldio bound at {tuple(bnd['shape'])} bf16: "
          f"{bnd['ms']:.4f} ms ({bnd['bound_by']}; exp2 at "
          f"{ex2_rate:.4g}/s); card {card}")
    net, x = kdualnum.make_net_and_input(dev, 48)
    reset_launches()
    stats = kdualnum.collect(net, x)
    fwd = launches()
    if fwd != expected_launches(net):
        raise SystemExit(f"FAIL kdualnum: forward launches {fwd}, the "
                         f"dispatch predicts {expected_launches(net)}")
    kinds = {s["kind"] for s in stats}
    if kinds != {"spatial", "channel"} or not all(
            np.isfinite(s["delta"]).all() for s in stats):
        raise SystemExit(f"FAIL kdualnum: captured kinds {kinds} or a "
                         "non-finite delta")
    for line in [kdualnum.capture_line(stats),
                 f"captured {len(stats)} spatial scan calls (input 48x48)"
                 ] + kdualnum.summarize(stats):
        print(f"[kdualnum] {line}")
    del net, x
    torch.cuda.empty_cache()
    print(f"[kldio/kdualnum] launches "
          f"{({k: v for k, v in counts.items() if v})}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def main():
    t0 = time.perf_counter()
    os.environ.update({k: "0" for k in SWITCHES})
    os.environ.pop("VMAMBAIR_EFFN_FUSED", None)
    probe()
    build()
    stats, shape_ms = kernels_vs_plain()
    for fused in (False, True):
        model_vs_plain(fused)
        model_grads_vs_plain(fused)
    model_grads_vs_plain(False, "MambaRealSR11", 9)
    serve_counts = serve(shape_ms)
    train_counts = train(shape_ms)
    pipe_counts = pipeline()
    torch.cuda.empty_cache()
    gan_counts = gan()
    torch.cuda.empty_cache()
    realsr_counts = realsr(shape_ms)
    torch.cuda.empty_cache()
    derain_counts = derain(shape_ms)
    torch.cuda.empty_cache()
    metric_counts = metrics_phase()
    torch.cuda.empty_cache()
    dist_counts = distributed()
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    probe_kernels_vs_plain(stats)
    probe_counts, ex2_rate = probe_race()
    separated_vs_plain(stats, ex2_rate)
    print(f"[probes] phase 8 {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    keffn_kprobe_vs_plain(stats)
    counts9 = keffn_kprobe_race()
    print(f"[keffn/kprobe] phase 9 {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    kldio_vs_plain(stats)
    counts10 = kldio_kdualnum_run(ex2_rate)
    print(f"[kldio/kdualnum] phase 10 {time.perf_counter() - t10:.1f} s")
    probe_counts = {k: probe_counts[k] + counts9[k] + counts10[k]
                    for k in KERNELS}
    kernels = []
    for name, k in KERNELS.items():
        terms = stats[name].pop("terms")
        stats[name].update(finish_bound(terms, ex2_rate))
        if terms["exp2"]:
            print(f"[bounds] {name}: {stats[name]['bound_ms']:.4f} ms "
                  f"({stats[name]['bound_by']}) with the exp2 term "
                  f"({terms['exp2'] / ex2_rate * 1e3:.4f} ms), "
                  f"{finish_bound(terms)['bound_ms']:.4f} ms without")
        if name in MODEL_KERNELS:
            # launched on its own path: serve, train, the pipeline, the
            # GAN stage, RealSR, deraining, the metrics' validation and
            # the distributed runs (K4's state form on the last alone)
            n = (serve_counts[name] + train_counts[name] + pipe_counts[name]
                 + gan_counts[name] + realsr_counts[name]
                 + derain_counts[name] + metric_counts[name]
                 + dist_counts[name])
            own = (dist_counts if k["path"] == "sp" else pipe_counts)[name]
            if n == 0 or own == 0:
                raise SystemExit(f"FAIL: {name} never launched on a main "
                                 "path")
            counts = dict(launches=n, launches_serve=serve_counts[name],
                          launches_train=train_counts[name],
                          launches_pipeline=pipe_counts[name],
                          launches_gan=gan_counts[name],
                          launches_realsr=realsr_counts[name],
                          launches_derain=derain_counts[name],
                          launches_metrics=metric_counts[name],
                          launches_distributed=dist_counts[name])
        else:
            # launched on its own path: the probes
            if probe_counts[name] == 0:
                raise SystemExit(f"FAIL: {name} never launched on the "
                                 "probe path")
            counts = dict(launches=probe_counts[name])
        if "grids_per_launch" in k:
            counts["grids_per_launch"] = k["grids_per_launch"]
        kernels.append(dict(
            name=name, route="cuda", source=k["source"],
            replaces=k["replaces"], **counts,
            launches_probe=probe_counts[name], **stats[name]))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
