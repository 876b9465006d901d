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
   (median of repeats) for the kernel and the plain version, beside the
   least time the card could take (bound) at the case's shapes. K1 at the
   four shapes of a served forward ((8,2,96,16384), (8,2,48,16384),
   (8,2,96,4096), (8,2,192,1024)), K2 at the five of a served forward
   in bf16 ((8,96,128,128) first, the main shape; its tensor-core route)
   and the five of the S1 step in fp32 ((8,48,64,64), (8,96,64,64),
   (8,96,32,32), (8,192,16,16), (8,384,8,8); its CUDA-core route), each
   beside its plain version (the cuDNN composite), K1c at the S1 step's
   (8,2,96,4096) and (8,2,48,4096) fp32 and K3 at every fp32 shape of
   the S1 step (the
   fused scans (8,4096,192), (8,4096,96), (8,1024,192), (8,256,384) both
   ways, the latent (8,64,768) both ways, the channel scans (8,c,8)) are
   timed in every row, each with its bound and its share of it, and K3's
   device ms per grid at each shape by torch.profiler; K2 also at the
   CUDA tests' ragged shapes (every width class, C no multiple of 16, H
   and W no multiple of the tiles, odd W); K5 at the five MamberBlock
   shapes of a served forward ((8,96,128,128) first), its bf16 rows (the
   tensor-core route) timed beside its plain version, and at ragged
   shapes (every width class, E != C, C up to 704, odd W, batch 1), bf16
   and fp32 (the CUDA-core route); K3 also over a
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
   channels to a group), bf16 and fp32;
4. model  - MambaSISR6 widths at depth [1,1,1,1] + 1, one batch of 8
   128x128 tiles in fp32, kernels vs the plain path, within 1e-3;
4b. model gradients - the same depth, fp32, 8 x 64x64 LQ, L1 loss: every
   parameter's gradient through the kernels against the plain path on the
   card within 2e-3 of its largest entry, and every scan and GDFN
   parameter's gradient non-zero and finite;
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
   beside it); then, counts reset, the two tools' entry points: keffn's
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
(for K1-K6 the launches in the serve, train and pipeline phases, for the
probe kernels those of the probe paths of phases 8 to 10, which must be at
least one each; a
launch is one call of the kernel's wrapper, which for K1, K1c and
`ld_fused` is four grids and for `scan_lpar`, `scan_combined` and the
stacks three, `grids_per_launch` in its entry;
max error, times and bound from phases 3 and 8-10) and the card's name and
power limit from nvidia-smi; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import contextlib
import json
import os
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
                                  SFU_NOMINAL, ab, hold, kdualnum, keffn,
                                  kldio, kpeak, kprobe, kseq, kvariants)
from vmambair_torch.train import build_model
from vmambair_torch.train.pipeline import test_pipeline, train_pipeline
from vmambair_torch.utils.img_util import imread, imwrite
from vmambair_torch.utils.options import finalize_options
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
# train, pipeline) or the probe paths of phases 8 to 10
MODEL_KERNELS = tuple(n for n, k in KERNELS.items() if k["path"] == "model")
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
K5_RAGGED_SHAPES = ((2, 48, 48, 13, 19), (2, 96, 100, 8, 8),
                    (2, 384, 384, 5, 7), (2, 20, 70, 3, 33),
                    (1, 40, 52, 9, 33), (1, 72, 72, 17, 10),
                    (1, 136, 72, 7, 11), (1, 200, 200, 16, 16),
                    (1, 264, 136, 6, 10), (1, 640, 64, 5, 8),
                    (1, 704, 704, 6, 10), (1, 20, 20, 30, 2),
                    (2, 96, 96, 1, 1))
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
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
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


def expected_launches(net, train: bool = False) -> dict:
    """Kernel launches of one forward (train: one training step), as the
    port's dispatch routes it: per MamberBlock two spatial pair scans (K1
    when the width is at most 256, else K4), one channel scan (K4) and one
    GDFN (K2), and with the switches on one OSS front (K5) and one OSS
    tail (K6). A training step takes the carry-saving forwards (K1c, K4c)
    instead of K1 and K4, and one scan backward (K3) per scan; K2, K5 and
    K6 have no backward kernel."""
    out = dict.fromkeys(KERNELS, 0)
    sfx = "_carries" if train else ""
    for m in net.modules():
        if not isinstance(m, MamberBlock):
            continue
        wide = not cuda_scan.fused_scan_supported(m.attn.d_inner,
                                                  m.attn.d_state)
        out[("selective_scan" if wide else "oss_scan_fused") + sfx] += 2
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


def time_ms(fn, reps=5) -> float:
    """Median over `reps` of CUDA-event time, after one warm-up call; each
    call queued behind a device sleep (`tools.hold`), so that a call
    shorter than its host-side launch path is timed on the card alone."""
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


def bound(bytes_moved, fp32_ops, bf16_mma=0, exp2=0) -> dict:
    """The terms of the least time the card could take for a call: the
    bytes over the HBM rate and the operations over their peak rates (ms),
    and the count of SFU exp2s, whose term `finish_bound` adds once phase 8
    has measured the ex2 rate to set beside the nominal one."""
    return dict(bytes_ms=bytes_moved / HBM_BPS * 1e3,
                ops_ms=(fp32_ops / FP32_FLOPS + bf16_mma / BF16_TC_FLOPS)
                * 1e3, exp2=exp2)


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


def _tail_case(b, d, hw, dtype, gen):
    """K6's inputs: the scans' (B, 2, D, L) sum and the SiLU gate."""
    return (torch.randn(b, 2, d, hw * hw, generator=gen, device="cuda"
                        ).to(dtype),
            F.silu(torch.randn(b, d, hw, hw, generator=gen, device="cuda")
                   ).to(dtype),
            1 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
            0.1 * torch.randn(d, generator=gen, device="cuda"))


def _front_bound(args):
    """JAX's count (pallas_effn.py:322): B H W (4 C E + 18 E), the in_conv
    products on the tensor cores for bf16 inputs; x read, xs and z
    written once."""
    x, w_dw = args[0], args[5]
    b, c, h, w = x.shape
    e = w_dw.shape[0]
    px = b * h * w
    mma, other = px * 4 * c * e, px * 18 * e
    by = nbytes(x) + 2 * px * e * x.element_size() + nbytes(*args[1:])
    if x.dtype == torch.bfloat16:
        return bound(by, other, mma)
    return bound(by, other + mma)


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
    weights once; the projections on the tensor cores for bf16."""
    x, w_out = args[0], args[5]
    b, c, h, w = x.shape
    return bound(*keffn.work((b, h, w, c), x.dtype, w_out.shape[1]))


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

    def pair_cmp(label, dtype):
        return lambda got, ref: max(
            check_close(f"{label} {n}", g, r, *TOL[dtype])
            for n, g, r in zip(("xs", "z"), got, ref))

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
                fwd_cmp(f"K2 {lab} {dtype}", dtype), _gdfn_bound(a),
                timed=True, key=(b, c, h, w, dtype), plain_timed=True)
        for (b, c, h, w) in K2_RAGGED_SHAPES:
            a = _gdfn_case(b, c, h, dtype, gen, w)
            lab = f"ragged ({b},{c},{h},{w})"
            add("gdfn_residual_fused", lab, dtype,
                lambda a=a: cuda_effn.gdfn_residual_fwd(*a),
                lambda a=a: cuda_effn.gdfn_residual_ref(*a),
                fwd_cmp(f"K2 {lab} {dtype}", dtype), _gdfn_bound(a))
    # K5 and K6 at the five MamberBlock shapes of a served forward (the
    # first, 30 of the 50 blocks, is the main shape); K5's bf16 rows (its
    # tensor-core route) timed beside its plain version; then K5 at the
    # ragged shapes
    cgen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for (b, c, hw) in K5_SERVE_SHAPES:
            lab = f"({b},{c},{hw},{hw})"
            a = _front_case(b, c, hw, dtype, cgen)
            add("oss_front_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_front_fwd(*a),
                lambda a=a: cuda_effn.oss_front_ref(*a),
                pair_cmp(f"K5 {lab} {dtype}", dtype), _front_bound(a),
                timed=dtype == torch.bfloat16, key=(b, c, hw, hw, dtype),
                plain_timed=True)
            a = _tail_case(b, c, hw, dtype, cgen)
            add("oss_tail_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_tail_fwd(*a),
                lambda a=a: cuda_effn.oss_tail_ref(*a),
                fwd_cmp(f"K6 {lab} {dtype}", dtype), _tail_bound(a))
        for (b, c, e, h, w) in K5_RAGGED_SHAPES:
            a = _front_case(b, c, h, dtype, cgen, e, w)
            lab = f"ragged ({b},{c},{h},{w}) E={e}"
            add("oss_front_fused", lab, dtype,
                lambda a=a: cuda_effn.oss_front_fwd(*a),
                lambda a=a: cuda_effn.oss_front_ref(*a),
                pair_cmp(f"K5 {lab} {dtype}", dtype), _front_bound(a))
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

    k3_calls = {}
    shape_ms = {"K2": {}, "K3": {}, "K4": {}, "K4c": {}, "K5": {}}
    by_name = {"selective_scan_bwd": "K3", "selective_scan": "K4",
               "selective_scan_carries": "K4c", "oss_front_fused": "K5",
               "gdfn_residual_fused": "K2"}
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
        ref = plain()
        err = cmp(got, ref)
        del got, ref
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        line = (f"[kernels] {name} {label} {str(dtype)[6:]}: max abs err "
                f"{err:.3e}")
        ms = None
        if st["ms"] is None:  # the first case: the main path's shape
            st["ms"], st["plain_ms"] = time_ms(kern), time_ms(plain, reps=3)
            st["terms"] = bnd
            ms = st["ms"]
            line += (f"; kernel {st['ms']:.4f} ms, plain "
                     f"{st['plain_ms']:.4f} ms")
            line += bound_share(bnd, st["ms"])
        elif timed:
            ms = time_ms(kern)
            line += f"; kernel {ms:.4f} ms"
            if plain_timed:
                line += f", plain {time_ms(plain, reps=3):.4f} ms"
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
    """Two K2 calls on the same inputs at the served forward's main shape
    (the tensor-core route) and at the S1 step's (the fp32 route) give the
    same bits."""
    for (b, c, h, w), dtype in ((K2_SERVE_SHAPES[0], torch.bfloat16),
                                (K2_STEP_SHAPES[1], torch.float32)):
        a = _gdfn_case(b, c, h, dtype, gen, w)
        if not torch.equal(cuda_effn.gdfn_residual_fwd(*a),
                           cuda_effn.gdfn_residual_fwd(*a)):
            raise SystemExit(f"FAIL K2 ({b},{c},{h},{w}) {dtype}: two calls "
                             "gave different bits")
    print("[kernels] K2 at (8,96,128,128) bf16 and (8,96,64,64) fp32: two "
          "calls each, the same bits")


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


def _reduced_net(seed):
    return build_network(dict(type="MambaSISR6", num_blocks=[1, 1, 1, 1],
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


def model_grads_vs_plain(fused: bool):
    """Phase 4b; `fused`: with K5 and K6 on (their parameters' gradients
    then come through the recompute backward of their Functions)."""
    net = _reduced_net(3)
    g = torch.Generator().manual_seed(4)
    gt = torch.rand(8, 3, 256, 256, generator=g)
    lq = torch.nn.functional.avg_pool2d(gt, 4).cuda()
    gt = gt.cuda()
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
    print(f"[grads] MambaSISR6 widths, depth [1,1,1,1]+1, 8x64x64 LQ, L1, "
          f"fp32, {tag}: {checked} parameter tensors within {GRAD_BAR} of "
          "their "
          f"largest entry (worst {worst[0]:.3e} at {worst[1]}); "
          f"{len(kernel_params)} scan/GDFN{'/front/tail' if fused else ''} "
          "tensors with non-zero finite "
          f"gradients; launches {counts}; kernels {1e3 * (t1 - t0):.1f} ms,"
          f" plain {1e3 * (t2 - t1):.1f} ms (first calls)")
    del net, got, ref
    torch.cuda.empty_cache()


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
    tally = {}
    with oss_switches(True), k5_shapes(tally):
        by_class = profile("serve_front_tail", lambda: ups.tile_process(
            np.random.RandomState(7).rand(512, 256, 3).astype(np.float32)))
    shape_account("serve", "K5", "forward with K5/K6 on", tally,
                  shape_ms["K5"], by_class.get("K5 OSS front", 0.0))
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
    ("K2 GDFN", ("gdfn_kernel", "gdfn_mma_kernel")),
    ("K5 OSS front", ("oss_front_kernel", "oss_front_mma_kernel")),
    ("K6 OSS tail", ("oss_tail_kernel",)),
    ("convolutions", ("fprop", "dgrad", "wgrad", "conv", "implicit",
                      "cudnn", "winograd")),
    ("matrix products (einsums)", ("gemm", "xmma", "cutlass", "splitK")),
    ("optimizer (Adam, EMA)", ("multi_tensor", "adam", "lerp")),
    ("copies", ("Memcpy", "Memset", "copy")),
)


def device_breakdown(prof) -> dict:
    """Device time (ms) of the profiled kernels, by class."""
    out = {}
    for row in prof.key_averages():
        # kernels only, as the table's own total counts them: no CPU rows,
        # no ranges annotated on the device (such as Optimizer.step)
        if row.device_type != torch.autograd.DeviceType.CUDA or getattr(
                row, "is_user_annotation", False):
            continue
        ms = getattr(row, "self_device_time_total",
                     getattr(row, "self_cuda_time_total", 0)) / 1e3
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in row.key for k in keys)),
                   "elementwise and reductions")
        out[cls] = out.get(cls, 0.0) + ms
    return out


def profile(name, fn):
    """A torch.profiler table of one call of fn (top rows printed, all in
    chiprun_out/<name>_profile.txt) and its device time by class against
    the host clock around the call."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    by_class = device_breakdown(prof)
    busy = sum(by_class.values())
    summary = (f"[{name}] device time by class (ms): " + ", ".join(
        f"{c} {v:.1f}" for c, v in sorted(by_class.items(),
                                          key=lambda kv: -kv[1]))
        + f"; device sum {busy:.1f} ms of {wall:.1f} ms on the host clock "
        f"under the profiler (idle {100 * (1 - busy / wall):.1f}%)")
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


def _pipeline_opt(total_iter: int, auto_resume: bool) -> dict:
    """RECIPE with its datasets pointed at the synthetic PNGs, 8 steps,
    validation (PSNR-Y, crop 4) every 4, checkpoints every 4."""
    train_ds = {"name": "synthetic DF2K", "type": "PairedImageDataset",
                "dataroot_gt": os.path.join(DATA, "train", "gt"),
                "dataroot_lq": os.path.join(DATA, "train", "lq"),
                "io_backend": {"type": "disk"}, "gt_size": 256,
                "use_hflip": True, "use_rot": True, "num_worker_per_gpu": 8,
                "batch_size_per_gpu": 8, "dataset_enlarge_ratio": 100}
    opt = json.loads(json.dumps(RECIPE))
    opt.update(num_gpu=1, auto_resume=auto_resume,
               datasets={"train": train_ds, "val_1": _val_dataset()},
               path={"experiments_root": os.path.join(PIPE, "exp"),
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
                st["terms"] = bound(*keffn.work(shape, dtype))
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
              + (f"; all 38 rows' fp32 ops {r['rows38_ops_ms']:.4f} ms"
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
    serve_counts = serve(shape_ms)
    train_counts = train(shape_ms)
    pipe_counts = pipeline()
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
            # launched on its own path: serve, train and the pipeline
            n = serve_counts[name] + train_counts[name] + pipe_counts[name]
            if n == 0 or pipe_counts[name] == 0:
                raise SystemExit(f"FAIL: {name} never launched on a main "
                                 "path")
            counts = dict(launches=n, launches_serve=serve_counts[name],
                          launches_train=train_counts[name],
                          launches_pipeline=pipe_counts[name])
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
    main()
