"""RealSR models: the on-device two-order degradation synthesis, the
training-pair queue, and the S1 (`RealESRNetModel`) and GAN
(`RealESRGANModel`) stages.

The port's copy of `vmambair_tpu/train/realesrgan_model.py`. `feed_data`
takes clean GT crops and per-sample blur kernels from `RealESRGANDataset`
and synthesises the LQ input on the device, without a gradient:

  order 1: blur(kernel1) -> random resize (up / down / keep) ->
           Gaussian | Poisson noise -> JPEG;
  order 2: blur(kernel2) with `second_blur_prob` -> resize back to the
           canvas and by a second factor -> noise -> {resize to H/scale +
           sinc, then JPEG} or {JPEG, then resize + sinc}, even odds ->
           the uint8 grid;
  then a paired random crop to gt_size, and the shuffle queue of
  `queue_size` training pairs.

The draws split as the JAX package's traced ones do, with each random op a
draw and a deterministic apply (`Synthesis.draw`, `synthesize`):
- the discrete choices and the scalars that shape the resampling matrices
  (resize category, factor and mode, the second blur, the noise kind, the
  JPEG/sinc order, the crop) come from a host `np.random.RandomState`, so
  no device value is read back;
- the per-image values (noise sigma, Poisson scale, grey mask, JPEG
  quality) and the noise samples come from a `torch.Generator` on the
  model's device.
The resizes keep JAX's fixed canvas: the factor-1.5 upscale crops the
content to the canvas, as JAX does (not the reference's dynamic-size
resize).

Under data parallelism the synthesis and the queue follow the global-batch
rule (`parallel.on_global_batch`), as JAX synthesises the global batch with
one key and keeps one queue over it (`vmambair_tpu/train/
realesrgan_model.py:175-199`): every rank gathers the ranks' GT rows and
kernels, synthesises the global batch with its equally seeded generators,
keeps the same global queue, and takes its own rows.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..ops.degradation import (
    TorchSampler,
    add_gaussian_noise,
    add_poisson_noise,
    filter2d,
    jpeg_compress_padded,
    random_resize,
    random_resize_back,
    usm_sharp,
)
from ..parallel import on_global_batch
from ..utils.registry import MODEL_REGISTRY
from .gan_model import SRGANModel
from .sr_model import SRModel, _is_on, to_device

logger = logging.getLogger("vmambair_torch")

KERNEL_KEYS = ("kernel1", "kernel2", "sinc_kernel")


@dataclass
class NoiseDraw:
    """One noise step's draws: the kind (host), and per image (device)
    the Gaussian sigma (on the [0, 1] scale), the Poisson scale and the
    grey mask."""
    gaussian: bool
    sigma: torch.Tensor
    scale: torch.Tensor
    gray: torch.Tensor


@dataclass
class Draws:
    """One batch's draws of the two-order synthesis."""
    s1: float              # order 1's resize factor
    m1: int                # its mode (0 area, 1 bilinear, 2 bicubic)
    noise1: NoiseDraw
    q1: torch.Tensor       # (B,) JPEG quality
    blur2: bool            # the second blur
    s2: float
    m2: int
    noise2: NoiseDraw
    q2: torch.Tensor
    m3: int                # the final resize's mode
    sinc_first: bool       # resize + sinc, then JPEG (else JPEG first)
    top: int               # the crop's offsets on the LQ grid
    left: int


def _draw_scale(rng: np.random.RandomState, prob, rrange) -> float:
    """The resize factor: up in [1, hi], down in [lo, 1] or 1, with
    category probabilities `prob`; fp32 as JAX computes it."""
    cat = rng.choice(3, p=np.asarray(prob, np.float64))
    u = np.float32(rng.uniform())
    lo, hi = (float(v) for v in rrange)
    one = np.float32(1.0)
    return float((one + u * np.float32(hi - 1.0),
                  np.float32(lo) + u * np.float32(1.0 - lo), one)[cat])


def synthesize(gt, kernel1, kernel2, sinc_kernel, d: Draws, sampler,
               scale: int, gt_size: int):
    """The two-order degradation of `gt` (B, 3, H, W) under the draws `d`
    (noise samples from `sampler`). Returns (gt crop, USM-sharpened gt
    crop, lq crop), the crops gt_size and gt_size / scale."""
    b, c, h, w = gt.shape
    gt_usm = usm_sharp(gt)

    out = filter2d(gt_usm, kernel1)
    out = random_resize(out, d.s1, d.m1)
    out = noise_step(out, d.noise1, sampler, "1")
    out = jpeg_compress_padded(out, d.q1)

    if d.blur2:
        out = filter2d(out, kernel2)
    # back to the canvas (net factor 1), then the second factor
    out = random_resize_back(out, d.s1, d.m2, (h, w))
    out = random_resize(out, d.s2, d.m2)
    out = noise_step(out, d.noise2, sampler, "2")

    lq_hw = (h // scale, w // scale)
    if d.sinc_first:
        out = random_resize_back(out, d.s2, d.m3, lq_hw)
        out = filter2d(out, sinc_kernel)
        out = jpeg_compress_padded(out, d.q2)
    else:
        out = jpeg_compress_padded(out, d.q2)
        out = random_resize_back(out, d.s2, d.m3, lq_hw)
        out = filter2d(out, sinc_kernel)
    lq = torch.clamp(torch.round(out * 255.0), 0.0, 255.0) / 255.0

    p = gt_size // scale
    top, left = d.top, d.left
    lq_c = lq[:, :, top:top + p, left:left + p]
    gs = (slice(None), slice(None), slice(top * scale, top * scale + gt_size),
          slice(left * scale, left * scale + gt_size))
    return gt[gs], gt_usm[gs], lq_c


def noise_step(img, nd: NoiseDraw, sampler, tag: str):
    """Gaussian or Poisson noise as `nd` draws it; the Gaussian samples
    are `sampler.normal`'s "gauss{tag}" and "gauss{tag}_gray", the Poisson
    ones `sampler.poisson`'s "poisson{tag}" and "poisson{tag}_gray"."""
    b, c, h, w = img.shape
    if nd.gaussian:
        return add_gaussian_noise(
            img, nd.sigma, nd.gray,
            sampler.normal((b, c, h, w), f"gauss{tag}"),
            sampler.normal((b, 1, h, w), f"gauss{tag}_gray"))
    return add_poisson_noise(img, nd.scale, nd.gray, sampler,
                             f"poisson{tag}")


class Synthesis:
    """The synthesis of one model: its YAML ranges, a host generator for
    the discrete draws and a device generator for the per-image values and
    the noise, both seeded from `seed`. A call draws and applies."""

    def __init__(self, opt: Dict[str, Any], scale: int, gt_size: int,
                 seed: int, device):
        self.opt = opt
        self.scale, self.gt_size = scale, gt_size
        self.device = torch.device(device)
        self.host_rng = np.random.RandomState(seed + 101)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 102)
        self.sampler = TorchSampler(self.gen)

    def _uniform(self, b, lo, hi):
        u = torch.rand(b, generator=self.gen, device=self.device)
        return lo + u * (hi - lo)

    def _noise(self, b, sfx: str) -> NoiseDraw:
        opt = self.opt
        nr = opt[f"noise_range{sfx}"]
        pr = opt[f"poisson_scale_range{sfx}"]
        gray_prob = float(opt.get(f"gray_noise_prob{sfx}", 0.0))
        gaussian = bool(self.host_rng.uniform()
                        < float(opt[f"gaussian_noise_prob{sfx}"]))
        return NoiseDraw(
            gaussian=gaussian,
            sigma=self._uniform(b, float(nr[0]), float(nr[1])) / 255.0,
            scale=self._uniform(b, float(pr[0]), float(pr[1])),
            gray=self._uniform(b, 0.0, 1.0) < gray_prob)

    def draw(self, b: int, h: int, w: int) -> Draws:
        opt, rng = self.opt, self.host_rng
        jr1 = opt.get("jpeg_range", [30, 95])
        jr2 = opt.get("jpeg_range2", [30, 95])
        s1 = _draw_scale(rng, opt.get("resize_prob", [0.2, 0.7, 0.1]),
                         opt.get("resize_range", [0.15, 1.5]))
        m1 = int(rng.randint(3))
        noise1 = self._noise(b, "")
        q1 = self._uniform(b, float(jr1[0]), float(jr1[1]))
        blur2 = bool(rng.uniform()
                     < float(opt.get("second_blur_prob", 0.8)))
        s2 = _draw_scale(rng, opt.get("resize_prob2", [0.3, 0.4, 0.3]),
                         opt.get("resize_range2", [0.3, 1.2]))
        m2 = int(rng.randint(3))
        noise2 = self._noise(b, "2")
        q2 = self._uniform(b, float(jr2[0]), float(jr2[1]))
        m3 = int(rng.randint(3))
        sinc_first = bool(rng.uniform() < 0.5)
        p = self.gt_size // self.scale
        top = int(rng.randint(h // self.scale - p + 1))
        left = int(rng.randint(w // self.scale - p + 1))
        return Draws(s1, m1, noise1, q1, blur2, s2, m2, noise2, q2, m3,
                     sinc_first, top, left)

    @torch.no_grad()
    def __call__(self, gt, kernel1, kernel2, sinc_kernel):
        b, _, h, w = gt.shape
        d = self.draw(b, h, w)
        return synthesize(gt, kernel1, kernel2, sinc_kernel, d,
                          self.sampler, self.scale, self.gt_size)


class _DegradationMixin:
    """feed_data of both stages: device synthesis + the shuffle queue."""

    def _init_degradation(self):
        opt = self.opt
        train_ds = (opt.get("datasets") or {}).get("train") or {}
        self.gt_size = int(train_ds.get("gt_size", opt.get("gt_size", 256)))
        self.queue_size = int(opt.get("queue_size", 180))
        self.synthesis = Synthesis(opt, self.scale, self.gt_size, self.seed,
                                   self.device)
        self._queue = None  # made at the first batch, when its shapes show
        self._queue_ptr = 0
        self.l1_gt_usm = bool(opt.get("l1_gt_usm", True))
        self.percep_gt_usm = bool(opt.get("percep_gt_usm", True))
        self.gan_gt_usm = bool(opt.get("gan_gt_usm", False))
        self.gt_usm = None
        self._enqueue_rng = np.random.RandomState(self.seed + 77)

    def _dequeue_and_enqueue(self, lq, gt):
        """The training-pair pool: filled in order (each batch passes
        through), then on each step shuffled by a host permutation, its
        first batch handed out and replaced by the new one. Device
        buffers; the permutation goes to the device from pinned memory."""
        if self.queue_size <= 0:
            return lq, gt
        b = lq.shape[0]
        if self._queue is None:
            qs = (self.queue_size // b) * b
            if qs == 0:
                return lq, gt
            self._queue = (lq.new_zeros((qs,) + lq.shape[1:]),
                           gt.new_zeros((qs,) + gt.shape[1:]))
            self._queue_len = qs
        q_lq, q_gt = self._queue
        if self._queue_ptr == self._queue_len:  # full: shuffle, swap
            perm = to_device(self._enqueue_rng.permutation(self._queue_len),
                             self.device, np.int64)
            q_lq, q_gt = q_lq.index_select(0, perm), q_gt.index_select(0, perm)
            out = q_lq[:b].clone(), q_gt[:b].clone()
            q_lq[:b], q_gt[:b] = lq, gt
            self._queue = (q_lq, q_gt)
            return out
        p = self._queue_ptr
        q_lq[p:p + b], q_gt[p:p + b] = lq, gt
        self._queue_ptr += b
        return lq, gt

    def put_batch(self, data: Dict[str, Any], keys=None) -> Dict[str, Any]:
        """A training batch's GT (NCHW) and blur kernels (B, 21, 21) on the
        device; otherwise SRModel's, of `keys` (lq, gt)."""
        if keys is not None or not (self.is_train and "kernel1" in data):
            return SRModel.put_batch(self, data, keys or ("lq", "gt"))
        out = SRModel.put_batch(self, data, ("gt",))
        for k in KERNEL_KEYS:
            v = data[k]
            if not (torch.is_tensor(v) and _is_on(v, self.device)):
                out[k] = to_device(v, self.device)
        return out

    def feed_data(self, data: Dict[str, Any]):
        data = self.put_batch(data)
        if not self.is_train or "kernel1" not in data:
            # evaluation: plain (lq, gt) data
            self.lq = data["lq"]
            self.gt = data.get("gt")
            self.gt_usm = self.gt
            return
        self.lq, pair = on_global_batch(
            self._synthesize_and_queue, data["gt"],
            *(data[k] for k in KERNEL_KEYS))
        c = pair.shape[1] // 2
        self.gt, self.gt_usm = pair[:, :c], pair[:, c:]

    def _synthesize_and_queue(self, gt, kernel1, kernel2, sinc_kernel):
        """(lq, GT and USM-sharpened GT joined on channels) of a batch:
        the synthesis, then the queue."""
        gt_c, gt_usm_c, lq = self.synthesis(gt, kernel1, kernel2,
                                            sinc_kernel)
        return self._dequeue_and_enqueue(
            lq.contiguous(), torch.cat([gt_c, gt_usm_c], 1))


@MODEL_REGISTRY.register(name="RealESRGANModel")
@MODEL_REGISTRY.register(name="MambaRealSRGAN")
@MODEL_REGISTRY.register(name="MambaRealSRGANtest")
class RealESRGANModel(_DegradationMixin, SRGANModel):
    """The GAN stage with a per-loss choice of the USM-sharpened GT
    (`l1_gt_usm`, `percep_gt_usm`, `gan_gt_usm`). As in JAX, the G step's
    pass through D keeps D's spectral norms as they are; D's step updates
    them twice. `MambaRealSRGANtest` is the same class: `feed_data` takes
    GT-free batches outside training."""

    g_step_updates_u = False

    def __init__(self, opt: Dict[str, Any], device="cuda"):
        super().__init__(opt, device)
        self._init_degradation()

    def _g_targets(self):
        return (self.gt_usm if self.l1_gt_usm else self.gt,
                self.gt_usm if self.percep_gt_usm else self.gt)

    def _d_real(self):
        return self.gt_usm if self.gan_gt_usm else self.gt


@MODEL_REGISTRY.register(name="RealESRNetModel")
@MODEL_REGISTRY.register(name="MambaRealSR")
class RealESRNetModel(_DegradationMixin, SRModel):
    """The S1 stage (L1) with the same synthesis; L1 against the
    USM-sharpened GT where `l1_gt_usm`."""

    def __init__(self, opt: Dict[str, Any], device="cuda"):
        super().__init__(opt, device)
        self._init_degradation()

    def optimize_parameters(self, current_iter: int):
        gt = self.gt
        if self.gt_usm is not None and self.l1_gt_usm:
            self.gt = self.gt_usm
        try:
            super().optimize_parameters(current_iter)
        finally:
            self.gt = gt
