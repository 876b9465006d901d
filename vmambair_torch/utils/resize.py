"""Lanczos-4 image resize in torch: the counterpart of
`cv2.resize(img, (w, h), interpolation=cv2.INTER_LANCZOS4)` that
`vmambair_tpu/utils/upscaler.py` calls for `enhance(outscale=...)`.

Separable, 8 taps per axis, as OpenCV computes it (held against cv2 on the
CPU by the tests):

- coordinate map: output pixel i samples source position
  x = (i + 0.5) * (in / out) - 0.5 (half-pixel centres), its taps at
  floor(x) - 3 .. floor(x) + 4;
- weights: the Lanczos window sin(pi t) sin(pi t / 4) / (pi^2 t^2 / 4) at
  t = frac(x) + 3 - k for tap k, divided by their sum; a tap at t = 0
  takes all the weight;
- border: a tap outside the image reads the nearest edge pixel
  (replicate).

The port's machine has no cv2, so this is the only resize the port has.
"""

from __future__ import annotations

import math

import torch

TAPS = 8


def lanczos4_weights(n_in: int, n_out: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """For each of `n_out` output pixels along one axis: the source index
    of each of its 8 taps (clamped to the image), (n_out, 8) int64, and
    their weights, (n_out, 8) float32."""
    i = torch.arange(n_out, dtype=torch.float64)
    # cv2 rounds the source coordinate to float32 before taking its floor
    x = ((i + 0.5) * (n_in / n_out) - 0.5).to(torch.float32).double()
    x0 = torch.floor(x)
    frac = x - x0
    k = torch.arange(TAPS, dtype=torch.float64)
    t = frac[:, None] + 3 - k                      # distance of each tap
    # the window tends to 1 as t -> 0; `safe` keeps the division finite
    at0 = t.abs() < 1e-7
    safe = torch.where(at0, torch.ones_like(t), t)
    w = torch.sin(math.pi * safe) * torch.sin(math.pi * safe / 4) / (
        (math.pi * safe / 2) ** 2)
    w = torch.where(at0, torch.ones_like(w), w)
    w = w / w.sum(1, keepdim=True)
    idx = (x0[:, None] - 3 + k).clamp(0, n_in - 1).long()
    return idx, w.float()


def resize_lanczos4(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """img: (H, W) or (H, W, C) float32, on any device; returns it resized
    to `out_hw` = (h, w), float32 on the same device: along W, then
    along H, each output a weighted sum of 8 taps."""
    if img.dim() not in (2, 3):
        raise ValueError(f"resize_lanczos4: takes (H, W) or (H, W, C), got "
                         f"{tuple(img.shape)}")
    h_in, w_in = img.shape[:2]
    h_out, w_out = out_hw
    if h_out < 1 or w_out < 1:
        raise ValueError(f"resize_lanczos4: output size {out_hw}")
    x = img.float()
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    # along W: (H, W, C) -> (H, w_out, C)
    idx, w = (t.to(x.device) for t in lanczos4_weights(w_in, w_out))
    x = (x[:, idx] * w[None, :, :, None]).sum(2)
    # along H: (H, w_out, C) -> (h_out, w_out, C)
    idx, w = (t.to(x.device) for t in lanczos4_weights(h_in, h_out))
    x = (x[idx] * w[:, :, None, None]).sum(1)
    return x[..., 0] if squeeze else x
