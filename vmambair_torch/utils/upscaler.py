"""RestorationUpscaler: tiled inference on one GPU.

Counterpart of `vmambair_tpu/utils/upscaler.py` (the reference's
`RealESRGANer`): reflect pre-pad and pad-to-window, overlapping
`tile_process` with a `tile_pad` halo and a seam-free merge, optional half
precision, and the alpha path in `enhance`. Tiles keep one fixed shape and
run in fixed-size batches. Images are HWC numpy on the host; the model
sees NCHW tensors on `device`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class RestorationUpscaler:
    def __init__(self, scale: int, model: torch.nn.Module, device,
                 tile: int = 0, tile_pad: int = 10, pre_pad: int = 10,
                 half: bool = False, window: int = 8, tile_batch: int = 4):
        self.scale = scale
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tile = tile
        self.tile_pad = tile_pad
        self.pre_pad = pre_pad
        self.window = window
        self.dtype = torch.bfloat16 if half else torch.float32
        self.tile_batch = max(1, tile_batch)

    def _apply(self, batch: np.ndarray) -> np.ndarray:
        """(N, H, W, C) float32 -> (N, sH, sW, C) float32 through the net."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
            x = x.permute(0, 3, 1, 2).to(self.dtype)
            y = self.model(x).float().permute(0, 2, 3, 1)
            return y.cpu().numpy()

    # -- whole-image path --------------------------------------------------
    def pre_process(self, img: np.ndarray) -> tuple[np.ndarray, int, int]:
        """Reflect pre-pad + pad to the window multiple. Returns the padded
        array and the original h, w."""
        h, w = img.shape[:2]
        p = self.pre_pad
        if p:
            img = np.pad(img, ((p, p), (p, p), (0, 0)), mode="reflect")
        hp, wp = img.shape[:2]
        ph = (self.window - hp % self.window) % self.window
        pw = (self.window - wp % self.window) % self.window
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        return img, h, w

    def post_process(self, out: np.ndarray, h: int, w: int) -> np.ndarray:
        s, p = self.scale, self.pre_pad
        return out[p * s: p * s + h * s, p * s: p * s + w * s]

    # -- overlapped tiling -------------------------------------------------
    def tile_process(self, img: np.ndarray) -> np.ndarray:
        """img: HWC float32. Overlapping tiles with halo, seam-free merge;
        tiles run in fixed-size batches of one shape."""
        h, w = img.shape[:2]
        s, tile, pad = self.scale, self.tile, self.tile_pad
        ny = math.ceil(h / tile)
        nx = math.ceil(w / tile)
        # reflect-pad so every (tile + 2*pad) patch is in range
        padded = np.pad(
            img,
            ((pad, pad + ny * tile - h), (pad, pad + nx * tile - w), (0, 0)),
            mode="reflect",
        )
        patch_size = tile + 2 * pad
        patches = [
            padded[iy * tile: iy * tile + patch_size,
                   ix * tile: ix * tile + patch_size]
            for iy in range(ny) for ix in range(nx)
        ]
        out = np.zeros((h * s, w * s, img.shape[2]), np.float32)
        tb = self.tile_batch
        n = len(patches)
        patches += [patches[-1]] * ((tb - n % tb) % tb)
        results = np.concatenate([
            self._apply(np.stack(patches[i: i + tb]))
            for i in range(0, len(patches), tb)
        ], axis=0)[:n]
        for idx in range(n):
            iy, ix = divmod(idx, nx)
            res = results[idx][pad * s: (pad + tile) * s,
                               pad * s: (pad + tile) * s]
            y0, x0 = iy * tile * s, ix * tile * s
            hh = min(tile * s, h * s - y0)
            ww = min(tile * s, w * s - x0)
            out[y0: y0 + hh, x0: x0 + ww] = res[:hh, :ww]
        return out

    # -- public API --------------------------------------------------------
    def enhance(self, img: np.ndarray) -> tuple[np.ndarray, str]:
        """img: HWC BGR uint8/uint16 (or HW gray / HWCA with alpha).
        Returns (output BGR uint8/16, img_mode)."""
        max_range = 65535.0 if img.dtype == np.uint16 else 255.0
        imgf = img.astype(np.float32) / max_range
        alpha = None
        if imgf.ndim == 2:
            img_mode = "L"
            imgf = np.repeat(imgf[:, :, None], 3, axis=2)
        elif imgf.shape[2] == 4:
            img_mode = "RGBA"
            alpha = imgf[:, :, 3]
            imgf = imgf[:, :, 2::-1]  # BGR -> RGB
        else:
            img_mode = "RGB"
            imgf = imgf[:, :, ::-1]
        out = self._run(np.ascontiguousarray(imgf))
        out = out[:, :, ::-1]  # RGB -> BGR
        if alpha is not None:
            # alpha goes through the model too (`alpha_upsampler` realesrgan)
            a3 = np.repeat(alpha[:, :, None], 3, axis=2)
            out = np.dstack([out, self._run(a3)[:, :, 0]])
        if img_mode == "L":  # BGR -> gray with cv2's weights
            out = out @ np.array([0.114, 0.587, 0.299], np.float32)
        if max_range == 65535.0:
            return (np.clip(out, 0, 1) * 65535.0).round().astype(
                np.uint16), img_mode
        return (np.clip(out, 0, 1) * 255.0).round().astype(np.uint8), img_mode

    def _run(self, img: np.ndarray) -> np.ndarray:
        if self.tile:
            return self.tile_process(img)
        padded, h, w = self.pre_process(img)
        return self.post_process(self._apply(padded[None])[0], h, w)
