"""Image I/O and array helpers of the port, with its own PNG codec.

Counterpart of `vmambair_tpu/utils/img_util.py`, which is built on `cv2`;
the machine with the card has no `cv2`, so the port reads and writes PNG
itself, with `zlib` and numpy: 8- and 16-bit gray, gray + alpha, RGB and
RGBA, all five row filters, no interlace. Decoded images come back as
`cv2` gives them: BGR (BGRA) channel order, HWC, uint16 for a 16-bit file
read "unchanged" and uint8 otherwise (a 16-bit sample's high byte), and a
colour file read as "grayscale" with libpng's fixed-point weights, which
`cv2.IMREAD_GRAYSCALE` uses. Any other format (JPEG, palette PNG,
interlaced PNG) goes to `cv2` where it is installed and raises a clear
error where it is not.

Also the array helpers of the JAX module: `img2batch`, `batch2img`,
`pad_to_multiple`, `padding` (numpy's `symmetric` mode: `cv2.BORDER_REFLECT`
repeats the edge pixel, which numpy's `reflect` does not) and
`crop_border`.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Sequence, Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
# libpng's RGB -> gray weights in 1/32768 (png_set_rgb_to_gray with
# 0.299 / 0.587, which cv2's PNG reader asks for): 8-bit samples are
# truncated, 16-bit ones rounded, then cut to their high byte
_GRAY_RC, _GRAY_GC = 9797, 19234
_GRAY_BC = 32768 - _GRAY_RC - _GRAY_GC


class UnsupportedPNG(ValueError):
    """A PNG the port's decoder does not read (it takes 8- and 16-bit gray,
    gray + alpha, RGB and RGBA without interlace)."""


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND: truncated file")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undoes the per-row filters of decompressed scanlines; returns
    (h, w, bpp) uint8."""
    rows = raw.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())} is not 0-4")
    filt = rows[:, 1:].reshape(h, w, bpp)
    if ftype.max(initial=0) <= 2:
        # None, Sub and Up: one vectorised step per row, many times faster
        # than the H + W steps on short diagonals below (the port's encoder
        # writes Sub, so its datasets decode here)
        out = np.empty((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            f = ftype[r]
            if f == 0:
                out[r] = filt[r]
            elif f == 1:
                out[r] = np.cumsum(filt[r], axis=0, dtype=np.uint8)
            else:
                out[r] = filt[r] + prev
            prev = out[r]
        return out
    # Average and Paeth depend on the decoded left, upper and upper-left
    # pixels: decode along anti-diagonals r + x = k, each a vectorised step
    # over every row's own filter. P holds the image with a zero row on top
    # and a zero column on the left.
    P = np.zeros((h + 1, w + 1, bpp), np.int32)
    f32 = filt.astype(np.int32)
    ft = ftype.astype(np.int32)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(k, h - 1) + 1)
        x = k - r
        a, b, c = P[r + 1, x], P[r, x + 1], P[r, x]
        t = ft[r][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))
        P[r + 1, x + 1] = (f32[r, x] + pred) & 0xFF
    return P[1:, 1:].astype(np.uint8)


def png_decode(data: bytes) -> np.ndarray:
    """An 8- or 16-bit PNG -> HW (gray) or HWC uint8 / uint16 in the file's
    channel order (gray + alpha, RGB, RGBA). Raises UnsupportedPNG for
    other PNGs."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace:
        raise UnsupportedPNG(
            f"PNG of bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}: the port's decoder reads 8- and 16-bit gray, "
            "gray + alpha, RGB and RGBA without interlace")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8  # the filters work on bytes, a pixel's apart
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data of {raw.size} bytes for a {w}x{h} "
                         f"image of {bpp} bytes per pixel")
    img = _unfilter(raw, h, w, bpp)
    if depth == 16:  # big-endian samples
        img = img.reshape(h, w, ch, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    return img[:, :, 0] if ch == 1 else img


def _filter_rows(img: np.ndarray, ftype: int) -> np.ndarray:
    """Applies one filter type to every row of an (h, w, bpp) uint8 image;
    returns the filtered bytes (h, w, bpp) uint8."""
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def png_encode(img: np.ndarray, level: int = 3, ftype: int = 1) -> bytes:
    """HW or HWC uint8 or uint16 (1-4 channels, in PNG order: gray, gray +
    alpha, RGB, RGBA) -> an 8- or 16-bit PNG's bytes, every row with filter
    `ftype` (0-4: None, Sub, Up, Average, Paeth), zlib level `level`."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"png_encode: {img.dtype} image; the port writes "
                        "8- and 16-bit PNG only")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"png_encode: {ch} channels")
    if ftype not in range(5):
        raise ValueError(f"png_encode: filter type {ftype}")
    depth = 8 * img.dtype.itemsize
    if depth == 16:  # big-endian samples, filtered as bytes
        img = img.astype(">u2").view(np.uint8).reshape(h, w, 2 * ch)
    rows = _filter_rows(img, ftype).reshape(h, -1)
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8), rows], 1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB -> gray as libpng converts it for cv2's
    IMREAD_GRAYSCALE: 8-bit truncated, 16-bit rounded and cut to 8 bits."""
    r, g, b = (rgb[:, :, i].astype(np.int64) for i in range(3))
    acc = _GRAY_RC * r + _GRAY_GC * g + _GRAY_BC * b
    if rgb.dtype == np.uint16:
        return (((acc + 16384) >> 15) >> 8).astype(np.uint8)
    return (acc >> 15).astype(np.uint8)


def _from_png(img: np.ndarray, flag: str) -> np.ndarray:
    """A decoded PNG -> what cv2.imdecode gives for `flag`: a 16-bit image
    stays uint16 only "unchanged", else its high bytes; a colour image read
    as grayscale goes through libpng's weights."""
    if flag == "grayscale" and img.ndim == 3 and img.shape[2] >= 3:
        return _rgb_to_gray(img[:, :, :3])
    if img.dtype == np.uint16 and flag != "unchanged":
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        gray, alpha, col = img, None, None
    else:
        ch = img.shape[2]
        alpha = img[:, :, ch - 1] if ch in (2, 4) else None
        gray = img[:, :, 0] if ch == 2 else None
        col = img[:, :, 2::-1] if ch >= 3 else None  # RGB -> BGR
    if flag == "grayscale":
        return gray
    if flag == "color" or (flag == "unchanged" and alpha is None):
        if col is None:
            return gray if flag == "unchanged" else np.repeat(
                gray[:, :, None], 3, axis=2)
        return np.ascontiguousarray(col)
    if col is None:  # unchanged gray + alpha: cv2 gives BGRA
        col = np.repeat(gray[:, :, None], 3, axis=2)
    return np.dstack([col, alpha])


_CV2_FLAGS = {"color": "IMREAD_COLOR", "grayscale": "IMREAD_GRAYSCALE",
              "unchanged": "IMREAD_UNCHANGED"}


def imfrombytes(content: bytes, flag: str = "color",
                float32: bool = False) -> np.ndarray:
    """Image bytes -> BGR HWC uint8 (float32 / 255 with `float32`); `flag`
    is "color", "grayscale" or "unchanged", as for cv2 (a 16-bit PNG read
    "unchanged" is uint16, and float32 still divides by 255, as
    `astype(np.float32) / 255` of cv2's array does)."""
    if flag not in _CV2_FLAGS:
        raise ValueError(f"flag {flag!r}")
    img = None
    if content[:8] == PNG_SIGNATURE:
        try:
            img = _from_png(png_decode(content), flag)
        except UnsupportedPNG:
            if _cv2() is None:
                raise
    if img is None:
        cv2 = _cv2()
        if cv2 is None:
            raise ValueError(
                "imfrombytes: not a PNG the port reads, and cv2, which "
                "reads other formats, is not installed")
        img = cv2.imdecode(np.frombuffer(content, np.uint8),
                           getattr(cv2, _CV2_FLAGS[flag]))
        if img is None:
            raise ValueError("imfrombytes: cv2 could not decode the image")
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imread(path: str, flag: str = "color", float32: bool = False):
    with open(path, "rb") as f:
        return imfrombytes(f.read(), flag, float32)


def imwrite(img: np.ndarray, file_path: str, params=None,
            auto_mkdir: bool = True) -> bool:
    """Writes an HW / HWC BGR(A) image; `.png` with the port's encoder
    (uint8 or uint16 as 8- or 16-bit; `params` may hold cv2's
    `[IMWRITE_PNG_COMPRESSION (16), level]`), any other extension through
    cv2."""
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
    params = list(params or [])
    if file_path.lower().endswith(".png") and img.dtype in (np.uint8,
                                                             np.uint16):
        level = params[params.index(16) + 1] if 16 in params[::2] else 3
        if img.ndim == 3 and img.shape[2] >= 3:  # BGR(A) -> RGB(A)
            img = np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], 2)
        with open(file_path, "wb") as f:
            f.write(png_encode(img, level=int(level)))
        return True
    cv2 = _cv2()
    if cv2 is None:
        raise ValueError(
            f"imwrite {file_path}: the port writes 8- and 16-bit PNG "
            f"itself; this {img.dtype} image or extension needs cv2, which "
            "is not installed")
    return cv2.imwrite(file_path, img, params)


def img2batch(imgs: Union[np.ndarray, Sequence[np.ndarray]],
              bgr2rgb: bool = True) -> np.ndarray:
    """HWC BGR float32 image(s) -> (N, H, W, C) RGB float32 batch."""
    if isinstance(imgs, np.ndarray):
        imgs = [imgs]
    out = []
    for img in imgs:
        if img.ndim == 2:
            img = img[..., None]
        if bgr2rgb and img.shape[2] == 3:
            img = img[..., ::-1]
        out.append(np.ascontiguousarray(img, dtype=np.float32))
    return np.stack(out, axis=0)


def batch2img(tensor, rgb2bgr: bool = True, out_type=np.uint8,
              min_max=(0, 1)) -> Union[np.ndarray, List[np.ndarray]]:
    """(N, H, W, C) or (H, W, C) float -> HWC BGR uint8 image(s), clamped
    to min_max then rescaled (the reference's `tensor2img`)."""
    arr = np.asarray(tensor, dtype=np.float32)
    single = arr.ndim == 3
    if single:
        arr = arr[None]
    arr = (np.clip(arr, *min_max) - min_max[0]) / (min_max[1] - min_max[0])
    outs = []
    for img in arr:
        if rgb2bgr and img.shape[2] == 3:
            img = img[..., ::-1]
        if img.shape[2] == 1:
            img = img[..., 0]
        if out_type == np.uint8:
            img = (img * 255.0).round().astype(np.uint8)
        else:
            img = img.astype(out_type)
        outs.append(img)
    return outs[0] if single else outs


def pad_to_multiple(img: np.ndarray, factor: int) -> np.ndarray:
    """Reflect-pad an HWC (or NHWC) image so H, W are multiples of factor
    (the reference's `pad_test`)."""
    h, w = img.shape[-3:-1]
    ph = (factor - h % factor) % factor
    pw = (factor - w % factor) % factor
    if ph == 0 and pw == 0:
        return img
    pad = [(0, 0)] * (img.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
    return np.pad(img, pad, mode="reflect")


def padding(img_lq: np.ndarray, img_gt: np.ndarray, gt_size: int):
    """Pads both images at the bottom and right up to at least gt_size,
    repeating the edge pixel (cv2.BORDER_REFLECT, numpy's `symmetric`)."""
    h, w = img_lq.shape[:2]
    ph, pw = max(0, gt_size - h), max(0, gt_size - w)
    if ph == 0 and pw == 0:
        return img_lq, img_gt

    def pad(img):
        return np.pad(img, [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2),
                      mode="symmetric")

    return pad(img_lq), pad(img_gt)


def crop_border(img, border: int):
    if border == 0:
        return img
    return img[..., border:-border, border:-border, :]
