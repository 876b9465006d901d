"""The port's `enhance(outscale=...)` and its Lanczos-4 resize
(`vmambair_torch/utils/resize.py`) against cv2 and the JAX package.

The resize is held against `cv2.resize(..., interpolation=INTER_LANCZOS4)`
on float32 images within 1e-5 absolute: up and down, integer and
non-integer factors, 1, 3 and 4 channels. `enhance` is held against the
JAX package's `RestorationUpscaler.enhance` with a tiny OSSNet whose
perturbed weights are carried across by `jax_to_torch`: gray, RGB and RGBA,
uint8 and uint16, outscale 2 and 3.5, within 1 code value. The port runs in
a subprocess with JAX, cv2 and the JAX package blocked, so the resize it
takes there is its own. Inputs come from `numpy.random.RandomState`.
"""

import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmambair_tpu.models import OSSNet as JaxOSSNet
from vmambair_tpu.utils.upscaler import RestorationUpscaler as JaxUpscaler
from vmambair_torch.utils.convert import jax_to_torch
from vmambair_torch.utils.resize import resize_lanczos4

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            scale=4, tail="pixelshuffle")
UPS = dict(tile=8, tile_pad=4, tile_batch=2)  # patches of 16
BLOCKED = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'cv2', 'yaml', "
           "'vmambair_tpu', 'tools'):\n"
           "    sys.modules[m] = None\n")


@pytest.mark.parametrize("h,w,c,oh,ow", [
    (12, 12, 3, 24, 24),    # up x2
    (12, 10, 3, 42, 35),    # up x3.5
    (9, 13, 1, 40, 17),     # up, a factor per axis, one channel
    (20, 14, 4, 70, 49),    # up x3.5, four channels
    (64, 48, 3, 16, 12),    # down x4
    (64, 48, 4, 23, 37),    # down by one axis, up by the other
    (40, 33, 0, 17, 91),    # a 2-D gray image
    (30, 30, 3, 30, 30),    # same size
    (5, 5, 3, 80, 80),      # up x16: taps past both borders
])
def test_lanczos4_matches_cv2(h, w, c, oh, ow):
    rng = np.random.RandomState(h * w + oh)
    img = rng.rand(h, w, max(c, 1)).astype(np.float32)
    if c <= 1:
        img = img[:, :, 0]
    ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LANCZOS4)
    got = resize_lanczos4(torch.from_numpy(img), (oh, ow)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _image(mode, dtype, seed):
    top = 65535 if dtype == np.uint16 else 255
    shape = {"L": (12, 12), "RGB": (12, 12, 3), "RGBA": (12, 12, 4)}[mode]
    return (np.random.RandomState(seed).rand(*shape) * top).astype(dtype)


CASES = [(mode, dtype, outscale)
         for mode in ("L", "RGB", "RGBA")
         for dtype in (np.uint8, np.uint16)
         for outscale in (2, 3.5)]


def _key(mode, dtype, outscale):
    return f"{mode}_{np.dtype(dtype).name}_{outscale}"


@pytest.fixture(scope="module")
def enhanced(tmp_path_factory):
    """key -> (JAX output, its mode, the port's output, its mode) for every
    case; the port's outputs from one subprocess with cv2 and JAX
    blocked."""
    tmp = tmp_path_factory.mktemp("enhance")
    model = JaxOSSNet(scan_impl="xla", **TINY)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)).astype(
            np.float32), params)
    torch.save(jax_to_torch(params), tmp / "net.pth")
    jax_ups = JaxUpscaler(4, model, {"params": params}, **UPS)
    images, ref = {}, {}
    for i, case in enumerate(CASES):
        k = _key(*case)
        images[k] = _image(case[0], case[1], 30 + i)
        ref[k] = jax_ups.enhance(images[k], outscale=case[2])
    np.savez(tmp / "in.npz", **images)
    code = BLOCKED + f"""
import numpy as np, torch
torch.set_num_threads(1)
from vmambair_torch.models import OSSNet
from vmambair_torch.utils.upscaler import RestorationUpscaler
net = OSSNet(**{TINY!r})
net.load_state_dict(torch.load({str(tmp / "net.pth")!r}))
ups = RestorationUpscaler(4, net, "cpu", **{UPS!r})
data = np.load({str(tmp / "in.npz")!r})
out = {{}}
for k in data.files:
    img, mode = ups.enhance(data[k], outscale=float(k.split("_")[-1]))
    out[k], out[k + "_mode"] = img, np.array(mode)
np.savez({str(tmp / "out.npz")!r}, **out)
assert sys.modules["cv2"] is None
"""
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
    got = np.load(tmp / "out.npz")
    return {k: (*ref[k], got[k], str(got[k + "_mode"])) for k in images}


@pytest.mark.parametrize("mode,dtype,outscale", CASES)
def test_enhance_outscale_matches_jax(enhanced, mode, dtype, outscale):
    ref, ref_mode, got, got_mode = enhanced[_key(mode, dtype, outscale)]
    side = int(12 * outscale)
    shape = (side, side) if mode == "L" else (side, side, len(mode))
    assert got_mode == ref_mode == mode
    assert got.shape == ref.shape == shape
    assert got.dtype == ref.dtype == dtype
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64)).max()
    assert diff <= 1, f"{diff} code values apart"
