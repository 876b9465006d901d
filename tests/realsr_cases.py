"""Shared inputs of the RealSR tests: the degradation ranges of
`options/mambaSR11_x4.yml`, seeded blur and sinc kernels, NHWC <-> NCHW,
and `JaxSampler`, the synthesis sampler over JAX's draws. JAX is imported
only where `JaxSampler` draws: the card's tests use this module too."""

import numpy as np
import torch

from vmambair_torch.data.degradations import (
    circular_lowpass_kernel,
    pad_kernel,
    random_mixed_kernels,
)

SYNTH = dict(
    resize_prob=[0.2, 0.7, 0.1], resize_range=[0.15, 1.5],
    gaussian_noise_prob=0.5, noise_range=[1, 30],
    poisson_scale_range=[0.05, 3], gray_noise_prob=0.4,
    jpeg_range=[30, 95], second_blur_prob=0.8,
    resize_prob2=[0.3, 0.4, 0.3], resize_range2=[0.3, 1.2],
    gaussian_noise_prob2=0.5, noise_range2=[1, 25],
    poisson_scale_range2=[0.05, 2.5], gray_noise_prob2=0.4,
    jpeg_range2=[30, 95])
FAMILIES = ["iso", "aniso", "generalized_iso", "generalized_aniso",
            "plateau_iso", "plateau_aniso"]


def kernels(b, seed):
    """b seeded blur kernels of every family for each order and b sinc
    kernels, each (b, 21, 21) float32."""
    rng = np.random.RandomState(seed)
    k1, k2, sinc = [], [], []
    for _ in range(b):
        for out, sig in ((k1, (0.2, 3)), (k2, (0.2, 1.5))):
            size = int(rng.choice([7, 9, 13, 21]))
            out.append(pad_kernel(random_mixed_kernels(
                FAMILIES, [1 / 6] * 6, size, sig, sig, rng=rng), 21))
        sinc.append(circular_lowpass_kernel(rng.uniform(np.pi / 3, np.pi),
                                            int(rng.choice([7, 11, 21])),
                                            pad_to=21))
    return [np.stack(k).astype(np.float32) for k in (k1, k2, sinc)]


def nchw(x):
    """An NHWC array (numpy or JAX) -> an NCHW torch tensor."""
    return torch.from_numpy(np.array(np.transpose(np.asarray(x),
                                                  (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().cpu().numpy(), (0, 2, 3, 1))


class JaxSampler:
    """The port's sampler interface over JAX's draws: normals from
    `normals[tag]` (NHWC arrays of JAX), Poisson samples from
    `jax.random.poisson(keys[tag], rate)` at the port's rate (NCHW ->
    NHWC: JAX's element order)."""

    def __init__(self, normals=None, keys=None):
        self.normals, self.keys = normals or {}, keys or {}

    def normal(self, shape, tag):
        out = nchw(self.normals[tag])
        assert tuple(out.shape) == tuple(shape), (tag, out.shape, shape)
        return out

    def poisson(self, rate, tag):
        import jax
        import jax.numpy as jnp

        return nchw(jax.random.poisson(self.keys[tag],
                                       jnp.asarray(nhwc(rate))))
