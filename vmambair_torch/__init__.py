"""VmambaIR in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of `vmambair_tpu` (JAX/Flax/Pallas), which stays the reference. The
layout mirrors it: `ops/` (the scan, GDFN and OSS front/tail kernels with
their plain versions), `models/`, `data/`, `train/`, `losses/`, `metrics/`,
`utils/`, and `inference.py`. The CUDA sources are in `csrc/` and are built
by `_build.py` at first use.
"""
