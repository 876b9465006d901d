"""Scan and GDFN entry points: CUDA kernels and their plain versions."""
