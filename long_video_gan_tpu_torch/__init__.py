"""long_video_gan_tpu_torch — the PyTorch/CUDA port of `long_video_gan_tpu`.

Runs two-stage long-video generation (lres 36x64 video, then streamed 144x256
super-resolution) on one NVIDIA Hopper GPU. The JAX package beside it is the
reference: every module here has a counterpart of the same name there, and the
tests hold each one against it on the same weights and inputs.

Layout (mirrors `long_video_gan_tpu`):
  ops/       bias_act, upfirdn2d, filtered_lrelu (+ its CUDA kernel wrapper)
  csrc/      CUDA C++ kernels, built with nvcc at first use
  models/    lres and sres generators
  io/        `.lvg` checkpoint reader and JAX-variable loading
  utils/     shape asserts, nvcc build helper
  generate.py  the two-stage generation entry point and CLI

This package imports torch, numpy and scipy, never jax or flax.
"""

__version__ = "0.1.0"
