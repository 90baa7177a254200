"""long_video_gan_tpu_torch — the PyTorch/CUDA port of `long_video_gan_tpu`.

Runs two-stage long-video generation (lres 36x64 video, then streamed 144x256
super-resolution), both GAN trainers (low-res and super-resolution, on one
GPU or several over torch.distributed) and the quality metrics (FVD, FID,
KID, IS, video IS) on NVIDIA Hopper GPUs.
The JAX package beside it is the reference: every module here has a
counterpart of the same name there, and the tests hold each one against it on
the same weights and inputs.

Layout (mirrors `long_video_gan_tpu`):
  ops/       bias_act, upfirdn2d, conv2d_resample, grid_sample, filtered_lrelu
             (+ its CUDA kernels' wrapper)
  csrc/      CUDA C++ kernels, built with nvcc at first use
  models/    lres and sres generators and discriminators, ADA, DiffAugment
  train/     Adam, EMA, temporal augmentations, statistics, both GAN trainers
             and their train state in `.lvg`
  io/        `.lvg` checkpoint reader and writer, JAX-variable and
             reference-state_dict conversion
  data/      ZIP-of-JPEG datasets, the loader, the JPEG decoder, the
             dataset tools (synthetic, from frames, videos, YouTube clips)
  metrics/   feature statistics, the I3D / InceptionV3 / C3D detectors and
             their weight converters, the sampling protocols, the registry
  parallel/  several processes: launch, the global-batch collectives,
             time-sharded lres synthesis
  utils/     shape asserts, nvcc build helper, URL fetching, profiling
  generate.py      the two-stage generation entry point and CLI
  calc_metrics.py  the metric CLI
  train_lres.py    the lres training CLI
  train_sres.py    the sres training CLI
  bench_train.py   the training-throughput benchmark
  convert_checkpoint.py     reference G_ema pickles to `.lvg`
  plot_color_similarity.py  the color-drift figure

This package imports torch, numpy and scipy, never jax or flax; the dataset
tools also PIL (and OpenCV for videos), the figure matplotlib.
"""

__version__ = "0.1.0"
