"""Small shared helpers (shape contracts, the CLIs' device, matmul precision
and recompute options)."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def assert_shape(x, ref_shape: Sequence[Optional[int]]) -> None:
    """Assert `x.shape` matches `ref_shape`; None entries are wildcards.

    Counterpart of `long_video_gan_tpu.utils.misc.assert_shape`.
    """
    if x.ndim != len(ref_shape):
        raise AssertionError(f"Wrong number of dimensions: got {x.ndim}, expected {len(ref_shape)}")
    for idx, (size, ref_size) in enumerate(zip(x.shape, ref_shape)):
        if ref_size is not None and int(size) != int(ref_size):
            raise AssertionError(f"Wrong size for dimension {idx}: got {size}, expected {ref_size}")


def cli_device(name: str) -> torch.device:
    """The device a CLI runs on: `--device` as given (default "cuda"). A CUDA
    device that is not there raises before anything is built; the CPU runs
    only when asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; pass "
                           f"--device cpu to run on the CPU")
    return device


def set_matmul_precision(precision: str) -> None:
    """The trainers' `--matmul-precision`: "highest" turns TF32 off for cuDNN
    convolutions and matmuls (the reference's f32), "high" allows it in
    matmuls too, "default" leaves PyTorch's flags as they are."""
    if precision == "highest":
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif precision == "high":
        torch.set_float32_matmul_precision("high")


def add_remat_options(parser: argparse.ArgumentParser) -> None:
    """The training CLIs' `--remat` and `--block-remat` (the JAX CLIs' flags,
    the same names and defaults)."""
    parser.add_argument("--remat", action="store_true",
                        help="recompute each G and D micro-batch loss in the backward "
                             "(torch.utils.checkpoint): less memory, more time")
    parser.add_argument("--block-remat", action="store_true",
                        help="recompute each of G's blocks in the backward "
                             "(torch.utils.checkpoint): G's activations one block at a time")
