"""filtered_lrelu — StyleGAN3's fused upsample -> bias -> leaky ReLU -> clamp ->
downsample, for a batch of 2D maps [N, C, H, W].

Counterpart of `long_video_gan_tpu/ops/filtered_lrelu.py`. Semantics:

  1. add channel bias `b`
  2. zero-stuff upsample by `up`, pad by `padding`, convolve with `fu`
     (overall gain up**2 so DC magnitude is preserved)
  3. multiply by `gain`, leaky-ReLU with `slope`, clamp to [-clamp, clamp]
  4. convolve with `fd`, decimate by `down`

  out_w = (in_w*up + px0 + px1 - (fu_w-1) - (fd_w-1) + (down-1)) // down

`filtered_lrelu_composed` is that sequence in plain PyTorch, and the plain
version of the Hopper kernel in `filtered_lrelu_cuda.py`. `impl` selects:

  "conv", "matrix"  the composed path
  "packed"          the kernel (the JAX package's lane-packed Pallas kernel on
                    the TPU); a CPU tensor takes the plain version
  "fused", "pallas" raise: their kernels are not ported yet (ROADMAP.md
                    Queue 2, K3 and K4)

Identity resamples (up == down == 1 with 1-tap filters) and `flip_filter`
always take the composed path, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .bias_act import bias_act
from .upfirdn2d import Filter, filter_size, parse_padding, upfirdn2d


def auto_impl_policy(up_factor: int, in_pixels: int, use_fp16: bool = True) -> str:
    """Backend for `impl="auto"`: the kernel for every bf16 layer, the composed
    path for the f32 head layers (the JAX package's policy on its measured
    chip). A CPU tensor given "packed" takes the plain version in the wrapper,
    so the choice does not depend on the device here."""
    del up_factor, in_pixels
    return "packed" if use_fp16 else "matrix"


def filtered_lrelu(
    x: torch.Tensor,
    fu: Filter = None,
    fd: Filter = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = math.sqrt(2.0),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
    impl: str = "conv",
) -> torch.Tensor:
    assert x.ndim == 4, f"expected NCHW input, got {tuple(x.shape)}"
    if impl in ("fused", "pallas"):
        raise NotImplementedError(
            f"filtered_lrelu impl={impl!r}: its kernel is not ported yet "
            f"(ROADMAP.md Queue 2, {'K3' if impl == 'fused' else 'K4'}); "
            f"use impl='packed' or 'conv'")
    if impl == "packed":
        fu_w, fu_h = filter_size(fu)
        fd_w, fd_h = filter_size(fd)
        trivial = up == 1 and down == 1 and fu_w * fu_h == 1 and fd_w * fd_h == 1
        if not (trivial or flip_filter):
            from .filtered_lrelu_cuda import filtered_lrelu_packed

            return filtered_lrelu_packed(x, fu, fd, b, up=up, down=down, padding=padding,
                                         gain=gain, slope=slope, clamp=clamp)
    elif impl not in ("conv", "matrix"):
        raise ValueError(f"unknown filtered_lrelu impl: {impl!r}")
    return filtered_lrelu_composed(x, fu, fd, b, up=up, down=down, padding=padding,
                                   gain=gain, slope=slope, clamp=clamp,
                                   flip_filter=flip_filter)


def filtered_lrelu_composed(
    x: torch.Tensor,
    fu: Filter = None,
    fd: Filter = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = math.sqrt(2.0),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
) -> torch.Tensor:
    """The composed op: bias_act -> upfirdn2d -> lrelu/clamp -> upfirdn2d."""
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    assert gain > 0 and slope >= 0
    assert clamp is None or clamp >= 0
    px0, px1, py0, py1 = parse_padding(padding)
    out_h, out_w = output_size(x.shape[2], x.shape[3], fu, fd, up, down,
                               (px0, px1, py0, py1))

    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up**2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    x = upfirdn2d(x, fd, down=down, flip_filter=flip_filter)

    assert x.shape[2] == out_h and x.shape[3] == out_w, (
        f"filtered_lrelu shape mismatch: got {tuple(x.shape[2:])}, expected {(out_h, out_w)}")
    return x


def output_size(in_h: int, in_w: int, fu: Filter, fd: Filter, up: int, down: int,
                padding) -> tuple[int, int]:
    """(out_h, out_w) of filtered_lrelu for an `in_h` x `in_w` map."""
    px0, px1, py0, py1 = parse_padding(padding)
    fu_w, fu_h = filter_size(fu)
    fd_w, fd_h = filter_size(fd)
    out_w = (in_w * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (in_h * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down
    return out_h, out_w
