"""filtered_lrelu — StyleGAN3's fused upsample -> bias -> leaky ReLU -> clamp ->
downsample, for a batch of 2D maps [N, C, H, W].

Counterpart of `long_video_gan_tpu/ops/filtered_lrelu.py`. Semantics:

  1. add channel bias `b`
  2. zero-stuff upsample by `up`, pad by `padding`, convolve with `fu`
     (overall gain up**2 so DC magnitude is preserved)
  3. multiply by `gain`, leaky-ReLU with `slope`, clamp to [-clamp, clamp]
  4. convolve with `fd`, decimate by `down`

  out_w = (in_w*up + px0 + px1 - (fu_w-1) - (fd_w-1) + (down-1)) // down

`filtered_lrelu_composed` is that sequence in plain PyTorch. `impl` selects,
as in the JAX package:

  "conv", "matrix"  the composed path
  "packed"          K1 forward, K2 backward (`filtered_lrelu_cuda.py`; the
                    JAX package's lane-packed Pallas kernels), first-order
                    differentiable, with the TPU kernel's stage rounding to
                    the maps' type (`filtered_lrelu_bands.py`): bf16 maps on
                    the tensor cores, f32 maps in f32 FMA
  "fused"           K3a forward, K3b backward (`filtered_lrelu_fused.py`; the
                    whole-image operator-product kernels), first-order
                    differentiable, with the TPU kernel's bf16 stage rounding
  "pallas"          K4 (`filtered_lrelu_exact.py`; the f32-exact kernel),
                    forward only; a top crop of `up` or more rows raises, where
                    the JAX kernel fails
  "auto"            "packed", on every layer, bf16 and f32 (below)

`auto` differs from the JAX package's, which keeps its f32 layers on the
composed path ("matrix"), its choice on the v5e. On the H100 the composed path
runs the f32 head layers L0-L2 of the sres plan as depthwise convolutions over
the up^2-times-larger supersampled map in device memory: 9.99 ms of a
16-frame segment against 0.72 ms on the f32 kernels, and the kernel was the
faster route at every f32 layer of an all-f32 plan, forward and input
gradient (`scripts/torch_bench_layers.py --num-fp16-res 0`; PERF.md). A CPU
tensor takes the plain version in the wrapper, so the choice does not
depend on the device here.

For "packed" and "fused", identity resamples (up == down == 1 with 1-tap
filters) and `flip_filter` take the composed path, as in the JAX package;
"pallas" always takes K4. A CPU tensor takes each kernel's plain version in
its wrapper; a CUDA tensor launches the kernel or raises. The fifth kernel,
K5 (`filtered_lrelu_polyphase.py`), has no `impl`: as in the JAX package, it
is reached through its own entry point.

While a profiler records, each call opens the span `lvg.filtered_lrelu.<path>`
after dispatch, the path taken: `packed`, `fused`, `exact` (K4) or
`composed`; the kernels' backward opens `<span>.bwd` (`utils/profiling.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.profiling import annotate
from .bias_act import bias_act
from .upfirdn2d import Filter, filter_size, parse_padding, upfirdn2d


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
    kw = dict(up=up, down=down, padding=padding, gain=gain, slope=slope, clamp=clamp)
    if impl == "auto":
        impl = "packed"
    if impl == "pallas":
        from .filtered_lrelu_exact import filtered_lrelu_exact

        with annotate("lvg.filtered_lrelu.exact"):
            return filtered_lrelu_exact(x, fu, fd, b, **kw)
    if impl in ("packed", "fused"):
        fu_w, fu_h = filter_size(fu)
        fd_w, fd_h = filter_size(fd)
        trivial = up == 1 and down == 1 and fu_w * fu_h == 1 and fd_w * fd_h == 1
        if not (trivial or flip_filter):
            if impl == "packed":
                from .filtered_lrelu_cuda import filtered_lrelu_packed

                with annotate("lvg.filtered_lrelu.packed"):
                    return filtered_lrelu_packed(x, fu, fd, b, **kw)
            from .filtered_lrelu_fused import filtered_lrelu_fused

            with annotate("lvg.filtered_lrelu.fused"):
                return filtered_lrelu_fused(x, fu, fd, b, **kw)
    elif impl not in ("conv", "matrix"):
        raise ValueError(f"unknown filtered_lrelu impl: {impl!r}")
    with annotate("lvg.filtered_lrelu.composed"):
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
