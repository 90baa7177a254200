"""The polyphase filtered_lrelu forward for up, down in {1, 2}: the Hopper
kernel K5 of csrc/filtered_lrelu_polyphase.cu, reached through its own entry
point `filtered_lrelu_pallas_v2`, as in the JAX package.

Counterpart of `long_video_gan_tpu/ops/pallas/filtered_lrelu_v2.py`
`filtered_lrelu_pallas_v2`, with its signature: f32 inside, the output in the
maps' type, forward only. It raises ValueError where the JAX kernel fails: up
or down outside {1, 2} (where JAX asserts), a 2-D filter, or a top crop of
`up` rows or more (the limit it shares with K4, `filtered_lrelu_exact.py`).

A CUDA tensor launches K5 or raises; a CPU tensor takes its plain version,
`polyphase_plain`: the composed op in f32, cast to the maps' type, which is
K4's plain version too (the two kernels compute one function).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..utils.nvcc import load_library
from .filtered_lrelu_cuda import GEOMETRY_ARGS
from .filtered_lrelu_exact import ForwardOnly, check_limits, launch_fwd
from .filtered_lrelu_exact import exact_plain as polyphase_plain
from .upfirdn2d import Filter, parse_padding

SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_polyphase.cu"

# Kernel launches since the last reset (the caller sets it to 0).
launches = 0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load K5."""
    args = [ctypes.c_void_p] * 2 + GEOMETRY_ARGS + [ctypes.c_void_p]
    return load_library("filtered_lrelu_polyphase.cu", {"lvg_polyphase_fwd_f32": args,
                                                        "lvg_polyphase_fwd_bf16": args})


def filtered_lrelu_pallas_v2(x: torch.Tensor, fu: Filter = None, fd: Filter = None,
                             b: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                             padding=0, gain: float = math.sqrt(2.0), slope: float = 0.2,
                             clamp: Optional[float] = None) -> torch.Tensor:
    """filtered_lrelu on NCHW maps with separable filters, up and down in
    {1, 2}, forward only."""
    entry = "filtered_lrelu_pallas_v2 (K5)"
    if up not in (1, 2) or down not in (1, 2):
        raise ValueError(f"{entry} takes up and down in {{1, 2}}, got up={up}, down={down} "
                         f"(the JAX package's kernel asserts it)")
    check_limits(entry, fu, fd, int(up), padding)
    assert x.ndim == 4, f"expected NCHW input, got {tuple(x.shape)}"
    if b is not None:
        x = x + b.reshape(1, -1, 1, 1).to(x.dtype)
    args = (fu, fd, int(up), int(down), parse_padding(padding), float(gain), float(slope),
            clamp)
    return ForwardOnly.apply(x, polyphase_plain, polyphase_fwd_cuda, entry, args)


def polyphase_fwd_cuda(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding,
                       gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    """Launch K5 on bias-added NCHW `x`."""
    global launches
    y = launch_fwd(library, "lvg_polyphase_fwd", x, fu, fd, up, down, padding, gain, slope,
                   clamp)
    launches += 1
    return y
