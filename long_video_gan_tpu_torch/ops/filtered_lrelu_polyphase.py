"""The polyphase filtered_lrelu forward for up, down in {1, 2}: the Hopper
kernel K5, reached through its own entry point `filtered_lrelu_pallas_v2`,
as in the JAX package.

Counterpart of `long_video_gan_tpu/ops/pallas/filtered_lrelu_v2.py`
`filtered_lrelu_pallas_v2`, with its signature: f32 inside, the output in the
maps' type, forward only. It raises ValueError where the JAX kernel fails: up
or down outside {1, 2} (where JAX asserts), a 2-D filter, or a top crop of
`up` rows or more (the limit it shares with K4, `filtered_lrelu_exact.py`).

The JAX kernel's polyphase split is a TPU layout of the same function as K4
(its products name no precision, and its interpret run, which the port is
held to, is exact f32). So K5 is K4's tensor-core body under a kernel name of
its own, `filtered_lrelu_polyphase_tc_kernel` in csrc/filtered_lrelu_exact_tc.cu
(one library with K4), with its own launch count.

A CUDA tensor launches K5 or raises; a CPU tensor takes its plain version,
`polyphase_plain`: the composed op in f32, cast to the maps' type, which is
K4's plain version too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .filtered_lrelu_exact import SOURCE as SOURCE   # one source and library with K4
from .filtered_lrelu_exact import ForwardOnly, check_limits, launch_fwd
from .filtered_lrelu_exact import exact_plain as polyphase_plain
from .upfirdn2d import Filter, parse_padding

# Kernel launches since the last reset (the caller sets it to 0).
launches = 0


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
    check_limits(entry, fu, fd, int(up), int(down), padding)
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
    y = launch_fwd("polyphase", x, fu, fd, up, down, padding, gain, slope, clamp)
    launches += 1
    return y
