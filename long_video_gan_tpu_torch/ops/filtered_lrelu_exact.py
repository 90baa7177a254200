"""The f32-exact filtered_lrelu forward: the Hopper kernel K4 of
csrc/filtered_lrelu_exact_tc.cu (the four banded products with every operand
and stage in three bf16 parts on the tensor cores, f32 stages whatever the
maps' type), reached through `filtered_lrelu(impl="pallas")`.

Counterpart of `long_video_gan_tpu/ops/pallas/filtered_lrelu_kernel.py`
`filtered_lrelu_pallas`: the maps cast to f32, every product and sum in f32,
the output in the maps' type. Forward only: the JAX kernel's `pallas_call`
has no gradient, and here a gradient through it raises. The port mirrors
the JAX kernel's limits with a ValueError: a top crop of `up` rows or more
(`_h_band_matrices` makes its top pad ceil(py0 / up) negative, which
`jnp.pad` refuses), and an `up` that does not divide 16 * down (its band
matrices assert it). It computes every other padding and factor.

A CUDA tensor launches K4 or raises; a CPU tensor takes its plain version,
`exact_plain`: the composed op in f32, cast to the maps' type. Nothing
CUDA-specific is built until the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..utils.nvcc import load_library
from .filtered_lrelu import filtered_lrelu_composed
from .filtered_lrelu_cuda import (TC_FWD_ARGS, TILE, check_input, kernel_geometry,
                                  launch_tc_fwd, raise_on_error)
from .upfirdn2d import Filter, parse_padding

SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_exact_tc.cu"

# Kernel launches since the last reset (the caller sets it to 0).
launches = 0

# bf16 parts of every operand and stage, on either map type.
PARTS = 3


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load K4 and K5, one source."""
    return load_library("filtered_lrelu_exact_tc.cu", {
        f"lvg_{kernel}_tc_fwd_{suffix}": TC_FWD_ARGS
        for kernel in ("exact", "polyphase") for suffix in ("bf16", "f32")})


def check_limits(entry: str, fu: Filter, fd: Filter, up: int, down: int, padding) -> None:
    """Raise ValueError where the JAX package's K4 and K5 kernels fail: a
    2-D filter, an `up` that does not divide 16 * down, or a top crop of
    `up` rows or more."""
    for f in (fu, fd):
        if f is not None and f.ndim != 1:
            raise ValueError(f"{entry} takes separable (1-D) filters, got shape "
                             f"{tuple(f.shape)}")
    if (16 * down) % up:
        raise ValueError(f"{entry}: up={up} must divide 16 * down = {16 * down} (the JAX "
                         f"package's kernel asserts it in `_h_band_matrices`, "
                         f"ops/pallas/filtered_lrelu_kernel.py)")
    py0 = parse_padding(padding)[2]
    if -(-py0 // up) < 0:
        raise ValueError(
            f"{entry}: padding py0={py0} crops {-py0} rows at the top with up={up}; the JAX "
            f"package's kernel takes py0 > -up only (`_h_band_matrices`, "
            f"ops/pallas/filtered_lrelu_kernel.py, pads the top by ceil(py0 / up), which "
            f"jnp.pad refuses when negative)")


def exact_plain(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding,
                gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    """K4's plain version on bias-added `x`: the composed op in f32, cast to
    x's dtype."""
    return filtered_lrelu_composed(x.float(), fu, fd, None, up=up, down=down, padding=padding,
                                   gain=gain, slope=slope, clamp=clamp).to(x.dtype)


class ForwardOnly(torch.autograd.Function):
    """A forward-only kernel (the plain version on a CPU tensor); its gradient
    raises, as `jax.grad` through the JAX kernel's `pallas_call` fails."""

    @staticmethod
    def forward(ctx, x, plain, kernel, entry, args):
        ctx.entry = entry
        return (plain if x.device.type == "cpu" else kernel)(x, *args)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            f"{ctx.entry} is forward-only: its kernel has no gradient, as the JAX package's "
            f"pallas_call has none. To differentiate, select impl='conv'.")


def filtered_lrelu_exact(x: torch.Tensor, fu: Filter = None, fd: Filter = None,
                         b: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                         padding=0, gain: float = math.sqrt(2.0), slope: float = 0.2,
                         clamp: Optional[float] = None) -> torch.Tensor:
    """filtered_lrelu on NCHW maps with separable filters, forward only."""
    entry = "filtered_lrelu impl='pallas' (K4)"
    check_limits(entry, fu, fd, int(up), int(down), padding)
    if b is not None:
        x = x + b.reshape(1, -1, 1, 1).to(x.dtype)
    args = (fu, fd, int(up), int(down), parse_padding(padding), float(gain), float(slope),
            clamp)
    return ForwardOnly.apply(x, exact_plain, exact_fwd_cuda, entry, args)


def launch_fwd(kernel: str, x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int,
               padding, gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    """Launch `kernel` ("exact": K4, "polyphase": K5) of `library()` on
    bias-added NCHW `x` (f32 or bf16, contiguous, on a CUDA device): the
    tensor-core forward over 32-wide tiles (T * down is a multiple of every
    `up` the JAX kernels take), operators in PARTS bf16 parts; returns a new
    tensor of x's dtype."""
    check_input(x, "tensor")
    geometry = kernel_geometry(x, fu, fd, up, down, padding)
    y = torch.empty(tuple(x.shape[:2]) + geometry[1:3], dtype=x.dtype, device=x.device)
    lib = library()
    suffix = "bf16" if x.dtype == torch.bfloat16 else "f32"
    with torch.cuda.device(x.device):
        rc = launch_tc_fwd(getattr(lib, f"lvg_{kernel}_tc_fwd_{suffix}"), x, y, up, down,
                           geometry, gain, slope, clamp, TILE, PARTS)
    raise_on_error(lib, rc, kernel)
    return y


def exact_fwd_cuda(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding,
                   gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    """Launch K4 on bias-added NCHW `x`."""
    global launches
    y = launch_fwd("exact", x, fu, fd, up, down, padding, gain, slope, clamp)
    launches += 1
    return y
