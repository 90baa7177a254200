"""filtered_lrelu as four banded operator products: the Hopper kernels K3a
(forward) and K3b (gradient) of csrc/filtered_lrelu_fused_tc.cu, joined by a
`torch.autograd.Function`.

Counterpart of `long_video_gan_tpu/ops/pallas/filtered_lrelu_fused.py`
`filtered_lrelu_fused` and its `_fused_op` custom VJP. Per plane X:

    out = Ad . act(Au . X . Bu^T) . Bd^T
    dX  = Au^T . (act'(U) * (Ad^T . dY . Bd)) . Bu,   U = Au . X . Bu^T

with the banded per-axis operators of `filtered_lrelu_bands.operators`. The
function is these products in this order, with the TPU kernel's stores
between them: for bf16 maps the operators, t1 = Au . X, Z = act(U) and
t3 = Z . Bd^T (backward: t1, Ad^T . dY, dU and dU . Bu) round to bf16, and
every sum is f32; f32 maps stay in f32 throughout (the TPU kernel's
Precision.HIGHEST). Both run on the tensor cores over K1/K2's tile plans
(`filtered_lrelu_cuda.launch_tc_fwd`, `launch_tc_bwd`): bf16 maps on K1/K2's
kernel bodies, f32 maps with every operand in three bf16 parts
(`filtered_lrelu_bands.split_matmul`). The Function saves the bias-added
input and recomputes U in the backward. The backward is first-order only: it
is a Function of its own whose backward raises, as `_first_order_only` makes
the JAX VJP.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions, `banded_fwd_plain` and `banded_bwd_plain` (`filtered_lrelu_bands.py`,
shared with K1/K2, whose function this is too). Nothing CUDA-specific is built
until the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..utils.nvcc import load_library
from ..utils.profiling import annotate, backward_span
from . import filtered_lrelu_cuda as cuda
from .filtered_lrelu_bands import banded_bwd_plain, banded_fwd_plain
from .filtered_lrelu_cuda import (TC_BWD_ARGS, TC_BWD_U_ARGS, TC_FWD_ARGS, bwd_u_cuda,
                                  check_gradient, check_input, kernel_geometry, launch_tc_bwd,
                                  launch_tc_fwd, raise_on_error)
from .upfirdn2d import Filter, parse_padding

SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_fused_tc.cu"

# Kernel launches since the last reset (the caller sets them to 0).
fwd_launches = 0
bwd_launches = 0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load K3a and K3b."""
    return load_library("filtered_lrelu_fused_tc.cu", {
        "lvg_fused_tc_fwd_bf16": TC_FWD_ARGS, "lvg_fused_tc_fwd_f32": TC_FWD_ARGS,
        "lvg_fused_tc_bwd_bf16": TC_BWD_ARGS, "lvg_fused_tc_bwd_f32": TC_BWD_ARGS,
        "lvg_fused_tc_bwd_u_bf16": TC_BWD_U_ARGS, "lvg_fused_tc_bwd_u_f32": TC_BWD_U_ARGS})


def tile_for(backward: bool, dtype: torch.dtype, up: int) -> int:
    """The tile edge of a K3 launch: K1/K2's `TILE`, but half of it for the
    f32 backward at up 4, whose three-part stages need more than a block's
    227 KB of shared memory at 32 (tests/test_torch_packed_tiles.py holds
    every plan geometry's footprint to that)."""
    return cuda.TILE // 2 if backward and dtype == torch.float32 and up == 4 else cuda.TILE


def filtered_lrelu_fused(x: torch.Tensor, fu: Filter = None, fd: Filter = None,
                         b: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                         padding=0, gain: float = math.sqrt(2.0), slope: float = 0.2,
                         clamp: Optional[float] = None) -> torch.Tensor:
    """filtered_lrelu on NCHW maps with separable filters, differentiable to
    first order in x (and b): bias added here, then the Function."""
    if b is not None:
        x = x + b.reshape(1, -1, 1, 1).to(x.dtype)
    return _FusedFilteredLReLU.apply(x, fu, fd, int(up), int(down), parse_padding(padding),
                                     float(gain), float(slope), clamp)


class _FusedFilteredLReLU(torch.autograd.Function):
    """K3a forward, K3b backward (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, fu, fd, up, down, padding, gain, slope, clamp):
        ctx.save_for_backward(x)
        ctx.args = (fu, fd, up, down, padding, gain, slope, clamp)
        ctx.span = backward_span("lvg.filtered_lrelu.")
        fn = banded_fwd_plain if x.device.type == "cpu" else fused_fwd_cuda
        return fn(x, fu, fd, up, down, padding, gain, slope, clamp)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        with annotate(ctx.span):
            return (_FusedFilteredLReLUGrad.apply(x, dy, ctx.args),) + (None,) * 8


class _FusedFilteredLReLUGrad(torch.autograd.Function):
    """The backward as a node of its own, so that a second differentiation
    reaches it and raises (see `filtered_lrelu_cuda._FilteredLReLUGrad`)."""

    @staticmethod
    def forward(ctx, x, dy, args):
        fn = banded_bwd_plain if x.device.type == "cpu" else fused_bwd_cuda
        return fn(x, dy.contiguous(), *args)

    @staticmethod
    def backward(ctx, ddx):
        raise NotImplementedError(
            "filtered_lrelu impl='fused' is first-order only: its gradient is the K3b "
            "kernel, which has no gradient of its own. For second-order use, select "
            "impl='conv'; the composed path differentiates to any order.")


# ---------------------------------------------------------------------------
# The kernels.


def _suffix(x: torch.Tensor) -> str:
    return "bf16" if x.dtype == torch.bfloat16 else "f32"


def fused_fwd_cuda(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding,
                   gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    """Launch K3a on bias-added NCHW `x` (f32 or bf16, contiguous, on a CUDA
    device); returns a new tensor of the same dtype."""
    global fwd_launches
    check_input(x, "tensor")
    geometry = kernel_geometry(x, fu, fd, up, down, padding)
    y = torch.empty(tuple(x.shape[:2]) + geometry[1:3], dtype=x.dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        rc = launch_tc_fwd(getattr(lib, f"lvg_fused_tc_fwd_{_suffix(x)}"), x, y, up, down,
                           geometry, gain, slope, clamp, tile_for(False, x.dtype, up))
    raise_on_error(lib, rc, "fused forward")
    fwd_launches += 1
    return y


def fused_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, fu: Filter, fd: Filter, up: int,
                   down: int, padding, gain: float, slope: float,
                   clamp: Optional[float]) -> torch.Tensor:
    """Launch K3b: dX at bias-added NCHW `x` along `dy` (both of one dtype,
    contiguous, on one CUDA device); returns dX of x's dtype."""
    global bwd_launches
    check_input(x, "input")
    geometry = kernel_geometry(x, fu, fd, up, down, padding)
    check_gradient(x, dy, geometry[1:3], "fused backward")
    dx = torch.empty_like(x)
    lib = library()
    with torch.cuda.device(x.device):
        rc = launch_tc_bwd(getattr(lib, f"lvg_fused_tc_bwd_{_suffix(x)}"), x, dy, dx, up, down,
                           geometry, gain, slope, clamp, tile_for(True, x.dtype, up))
    raise_on_error(lib, rc, "fused backward")
    bwd_launches += 1
    return dx


def fused_bwd_u_cuda(x: torch.Tensor, dy: torch.Tensor, fu: Filter, fd: Filter, up: int,
                     down: int, padding, gain: float, slope: float,
                     clamp: Optional[float]) -> tuple:
    """K3b with each tile's U (`filtered_lrelu_cuda.bwd_u_cuda`), at the tile
    K3b takes; check-only, counts no launch."""
    return bwd_u_cuda(library, f"lvg_fused_tc_bwd_u_{_suffix(x)}", x, dy, fu, fd, up, down,
                      padding, gain, slope, clamp, tile_for(True, x.dtype, up))
