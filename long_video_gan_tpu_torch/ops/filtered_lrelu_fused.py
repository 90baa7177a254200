"""filtered_lrelu as four banded operator products: the Hopper kernels K3a
(forward) and K3b (gradient) of csrc/filtered_lrelu_fused.cu, joined by a
`torch.autograd.Function`.

Counterpart of `long_video_gan_tpu/ops/pallas/filtered_lrelu_fused.py`
`filtered_lrelu_fused` and its `_fused_op` custom VJP. Per plane X:

    out = Ad . act(Au . X . Bu^T) . Bd^T
    dX  = Au^T . (act'(U) * (Ad^T . dY . Bd)) . Bu,   U = Au . X . Bu^T

with the banded per-axis operators of `filtered_lrelu_bands.operators`. The
function is these products in this order, with the TPU kernel's stores
between them: for bf16
maps the operators, t1 = Au . X, Z = act(U) and t3 = Z . Bd^T (backward: t1,
Ad^T . dY, dU and dU . Bu) round to bf16, and every sum is f32; f32 maps stay
in f32 throughout. The Function saves the bias-added input and recomputes U in
the backward. The backward is first-order only: it is a Function of its own
whose backward raises, as `_first_order_only` makes the JAX VJP.

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
from .filtered_lrelu_bands import banded_bwd_plain, banded_fwd_plain
from .filtered_lrelu_cuda import GEOMETRY_ARGS, check_input, kernel_geometry, raise_on_error
from .upfirdn2d import Filter, parse_padding

SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_fused.cu"

# Kernel launches since the last reset (the caller sets them to 0).
fwd_launches = 0
bwd_launches = 0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load K3a and K3b, and K4
    (`filtered_lrelu_exact.py`), whose forward is K3a's with no stage
    rounding."""
    fwd = [ctypes.c_void_p] * 2 + GEOMETRY_ARGS + [ctypes.c_void_p]
    bwd = [ctypes.c_void_p] * 3 + GEOMETRY_ARGS + [ctypes.c_int, ctypes.c_void_p]
    return load_library("filtered_lrelu_fused.cu", {
        "lvg_fused_fwd_f32": fwd, "lvg_fused_fwd_bf16": fwd,
        "lvg_fused_bwd_f32": bwd, "lvg_fused_bwd_bf16": bwd,
        "lvg_exact_fwd_f32": fwd, "lvg_exact_fwd_bf16": fwd})


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
        fn = banded_fwd_plain if x.device.type == "cpu" else fused_fwd_cuda
        return fn(x, fu, fd, up, down, padding, gain, slope, clamp)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
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


def _launch_args(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding):
    """Output size and the C arguments of a launch on `x`: the taps (rounded
    to bf16 for bf16 maps, as the TPU kernel's operators are) and geometry."""
    (px0, px1, py0, py1), out_h, out_w, taps, n_fu, n_fd = kernel_geometry(x, fu, fd, up, down,
                                                                            padding)
    taps = taps.to(x.dtype).float().contiguous()
    n, c, h, w = x.shape
    return (out_h, out_w), taps, [n * c, h, w, out_h, out_w, up, down, px0, px1, py0, py1,
                                  taps.data_ptr(), n_fu, n_fd]


def fused_fwd_cuda(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding,
                   gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    """Launch K3a on bias-added NCHW `x` (f32 or bf16, contiguous, on a CUDA
    device); returns a new tensor of the same dtype."""
    global fwd_launches
    check_input(x, "tensor")
    (out_h, out_w), taps, geometry = _launch_args(x, fu, fd, up, down, padding)
    y = torch.empty((x.shape[0], x.shape[1], out_h, out_w), dtype=x.dtype, device=x.device)
    lib = library()
    fn = lib.lvg_fused_fwd_bf16 if x.dtype == torch.bfloat16 else lib.lvg_fused_fwd_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), *geometry, float(gain), float(slope),
                math.inf if clamp is None else float(clamp), stream)
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
    check_input(dy, "gradient")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"filtered_lrelu fused backward: dy ({dy.dtype}, {dy.device}) must "
                        f"match x ({x.dtype}, {x.device})")
    (out_h, out_w), taps, geometry = _launch_args(x, fu, fd, up, down, padding)
    if tuple(dy.shape) != (x.shape[0], x.shape[1], out_h, out_w):
        raise ValueError(f"filtered_lrelu fused backward: dy shape {tuple(dy.shape)}, "
                         f"expected {(x.shape[0], x.shape[1], out_h, out_w)}")
    dx = torch.empty_like(x)
    lib = library()
    fn = lib.lvg_fused_bwd_bf16 if x.dtype == torch.bfloat16 else lib.lvg_fused_bwd_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *geometry, float(gain),
                float(slope), math.inf if clamp is None else float(clamp),
                0 if clamp is None else 1, stream)
    raise_on_error(lib, rc, "fused backward")
    bwd_launches += 1
    return dx
