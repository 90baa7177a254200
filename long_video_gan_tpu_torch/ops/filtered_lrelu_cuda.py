"""Wrappers of the Hopper filtered_lrelu kernels: the forward
(csrc/filtered_lrelu_fwd.cu, K1) and its gradient (csrc/filtered_lrelu_bwd.cu,
K2), joined by a `torch.autograd.Function`.

Counterpart of `long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py`
`filtered_lrelu_packed` and its `_packed_op` custom VJP. The Function saves the
bias-added input and recomputes the supersampled map in the backward, as the
JAX package does. The backward is first-order only: it is a Function of its
own whose backward raises, as `_first_order_only` makes the JAX VJP, so a
second-order request raises. The bias is added outside the Function, so its
gradient comes from autograd.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions: `filtered_lrelu_composed` forward, and `filtered_lrelu_bwd_plain`
(autograd of the composed op, U recomputed) backward. Nothing CUDA-specific is
imported or built until the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..utils.nvcc import load_library
from .filtered_lrelu import filtered_lrelu_composed, output_size
from .upfirdn2d import Filter, as_filter_tensor, parse_padding

SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_fwd.cu"
BWD_SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_bwd.cu"

# Kernel launches since the last reset (the caller sets them to 0).
launches = 0
bwd_launches = 0


# Geometry arguments of every filtered_lrelu kernel's C function: planes,
# in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1, taps, fu_taps,
# fd_taps, gain, slope, clamp.
GEOMETRY_ARGS = ([ctypes.c_int] * 11 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                 + [ctypes.c_float] * 3)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load the forward kernel's library."""
    args = [ctypes.c_void_p] * 2 + GEOMETRY_ARGS + [ctypes.c_void_p]
    return load_library("filtered_lrelu_fwd.cu", {"lvg_filtered_lrelu_fwd_f32": args,
                                                  "lvg_filtered_lrelu_fwd_bf16": args})


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """Build (at first use) and load the backward kernel's library."""
    args = [ctypes.c_void_p] * 3 + GEOMETRY_ARGS + [ctypes.c_int, ctypes.c_void_p]
    return load_library("filtered_lrelu_bwd.cu", {"lvg_filtered_lrelu_bwd_f32": args,
                                                  "lvg_filtered_lrelu_bwd_bf16": args})


def filtered_lrelu_packed(x: torch.Tensor, fu: Filter = None, fd: Filter = None,
                          b: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                          padding=0, gain: float = math.sqrt(2.0), slope: float = 0.2,
                          clamp: Optional[float] = None) -> torch.Tensor:
    """filtered_lrelu on NCHW maps with separable filters, differentiable to
    first order in x (and b): bias added here, then the Function."""
    if b is not None:
        x = x + b.reshape(1, -1, 1, 1).to(x.dtype)
    return _FilteredLReLU.apply(x, fu, fd, int(up), int(down), parse_padding(padding),
                                float(gain), float(slope), clamp)


class _FilteredLReLU(torch.autograd.Function):
    """K1 forward, K2 backward (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, fu, fd, up, down, padding, gain, slope, clamp):
        ctx.save_for_backward(x)
        ctx.args = (fu, fd, up, down, padding, gain, slope, clamp)
        if x.device.type == "cpu":
            return filtered_lrelu_composed(x, fu, fd, None, up=up, down=down, padding=padding,
                                           gain=gain, slope=slope, clamp=clamp)
        return filtered_lrelu_fwd_cuda(x, fu, fd, up=up, down=down, padding=padding,
                                       gain=gain, slope=slope, clamp=clamp)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return (_FilteredLReLUGrad.apply(x, dy, ctx.args),) + (None,) * 8


class _FilteredLReLUGrad(torch.autograd.Function):
    """The backward as a node of its own, so that a second differentiation
    reaches it and raises (`_first_order_only` in the JAX package), whether it
    comes through `backward()` or `torch.autograd.grad`. `once_differentiable`
    does not do that: its error node hangs off detached copies of dx, so
    `torch.autograd.grad(..., x, allow_unused=True)` never reaches it and
    returns None for the second-order gradient."""

    @staticmethod
    def forward(ctx, x, dy, args):
        fu, fd, up, down, padding, gain, slope, clamp = args
        kw = dict(up=up, down=down, padding=padding, gain=gain, slope=slope, clamp=clamp)
        if x.device.type == "cpu":
            return filtered_lrelu_bwd_plain(x, dy, fu, fd, **kw)
        return filtered_lrelu_bwd_cuda(x, dy.contiguous(), fu, fd, **kw)

    @staticmethod
    def backward(ctx, ddx):
        raise NotImplementedError(
            "filtered_lrelu impl='packed' is first-order only: its gradient is the K2 "
            "kernel, which has no gradient of its own. For second-order use, select "
            "impl='conv'; the composed path differentiates to any order.")


def filtered_lrelu_bwd_plain(x: torch.Tensor, dy: torch.Tensor, fu: Filter, fd: Filter,
                             up: int, down: int, padding, gain: float, slope: float,
                             clamp: Optional[float]) -> torch.Tensor:
    """K2's plain version: the gradient of `filtered_lrelu_composed` at the
    bias-added `x` along `dy`, by autograd with the forward recomputed."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        y = filtered_lrelu_composed(xr, fu, fd, None, up=up, down=down, padding=padding,
                                    gain=gain, slope=slope, clamp=clamp)
        (dx,) = torch.autograd.grad(y, xr, dy)
    return dx


def _kernel_taps(f: Filter, device: torch.device, scale: float) -> torch.Tensor:
    f = as_filter_tensor(f, device)
    if f.numel() == 1:
        f = f.reshape(1)
    if f.ndim != 1:
        raise ValueError(f"the filtered_lrelu kernel takes separable (1-D) filters, "
                         f"got shape {tuple(f.shape)}")
    return f.flip(0) * scale


def check_input(x: torch.Tensor, what: str) -> None:
    """Raise unless `x` is a contiguous f32 or bf16 NCHW tensor on the card."""
    if x.device.type != "cuda":
        raise ValueError(f"filtered_lrelu kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"filtered_lrelu kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"filtered_lrelu kernel takes a contiguous NCHW {what}, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")


def kernel_geometry(x: torch.Tensor, fu: Filter, fd: Filter, up, down, padding):
    """(padding, out_h, out_w, taps, fu taps, fd taps) of a kernel launch on
    `x`: the f32 taps on x's device, fu flipped and times `up`, then fd
    flipped."""
    if not (isinstance(up, int) and isinstance(down, int) and up >= 1 and down >= 1):
        raise ValueError(f"up and down must be positive ints, got {up!r}, {down!r}")
    pad = parse_padding(padding)
    out_h, out_w = output_size(x.shape[2], x.shape[3], fu, fd, up, down, pad)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"filtered_lrelu output would be empty: {out_h}x{out_w}")
    fu_taps = _kernel_taps(fu, x.device, float(up))
    fd_taps = _kernel_taps(fd, x.device, 1.0)
    taps = torch.cat([fu_taps, fd_taps]).contiguous()
    return pad, out_h, out_w, taps, fu_taps.numel(), fd_taps.numel()


def raise_on_error(lib: ctypes.CDLL, rc: int, which: str) -> None:
    """Turn a launch's cudaError_t into a raise."""
    if rc != 0:
        raise RuntimeError(f"filtered_lrelu {which} kernel launch failed: "
                           f"{lib.lvg_cuda_error_string(rc).decode()} (cudaError {rc})")


def filtered_lrelu_fwd_cuda(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int,
                            padding, gain: float, slope: float,
                            clamp: Optional[float]) -> torch.Tensor:
    """Launch K1 on bias-added NCHW `x` (f32 or bf16, contiguous, on a CUDA
    device); returns a new tensor of the same dtype."""
    global launches
    check_input(x, "tensor")
    (px0, px1, py0, py1), out_h, out_w, taps, n_fu, n_fd = kernel_geometry(x, fu, fd, up, down,
                                                                      padding)
    n, c, h, w = x.shape
    y = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device)
    lib = library()
    fn = (lib.lvg_filtered_lrelu_fwd_bf16 if x.dtype == torch.bfloat16
          else lib.lvg_filtered_lrelu_fwd_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, out_h, out_w, up, down,
                px0, px1, py0, py1, taps.data_ptr(), n_fu, n_fd,
                float(gain), float(slope), math.inf if clamp is None else float(clamp),
                stream)
    raise_on_error(lib, rc, "forward")
    launches += 1
    return y


def filtered_lrelu_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, fu: Filter, fd: Filter,
                            up: int, down: int, padding, gain: float, slope: float,
                            clamp: Optional[float]) -> torch.Tensor:
    """Launch K2: the gradient at bias-added NCHW `x` along `dy` (both of one
    dtype, contiguous, on one CUDA device); returns dx of x's dtype."""
    global bwd_launches
    check_input(x, "input")
    check_input(dy, "gradient")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"filtered_lrelu backward: dy ({dy.dtype}, {dy.device}) must match "
                        f"x ({x.dtype}, {x.device})")
    (px0, px1, py0, py1), out_h, out_w, taps, n_fu, n_fd = kernel_geometry(x, fu, fd, up, down,
                                                                      padding)
    n, c, h, w = x.shape
    if tuple(dy.shape) != (n, c, out_h, out_w):
        raise ValueError(f"filtered_lrelu backward: dy shape {tuple(dy.shape)}, expected "
                         f"{(n, c, out_h, out_w)}")
    dx = torch.empty_like(x)
    lib = bwd_library()
    fn = (lib.lvg_filtered_lrelu_bwd_bf16 if x.dtype == torch.bfloat16
          else lib.lvg_filtered_lrelu_bwd_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n * c, h, w, out_h, out_w, up,
                down, px0, px1, py0, py1, taps.data_ptr(), n_fu, n_fd, float(gain),
                float(slope), math.inf if clamp is None else float(clamp),
                0 if clamp is None else 1, stream)
    raise_on_error(lib, rc, "backward")
    bwd_launches += 1
    return dx
