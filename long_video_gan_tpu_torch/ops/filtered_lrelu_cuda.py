"""Wrappers of the Hopper filtered_lrelu kernels K1 (forward) and K2 (its
input gradient), joined by a `torch.autograd.Function`: for bf16 maps the
tensor-core kernels of csrc/filtered_lrelu_tc.cu, for f32 maps (the sres
plan's head layers L0-L2 under `auto`) the f32-FMA kernels of
csrc/filtered_lrelu_fwd.cu and csrc/filtered_lrelu_bwd.cu, tiled to the plane.

Counterpart of `long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py`
`filtered_lrelu_packed` and its `_packed_op` custom VJP; the function is the
TPU kernels', four (six) banded products with bf16 stage rounding
(`filtered_lrelu_bands.py`). The Function saves the bias-added input and
recomputes the supersampled map in the backward, as the JAX package does. The
backward is first-order only: it is a Function of its own whose backward
raises, as `_first_order_only` makes the JAX VJP, so a second-order request
raises. The bias is added outside the Function, so its gradient comes from
autograd.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions, `banded_fwd_plain` and `banded_bwd_plain`. Nothing CUDA-specific is
imported or built until the first launch. `launches` / `bwd_launches` count
the tensor-core K1 / K2 launches (bf16 maps), `f32_launches` /
`f32_bwd_launches` those of the f32 kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..utils.nvcc import load_library
from ..utils.profiling import annotate, backward_span
from . import filtered_lrelu_bands as bands
from .filtered_lrelu import output_size
from .upfirdn2d import Filter, as_filter_tensor, parse_padding

SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_fwd.cu"
BWD_SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_bwd.cu"
TC_SOURCE = "long_video_gan_tpu_torch/csrc/filtered_lrelu_tc.cu"

# Kernel launches since the last reset (the caller sets them to 0): the
# tensor-core K1 / K2 on bf16 maps, and the f32 kernels.
launches = 0
bwd_launches = 0
f32_launches = 0
f32_bwd_launches = 0

# The bf16 kernels' output (dX) tile edge. A 64-wide forward tile was slower
# at 9 of the 11 bf16 layers of the 144x256 plan on the H100 (PERF.md).
TILE = 32
FWD_OPS = ("au_y", "au_x", "ad_y", "ad_x")
BWD_OPS = ("au_y", "au_x", "adt_y", "adt_x", "aut_y", "aut_x")


# Geometry arguments of the f32 kernels' C functions (filtered_lrelu_fwd.cu,
# _bwd.cu): planes, in_h, in_w, out_h, out_w, up, down, px0, px1, py0, py1,
# taps, fu_taps, fd_taps, gain, slope, clamp.
GEOMETRY_ARGS = ([ctypes.c_int] * 11 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                 + [ctypes.c_float] * 3)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load the f32 forward kernel's library."""
    args = [ctypes.c_void_p] * 2 + GEOMETRY_ARGS + [ctypes.c_void_p]
    return load_library("filtered_lrelu_fwd.cu", {"lvg_filtered_lrelu_fwd_f32": args})


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """Build (at first use) and load the f32 backward kernel's library."""
    args = [ctypes.c_void_p] * 3 + GEOMETRY_ARGS + [ctypes.c_int, ctypes.c_void_p]
    return load_library("filtered_lrelu_bwd.cu", {"lvg_filtered_lrelu_bwd_f32": args})


# Arguments of the tensor-core kernels' C functions (csrc/filtered_lrelu_tc.cuh
# `launch_fwd_tc`, `launch_bwd_tc`): x, y, ops, windows, params and their
# count, gain, slope, clamp, stream; the backward x, dy, dx, ops, windows,
# params and count, gain, slope, clamp, has_clamp, stream.
_TC_PARAMS = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
TC_FWD_ARGS = [ctypes.c_void_p] * 4 + _TC_PARAMS + [ctypes.c_float] * 3 + [ctypes.c_void_p]
TC_BWD_ARGS = ([ctypes.c_void_p] * 5 + _TC_PARAMS + [ctypes.c_float] * 3
               + [ctypes.c_int, ctypes.c_void_p])
# The check-only backward that also writes each tile's U: x, dy, dx, u, then
# as TC_BWD_ARGS from ops on.
TC_BWD_U_ARGS = [ctypes.c_void_p] + TC_BWD_ARGS


@functools.lru_cache(maxsize=None)
def tc_library() -> ctypes.CDLL:
    """Build (at first use) and load the bf16 tensor-core kernels' library."""
    return load_library("filtered_lrelu_tc.cu", {"lvg_tc_fwd": TC_FWD_ARGS,
                                                 "lvg_tc_bwd": TC_BWD_ARGS,
                                                 "lvg_tc_bwd_u": TC_BWD_U_ARGS})


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
        ctx.span = backward_span("lvg.filtered_lrelu.")
        fn = bands.banded_fwd_plain if x.device.type == "cpu" else filtered_lrelu_fwd_cuda
        return fn(x, fu, fd, up, down, padding, gain, slope, clamp)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        with annotate(ctx.span):
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
        fn = bands.banded_bwd_plain if x.device.type == "cpu" else filtered_lrelu_bwd_cuda
        return fn(x, dy.contiguous(), *args)

    @staticmethod
    def backward(ctx, ddx):
        raise NotImplementedError(
            "filtered_lrelu impl='packed' is first-order only: its gradient is the K2 "
            "kernel, which has no gradient of its own. For second-order use, select "
            "impl='conv'; the composed path differentiates to any order.")


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


@functools.lru_cache(maxsize=256)
def _tc_plan(backward: bool, up: int, down: int, padding: tuple, nfu: int, nfd: int,
             device: torch.device, tile: int = TILE):
    """A layer's tile plan for `tile`-wide tiles, its operators' tap indices
    and K-windows on `device`, and {operator: (offset, ld, first window)}."""
    make = bands.bwd_tile_plan if backward else bands.fwd_tile_plan
    plan = make(tile, up, down, padding, nfu, nfd)
    widths = {name: op.kb for name, op in plan.ops.items()}
    if backward:   # U and dZ run side by side over one window width
        widths["au_x"] = widths["adt_x"] = max(widths["au_x"], widths["adt_x"])
    index, windows, where = bands.pack_ops(plan.ops, BWD_OPS if backward else FWD_OPS, widths)
    return plan, index.to(device), windows.to(device), where


def _aligned(t: torch.Tensor, width: int, step: int) -> int:
    """1 if a kernel may load `t`'s patches as 4-byte words: even rows, even
    patch starts, a 4-byte aligned base."""
    return int(width % 2 == 0 and step % 2 == 0 and t.data_ptr() % 4 == 0)


def _c_ints(values: list) -> tuple:
    return (ctypes.c_int * len(values))(*values), len(values)


def _tc_ops(index: torch.Tensor, taps: torch.Tensor, parts: int) -> torch.Tensor:
    """The operator blocks on the card, gathered from the f32 taps there (no
    read-back to the host), as `parts` bf16 parts one after another
    (`filtered_lrelu_bands.bf16_parts`): 1 for bf16 maps, 3 for f32."""
    values = torch.cat([taps, taps.new_zeros(1)])[index]
    return torch.cat(bands.bf16_parts(values, parts))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def tc_parts(x: torch.Tensor) -> int:
    """bf16 parts per operand of a tensor-core kernel on `x`'s type: 1 for
    bf16 maps, 3 for f32 maps (csrc/filtered_lrelu_tc.cuh)."""
    return 1 if x.dtype == torch.bfloat16 else 3


def tc_params(backward: bool, plan, index: torch.Tensor, windows: torch.Tensor, where: dict,
              sizes: tuple, aligned: tuple) -> list:
    """The host ints of a tensor-core launch (FwdParams' or BwdParams' order,
    csrc/filtered_lrelu_tc.cuh): `sizes` = (planes, in_h, in_w, out_h,
    out_w), `aligned` the patch-load flags (x; backward: x, dy)."""
    if backward:
        params = [*sizes, plan.tile, plan.rp, plan.px, plan.pd, plan.dstep, plan.y.x_base,
                  plan.x.x_base, plan.y.d_base, plan.x.d_base, *aligned]
    else:
        params = [*sizes, plan.tile, plan.rp, plan.pp, plan.step, plan.y.base, plan.x.base,
                  *aligned]
    params += [v for name in (BWD_OPS if backward else FWD_OPS) for v in where[name]]
    return params + [index.numel(), windows.numel()]


def launch_tc_fwd(fn, x: torch.Tensor, y: torch.Tensor, up: int, down: int, geometry,
                  gain: float, slope: float, clamp: Optional[float], tile: int = TILE,
                  parts: Optional[int] = None) -> int:
    """Launch the tensor-core forward C function `fn` (K1, K3a, K4, K5) on
    bias-added `x` into `y` over `tile`-wide tiles, given `kernel_geometry`'s
    (padding, out_h, out_w, taps, fu taps, fd taps), with the operators in
    `parts` bf16 parts (default `tc_parts(x)`; K4/K5 take 3 on either map
    type); returns its cudaError_t."""
    pad, out_h, out_w, taps, n_fu, n_fd = geometry
    n, c, h, w = x.shape
    plan, index, windows, where = _tc_plan(False, up, down, pad, n_fu, n_fd, x.device, tile)
    ops = _tc_ops(index, taps, parts or tc_parts(x))
    params = tc_params(False, plan, index, windows, where, (n * c, h, w, out_h, out_w),
                       (_aligned(x, w, plan.step),))
    return fn(x.data_ptr(), y.data_ptr(), ops.data_ptr(), windows.data_ptr(), *_c_ints(params),
              float(gain), float(slope), math.inf if clamp is None else float(clamp),
              _stream(x))


def launch_tc_bwd(fn, x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, up: int, down: int,
                  geometry, gain: float, slope: float, clamp: Optional[float],
                  tile: int = TILE, u: Optional[torch.Tensor] = None) -> int:
    """Launch the tensor-core backward C function `fn` (K2, K3b) over
    `tile`-wide dX tiles: dx at bias-added `x` along `dy`; returns its
    cudaError_t. `u`: the f32 buffer of a check-only `fn` that also writes
    each tile's U (`bwd_u_cuda`)."""
    pad, out_h, out_w, taps, n_fu, n_fd = geometry
    n, c, h, w = x.shape
    plan, index, windows, where = _tc_plan(True, up, down, pad, n_fu, n_fd, x.device, tile)
    ops = _tc_ops(index, taps, tc_parts(x))
    params = tc_params(True, plan, index, windows, where, (n * c, h, w, out_h, out_w),
                       (_aligned(x, w, tile), _aligned(dy, out_w, plan.dstep)))
    buffers = (x, dy, dx) if u is None else (x, dy, dx, u)
    return fn(*(t.data_ptr() for t in buffers), ops.data_ptr(), windows.data_ptr(),
              *_c_ints(params), float(gain), float(slope),
              math.inf if clamp is None else float(clamp), 0 if clamp is None else 1,
              _stream(x))


def bwd_tile_setup(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding,
                   tile: int = TILE):
    """(plan, window widths, f32 taps) of a tensor-core backward launch on
    `x` over `tile`-wide tiles: what `filtered_lrelu_bands.tiled_bwd_plain`
    contracts."""
    pad, _, _, taps, n_fu, n_fd = kernel_geometry(x, fu, fd, up, down, padding)
    plan, _, _, where = _tc_plan(True, up, down, pad, n_fu, n_fd, torch.device("cpu"), tile)
    return plan, {name: ref[3] for name, ref in where.items()}, taps


def bwd_u_cuda(library, symbol: str, x: torch.Tensor, dy: torch.Tensor, fu: Filter,
               fd: Filter, up: int, down: int, padding, gain: float, slope: float,
               clamp: Optional[float], tile: int = TILE) -> tuple:
    """Check-only: dX at bias-added NCHW `x` along `dy`, the U of every tile
    as act' takes it, f32 [tiles, planes, rp, rp] (tiles in row-major order,
    `tiled_bwd_plain`'s layout), and the tile setup that contracts it
    (`bwd_tile_setup`), from C function `symbol` of `library()`, a build of
    the K2/K3b bodies that also writes U. A CPU tensor takes the tile
    contraction, `tiled_bwd_plain` at its own U. Counts no launch."""
    n, c, h, w = x.shape
    setup = bwd_tile_setup(x, fu, fd, up, down, padding, tile)
    plan = setup[0]
    if x.device.type == "cpu":
        dx, u = bands.tiled_bwd_plain(x.reshape(n * c, h, w), dy.reshape(n * c, *dy.shape[2:]),
                                      *setup, gain, slope, clamp, return_u=True)
        return dx.reshape(x.shape), u, setup
    check_input(x, "input")
    geometry = kernel_geometry(x, fu, fd, up, down, padding)
    check_gradient(x, dy, geometry[1:3], "backward")
    tiles = math.prod(bands.tile_counts(h, w, tile))
    dx = torch.empty_like(x)
    u = torch.empty((n * c, tiles, plan.rp, plan.rp), dtype=torch.float32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        rc = launch_tc_bwd(getattr(lib, symbol), x, dy, dx, up, down, geometry, gain, slope,
                           clamp, tile, u)
    raise_on_error(lib, rc, "check-only backward")
    return dx, u.transpose(0, 1), setup


def filtered_lrelu_bwd_u_cuda(x: torch.Tensor, dy: torch.Tensor, fu: Filter, fd: Filter,
                              up: int, down: int, padding, gain: float, slope: float,
                              clamp: Optional[float]) -> tuple:
    """K2 in bf16 with each tile's U (`bwd_u_cuda`); check-only, counts no
    launch. f32 maps have no such build: their K2 is csrc/filtered_lrelu_bwd.cu."""
    if x.device.type != "cpu" and x.dtype != torch.bfloat16:
        raise TypeError(f"K2's U is written by its bf16 tensor-core kernel only, got {x.dtype}")
    return bwd_u_cuda(tc_library, "lvg_tc_bwd_u", x, dy, fu, fd, up, down, padding, gain,
                      slope, clamp)


def check_gradient(x: torch.Tensor, dy: torch.Tensor, out_hw: tuple, which: str) -> None:
    """Raise unless `dy` is a contiguous NCHW gradient of x's type and device
    and of the output's shape."""
    check_input(dy, "gradient")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"filtered_lrelu {which}: dy ({dy.dtype}, {dy.device}) must match "
                        f"x ({x.dtype}, {x.device})")
    want = tuple(x.shape[:2]) + tuple(out_hw)
    if tuple(dy.shape) != want:
        raise ValueError(f"filtered_lrelu {which}: dy shape {tuple(dy.shape)}, expected {want}")


def filtered_lrelu_fwd_cuda(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int,
                            padding, gain: float, slope: float,
                            clamp: Optional[float]) -> torch.Tensor:
    """Launch K1 on bias-added NCHW `x` (f32 or bf16, contiguous, on a CUDA
    device); returns a new tensor of the same dtype."""
    global launches, f32_launches
    check_input(x, "tensor")
    geometry = kernel_geometry(x, fu, fd, up, down, padding)
    pad, out_h, out_w, taps, n_fu, n_fd = geometry
    n, c, h, w = x.shape
    y = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            lib = tc_library()
            rc = launch_tc_fwd(lib.lvg_tc_fwd, x, y, up, down, geometry, gain, slope, clamp)
        else:
            lib = library()
            rc = lib.lvg_filtered_lrelu_fwd_f32(
                x.data_ptr(), y.data_ptr(), n * c, h, w, out_h, out_w, up, down, *pad,
                taps.data_ptr(), n_fu, n_fd, float(gain), float(slope),
                math.inf if clamp is None else float(clamp), _stream(x))
    raise_on_error(lib, rc, "forward")
    if x.dtype == torch.bfloat16:
        launches += 1
    else:
        f32_launches += 1
    return y


def filtered_lrelu_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, fu: Filter, fd: Filter,
                            up: int, down: int, padding, gain: float, slope: float,
                            clamp: Optional[float]) -> torch.Tensor:
    """Launch K2: the gradient at bias-added NCHW `x` along `dy` (both of one
    dtype, contiguous, on one CUDA device); returns dx of x's dtype."""
    global bwd_launches, f32_bwd_launches
    check_input(x, "input")
    geometry = kernel_geometry(x, fu, fd, up, down, padding)
    pad, out_h, out_w, taps, n_fu, n_fd = geometry
    check_gradient(x, dy, (out_h, out_w), "backward")
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            lib = tc_library()
            rc = launch_tc_bwd(lib.lvg_tc_bwd, x, dy, dx, up, down, geometry, gain, slope,
                               clamp)
        else:
            lib = bwd_library()
            rc = lib.lvg_filtered_lrelu_bwd_f32(
                x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n * c, h, w, out_h, out_w, up,
                down, *pad, taps.data_ptr(), n_fu, n_fd, float(gain), float(slope),
                math.inf if clamp is None else float(clamp), 0 if clamp is None else 1,
                _stream(x))
    raise_on_error(lib, rc, "backward")
    if x.dtype == torch.bfloat16:
        bwd_launches += 1
    else:
        f32_bwd_launches += 1
    return dx
