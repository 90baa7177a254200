"""Wrapper of the Hopper filtered_lrelu forward kernel (csrc/filtered_lrelu_fwd.cu).

Counterpart of `long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py`
`filtered_lrelu_packed`. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain version, `filtered_lrelu_composed`. Nothing CUDA-specific
is imported or built until the first launch.

Forward only: the backward kernel (ROADMAP.md Queue 2, K2) is not ported, so
the kernel path raises when asked for a gradient instead of returning an
output that has lost it.
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

# Kernel launches since the last reset (the caller sets it to 0).
launches = 0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = load_library("filtered_lrelu_fwd.cu")
    args = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 11
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    for fn in (lib.lvg_filtered_lrelu_fwd_f32, lib.lvg_filtered_lrelu_fwd_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.lvg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lvg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def filtered_lrelu_packed(x: torch.Tensor, fu: Filter = None, fd: Filter = None,
                          b: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                          padding=0, gain: float = math.sqrt(2.0), slope: float = 0.2,
                          clamp: Optional[float] = None) -> torch.Tensor:
    """filtered_lrelu on NCHW maps with separable filters: bias added here,
    then the kernel (CUDA tensor) or its plain version (CPU tensor)."""
    if b is not None:
        x = x + b.reshape(1, -1, 1, 1).to(x.dtype)
    if x.device.type == "cpu":
        return filtered_lrelu_composed(x, fu, fd, None, up=up, down=down, padding=padding,
                                       gain=gain, slope=slope, clamp=clamp)
    return filtered_lrelu_fwd_cuda(x, fu, fd, up=up, down=down, padding=padding,
                                   gain=gain, slope=slope, clamp=clamp)


def _kernel_taps(f: Filter, device: torch.device, scale: float) -> torch.Tensor:
    f = as_filter_tensor(f, device)
    if f.numel() == 1:
        f = f.reshape(1)
    if f.ndim != 1:
        raise ValueError(f"the filtered_lrelu kernel takes separable (1-D) filters, "
                         f"got shape {tuple(f.shape)}")
    return f.flip(0) * scale


def filtered_lrelu_fwd_cuda(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int,
                            padding, gain: float, slope: float,
                            clamp: Optional[float]) -> torch.Tensor:
    """Launch the kernel on bias-added NCHW `x` (f32 or bf16, contiguous, on a
    CUDA device); returns a new tensor of the same dtype."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"filtered_lrelu kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"filtered_lrelu kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"filtered_lrelu kernel takes a contiguous NCHW tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("filtered_lrelu kernel is forward only: its backward "
                           "(ROADMAP.md Queue 2, K2) is not ported; use impl='conv' "
                           "for a gradient or run under torch.no_grad()")
    if not (isinstance(up, int) and isinstance(down, int) and up >= 1 and down >= 1):
        raise ValueError(f"up and down must be positive ints, got {up!r}, {down!r}")
    pad = parse_padding(padding)
    px0, px1, py0, py1 = pad
    n, c, h, w = x.shape
    out_h, out_w = output_size(h, w, fu, fd, up, down, pad)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"filtered_lrelu output would be empty: {out_h}x{out_w}")
    fu_taps = _kernel_taps(fu, x.device, float(up))
    fd_taps = _kernel_taps(fd, x.device, 1.0)
    taps = torch.cat([fu_taps, fd_taps]).contiguous()
    y = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device)

    lib = library()
    fn = (lib.lvg_filtered_lrelu_fwd_bf16 if x.dtype == torch.bfloat16
          else lib.lvg_filtered_lrelu_fwd_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, out_h, out_w, up, down,
                px0, px1, py0, py1, taps.data_ptr(), fu_taps.numel(), fd_taps.numel(),
                float(gain), float(slope), math.inf if clamp is None else float(clamp),
                stream)
    if rc != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch failed: "
                           f"{lib.lvg_cuda_error_string(rc).decode()} (cudaError {rc})")
    launches += 1
    return y
