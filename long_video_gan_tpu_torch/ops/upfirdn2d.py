"""upfirdn2d — pad, upsample, FIR-filter, downsample a batch of 2D maps.

Counterpart of `long_video_gan_tpu/ops/upfirdn2d.py`, with its two backends:

  "conv"    zero-stuff, pad (negative = crop), one depthwise `conv2d` per
            separable pass (or one 2-D conv), decimate through the conv stride;
  "matrix"  the same linear operator as two dense banded per-axis operators
            [out, in] (`axis_matrix`), applied by two `torch.einsum`
            contractions; a 2-D filter takes the conv path, as in the JAX
            package. "fused" and "pallas" (selectors of the filtered_lrelu
            kernels) come here too, as the JAX package routes them.

"auto" and "packed" take the conv path, which is what the main path (the
kernel policy) measured on the card. The JAX package sends them to "matrix"
as well; which backend serves them better on the card is for a measurement
to decide.

The op is an autograd Function whose gradient is upfirdn2d again, with up and
down swapped and the filter flipped (the reference's hand-derived adjoint),
so every order of derivative runs the same forward convolutions. Autograd's
own double backward of a depthwise conv runs one convolution per channel on
the card: R1, which differentiates D and the ADA warp twice, took 41 s per
micro-batch of 16 that way (NVIDIA H100).

Filters are numpy arrays, torch tensors (modules keep them as non-persistent
buffers, so they live on the module's device) or None (identity).

While a profiler records, each call opens the span `lvg.upfirdn2d.<backend>`
and each backward of the Function `<span>.bwd`, inside the `.bwd` span of the
`lvg.filtered_lrelu.*` call whose forward made it (`utils/profiling.py`).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import annotate, backward_span

Filter = Optional[Union[np.ndarray, torch.Tensor]]


def parse_scaling(scaling) -> tuple[int, int]:
    if isinstance(scaling, (int, np.integer)):
        scaling = [scaling, scaling]
    sx, sy = (int(s) for s in scaling)
    assert sx >= 1 and sy >= 1
    return sx, sy


def parse_padding(padding) -> tuple[int, int, int, int]:
    if isinstance(padding, (int, np.integer)):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def filter_size(f: Filter) -> tuple[int, int]:
    """(width, height) of a filter; (1, 1) for None."""
    if f is None:
        return 1, 1
    assert 1 <= f.ndim <= 2
    return int(f.shape[-1]), int(f.shape[0])


def as_filter_tensor(f: Filter, device: torch.device) -> torch.Tensor:
    """float32 taps on `device` (a no-op for a buffer already there)."""
    if f is None:
        return torch.ones([1, 1], dtype=torch.float32, device=device)
    if isinstance(f, torch.Tensor):
        f = f.to(device=device, dtype=torch.float32)
    else:
        f = torch.as_tensor(np.asarray(f, dtype=np.float32), device=device)
    assert f.ndim in (1, 2)
    return f


def upfirdn2d(x: torch.Tensor, f: Filter, up=1, down=1, padding=0, flip_filter=False,
              gain=1.0, impl="conv") -> torch.Tensor:
    """Upsample, FIR filter, and downsample a batch of 2D maps `[N, C, H, W]`.

    Per channel: zero-insertion upsample by `up` (int or `[upx, upy]`), zero-pad
    by `padding` (int, `[x, y]` or `[x0, x1, y0, y1]`; negative = crop),
    convolve with `f` (`[fh, fw]` full, `[taps]` separable, None identity),
    keep every `down`-th sample. `flip_filter=False` means convolution, True
    means correlation. Output height is (H*upy + py0 + py1 - fh) // downy + 1.
    Differentiable to any order in `x`.
    """
    assert x.ndim == 4, f"expected NCHW input, got shape {tuple(x.shape)}"
    if impl in ("fused", "pallas"):
        impl = "matrix"
    elif impl in ("packed", "auto"):
        impl = "conv"
    assert impl in ("conv", "matrix"), impl
    f = as_filter_tensor(f, x.device)
    upx, upy = parse_scaling(up)
    downx, downy = parse_scaling(down)
    padding = parse_padding(padding)
    px0, px1, py0, py1 = padding
    fw, fh = filter_size(f)
    assert x.shape[3] * upx + px0 + px1 >= fw and x.shape[2] * upy + py0 + py1 >= fh, (
        f"upsampled buffer smaller than filter {fh}x{fw}")
    if impl == "matrix" and f.ndim == 1:
        with annotate("lvg.upfirdn2d.matrix"):
            return _upfirdn2d_matrix(x, f, (upx, upy), (downx, downy), padding,
                                     bool(flip_filter), float(gain))
    with annotate("lvg.upfirdn2d.conv"):
        return _Upfirdn2d.apply(x, f, (upx, upy), (downx, downy), padding, bool(flip_filter),
                                float(gain))


class _Upfirdn2d(torch.autograd.Function):
    """upfirdn2d with the adjoint as its gradient."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        ctx.save_for_backward(f)
        ctx.args = (tuple(x.shape), up, down, padding, flip_filter, gain)
        ctx.spans = (backward_span("lvg.filtered_lrelu."), backward_span("lvg.upfirdn2d."))
        return _upfirdn2d_conv(x, f, up, down, padding, flip_filter, gain)

    @staticmethod
    def backward(ctx, dy):
        (f,) = ctx.saved_tensors
        in_shape, (upx, upy), (downx, downy), (px0, px1, py0, py1), flip_filter, gain = ctx.args
        fw, fh = filter_size(f)
        in_h, in_w = in_shape[2:]
        out_h, out_w = dy.shape[2:]
        padding = (fw - px0 - 1, in_w * upx - out_w * downx + px0 - upx + 1,
                   fh - py0 - 1, in_h * upy - out_h * downy + py0 - upy + 1)
        owner, span = ctx.spans
        with annotate(owner), annotate(span):
            dx = _Upfirdn2d.apply(dy, f, (downx, downy), (upx, upy), padding, not flip_filter,
                                  gain)
        assert tuple(dx.shape) == in_shape, (tuple(dx.shape), in_shape)
        return dx, None, None, None, None, None, None


def pad_or_crop(x: torch.Tensor, padding: tuple[int, int, int, int]) -> torch.Tensor:
    """Zero-pad NCHW maps by [px0, px1, py0, py1]; negative entries crop."""
    px0, px1, py0, py1 = padding
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    return x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
             max(-px0, 0):x.shape[3] - max(-px1, 0)]


def _upfirdn2d_conv(x: torch.Tensor, f: torch.Tensor, up: tuple[int, int],
                    down: tuple[int, int], padding: tuple[int, int, int, int],
                    flip_filter: bool, gain: float) -> torch.Tensor:
    """The forward computation: zero-stuff, pad/crop, depthwise FIR conv(s)
    with the decimation as their stride."""
    (upx, upy), (downx, downy) = up, down
    n, c, in_h, in_w = x.shape
    fw, fh = filter_size(f)

    # Zero-stuff: each sample padded to a full stride (up-1 trailing zeros).
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, in_h, 1, in_w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, in_h * upy, in_w * upx)

    x = pad_or_crop(x, padding)

    # conv2d correlates: flip for convolution. Gain ** (ndim/2) per pass so
    # two separable passes compose to `gain`.
    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f.to(x.dtype)
    if f.ndim == 1:
        x = F.conv2d(x, f.reshape(1, 1, 1, fw).expand(c, 1, 1, fw), groups=c)
        x = F.conv2d(x, f.reshape(1, 1, fw, 1).expand(c, 1, fw, 1), groups=c,
                     stride=(downy, downx))
    else:
        x = F.conv2d(x, f.reshape(1, 1, fh, fw).expand(c, 1, fh, fw), groups=c,
                     stride=(downy, downx))
    return x


# ---------------------------------------------------------------------------
# Matrix backend: each axis's resampling as a dense banded operator R[out, in].


@functools.lru_cache(maxsize=256)
def axis_nonzeros(in_size: int, up: int, down: int, pad0: int, pad1: int, taps: int):
    """Output size, and the (row, column, tap) of every nonzero of one axis's
    [out, in] operator: output `row` reads input `column` through `tap` of
    the flipped filter. Each (row, column) pair meets one tap at most."""
    up_size = in_size * up + pad0 + pad1
    out_size = (up_size - taps) // down + 1
    rows = np.arange(out_size)[:, None]            # output index
    ktap = np.arange(taps)[None, :]                # filter tap index
    src = rows * down + ktap - pad0                # index into the zero-stuffed signal
    in_idx, rem = np.divmod(src, up)
    valid = (rem == 0) & (in_idx >= 0) & (in_idx < in_size)
    nonzeros = [torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, src.shape)[valid]))
                for a in (rows, in_idx, ktap)]
    return (out_size, *nonzeros)


def upfirdn2d_macs(in_h: int, in_w: int, taps: int, up: int = 1, down: int = 1, padding=0,
                   h_first: bool = True) -> tuple[int, int, int]:
    """(out_h, out_w, multiply-adds per map) of upfirdn2d with a separable
    `taps`-tap filter, tap-exact: each pass costs the nonzeros of its axis's
    banded operator (`axis_nonzeros`) times the length of the other axis at
    that pass, the H pass first (`h_first`) or the W pass first. Zero taps
    of the zero-stuffing are not counted, whatever a backend computes."""
    px0, px1, py0, py1 = parse_padding(padding)
    out_h, rows_h, *_ = axis_nonzeros(in_h, up, down, py0, py1, taps)
    out_w, rows_w, *_ = axis_nonzeros(in_w, up, down, px0, px1, taps)
    nnz_h, nnz_w = rows_h.numel(), rows_w.numel()
    macs = nnz_h * in_w + nnz_w * out_h if h_first else nnz_w * in_h + nnz_h * out_w
    return out_h, out_w, macs


def axis_matrix(f: torch.Tensor, in_size: int, up: int, down: int, pad0: int, pad1: int,
                flip_filter: bool, gain: float) -> torch.Tensor:
    """Dense f32 [out, in] operator of one axis on the 1-D filter's device:
    zero-stuff (up) -> pad -> FIR -> decimate (the JAX package's
    `_axis_matrix`). Built from cached indices, so a filter on the card is
    never read back to the host."""
    out_size, rows, cols, taps = axis_nonzeros(in_size, up, down, pad0, pad1, f.shape[0])
    f = f.float() if flip_filter else f.float().flip(0)   # convolution flips the taps
    r = torch.zeros((out_size, in_size), dtype=torch.float32, device=f.device)
    r[rows.to(f.device), cols.to(f.device)] = f[taps.to(f.device)] * gain
    return r


def _upfirdn2d_matrix(x: torch.Tensor, f: torch.Tensor, up: tuple[int, int],
                      down: tuple[int, int], padding: tuple[int, int, int, int],
                      flip_filter: bool, gain: float) -> torch.Tensor:
    """[N, C, H, W] x [H', H] x [W', W] -> [N, C, H', W']: two contractions,
    each pass with gain ** 0.5 so that the two compose to `gain`."""
    (upx, upy), (downx, downy) = up, down
    px0, px1, py0, py1 = padding
    rh = axis_matrix(f, x.shape[2], upy, downy, py0, py1, flip_filter, gain ** 0.5)
    rw = axis_matrix(f, x.shape[3], upx, downx, px0, px1, flip_filter, gain ** 0.5)
    x = torch.einsum("nchw,yh->ncyw", x, rh.to(x.dtype))
    return torch.einsum("ncyw,xw->ncyx", x, rw.to(x.dtype))


# ---------------------------------------------------------------------------
# Convenience wrappers (padding arithmetic identical to the JAX package's).


def filter2d(x, f: Filter, padding=0, flip_filter=False, gain=1.0, impl="conv"):
    """FIR-filter NCHW maps; output is same-size by default."""
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain, impl=impl)


def upsample2d(x, f: Filter, up=2, padding=0, flip_filter=False, gain=1.0, impl="conv"):
    """Upsample NCHW maps by `up` with FIR filter `f`."""
    upx, upy = parse_scaling(up)
    return upfirdn2d(x, f, up=up, padding=upsample2d_padding(f, up, padding),
                     flip_filter=flip_filter, gain=gain * upx * upy, impl=impl)


def upsample2d_padding(f: Filter, up=2, padding=0) -> list[int]:
    """The [px0, px1, py0, py1] that `upsample2d` gives upfirdn2d."""
    upx, upy = parse_scaling(up)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    return [
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    ]


def downsample2d(x, f: Filter, down=2, padding=0, flip_filter=False, gain=1.0, impl="conv"):
    """Downsample NCHW maps by `down` with FIR filter `f`."""
    return upfirdn2d(x, f, down=down, padding=downsample2d_padding(f, down, padding),
                     flip_filter=flip_filter, gain=gain, impl=impl)


def downsample2d_padding(f: Filter, down=2, padding=0) -> list[int]:
    """The [px0, px1, py0, py1] that `downsample2d` gives upfirdn2d."""
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    return [
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    ]
