"""Plain PyTorch ops of the benchmark's reference models.

Frozen copies of the plain paths of `long_video_gan_tpu_torch.ops`: filter
design (numpy and scipy), `bias_act`, `upfirdn2d` on depthwise convolutions
with its adjoint as the gradient, and `filtered_lrelu` as the composed
sequence. Nothing here imports the program.

`lower_precision()` turns on the control of the correctness check: every
operand that enters a convolution, a matrix product or a FIR stage is
rounded one precision below the one it is computed in (float32 to bfloat16,
bfloat16 to float8 e4m3), which is what computing there would do to it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Precision of the control.

_LOWER = [False, False]   # [on, bfloat16 to float8 too]
FP8_MAX = 448.0   # largest finite float8 e4m3fn


@contextlib.contextmanager
def lower_precision(on: bool = True, fp8: bool = True):
    """Within the block, `q` rounds its operands one precision lower:
    float32 to bfloat16, and with `fp8` bfloat16 to float8 e4m3."""
    before = list(_LOWER)
    _LOWER[:] = [on, fp8]
    try:
        yield
    finally:
        _LOWER[:] = before


@contextlib.contextmanager
def tf32_off():
    """Full-float32 cuDNN convolutions and matrix products inside the block
    (cuDNN takes TF32 by default on the card)."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _round_lower(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if x.dtype == torch.bfloat16 and fp8:
        return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.bfloat16)
    return x


class _RoundLower(torch.autograd.Function):
    """The value rounded one precision lower (float32 to bfloat16,
    bfloat16 to float8 e4m3); in the backward the gradient too where it is
    float32 (bfloat16 gradients stay: unscaled float8 gradients underflow to
    nothing); differentiable to any order."""

    @staticmethod
    def forward(ctx, x):
        return _round_lower(x, fp8=_LOWER[1])

    @staticmethod
    def backward(ctx, g):
        return _RoundLowerGrad.apply(g)


class _RoundLowerGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g):
        return _round_lower(g, fp8=False)

    @staticmethod
    def backward(ctx, gg):
        return _RoundLower.apply(gg)


def q(x: torch.Tensor) -> torch.Tensor:
    """`x` as it would be one precision lower (the control), else `x`."""
    if not _LOWER[0] or not x.is_floating_point():
        return x
    return _RoundLower.apply(x)


def assert_shape(x, ref_shape) -> None:
    if x.ndim != len(ref_shape):
        raise AssertionError(f"Wrong number of dimensions: got {x.ndim}, expected {len(ref_shape)}")
    for idx, (size, ref) in enumerate(zip(x.shape, ref_shape)):
        if ref is not None and int(size) != int(ref):
            raise AssertionError(f"Wrong size for dimension {idx}: got {size}, expected {ref}")


def global_draw(draw, n: int) -> torch.Tensor:
    """A batch-leading draw for `n` rows (one process holds the whole batch)."""
    return draw(n)


# ---------------------------------------------------------------------------
# Filters.

WAVELETS = {
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025],
    "sym6": [
        0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
    ],
}


def design_kaiser_lowpass(numtaps: int, cutoff: float, width: float, fs: float) -> np.ndarray:
    return np.asarray(scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs),
                      dtype=np.float32)


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False) -> Optional[np.ndarray]:
    """None for one tap, a separable Kaiser low-pass, or a 2-D Kaiser-windowed
    jinc (radial)."""
    if numtaps == 1:
        return None
    if not radial:
        return design_kaiser_lowpass(numtaps, cutoff, width, fs)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f = np.where(r == 0, cutoff, f)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    return np.asarray(f / np.sum(f), dtype=np.float32)


def wavelet_lowpass(name: str) -> np.ndarray:
    return np.asarray(WAVELETS[name], dtype=np.float64)


def tent_filter(scale: int) -> np.ndarray:
    half = np.linspace(0.5 / scale, 1 - 0.5 / scale, scale)
    f = np.concatenate([half, half[::-1]])
    return np.asarray(f / f.sum(), dtype=np.float32)


def kaiser_resample_filter(scale: int, filter_size: int = 6, cutoff: float = 1.0,
                           width: float = 6.0, sampling_rate: float = 4.0) -> np.ndarray:
    return design_kaiser_lowpass(scale * filter_size, cutoff, width, scale * sampling_rate)


def setup_filter(f, normalize: bool = True, flip_filter: bool = False, gain: float = 1.0,
                 separable: Optional[bool] = None) -> np.ndarray:
    """StyleGAN's `setup_filter`: 1-D taps of 8 or more stay separable,
    shorter ones become their outer product."""
    f = np.asarray(1 if f is None else f, dtype=np.float32)
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    return np.ascontiguousarray(f * (gain ** (f.ndim / 2)), dtype=np.float32)


def filter_buffer(f, device=None) -> Optional[torch.Tensor]:
    return None if f is None else torch.as_tensor(np.asarray(f, np.float32), device=device)


# ---------------------------------------------------------------------------
# bias_act.

SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": ActivationSpec(lambda x, a: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, a: F.relu(x), 0.0, SQRT2),
    "lrelu": ActivationSpec(lambda x, a: F.leaky_relu(x, a), 0.2, SQRT2),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


# ---------------------------------------------------------------------------
# upfirdn2d.


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (int, np.integer)):
        return int(v), int(v)
    a, b = v
    return int(a), int(b)


def parse_padding(padding) -> tuple[int, int, int, int]:
    if isinstance(padding, (int, np.integer)):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        padding = [padding[0], padding[0], padding[1], padding[1]]
    return tuple(padding)


def filter_size(f) -> tuple[int, int]:
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def _taps(f, device) -> torch.Tensor:
    if f is None:
        return torch.ones([1, 1], dtype=torch.float32, device=device)
    return torch.as_tensor(f, dtype=torch.float32, device=device)


def upfirdn2d(x: torch.Tensor, f, up=1, down=1, padding=0, flip_filter: bool = False,
              gain: float = 1.0, impl: str = "conv") -> torch.Tensor:
    """Zero-stuff by `up`, pad (negative crops), convolve with `f` (1-D
    separable or 2-D), keep every `down`-th sample; per channel of NCHW.
    Every `impl` takes the depthwise-convolution path here."""
    f = _taps(f, x.device)
    return _Upfirdn2d.apply(x, f, _pair(up), _pair(down), parse_padding(padding),
                            bool(flip_filter), float(gain))


class _Upfirdn2d(torch.autograd.Function):
    """upfirdn2d whose gradient is its adjoint (up and down swapped, filter
    flipped), so every order of derivative runs forward convolutions."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        ctx.save_for_backward(f)
        ctx.args = (tuple(x.shape), up, down, padding, flip_filter, gain)
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
        dx = _Upfirdn2d.apply(dy, f, (downx, downy), (upx, upy), padding, not flip_filter, gain)
        return dx, None, None, None, None, None, None


def _upfirdn2d_conv(x, f, up, down, padding, flip_filter, gain):
    (upx, upy), (downx, downy) = up, down
    n, c, in_h, in_w = x.shape
    fw, fh = filter_size(f)
    x = q(x)
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, in_h, 1, in_w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, in_h * upy, in_w * upx)
    px0, px1, py0, py1 = padding
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0), max(-px0, 0):x.shape[3] - max(-px1, 0)]
    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = q(f.to(x.dtype))
    if f.ndim == 1:
        x = F.conv2d(x, f.reshape(1, 1, 1, fw).expand(c, 1, 1, fw), groups=c)
        x = F.conv2d(q(x), f.reshape(1, 1, fw, 1).expand(c, 1, fw, 1), groups=c,
                     stride=(downy, downx))
    else:
        x = F.conv2d(x, f.reshape(1, 1, fh, fw).expand(c, 1, fh, fw), groups=c,
                     stride=(downy, downx))
    return x


def upsample2d_padding(f, up=2, padding=0) -> list[int]:
    upx, upy = _pair(up)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    return [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
            py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]


def downsample2d_padding(f, down=2, padding=0) -> list[int]:
    downx, downy = _pair(down)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    return [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
            py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0, impl="conv"):
    upx, upy = _pair(up)
    return upfirdn2d(x, f, up=up, padding=upsample2d_padding(f, up, padding),
                     flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0, impl="conv"):
    return upfirdn2d(x, f, down=down, padding=downsample2d_padding(f, down, padding),
                     flip_filter=flip_filter, gain=gain)


# ---------------------------------------------------------------------------
# filtered_lrelu.


def filtered_lrelu(x: torch.Tensor, fu=None, fd=None, b=None, up: int = 1, down: int = 1,
                   padding=0, gain: float = SQRT2, slope: float = 0.2,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """bias -> upsample (gain up^2) -> lrelu * gain, clamp -> downsample."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down)


@functools.lru_cache(maxsize=None)
def _nonzeros(in_size: int, up: int, down: int, pad0: int, pad1: int, taps: int
              ) -> tuple[int, int]:
    """(output size, nonzeros) of one axis's banded [out, in] operator."""
    out_size = (in_size * up + pad0 + pad1 - taps) // down + 1
    rows = np.arange(out_size)[:, None]
    src = rows * down + np.arange(taps)[None, :] - pad0
    idx, rem = np.divmod(src, up)
    return out_size, int(((rem == 0) & (idx >= 0) & (idx < in_size)).sum())


def upfirdn2d_macs(in_h: int, in_w: int, taps: int, up: int = 1, down: int = 1, padding=0,
                   h_first: bool = True) -> tuple[int, int, int]:
    """(out_h, out_w, multiply-adds per map) of a separable upfirdn2d,
    tap-exact: each pass costs its axis's nonzeros times the other axis's
    length at that pass; zero taps of the zero-stuffing are not counted."""
    px0, px1, py0, py1 = parse_padding(padding)
    out_h, nnz_h = _nonzeros(in_h, up, down, py0, py1, taps)
    out_w, nnz_w = _nonzeros(in_w, up, down, px0, px1, taps)
    macs = nnz_h * in_w + nnz_w * out_h if h_first else nnz_w * in_h + nnz_h * out_w
    return out_h, out_w, macs


# ---------------------------------------------------------------------------
# Bilinear grid sampling, differentiable to any order (the ADA warp).


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample `x` [N, C, H, W] at normalized coords `grid` [N, Ho, Wo, 2]
    (x then y, in [-1, 1]; -1 is the left edge of the first pixel).
    Out-of-bounds samples read zeros."""
    n, c, h, w = x.shape
    out_h, out_w = grid.shape[1:3]
    gx = (grid[..., 0] + 1.0) * (w / 2) - 0.5    # [N, Ho, Wo]
    gy = (grid[..., 1] + 1.0) * (h / 2) - 0.5

    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0

    vx0 = (x0 >= 0) & (x0 < w)
    vx1 = (x0 + 1 >= 0) & (x0 + 1 < w)
    vy0 = (y0 >= 0) & (y0 < h)
    vy1 = (y0 + 1 >= 0) & (y0 + 1 < h)

    # Top-left corner of each 2x2 patch in the padded source, clipped so that
    # the patch stays in bounds; invalid corners get zero weight. A NaN
    # coordinate (a degenerate transform) reads the pad and, through its NaN
    # weights, gives NaN, as in the JAX package.
    xp = F.pad(x, [1, 1, 1, 1])
    pw = w + 2
    sy = torch.clamp(torch.nan_to_num(y0 + 1), 0, h).long().reshape(n, 1, -1)
    sx = torch.clamp(torch.nan_to_num(x0 + 1), 0, w).long().reshape(n, 1, -1)
    flat = xp.reshape(n, c, -1)
    base = (sy * pw + sx).expand(n, c, sy.shape[2])

    def corner(offset: int) -> torch.Tensor:
        return torch.gather(flat, 2, base + offset).reshape(n, c, out_h, out_w)

    f = lambda m: m.to(x.dtype)[:, None]         # [N, 1, Ho, Wo] # noqa: E731
    wx = wx.to(x.dtype)[:, None]
    wy = wy.to(x.dtype)[:, None]
    w00 = (1 - wx) * (1 - wy) * (f(vx0) * f(vy0))
    w01 = wx * (1 - wy) * (f(vx1) * f(vy0))
    w10 = (1 - wx) * wy * (f(vx0) * f(vy1))
    w11 = wx * wy * (f(vx1) * f(vy1))
    return (corner(0) * w00 + corner(1) * w01 + corner(pw) * w10 + corner(pw + 1) * w11)


def affine_grid(theta: torch.Tensor, size: tuple[int, int, int, int]) -> torch.Tensor:
    """Sampling grid [N, H, W, 2] for 2D affine matrices `theta` [N, 2, 3]
    (`F.affine_grid(align_corners=False)`: xy coordinates at pixel centres)."""
    _, _, h, w = size
    dev = theta.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (2.0 / w) - 1.0
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (2.0 / h) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")                  # [H, W]
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)       # [H, W, 3]
    return torch.einsum("nij,hwj->nhwi", theta.float(), base)


# ---------------------------------------------------------------------------
# 2D convolution with FIR up/downsampling (the sres discriminator).


def pad_or_crop(x: torch.Tensor, padding) -> torch.Tensor:
    px0, px1, py0, py1 = padding
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    return x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
             max(-px0, 0):x.shape[3] - max(-px1, 0)]


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=(0, 0, 0, 0),
            groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """Plain 2D conv. flip_weight=True is correlation (torch conv2d semantics)."""
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    if any(padding):
        x = pad_or_crop(x, padding)
    return F.conv2d(q(x), q(w.to(x.dtype)), stride=stride, groups=groups)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f=None, up: int = 1,
                    down: int = 1, padding=0, groups: int = 1, flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """Conv2d fused with FIR up/downsampling: x [N, inC, H, W], w [outC,
    inC // groups, kh, kw], f a FIR filter (None = identity), `padding`
    relative to the upsampled image (negative = crop)."""
    assert x.ndim == 4 and w.ndim == 4
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    fw, fh = filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    if up > 1:
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                      flip_filter=flip_filter)
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    return _conv2d(x, w, padding=(px0, px1, py0, py1), groups=groups, flip_weight=flip_weight)
