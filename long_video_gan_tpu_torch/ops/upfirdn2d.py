"""upfirdn2d — pad, upsample, FIR-filter, downsample a batch of 2D maps.

Counterpart of `long_video_gan_tpu/ops/upfirdn2d.py`, `conv` backend: zero-stuff,
pad (negative = crop), one depthwise `conv2d` per separable pass (or one 2-D
conv), decimate through the conv stride. `impl="matrix"` (the JAX package's
banded-matrix formulation for the TPU's matrix unit) takes the same path here;
a matrix backend of its own is listed in ROADMAP.md Queue 1.

Filters are numpy arrays, torch tensors (modules keep them as non-persistent
buffers, so they live on the module's device) or None (identity).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

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
    """
    assert x.ndim == 4, f"expected NCHW input, got shape {tuple(x.shape)}"
    if impl in ("fused", "packed", "pallas", "auto", "matrix"):
        impl = "conv"
    assert impl == "conv", impl
    f = as_filter_tensor(f, x.device)
    upx, upy = parse_scaling(up)
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)

    n, c, in_h, in_w = x.shape
    fw, fh = filter_size(f)
    assert in_w * upx + px0 + px1 >= fw and in_h * upy + py0 + py1 >= fh, (
        f"upsampled buffer smaller than filter {fh}x{fw}")

    # Zero-stuff: each sample padded to a full stride (up-1 trailing zeros).
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, in_h, 1, in_w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, in_h * upy, in_w * upx)

    # Pad, then crop for negative padding.
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
          max(-px0, 0):x.shape[3] - max(-px1, 0)]

    # conv2d correlates: flip for convolution. Gain ** (ndim/2) per pass so
    # two separable passes compose to `gain`.
    f = f * (float(gain) ** (f.ndim / 2))
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
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    ]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy, impl=impl)


def downsample2d(x, f: Filter, down=2, padding=0, flip_filter=False, gain=1.0, impl="conv"):
    """Downsample NCHW maps by `down` with FIR filter `f`."""
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    ]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain, impl=impl)
