"""2D convolution with optional FIR up/downsampling (NCHW).

Counterpart of `long_video_gan_tpu/ops/conv2d_resample.py`: padding is
relative to the upsampled image and applied once up front; downsampling is
FIR then a strided conv, upsampling is zero-stuff + FIR, conv, then an
optional FIR decimation. Plain torch ops (cuDNN on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .upfirdn2d import Filter, filter_size, pad_or_crop, parse_padding, upfirdn2d


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=(0, 0, 0, 0),
            groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """Plain 2D conv. flip_weight=True is correlation (torch conv2d semantics)."""
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    if any(padding):
        x = pad_or_crop(x, padding)
    return F.conv2d(x, w.to(x.dtype), stride=stride, groups=groups)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Filter = None, up: int = 1,
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
