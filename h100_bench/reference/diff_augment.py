"""DiffAugment (color, translation, cutout) adapted to video.

Benchmark reference: plain PyTorch on one process, importing only
`h100_bench.reference`. It follows the published augmentation
(NVlabs/long-video-gan, `model/diff_augment.py`, after Zhao et al. 2020) with
the JAX package's numerics (`long_video_gan_tpu/models/diff_augment.py`):
one transform per clip, the same in every frame; color ops see time folded
into pixels ([N, C, T*H, W]), geometric ops time folded into channels
([N, C*T, H, W]). Every draw comes from the `torch.Generator` passed in, on
its device, in the program's order: brightness, saturation and contrast
(one uniform per clip each), the translation's two integer offsets, then
the cutout's two.

Departure from the program: the draws cannot be injected (the program takes
them as arguments for its tests against the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _uniform(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    draw = torch.rand((x.shape[0],), generator=generator, device=generator.device)
    return draw.to(x.device, x.dtype).view(-1, 1, 1, 1)


def _randint(n: int, low: int, high: int, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randint(low, high, (n,), generator=generator,
                         device=generator.device).to(device, torch.int64)


def brightness(x, generator):
    return x + (_uniform(x, generator) - 0.5)


def saturation(x, generator):
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) * (_uniform(x, generator) * 2) + mean


def contrast(x, generator):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (_uniform(x, generator) + 0.5) + mean


def translation(x, generator, ratio: float = 0.25):
    """Shift rows and columns by integers in [-shift, shift], zero-padded."""
    n, c, h, w = x.shape
    shift = round(max(h, w) * ratio)
    tx = _randint(n, -shift, shift + 1, generator, x.device)
    ty = _randint(n, -shift, shift + 1, generator, x.device)
    x = F.pad(x, [1, 1, 1, 1])
    ix = torch.clamp(torch.arange(h, device=x.device)[None] + tx[:, None] + 1, 0, h + 1)
    iy = torch.clamp(torch.arange(w, device=x.device)[None] + ty[:, None] + 1, 0, w + 1)
    x = torch.take_along_dim(x, ix.view(n, 1, h, 1), dim=2)
    return torch.take_along_dim(x, iy.view(n, 1, 1, w), dim=3)


def cutout(x, generator, ratio: float = 0.5):
    """Zero a cut_h x cut_w rectangle centred on drawn offsets, clipped."""
    n, c, h, w = x.shape
    cut_h, cut_w = int(h * ratio + 0.5), int(w * ratio + 0.5)
    off_x = _randint(n, 0, h + (1 - cut_h % 2), generator, x.device).view(n, 1, 1)
    off_y = _randint(n, 0, w + (1 - cut_w % 2), generator, x.device).view(n, 1, 1)
    gx = torch.arange(h, device=x.device)[None, :, None]
    gy = torch.arange(w, device=x.device)[None, None, :]
    in_x = ((gx >= torch.clamp(off_x - cut_h // 2, min=0))
            & (gx <= torch.clamp(off_x - cut_h // 2 + cut_h - 1, max=h - 1)))
    in_y = ((gy >= torch.clamp(off_y - cut_w // 2, min=0))
            & (gy <= torch.clamp(off_y - cut_w // 2 + cut_w - 1, max=w - 1)))
    return x * (1.0 - (in_x & in_y).to(x.dtype))[:, None]


POLICY = {"color": [brightness, saturation, contrast], "translation": [translation],
          "cutout": [cutout]}


def diff_augment(x: torch.Tensor, policy: str, generator: torch.Generator) -> torch.Tensor:
    """x: [N, C, T, H, W] videos in [-1, 1]."""
    if not policy:
        return x
    n, c, t, h, w = x.shape
    for p in policy.split(","):
        x = x.reshape(n, c, t * h, w) if p == "color" else x.reshape(n, c * t, h, w)
        for fn in POLICY[p]:
            x = fn(x, generator)
        x = x.reshape(n, c, t, h, w)
    return x
