"""DiffAugment (color / translation / cutout) adapted to video.

Counterpart of `long_video_gan_tpu/models/diff_augment.py`: one transform per
clip, the same in every frame. Color ops fold time into pixels
([N, C, T*H, W]), geometric ops fold time into channels ([N, C*T, H, W]).
Every op is differentiable in x.

Each op takes its draws as an optional tensor (or pair), so a test can feed
it the draws the JAX function made from its key; without them it draws from
a `torch.Generator`. `diff_augment` takes them as a list, one entry per op in
the policy's order.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..parallel.mesh import global_draw


def diff_augment(x: torch.Tensor, policy: str = "color,translation,cutout",
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Sequence[Any]] = None) -> torch.Tensor:
    """x: [N, C, T, H, W] video batch in [-1, 1]."""
    if not policy:
        return x
    n, c, t, h, w = x.shape
    draws = iter(draws) if draws is not None else None
    for p in policy.split(","):
        x = x.reshape(n, c, t * h, w) if p == "color" else x.reshape(n, c * t, h, w)
        for fn in AUGMENT_FNS[p]:
            x = fn(x, generator, next(draws) if draws is not None else None)
        x = x.reshape(n, c, t, h, w)
    return x


def _uniform(x: torch.Tensor, generator: Optional[torch.Generator], draw) -> torch.Tensor:
    """[N, 1, 1, 1] uniform draws in [0, 1), given or from `generator`."""
    if draw is None:
        if generator is None:
            raise ValueError("need the draws or a torch.Generator to draw them from")
        draw = global_draw(lambda m: torch.rand((m,), generator=generator,
                                                device=generator.device), x.shape[0])
    return draw.to(x.device, x.dtype).view(-1, 1, 1, 1)


def _randint(n: int, low: int, high: int, generator: Optional[torch.Generator], draw):
    """Two [N] integer draws in [low, high), given as a pair or from `generator`."""
    if draw is None:
        if generator is None:
            raise ValueError("need the draws or a torch.Generator to draw them from")
        draw = [global_draw(lambda m: torch.randint(low, high, (m,), generator=generator,
                                                    device=generator.device), n)
                for _ in range(2)]
    return draw


def rand_brightness(x, generator=None, draw=None, scale=1.0):
    return x + (_uniform(x, generator, draw) - 0.5) * scale


def rand_saturation(x, generator=None, draw=None, scale=1.0):
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) * (_uniform(x, generator, draw) * 2 * scale) + mean


def rand_contrast(x, generator=None, draw=None, scale=1.0):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * ((_uniform(x, generator, draw) + 0.5) * scale) + mean


def rand_translation(x, generator=None, draw=None, ratio=0.25):
    """Integer translate per sample with zero padding: (tx, ty) in
    [-shift, shift] move rows and columns."""
    n, c, h, w = x.shape
    shift = round(max(h, w) * ratio)
    tx, ty = (v.to(x.device, torch.int64) for v in
              _randint(n, -shift, shift + 1, generator, draw))
    x_pad = torch.nn.functional.pad(x, [1, 1, 1, 1])
    ix = torch.clamp(torch.arange(h, device=x.device)[None] + tx[:, None] + 1, 0, h + 1)
    iy = torch.clamp(torch.arange(w, device=x.device)[None] + ty[:, None] + 1, 0, w + 1)
    x_pad = torch.take_along_dim(x_pad, ix.view(n, 1, h, 1), dim=2)
    return torch.take_along_dim(x_pad, iy.view(n, 1, 1, w), dim=3)


def rand_cutout(x, generator=None, draw=None, ratio=0.5):
    """Zero a random rectangle per sample: the reference's clamped index
    arithmetic in closed form, a clipped interval per axis around the drawn
    offsets."""
    n, c, h, w = x.shape
    cut_h, cut_w = int(h * ratio + 0.5), int(w * ratio + 0.5)
    if draw is None:
        if generator is None:
            raise ValueError("need the draws or a torch.Generator to draw them from")
        draw = [global_draw(lambda m: torch.randint(0, size + (1 - cut % 2), (m,),
                                                    generator=generator,
                                                    device=generator.device), n)
                for size, cut in ((h, cut_h), (w, cut_w))]
    off_x, off_y = (v.to(x.device, torch.int64).view(n, 1, 1) for v in draw)
    gx = torch.arange(h, device=x.device)[None, :, None]
    gy = torch.arange(w, device=x.device)[None, None, :]
    lo_x, hi_x = off_x - cut_h // 2, off_x - cut_h // 2 + cut_h - 1
    lo_y, hi_y = off_y - cut_w // 2, off_y - cut_w // 2 + cut_w - 1
    in_x = (gx >= torch.clamp(lo_x, min=0)) & (gx <= torch.clamp(hi_x, max=h - 1))
    in_y = (gy >= torch.clamp(lo_y, min=0)) & (gy <= torch.clamp(hi_y, max=w - 1))
    mask = 1.0 - (in_x & in_y).to(x.dtype)
    return x * mask[:, None]


AUGMENT_FNS = {
    "color": [rand_brightness, rand_saturation, rand_contrast],
    "translation": [rand_translation],
    "cutout": [rand_cutout],
}
