"""Bilinear grid sampling (NCHW), differentiable to any order.

Counterpart of `long_video_gan_tpu/ops/grid_sample.py`: `grid_sample(mode=
'bilinear', padding_mode='zeros', align_corners=False)` as the ADA warp uses
it. Written as a gather of the four corners from the one-pixel zero-padded
source and a lerp whose weights carry the per-corner validity, the JAX
package's formulation: `torch.gather` differentiates through `scatter_add`
and back, so R1 can differentiate D through the warp twice, which
`F.grid_sample`'s native backward does not allow.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
