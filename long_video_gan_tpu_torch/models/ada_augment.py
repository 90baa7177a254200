"""ADA augmentation pipeline (StyleGAN2-ADA) generalized to video.

Counterpart of `long_video_gan_tpu/models/ada_augment.py` `AugmentPipe`: one
transform per clip (time folds into channels for the geometric warp and into
pixels for the color transform, so every frame of a clip gets the same
augmentation), differentiable in the videos, with the overall probability `p`
a float or a tensor (the trainer's adapted `ada_p`). The geometric warp
reflect-pads by the same static margin (`margin_frac`).

A `torch.Generator` takes the place of the JAX key. The values are drawn in
the JAX package's order and under its conditions (one draw per JAX subkey),
so `debug_percentile` runs, which overwrite every transform parameter, match
the JAX package's. `random_temporal_filter`, a per-clip temporal FIR that no
trainer calls, completes the pipeline; its draws can be injected.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from ..ops.filters import setup_filter, wavelet_lowpass
from ..ops.grid_sample import affine_grid, grid_sample
from ..ops.upfirdn2d import downsample2d, upsample2d
from ..parallel.mesh import global_draw
from ..utils.profiling import annotate

# ---------------------------------------------------------------------------
# Batched homogeneous transforms: [n, 3, 3] / [n, 4, 4] float32.


def _mat(rows, n: int, device) -> torch.Tensor:
    elems = [torch.as_tensor(v, dtype=torch.float32, device=device).expand(n)
             for row in rows for v in row]
    size = len(rows)
    return torch.stack(elems, dim=-1).reshape(n, size, size)


def translate2d(tx, ty, n, device):
    return _mat([[1, 0, tx], [0, 1, ty], [0, 0, 1]], n, device)


def scale2d(sx, sy, n, device):
    return _mat([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], n, device)


def rotate2d(theta, n, device):
    c, s = torch.cos(theta), torch.sin(theta)
    return _mat([[c, -s, 0], [s, c, 0], [0, 0, 1]], n, device)


def translate2d_inv(tx, ty, n, device):
    return translate2d(-tx, -ty, n, device)


def scale2d_inv(sx, sy, n, device):
    return scale2d(1 / sx, 1 / sy, n, device)


def rotate2d_inv(theta, n, device):
    return rotate2d(-theta, n, device)


def translate3d(tx, ty, tz, n, device):
    return _mat([[1, 0, 0, tx], [0, 1, 0, ty], [0, 0, 1, tz], [0, 0, 0, 1]], n, device)


def scale3d(sx, sy, sz, n, device):
    return _mat([[sx, 0, 0, 0], [0, sy, 0, 0], [0, 0, sz, 0], [0, 0, 0, 1]], n, device)


def rotate3d(v, theta, n, device):
    vx, vy, vz = v[0], v[1], v[2]
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    return _mat([
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, 0],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, 0],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, 0],
        [0, 0, 0, 1],
    ], n, device)


def _reflect_pad(x: torch.Tensor, pad: int, dims=(2, 3), pad_hi: Optional[int] = None
                 ) -> torch.Tensor:
    """Reflect-pad axes `dims` by `pad` (and `pad_hi` after, if given) as
    `jnp.pad(mode="reflect")` does, also where a pad reaches past the size
    (F.pad's reflect mode refuses that)."""
    pad_hi = pad if pad_hi is None else pad_hi
    for dim in dims:
        size = x.shape[dim]
        idx = torch.arange(-pad, size + pad_hi, device=x.device)
        period = 2 * (size - 1)
        idx = idx.remainder(period)
        x = x.index_select(dim, torch.where(idx >= size, period - idx, idx))
    return x


def _erfinv(v: float) -> torch.Tensor:
    return torch.special.erfinv(torch.tensor(v, dtype=torch.float32))


# ---------------------------------------------------------------------------


def _freq_filter_bank() -> np.ndarray:
    """4-band sym2 filter bank (the JAX package's `_freq_filter_bank`)."""
    hz_lo = np.asarray(wavelet_lowpass("sym2"))
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    bank = np.eye(4, 1)
    for i in range(1, bank.shape[0]):
        bank = np.dstack([bank, np.zeros_like(bank)]).reshape(bank.shape[0], -1)[:, :-1]
        bank = scipy.signal.convolve(bank, [hz_lo2])
        bank[i, (bank.shape[1] - hz_hi2.size) // 2: (bank.shape[1] + hz_hi2.size) // 2] += hz_hi2
    return np.asarray(bank, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class AugmentPipe:
    """Static augmentation config; call with (generator, videos, p)."""

    # Pixel blitting.
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    # General geometric.
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    # Color.
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # Image-space filtering.
    imgfilter: float = 0.0
    imgfilter_bands: tuple = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    # Image-space corruptions.
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    # Static reflect-pad margin of the geometric warp, as a fraction of the
    # image size (1.0 is the reference's own clamp bound, size - 1).
    margin_frac: float = 1.0

    @property
    def has_color(self) -> bool:
        return any(v > 0 for v in (self.brightness, self.contrast, self.lumaflip,
                                   self.hue, self.saturation))

    def __call__(self, generator: torch.Generator, videos: torch.Tensor,
                 p: Union[float, torch.Tensor],
                 debug_percentile: Optional[float] = None) -> torch.Tensor:
        with annotate("lvg.augment"):
            assert videos.ndim == 5
            n, c, t, height, width = videos.shape
            dev = videos.device
            p = torch.as_tensor(p, dtype=torch.float32, device=dev)
            dp = debug_percentile

            def rand(shape=()):
                return global_draw(lambda m: torch.rand((m,) + shape, generator=generator,
                                                        device=generator.device), n).to(dev)

            def nrand(shape=()):
                return global_draw(lambda m: torch.randn((m,) + shape, generator=generator,
                                                         device=generator.device), n).to(dev)

            def where(cond, value, default):
                return torch.where(cond, value, torch.as_tensor(default, dtype=value.dtype,
                                                                device=dev))

            def full(ref, value):
                return torch.full_like(ref, float(value))

            # ---------------- pixel blits + geometric transform matrix ----------
            g_inv = torch.eye(3, device=dev).repeat(n, 1, 1)
            geom_active = False
            ones = torch.ones(n, device=dev)

            if self.xflip > 0:
                i = torch.floor(rand() * 2)
                i = where(rand() < self.xflip * p, i, 0.0)
                if dp is not None:
                    i = full(i, math.floor(dp * 2))
                g_inv = g_inv @ scale2d_inv(1 - 2 * i, ones, n, dev)
                geom_active = True

            if self.rotate90 > 0:
                i = torch.floor(rand() * 4)
                i = where(rand() < self.rotate90 * p, i, 0.0)
                if dp is not None:
                    i = full(i, math.floor(dp * 4))
                g_inv = g_inv @ rotate2d_inv(-np.pi / 2 * i, n, dev)
                geom_active = True

            if self.xint > 0:
                tvec = (rand((2,)) * 2 - 1) * self.xint_max
                tvec = where(rand((1,)) < self.xint * p, tvec, 0.0)
                if dp is not None:
                    tvec = full(tvec, (np.float32(dp) * 2 - 1) * self.xint_max)
                g_inv = g_inv @ translate2d_inv(torch.round(tvec[:, 0] * width),
                                                torch.round(tvec[:, 1] * height), n, dev)
                geom_active = True

            if self.scale > 0:
                s = torch.exp2(nrand() * self.scale_std)
                s = where(rand() < self.scale * p, s, 1.0)
                if dp is not None:
                    s = full(s, torch.exp2(_erfinv(dp * 2 - 1) * self.scale_std))
                g_inv = g_inv @ scale2d_inv(s, s, n, dev)
                geom_active = True

            p_rot = 1 - torch.sqrt(torch.clamp(1 - self.rotate * p, 0, 1))
            if self.rotate > 0:
                theta = (rand() * 2 - 1) * np.pi * self.rotate_max
                theta = where(rand() < p_rot, theta, 0.0)
                if dp is not None:
                    theta = full(theta, (np.float32(dp) * 2 - 1) * np.pi * self.rotate_max)
                g_inv = g_inv @ rotate2d_inv(-theta, n, dev)
                geom_active = True

            if self.aniso > 0:
                s = torch.exp2(nrand() * self.aniso_std)
                s = where(rand() < self.aniso * p, s, 1.0)
                if dp is not None:
                    s = full(s, torch.exp2(_erfinv(dp * 2 - 1) * self.aniso_std))
                g_inv = g_inv @ scale2d_inv(s, 1 / s, n, dev)
                geom_active = True

            if self.rotate > 0:
                theta = (rand() * 2 - 1) * np.pi * self.rotate_max
                theta = where(rand() < p_rot, theta, 0.0)
                if dp is not None:
                    theta = torch.zeros_like(theta)
                g_inv = g_inv @ rotate2d_inv(-theta, n, dev)

            if self.xfrac > 0:
                tvec = nrand((2,)) * self.xfrac_std
                tvec = where(rand((1,)) < self.xfrac * p, tvec, 0.0)
                if dp is not None:
                    tvec = full(tvec, _erfinv(dp * 2 - 1) * self.xfrac_std)
                g_inv = g_inv @ translate2d_inv(tvec[:, 0] * width, tvec[:, 1] * height, n, dev)
                geom_active = True

            # ---------------- execute geometric transform -----------------------
            if geom_active:
                hz_geom = torch.as_tensor(setup_filter(wavelet_lowpass("sym6")), device=dev)
                hz_pad = hz_geom.shape[0] // 4
                x = videos.reshape(n, c * t, height, width)

                mx = int(min(np.ceil(self.margin_frac * width), width - 1))
                my = int(min(np.ceil(self.margin_frac * height), height - 1))
                mx = max(mx, hz_pad * 2)
                my = max(my, hz_pad * 2)
                x = F.pad(x, [mx, mx, my, my], mode="reflect")

                x = upsample2d(x, hz_geom, up=2)
                g_inv = scale2d(2, 2, n, dev) @ g_inv @ scale2d_inv(2, 2, n, dev)
                g_inv = (translate2d(-0.5, -0.5, n, dev) @ g_inv
                         @ translate2d_inv(-0.5, -0.5, n, dev))

                out_h = (height + hz_pad * 2) * 2
                out_w = (width + hz_pad * 2) * 2
                g_inv = (scale2d(2 / x.shape[3], 2 / x.shape[2], n, dev) @ g_inv
                         @ scale2d_inv(2 / out_w, 2 / out_h, n, dev))

                x = grid_sample(x, affine_grid(g_inv[:, :2, :], (n, c * t, out_h, out_w)))

                x = downsample2d(x, hz_geom, down=2, padding=-hz_pad * 2, flip_filter=True)
                videos = x.reshape(n, c, t, height, width)

            # ---------------- color transform -----------------------------------
            if self.has_color:
                cmat = torch.eye(4, device=dev).repeat(n, 1, 1)
                v_luma = torch.as_tensor(np.asarray([1, 1, 1, 0]) / np.sqrt(3), dtype=torch.float32,
                                         device=dev)

                if self.brightness > 0:
                    b = nrand() * self.brightness_std
                    b = where(rand() < self.brightness * p, b, 0.0)
                    if dp is not None:
                        b = full(b, _erfinv(dp * 2 - 1) * self.brightness_std)
                    cmat = translate3d(b, b, b, n, dev) @ cmat

                if self.contrast > 0:
                    cf = torch.exp2(nrand() * self.contrast_std)
                    cf = where(rand() < self.contrast * p, cf, 1.0)
                    if dp is not None:
                        cf = full(cf, torch.exp2(_erfinv(dp * 2 - 1) * self.contrast_std))
                    cmat = scale3d(cf, cf, cf, n, dev) @ cmat

                outer = torch.outer(v_luma, v_luma)
                eye4 = torch.eye(4, device=dev)
                if self.lumaflip > 0:
                    i = torch.floor(rand() * 2)
                    i = where(rand() < self.lumaflip * p, i, 0.0)
                    if dp is not None:
                        i = full(i, math.floor(dp * 2))
                    cmat = (eye4 - 2 * outer * i[:, None, None]) @ cmat   # Householder

                if self.hue > 0 and c > 1:
                    theta = (rand() * 2 - 1) * np.pi * self.hue_max
                    theta = where(rand() < self.hue * p, theta, 0.0)
                    if dp is not None:
                        theta = full(theta, (np.float32(dp) * 2 - 1) * np.pi * self.hue_max)
                    cmat = rotate3d(v_luma, theta, n, dev) @ cmat

                if self.saturation > 0 and c > 1:
                    s = torch.exp2(nrand() * self.saturation_std)
                    s = where(rand() < self.saturation * p, s, 1.0)
                    if dp is not None:
                        s = full(s, torch.exp2(_erfinv(dp * 2 - 1) * self.saturation_std))
                    cmat = (outer + (eye4 - outer) * s[:, None, None]) @ cmat

                flat = videos.reshape(n, c, t * height * width)
                if c == 3:
                    flat = cmat[:, :3, :3] @ flat + cmat[:, :3, 3:]
                elif c == 1:
                    cm = cmat[:, :3, :].mean(dim=1, keepdim=True)
                    flat = flat * cm[:, :, :3].sum(dim=2, keepdim=True) + cm[:, :, 3:]
                else:
                    raise ValueError("videos must be RGB (3) or L (1) channels")
                videos = flat.reshape(n, c, t, height, width)

            # ---------------- image-space filtering ------------------------------
            if self.imgfilter > 0:
                bank = _freq_filter_bank()
                num_bands = bank.shape[0]
                assert len(self.imgfilter_bands) == num_bands
                expected_power = torch.as_tensor(np.array([10, 1, 1, 1]) / 13, dtype=torch.float32,
                                                 device=dev)

                gains = torch.ones((n, num_bands), device=dev)
                for i, band_strength in enumerate(self.imgfilter_bands):
                    t_i = torch.exp2(nrand() * self.imgfilter_std)
                    t_i = where(rand() < self.imgfilter * p * band_strength, t_i, 1.0)
                    if dp is not None:
                        t_i = (full(t_i, torch.exp2(_erfinv(dp * 2 - 1) * self.imgfilter_std))
                               if band_strength > 0 else torch.ones_like(t_i))
                    tvec = torch.ones((n, num_bands), device=dev)
                    tvec[:, i] = t_i
                    tvec = tvec / (expected_power * tvec.square()).sum(dim=-1, keepdim=True).sqrt()
                    gains = gains * tvec

                hz_prime = gains @ torch.as_tensor(bank, device=dev)           # [N, taps]
                taps = bank.shape[1]
                pad = taps // 2
                # Per-clip separable filter on every channel and frame: a grouped
                # conv over n * c * t maps.
                x = videos.reshape(1, n * c * t, height, width)
                x = _reflect_pad(x, pad)
                k = hz_prime.repeat_interleave(c * t, dim=0)                   # [N*c*t, taps]
                x = F.conv2d(x, k.reshape(-1, 1, 1, taps).to(x.dtype), groups=n * c * t)
                x = F.conv2d(x, k.reshape(-1, 1, taps, 1).to(x.dtype), groups=n * c * t)
                videos = x.reshape(n, c, t, height, width)

            # ---------------- corruptions ----------------------------------------
            x = videos.reshape(n, c * t, height, width)

            if self.noise > 0:
                sigma = nrand().abs() * self.noise_std
                sigma = where(rand() < self.noise * p, sigma, 0.0)
                if dp is not None:
                    sigma = full(sigma, torch.special.erfinv(torch.tensor(dp, dtype=torch.float32))
                                 * self.noise_std)
                noise = global_draw(lambda m: torch.randn((m,) + x.shape[1:], generator=generator,
                                                          device=generator.device), n).to(dev)
                x = x + noise * sigma[:, None, None, None]

            if self.cutout > 0:
                size = torch.full((n, 2), self.cutout_size, device=dev)
                size = where(rand((1,)) < self.cutout * p, size, 0.0)
                center = rand((2,))
                if dp is not None:
                    size = full(size, self.cutout_size)
                    center = full(center, dp)
                coord_x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
                coord_y = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
                mask_x = (coord_x[None, None, :] - center[:, 0, None, None]).abs() \
                    >= size[:, 0, None, None] / 2
                mask_y = (coord_y[None, :, None] - center[:, 1, None, None]).abs() \
                    >= size[:, 1, None, None] / 2
                mask = (mask_x | mask_y).to(x.dtype)
                x = x * mask[:, None]

            return x.reshape(n, c, t, height, width)

    def random_temporal_filter(self, generator: Optional[torch.Generator], video: torch.Tensor,
                               p: Union[float, torch.Tensor], min_ksize: int = 2,
                               max_ksize: int = 16, max_std: float = 1.0,
                               draws: Optional[tuple] = None) -> torch.Tensor:
        """Random per-clip temporal FIR jitter of [N, C, T, H, W] videos: a
        box of `ksize` taps (drawn in [2, max_ksize], as the JAX package
        draws it) plus zero-mean noise of std U(0, max_std), applied along
        time after reflect padding, to the clips whose draw U(0, 1) exceeds
        `p` (the JAX package's condition). `draws` = (ksize [N] integers,
        std [N] in [0, 1), noise [N, max_ksize], u [N]) replaces the draws
        from `generator`."""
        assert video.ndim == 5 and min_ksize >= 2 and max_ksize >= min_ksize
        n = video.shape[0]
        dev = video.device
        if draws is None:
            gdev = generator.device
            draws = (global_draw(lambda m: torch.randint(2, max_ksize + 1, (m,),
                                                         generator=generator, device=gdev), n),
                     global_draw(lambda m: torch.rand((m,), generator=generator, device=gdev), n),
                     global_draw(lambda m: torch.randn((m, max_ksize), generator=generator,
                                                       device=gdev), n),
                     global_draw(lambda m: torch.rand((m,), generator=generator, device=gdev), n))
        ksize, std, noise, u = (d.to(dev) for d in draws)
        ksize = ksize.to(torch.int64).view(n, 1, 1, 1, 1)
        index = torch.arange(max_ksize, device=dev).view(1, 1, -1, 1, 1)
        kmask = ((index >= (max_ksize - ksize) // 2)
                 & (index < (max_ksize + ksize) // 2)).to(torch.float32)
        std = std.to(torch.float32).view(n, 1, 1, 1, 1) * max_std
        weight = noise.to(torch.float32).view(n, 1, max_ksize, 1, 1) * std * kmask
        weight = (1.0 / ksize) * kmask + weight - weight.mean(dim=2, keepdim=True)

        v = _reflect_pad(video, max_ksize // 2, dims=(2,), pad_hi=(max_ksize - 1) // 2)
        # Per-clip temporal conv: channels as the batch, clips as the groups.
        out = F.conv3d(v.transpose(0, 1), weight.to(v.dtype), groups=n).transpose(0, 1)
        pmask = torch.as_tensor(p, dtype=torch.float32, device=dev) < u.view(n, 1, 1, 1, 1)
        return torch.where(pmask, out, video)
