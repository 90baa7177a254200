"""Stage-2 super-resolution video generator (36x64 -> 144x256).

Counterpart of `long_video_gan_tpu/models/generator_sres.py`: a StyleGAN3
alias-free per-frame synthesis network conditioned on a +/-temporal_context
window of low-res frames, with a per-scale Kaiser-resampled conditioning
pyramid. Frames fold into the batch axis ((n t) c h w). Half-precision layers
run in bfloat16, as in the JAX package.

Each SynthesisLayer's filtered_lrelu goes through `ops.filtered_lrelu` with the
layer's `resample_impl`; "auto" sends every layer that resamples, bf16 and
f32, to the Hopper kernels.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.filtered_lrelu import filtered_lrelu
from ..ops.filters import design_lowpass_filter, kaiser_resample_filter
from ..ops.upfirdn2d import (downsample2d, downsample2d_padding, upfirdn2d_macs,
                             upsample2d, upsample2d_padding)
from ..parallel.mesh import mean_over_processes
from ..utils.misc import assert_shape
from ..utils.profiling import annotate
from .common import FullyConnectedLayer, checkpoint_block, filter_buffer, randn_


def modulated_conv2d(
    x: torch.Tensor,                # [N, Ci, H, W]
    w: torch.Tensor,                # [Co, Ci, kh, kw]
    s: torch.Tensor,                # [N, Ci] per-sample styles
    demodulate: bool = True,
    padding: int = 0,
    input_gain: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """StyleGAN3 modulated conv2d: conv(x, w * s) == conv(x * s, w) for
    per-input-channel styles, so the modulation moves to the activations and
    the conv stays dense. Styles and demodulation in f32, the conv in x's
    dtype."""
    batch = x.shape[0]
    out_channels, in_channels, kh, kw = w.shape
    assert_shape(x, (batch, in_channels, None, None))
    assert_shape(s, (batch, in_channels))

    w = w.float()
    s = s.float()
    if demodulate:
        w = w * w.square().mean(dim=(1, 2, 3), keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
        dcoefs = (torch.einsum("oikl,ni->no", w.square(), s.square()) + 1e-8).rsqrt()

    gain = s
    if input_gain is not None:
        gain = gain * input_gain.float().expand(batch, in_channels)

    x = x * gain[:, :, None, None].to(x.dtype)
    y = F.conv2d(x, w.to(x.dtype), padding=padding)
    if demodulate:
        y = y * dcoefs[:, :, None, None].to(y.dtype)
    return y


# ---------------------------------------------------------------------------


class MappingNetwork(nn.Module):
    """z -> per-layer w latents with w_avg tracking and truncation."""

    def __init__(self, z_dim: int, w_dim: int, num_ws: int, num_layers: int = 2,
                 lr_multiplier: float = 0.01, w_avg_beta: float = 0.998, device=None):
        super().__init__()
        self.z_dim, self.w_dim, self.num_ws = z_dim, w_dim, num_ws
        self.w_avg_beta = w_avg_beta
        features = [z_dim] + [w_dim] * num_layers
        self.num_layers = num_layers
        for idx, (fi, fo) in enumerate(zip(features[:-1], features[1:])):
            self.add_module(f"fc{idx}", FullyConnectedLayer(
                fi, fo, activation="lrelu", lrate_mul=lr_multiplier, device=device))
        self.register_buffer("w_avg", torch.zeros(w_dim, device=device))

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                update_emas: bool = False) -> torch.Tensor:
        assert_shape(z, (None, self.z_dim))
        if truncation_cutoff is None:
            truncation_cutoff = self.num_ws

        x = z.float()
        x = x * (x.square().mean(dim=1, keepdim=True) + 1e-8).rsqrt()
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)

        if update_emas:
            mean = mean_over_processes(x.detach().mean(dim=0))
            self.w_avg.copy_(mean + (self.w_avg - mean) * self.w_avg_beta)

        x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1.0:
            head = self.w_avg + (x[:, :truncation_cutoff] - self.w_avg) * truncation_psi
            x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


# ---------------------------------------------------------------------------


class SynthesisInput(nn.Module):
    """Fourier-feature input grid (fourfeats=True only). The random
    frequencies/phases are draw-once constants: a persistent buffer, the JAX
    package's "consts" collection."""

    def __init__(self, w_dim: int, channels: int, size: tuple[int, int],
                 sampling_rate: float, bandwidth: float, device=None):
        super().__init__()
        self.channels = channels
        self.size = tuple(size)                 # (width, height)
        self.sampling_rate = sampling_rate
        self.bandwidth = bandwidth
        w, h = self.size
        self.register_buffer("features", torch.zeros(1, channels, h, w, device=device))
        self.weight = nn.Parameter(torch.zeros(channels, channels, device=device))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        randn_(self.weight, generator)
        dev = generator.device
        freqs = torch.randn((self.channels, 2), generator=generator, device=dev)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp() ** 0.25) * self.bandwidth
        phases = torch.rand((self.channels,), generator=generator, device=dev) - 0.5
        w, h = self.size
        xs = ((torch.arange(w, device=dev) + 0.5) * 2 / w - 1) * (0.5 * w / self.sampling_rate)
        ys = ((torch.arange(h, device=dev) + 0.5) * 2 / h - 1) * (0.5 * h / self.sampling_rate)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)                          # [h, w, 2]
        feats = torch.einsum("cd,hwd->chw", freqs, grid) + phases[:, None, None]
        self.features.copy_(torch.sin(feats * (2 * np.pi))[None])

    def forward(self, batch_size: int) -> torch.Tensor:
        feats = torch.einsum("nchw,kc->nkhw", self.features,
                             self.weight / math.sqrt(self.channels))
        return feats.expand(batch_size, -1, -1, -1)


# ---------------------------------------------------------------------------


class SynthesisLayer(nn.Module):
    """Alias-free synthesis layer: modulated conv + filtered leaky ReLU with
    per-layer designed Kaiser / radial-jinc resampling filters."""

    def __init__(self, w_dim: int, is_torgb: bool, is_critically_sampled: bool,
                 use_fp16: bool, in_channels: int, out_channels: int,
                 in_size: tuple[int, int], out_size: tuple[int, int],
                 in_sampling_rate: float, out_sampling_rate: float,
                 in_cutoff: float, out_cutoff: float,
                 in_half_width: float, out_half_width: float,
                 conv_kernel: int = 3, filter_size: int = 6, lrelu_upsampling: int = 2,
                 use_radial_filters: bool = False, conv_clamp: Optional[float] = 256.0,
                 magnitude_ema_beta: float = 0.999, half_dtype: torch.dtype = torch.bfloat16,
                 resample_impl: str = "conv", device=None):
        super().__init__()
        self.w_dim = w_dim
        self.is_torgb = is_torgb
        self.use_fp16 = use_fp16
        self.in_channels, self.out_channels = in_channels, out_channels
        self.in_size = (int(in_size[0]), int(in_size[1]))        # (width, height)
        self.out_size = (int(out_size[0]), int(out_size[1]))
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta
        self.half_dtype = half_dtype
        self.resample_impl = resample_impl

        k = 1 if is_torgb else conv_kernel
        self.kernel = k
        tmp_sampling_rate = max(in_sampling_rate, out_sampling_rate) * (
            1 if is_torgb else lrelu_upsampling)

        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.register_buffer("magnitude_ema", torch.ones((), device=device))

        self.up_factor = int(np.rint(tmp_sampling_rate / in_sampling_rate))
        assert in_sampling_rate * self.up_factor == tmp_sampling_rate
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        self.register_buffer("up_filter", filter_buffer(design_lowpass_filter(
            numtaps=up_taps, cutoff=in_cutoff, width=in_half_width * 2,
            fs=tmp_sampling_rate), device), persistent=False)

        self.down_factor = int(np.rint(tmp_sampling_rate / out_sampling_rate))
        assert out_sampling_rate * self.down_factor == tmp_sampling_rate
        down_taps = filter_size * self.down_factor if self.down_factor > 1 and not is_torgb else 1
        down_radial = use_radial_filters and not is_critically_sampled
        self.register_buffer("down_filter", filter_buffer(design_lowpass_filter(
            numtaps=down_taps, cutoff=out_cutoff, width=out_half_width * 2,
            fs=tmp_sampling_rate, radial=down_radial), device), persistent=False)

        in_sz = np.asarray(self.in_size)
        out_sz = np.asarray(self.out_size)
        pad_total = (out_sz - 1) * self.down_factor + 1
        pad_total -= (in_sz + k - 1) * self.up_factor
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]), int(pad_hi[1])]

    def reset_parameters_(self, generator: torch.Generator) -> None:
        randn_(self.weight, generator)

    def forward(self, x: torch.Tensor, w: torch.Tensor, force_fp32: bool = False,
                update_emas: bool = False) -> torch.Tensor:
        assert_shape(x, (None, self.in_channels, self.in_size[1], self.in_size[0]))
        assert_shape(w, (x.shape[0], self.w_dim))

        if update_emas:
            mag = mean_over_processes(x.detach().float().square().mean())
            self.magnitude_ema.copy_(mag + (self.magnitude_ema - mag) * self.magnitude_ema_beta)
        input_gain = self.magnitude_ema.rsqrt()

        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / math.sqrt(self.in_channels * (self.kernel ** 2)))

        dtype = self.half_dtype if (self.use_fp16 and not force_fp32) else torch.float32
        x = modulated_conv2d(x.to(dtype), self.weight, styles, padding=self.kernel - 1,
                             demodulate=not self.is_torgb, input_gain=input_gain)

        gain = 1.0 if self.is_torgb else math.sqrt(2.0)
        slope = 1.0 if self.is_torgb else 0.2
        x = filtered_lrelu(x, fu=self.up_filter, fd=self.down_filter, b=self.bias.to(x.dtype),
                           up=self.up_factor, down=self.down_factor, padding=self.padding,
                           gain=gain, slope=slope, clamp=self.conv_clamp,
                           impl=self.resample_impl)
        assert_shape(x, (None, self.out_channels, self.out_size[1], self.out_size[0]))
        assert x.dtype == dtype
        return x


# ---------------------------------------------------------------------------


def synthesis_layer_plan(img_width: int, img_height: int, img_channels: int,
                         channel_base: int = 32768, channel_max: int = 512,
                         num_layers: int = 14, num_critical: int = 2,
                         first_cutoff: float = 2.0, first_stopband: float = 2 ** 2.1,
                         last_stopband_rel: float = 2 ** 0.3, margin_size: int = 10):
    """Static per-layer schedule: cutoffs, stopbands, sampling rates, sizes and
    channel counts, incl. the non-square per-axis size scaling with the last
    two layers pinned to the image size."""
    img_resolution = max(img_width, img_height)
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents

    sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes_x = np.ceil(sampling_rates * min(1, img_width / img_height)) + margin_size * 2
    sizes_y = np.ceil(sampling_rates * min(1, img_height / img_width)) + margin_size * 2
    sizes_x[-2:] = img_width
    sizes_y[-2:] = img_height
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels
    return dict(cutoffs=cutoffs, stopbands=stopbands, sampling_rates=sampling_rates,
                half_widths=half_widths, sizes_x=sizes_x, sizes_y=sizes_y, channels=channels)


class SynthesisNetwork(nn.Module):
    """Alias-free synthesis stack: num_layers + ToRGB, each consuming the
    per-layer conditioning map. Layers are attributes named
    `L{idx}_{width}_{height}_{channels}`, as in the JAX package."""

    def __init__(self, w_dim: int, img_width: int, img_height: int, img_channels: int,
                 cond_channels: int, channel_base: int = 32768, channel_max: int = 512,
                 num_layers: int = 14, num_critical: int = 2, first_cutoff: float = 2.0,
                 first_stopband: float = 2 ** 2.1, last_stopband_rel: float = 2 ** 0.3,
                 margin_size: int = 10, fourfeats: bool = False, output_scale: float = 0.25,
                 num_fp16_res: int = 4, conv_clamp: Optional[float] = 256.0,
                 resample_impl: str = "conv", block_remat: bool = False, device=None):
        super().__init__()
        self.w_dim = w_dim
        # Recompute each layer in the backward (`checkpoint_block`, the JAX
        # `nn.remat(SynthesisLayer)`): a differentiated pass holds one layer's
        # activations at a time, for a second forward per layer. The module
        # tree, and so the state dict, is the same either way.
        self.block_remat = block_remat
        self.img_width, self.img_height, self.img_channels = img_width, img_height, img_channels
        self.num_layers = num_layers
        self.fourfeats = fourfeats
        self.output_scale = output_scale
        self._plan = synthesis_layer_plan(img_width, img_height, img_channels, channel_base,
                                          channel_max, num_layers, num_critical, first_cutoff,
                                          first_stopband, last_stopband_rel, margin_size)
        p = self._plan
        sizes_x, sizes_y = p["sizes_x"], p["sizes_y"]
        rates, cutoffs, half_widths, channels = (
            p["sampling_rates"], p["cutoffs"], p["half_widths"], p["channels"])

        if fourfeats:
            self.input = SynthesisInput(
                w_dim=w_dim, channels=int(channels[0]),
                size=(int(sizes_x[0]), int(sizes_y[0])),
                sampling_rate=float(rates[0]), bandwidth=float(cutoffs[0]), device=device)

        img_resolution = max(img_width, img_height)
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            is_torgb = idx == num_layers
            is_critical = idx >= num_layers - num_critical
            use_fp16 = rates[idx] * (2 ** num_fp16_res) > img_resolution
            in_channels = cond_channels
            if idx > 0 or fourfeats:
                in_channels += int(channels[prev])
            layer = SynthesisLayer(
                w_dim=w_dim, is_torgb=is_torgb, is_critically_sampled=is_critical,
                use_fp16=bool(use_fp16), in_channels=in_channels,
                out_channels=int(channels[idx]),
                in_size=(int(sizes_x[prev]), int(sizes_y[prev])),
                out_size=(int(sizes_x[idx]), int(sizes_y[idx])),
                in_sampling_rate=int(rates[prev]), out_sampling_rate=int(rates[idx]),
                in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
                in_half_width=float(half_widths[prev]), out_half_width=float(half_widths[idx]),
                conv_clamp=conv_clamp, resample_impl=resample_impl, device=device)
            name = f"L{idx}_{int(sizes_x[idx])}_{int(sizes_y[idx])}_{int(channels[idx])}"
            self.add_module(name, layer)
            self.layer_names.append(name)

    @property
    def num_ws(self) -> int:
        return self.num_layers + 1

    def plan(self) -> dict:
        return self._plan

    @property
    def layers(self) -> list[SynthesisLayer]:
        return [getattr(self, name) for name in self.layer_names]

    def forward(self, ws: torch.Tensor, conds: list[torch.Tensor],
                force_fp32: bool = False, update_emas: bool = False) -> torch.Tensor:
        assert_shape(ws, (None, self.num_ws, self.w_dim))
        x = self.input(ws.shape[0]) if self.fourfeats else None
        remat = self.block_remat and torch.is_grad_enabled()
        for i, (name, layer) in enumerate(zip(self.layer_names, self.layers)):
            with annotate(f"lvg.layer.{name}"):
                cond = conds[i]
                x = cond if x is None else torch.cat([x, cond.to(x.dtype)], dim=1)
                if remat:
                    x = checkpoint_block(functools.partial(layer, force_fp32=force_fp32,
                                                           update_emas=update_emas),
                                         functools.partial(layer, force_fp32=force_fp32),
                                         x, ws[:, i].float())
                else:
                    x = layer(x, ws[:, i].float(), force_fp32, update_emas)
        if self.output_scale != 1:
            x = x * self.output_scale
        assert_shape(x, (None, self.img_channels, self.img_height, self.img_width))
        return x.float()


# ---------------------------------------------------------------------------
# Conditioning-pyramid resamplers (static filters, replicate edge padding).


class KaiserDownsample2d(nn.Module):
    def __init__(self, scale: int, filter_size: int = 6, cutoff: float = 1.0,
                 width: float = 6.0, sampling_rate: float = 4.0, pad: bool = True,
                 impl: str = "conv", device=None):
        super().__init__()
        self.scale, self.pad, self.impl = scale, pad, impl
        self.register_buffer("filter", filter_buffer(kaiser_resample_filter(
            scale, filter_size, cutoff, width, sampling_rate), device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 4
        p = int(self.pad) * self.scale
        if self.pad:
            x = F.pad(x, [p, p, p, p], mode="replicate")
        return downsample2d(x, self.filter, down=self.scale, padding=-p, impl=self.impl)

    def macs(self, h: int, w: int) -> tuple[int, int, int]:
        """(out_h, out_w, tap-exact multiply-adds per map) of `forward` on
        an h x w map (`upfirdn2d_macs`, H pass first)."""
        p = int(self.pad) * self.scale
        return upfirdn2d_macs(h + 2 * p, w + 2 * p, self.filter.shape[0], down=self.scale,
                              padding=downsample2d_padding(self.filter, self.scale, -p))


class KaiserUpsample2d(nn.Module):
    def __init__(self, scale: int, filter_size: int = 6, cutoff: float = 1.0,
                 width: float = 6.0, sampling_rate: float = 4.0, pad: bool = True,
                 impl: str = "conv", device=None):
        super().__init__()
        self.scale, self.pad, self.impl = scale, pad, impl
        self.register_buffer("filter", filter_buffer(kaiser_resample_filter(
            scale, filter_size, cutoff, width, sampling_rate), device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 4
        p = int(self.pad)
        if self.pad:
            x = F.pad(x, [p, p, p, p], mode="replicate")
        return upsample2d(x, self.filter, up=self.scale, padding=-p * self.scale, impl=self.impl)

    def macs(self, h: int, w: int) -> tuple[int, int, int]:
        """(out_h, out_w, tap-exact multiply-adds per map) of `forward` on
        an h x w map (`upfirdn2d_macs`, H pass first)."""
        p = int(self.pad)
        return upfirdn2d_macs(h + 2 * p, w + 2 * p, self.filter.shape[0], up=self.scale,
                              padding=upsample2d_padding(self.filter, self.scale,
                                                         -p * self.scale))


# ---------------------------------------------------------------------------


class Generator(nn.Module):
    """SG3 generator: mapping + synthesis + conditioning pyramid."""

    def __init__(self, z_dim: int, w_dim: int, img_width: int, img_height: int,
                 img_channels: int, cond_width: int, cond_height: int, cond_context: int,
                 margin_size: int = 10, fourfeats: bool = False, num_fp16_res: int = 4,
                 channel_base: int = 32768, channel_max: int = 512, num_layers: int = 14,
                 resample_impl: str = "conv", block_remat: bool = False, device=None):
        super().__init__()
        self.z_dim, self.w_dim = z_dim, w_dim
        self.img_width, self.img_height, self.img_channels = img_width, img_height, img_channels
        self.cond_width, self.cond_height, self.cond_context = cond_width, cond_height, cond_context
        self.margin_size = margin_size
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_width=img_width, img_height=img_height,
            img_channels=img_channels, cond_channels=self.cond_channels,
            margin_size=margin_size, fourfeats=fourfeats, num_fp16_res=num_fp16_res,
            channel_base=channel_base, channel_max=channel_max, num_layers=num_layers,
            resample_impl=resample_impl, block_remat=block_remat, device=device)
        self.mapping = MappingNetwork(z_dim=z_dim, w_dim=w_dim,
                                      num_ws=self.synthesis.num_ws, device=device)

        # Layers sharing a sampling rate share one resample (the 14-layer
        # 144x256 plan has 15 layer slots but 5 distinct scales): the pyramid
        # is computed once per distinct scale. Spatial resampling is linear
        # and per channel plane, so it commutes with the temporal unfold and
        # the crop; the values equal those of resampling per layer.
        rates = self.synthesis.plan()["sampling_rates"]
        cond_edge = max(cond_width, cond_height)
        self.resamplers = nn.ModuleDict()      # "down4", "up2", "id1", ...
        self._resample_keys = []               # per layer slot
        for idx in range(self.synthesis.num_ws):
            cond_scale = rates[max(idx - 1, 0)] / cond_edge
            if cond_scale < 1:
                kind, scale = "down", math.ceil(1 / cond_scale)
            elif cond_scale > 1:
                kind, scale = "up", math.ceil(cond_scale)
            else:
                kind, scale = "id", 1
            key = f"{kind}{scale}"
            if key not in self.resamplers:
                if kind == "down":
                    resample = KaiserDownsample2d(scale=scale, impl=resample_impl, device=device)
                elif kind == "up":
                    resample = KaiserUpsample2d(scale=scale, impl=resample_impl, device=device)
                else:
                    resample = nn.Identity()
                self.resamplers[key] = resample
            self._resample_keys.append(key)

    @property
    def cond_channels(self) -> int:
        return self.img_channels * (2 * self.cond_context + 1)

    def prep_cond(self, cond: torch.Tensor) -> list[torch.Tensor]:
        """Per-layer conditioning maps: pad the lr video to square + margin,
        Kaiser-resample the raw frames once per distinct layer scale,
        center-crop/pad per layer geometry, then unfold the +/-context
        temporal window into channels (c-major, s-minor)."""
        assert_shape(cond, (None, self.img_channels, None, self.cond_height, self.cond_width))
        n, c, t, h, w = cond.shape
        edge = max(self.cond_width, self.cond_height)
        px0 = (edge - w) // 2 + self.margin_size
        px1 = (edge - w + 1) // 2 + self.margin_size
        py0 = (edge - h) // 2 + self.margin_size
        py1 = (edge - h + 1) // 2 + self.margin_size

        # Per-frame stack for resampling: [n*t, c, H, W].
        frames = cond.transpose(1, 2).reshape(n * t, c, h, w)
        frames = F.pad(frames, [px0, px1, py0, py1], mode="replicate")

        levels = {key: resample(frames) for key, resample in self.resamplers.items()}

        s = 1 + 2 * self.cond_context
        t_out = t - s + 1
        # Made on the device: a copy from the host would wait for the stream.
        idx = (torch.arange(t_out, device=cond.device)[:, None]
               + torch.arange(s, device=cond.device)[None, :])

        plan = self.synthesis.plan()
        sizes_x, sizes_y = plan["sizes_x"], plan["sizes_y"]
        conds = []
        cache = {}
        for i, key in enumerate(self._resample_keys):
            prev = max(i - 1, 0)
            in_w = int(sizes_x[prev])
            in_h = int(sizes_y[prev])
            full_key = (key, in_h, in_w)
            if full_key in cache:
                conds.append(cache[full_key])
                continue
            layer_cond = levels[key]
            x0 = max(0, (layer_cond.shape[3] - in_w) // 2)
            y0 = max(0, (layer_cond.shape[2] - in_h) // 2)
            layer_cond = layer_cond[:, :, y0:y0 + in_h, x0:x0 + in_w]
            pxa = (in_w - layer_cond.shape[3]) // 2
            pxb = (in_w - layer_cond.shape[3] + 1) // 2
            pya = (in_h - layer_cond.shape[2]) // 2
            pyb = (in_h - layer_cond.shape[2] + 1) // 2
            if pxa or pxb or pya or pyb:
                layer_cond = F.pad(layer_cond, [pxa, pxb, pya, pyb], mode="replicate")
            # [n, t, c, h, w] -> windows [n, t_out, s, c, h, w] -> [(n t_out), c*s, h, w].
            y5 = layer_cond.reshape(n, t, c, in_h, in_w)
            windows = y5[:, idx].transpose(2, 3)                         # [n, t_out, c, s, h, w]
            out = windows.reshape(n * t_out, c * s, in_h, in_w)
            cache[full_key] = out
            conds.append(out)
        return conds

    def forward(self, z: torch.Tensor, cond: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None, update_emas: bool = False,
                **synthesis_kwargs) -> torch.Tensor:
        assert_shape(cond, (z.shape[0], self.img_channels, None, self.cond_height,
                            self.cond_width))
        out_seq_length = cond.shape[2] - 2 * self.cond_context
        assert out_seq_length > 0
        with annotate("lvg.prep_cond"):
            conds = self.prep_cond(cond)
        # Map once per video, repeat per frame (z is identical across frames).
        with annotate("lvg.mapping"):
            ws = self.mapping(z, truncation_psi=truncation_psi,
                              truncation_cutoff=truncation_cutoff, update_emas=update_emas)
        ws = ws.repeat_interleave(out_seq_length, dim=0)                # [(n t), num_ws, w]
        img = self.synthesis(ws, conds, update_emas=update_emas, **synthesis_kwargs)
        n = z.shape[0]
        return img.reshape(n, out_seq_length, self.img_channels,
                           self.img_height, self.img_width).transpose(1, 2)


# ---------------------------------------------------------------------------


class VideoGenerator(nn.Module):
    """Super-res video generator: lr video [N, 3, T + 2*context, lh, lw] ->
    hr video [N, 3, T, hh, hw], one z per video.

    `block_remat`: recompute each `SynthesisLayer` in the backward
    (`SynthesisNetwork`), the JAX training memory option of the same name,
    stored in checkpoints' kwargs; without a gradient it does nothing.
    """

    def __init__(self, hr_height: int = 256, hr_width: int = 256, lr_height: int = 32,
                 lr_width: int = 32, temporal_context: int = 4, latent_z_dim: int = 512,
                 latent_w_dim: int = 512, margin_size: int = 10, fourfeats: bool = False,
                 num_fp16_res: int = 4, channel_base: int = 32768, channel_max: int = 512,
                 num_layers: int = 14, resample_impl: str = "conv", block_remat: bool = False,
                 device=None):
        super().__init__()
        self.hr_height, self.hr_width = hr_height, hr_width
        self.lr_height, self.lr_width = lr_height, lr_width
        self.temporal_context = temporal_context
        self.latent_z_dim = latent_z_dim
        self.SG3 = Generator(
            z_dim=latent_z_dim, w_dim=latent_w_dim, img_width=hr_width, img_height=hr_height,
            img_channels=3, cond_width=lr_width, cond_height=lr_height,
            cond_context=temporal_context, margin_size=margin_size, fourfeats=fourfeats,
            num_fp16_res=num_fp16_res, channel_base=channel_base, channel_max=channel_max,
            num_layers=num_layers, resample_impl=resample_impl, block_remat=block_remat,
            device=device)

    @property
    def block_remat(self) -> bool:
        return self.SG3.synthesis.block_remat

    def forward(self, lr_video: torch.Tensor, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                magnitude_ema_beta: float = 1.0, **kwargs) -> torch.Tensor:
        """`z` [N, latent_z_dim] is injected or drawn from `generator`."""
        batch = lr_video.shape[0]
        assert lr_video.shape[2] - 2 * self.temporal_context > 0
        with annotate("lvg.G"):
            if z is None:
                if generator is None:
                    raise ValueError("need z or a torch.Generator to draw it from")
                z = torch.randn((batch, self.latent_z_dim), generator=generator,
                                device=generator.device).to(lr_video.device)
            update_emas = magnitude_ema_beta < 1
            return self.SG3(z, lr_video, update_emas=update_emas, **kwargs)


# Windows enqueued by `sample_video_segments` since the last reset (the
# caller sets them to 0): on any device, and on a synthesis stream.
segments = 0
stream_segments = 0


@functools.lru_cache(maxsize=None)
def synthesis_stream(device_index: int) -> torch.cuda.Stream:
    """The stream from PyTorch's pool on which `sample_video_segments`
    synthesizes on CUDA device `device_index`: one per device, made on
    first use."""
    return torch.cuda.Stream(device_index)


def _hand_over(segment: torch.Tensor, done: Optional[torch.cuda.Event]) -> torch.Tensor:
    """`segment` with the consumer's current stream ordered after `done`,
    the event of its window on the synthesis stream (None on the CPU), and
    its block kept from reuse until that stream's later work on it ends."""
    if done is not None:
        consumer = torch.cuda.current_stream(segment.device)
        consumer.wait_event(done)
        segment.record_stream(consumer)
    return segment


def sample_video_segments(G: VideoGenerator, lr_video: torch.Tensor, segment_length: int = 8,
                          temporal_context: int = 4, z: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None, prefetch: int = 1,
                          **kwargs) -> Iterator[torch.Tensor]:
    """Chunked hr synthesis: unfold the lr video into overlapping windows of
    segment_length + 2*context (stride segment_length), run the generator per
    window with the same z, yield hr segments.

    `prefetch` windows are enqueued ahead of the one being yielded, so the
    device keeps synthesizing while the consumer copies and encodes. On a
    CUDA `lr_video` every window is computed on the device's synthesis
    stream (`synthesis_stream`), which first waits for the caller's current
    stream; the consumer's current stream at each yield then waits for that
    segment's window alone. So a consumer's `.cpu()` returns once its own
    segment is done, not after the prefetched windows, and the copy runs
    while the next window computes. On the CPU the windows run in turn.
    Each in-flight segment holds one hr segment plus its synthesis
    workspace on the device. While a profiler records, each window's
    enqueue is a span `lvg.segment`.
    """
    global segments, stream_segments
    n, c, t, h, w = lr_video.shape
    out_t = t - 2 * temporal_context
    assert out_t > 0 and out_t % segment_length == 0
    if z is None:
        if generator is None:
            raise ValueError("need z or a torch.Generator to draw it from")
        z = torch.randn((n, G.latent_z_dim), generator=generator,
                        device=generator.device).to(lr_video.device)
    side = None
    if lr_video.is_cuda:
        side = synthesis_stream(lr_video.device.index)
        side.wait_stream(torch.cuda.current_stream(lr_video.device))
        # The caller may free these while the stream still reads them.
        lr_video.record_stream(side)
        z.record_stream(side)
    win = segment_length + 2 * temporal_context
    pending = collections.deque()
    for start in range(0, out_t, segment_length):
        with annotate("lvg.segment"):
            if side is None:
                pending.append((G(lr_video[:, :, start:start + win], z=z, **kwargs), None))
            else:
                with torch.cuda.stream(side):
                    segment = G(lr_video[:, :, start:start + win], z=z, **kwargs)
                    pending.append((segment, side.record_event()))
                stream_segments += 1
        segments += 1
        while len(pending) > max(prefetch, 0):
            yield _hand_over(*pending.popleft())
    while pending:
        yield _hand_over(*pending.popleft())
