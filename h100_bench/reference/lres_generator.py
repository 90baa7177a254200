"""Stage-1 low-resolution video generator (36x64, long sequences).

Benchmark reference: plain PyTorch in float32 on one process, importing only
`h100_bench.reference`; initializers declare `init_stds()` in place of
drawing, since the benchmark draws the weights. It follows the published
model (NVlabs/long-video-gan, `model/generator_lres.py`) with the JAX
package's numerics (`long_video_gan_tpu/models/generator_lres.py`), and
names its parameters and buffers as the program does, so one state dict
loads into both.

A multi-timescale "blurred noise" temporal latent (white noise through a bank
of Kaiser low-pass filters, one `conv1d`), a per-timestep mapping MLP, the
latent Kaiser-downsampled in time for each temporal block, then 6 temporal
and 4 spatial residual blocks of modulated conv3d with per-timestep styles
and magnitude-EMA input gains, and a ToRGB. Modulation scales the
activations and demodulation the conv output, so each modulated conv3d is
one dense `F.conv3d`.

Departures from the program, none of which changes a number:
  * float32 only: the bfloat16 layers (`num_fp16_layers`) and the block
    recompute (`block_remat`) are not part of it;
  * the temporal resamplers take no edge padding (every one the model
    builds has none);
  * the noise is always drawn from the `torch.Generator` the trainer passes.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .models_common import FullyConnectedLayer, SpatialBilinearUpsample
from .ops import (bias_act, design_kaiser_lowpass, downsample2d, filter_buffer,
                  kaiser_resample_filter, tent_filter, upsample2d)


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    return x * (x.square().mean(dim=dim, keepdim=True) + eps).rsqrt()


def center_crop(x: torch.Tensor, width: Optional[int] = None, height: Optional[int] = None,
                seq_length: Optional[int] = None) -> torch.Tensor:
    """Center-crop NCT / NCTHW tensors."""
    if width is not None:
        x0 = (x.shape[4] - width) // 2
        x = x[:, :, :, :, x0:x0 + width]
    if height is not None:
        y0 = (x.shape[3] - height) // 2
        x = x[:, :, :, y0:y0 + height]
    if seq_length is not None:
        t0 = (x.shape[2] - seq_length) // 2
        x = x[:, :, t0:t0 + seq_length]
    return x


class MagnitudeEMA(nn.Module):
    """Running mean of the input's mean square; returns its rsqrt. `beta` 1
    reads it, below 1 first moves it toward the batch's."""

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("magnitude_ema", torch.ones((), device=device))

    def forward(self, x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
        if beta != 1.0:
            mag = x.detach().float().square().mean()
            self.magnitude_ema.add_((1.0 - beta) * (mag - self.magnitude_ema))
        return self.magnitude_ema.rsqrt()


class TemporalResample(nn.Module):
    """A 1-D FIR along T of NCT / NCTHW, x2 up (zero-stuffed, gain 2) or x2
    down: space folds into the last axis, so the 2-D resampler filters
    [N, C, T, H*W] along its third axis."""

    def __init__(self, taps: np.ndarray, up: bool, device=None):
        super().__init__()
        self.up = up
        self.register_buffer("filter", filter_buffer(taps.reshape(-1, 1), device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(shape[0], shape[1], shape[2], -1)
        if self.up:
            x = upsample2d(x, self.filter, up=(1, 2))
        else:
            x = downsample2d(x, self.filter, down=(1, 2))
        return x.reshape(shape[0], shape[1], x.shape[2], *shape[3:])


def temporal_linear(up: bool, device=None) -> TemporalResample:
    return TemporalResample(tent_filter(2), up, device)


def temporal_kaiser_down(device=None) -> TemporalResample:
    return TemporalResample(kaiser_resample_filter(2), False, device)


def temporal_modulated_conv3d(x: torch.Tensor, weight: torch.Tensor, style: torch.Tensor,
                              input_gain: Optional[torch.Tensor] = None,
                              padding=(0, 0, 0), demodulate: bool = True) -> torch.Tensor:
    """Modulated conv3d of [N, Ci, T, H, W] by [Co, Ci, kt, kh, kw] with
    per-timestep styles [N, Ci, T]: both normalised by their largest
    magnitude, the weight by sqrt(fan-in); x scaled by the styles, convolved,
    the output scaled by each timestep's demodulation."""
    if demodulate:
        weight = weight / weight.abs().amax(dim=(1, 2, 3, 4), keepdim=True)
        style = style / style.abs().amax(dim=(1, 2), keepdim=True)
    weight = weight / math.sqrt(weight[0].numel())
    if input_gain is not None:
        x = x * input_gain
    y = F.conv3d(x * style[:, :, :, None, None], weight, padding=padding)
    if demodulate:
        demod = torch.einsum("oizyx,nit->not", weight.square(), style.square())
        y = y * (demod + 1e-8).rsqrt()[:, :, :, None, None]
    return y


class BlurredNoise(nn.Module):
    """White noise [N, channels / blur_widths, T + taps - 1] blurred by
    `blur_widths` Kaiser low-passes at log-spaced sampling rates, each
    scaled toward unit gain: [N, channels, T]."""

    def __init__(self, channels: int = 1024, min_sampling_rate: float = 250.0,
                 max_sampling_rate: float = 10000.0, blur_widths: int = 128,
                 cutoff: float = 2.0, width: float = 12.0, sampling_rate_base: float = 2.0,
                 normalize_per_filter: float = 1.0, device=None):
        super().__init__()
        self.blur_widths = blur_widths
        self.noise_channels = channels // blur_widths
        self.kernel_size = int(np.ceil(max_sampling_rate / 2))
        rates = np.clip(sampling_rate_base ** np.linspace(
            math.log(min_sampling_rate, sampling_rate_base),
            math.log(max_sampling_rate, sampling_rate_base), blur_widths),
            min_sampling_rate, max_sampling_rate)
        filters = np.zeros((blur_widths, self.kernel_size), dtype=np.float32)
        for i, rate in enumerate(rates):
            taps = int(np.ceil(rate / 2))
            filters[i, -taps:] = design_kaiser_lowpass(taps, cutoff, width, rate)
        scale = 1.0 + normalize_per_filter * (1.0 / np.sqrt((filters ** 2).sum(axis=1)) - 1.0)
        self.register_buffer("blur_filters", torch.as_tensor(filters[:, None, :], device=device),
                             persistent=False)
        self.register_buffer("output_scale", torch.as_tensor(
            scale.astype(np.float32)[None, :, None], device=device), persistent=False)

    def forward(self, noise: torch.Tensor) -> torch.Tensor:
        n, c, t = noise.shape
        feats = F.conv1d(noise.reshape(n * c, 1, t), self.blur_filters) * self.output_scale
        return feats.reshape(n, c * self.blur_widths, feats.shape[-1])


class LatentMappingNetwork(nn.Module):
    """Per-timestep MLP from the temporal embedding to w (lr x 0.01)."""

    def __init__(self, temporal_emb_dim: int, latent_w_dim: int, num_layers: int = 2,
                 device=None):
        super().__init__()
        self.latent_w_dim, self.num_layers = latent_w_dim, num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", FullyConnectedLayer(
                temporal_emb_dim if i == 0 else latent_w_dim, latent_w_dim, activation="lrelu",
                lrate_mul=0.01, device=device))

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        n, c, t = emb.shape
        x = normalize_2nd_moment(emb).transpose(1, 2).reshape(n * t, c)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x.reshape(n, t, self.latent_w_dim).transpose(1, 2)


def _styles(affine: FullyConnectedLayer, latent: torch.Tensor) -> torch.Tensor:
    n, c, t = latent.shape
    return affine(latent.transpose(1, 2).reshape(n * t, c)).reshape(n, t, -1).transpose(1, 2)


class Synthesis3dResBlock(nn.Module):
    """Two modulated conv3d (lrelu, clamp 256) and a 1x1x1 skip, summed at
    sqrt(1/2); then the optional x2 temporal-linear and spatial-bilinear
    upsampling with their center crops, and the second bias and lrelu."""

    def __init__(self, latent_dim: int, in_channels: int, out_channels: Optional[int] = None,
                 out_width: Optional[int] = None, out_height: Optional[int] = None,
                 temporal_ksize: int = 1, spatial_ksize: int = 1, temporal_up: bool = False,
                 spatial_up: bool = False, device=None):
        super().__init__()
        ic, oc = in_channels, out_channels or in_channels
        self.in_channels = ic
        self.out_width, self.out_height = out_width, out_height
        self.padding = (temporal_ksize // 2, spatial_ksize // 2, spatial_ksize // 2)
        kt, ks = temporal_ksize, spatial_ksize
        self.affine_0 = FullyConnectedLayer(latent_dim, ic, bias_init=1.0, device=device)
        self.affine_1 = FullyConnectedLayer(latent_dim, ic, bias_init=1.0, device=device)
        self.weight_0 = nn.Parameter(torch.zeros(ic, ic, kt, ks, ks, device=device))
        self.weight_1 = nn.Parameter(torch.zeros(oc, ic, kt, ks, ks, device=device))
        self.weight_skip = nn.Parameter(torch.zeros(oc, ic, 1, 1, 1, device=device))
        self.bias_0 = nn.Parameter(torch.zeros(ic, device=device))
        self.bias_1 = nn.Parameter(torch.zeros(oc, device=device))
        self.input_magnitude_ema_0 = MagnitudeEMA(device=device)
        self.input_magnitude_ema_1 = MagnitudeEMA(device=device)
        self.temporal_up, self.spatial_up = temporal_up, spatial_up
        if temporal_up:
            self.temporal_upsample = temporal_linear(True, device)
        if spatial_up:
            self.spatial_upsample = SpatialBilinearUpsample(device=device)

    def init_stds(self) -> dict[str, float]:
        return {"weight_0": 1.0, "weight_1": 1.0, "weight_skip": 1.0}

    def forward(self, x, latent, beta: float, out_seq_length: Optional[int]) -> torch.Tensor:
        x = x * self.input_magnitude_ema_0(x, beta)
        h = temporal_modulated_conv3d(x, self.weight_0, _styles(self.affine_0, latent),
                                      padding=self.padding)
        h = bias_act(h, self.bias_0, act="lrelu", clamp=256.0)
        h = temporal_modulated_conv3d(h, self.weight_1, _styles(self.affine_1, latent),
                                      self.input_magnitude_ema_1(h, beta), self.padding)
        skip = F.conv3d(x, self.weight_skip * (1.0 / math.sqrt(self.in_channels)))
        h = (skip + h) * math.sqrt(0.5)
        if self.temporal_up:
            h = self.temporal_upsample(h)
        h = center_crop(h, seq_length=out_seq_length)
        if self.spatial_up:
            h = self.spatial_upsample(h)
        h = center_crop(h, width=self.out_width, height=self.out_height)
        return bias_act(h, self.bias_1, act="lrelu", clamp=256.0)


class ToRGB(nn.Module):
    """Non-demodulated 1x1x1 modulated conv to RGB, clamp 256."""

    def __init__(self, latent_dim: int, in_channels: int, device=None):
        super().__init__()
        self.affine = FullyConnectedLayer(latent_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.zeros(3, in_channels, 1, 1, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(3, device=device))
        self.input_magnitude_ema = MagnitudeEMA(device=device)

    def init_stds(self) -> dict[str, float]:
        return {"weight": 1.0}

    def forward(self, x, latent, beta: float) -> torch.Tensor:
        y = temporal_modulated_conv3d(x, self.weight, _styles(self.affine, latent),
                                      self.input_magnitude_ema(x, beta), demodulate=False)
        return bias_act(y, self.bias, clamp=256.0)


class VideoGenerator(nn.Module):
    """The stage-1 generator: [batch, 3, seq_length, out_height, out_width]
    videos from white noise drawn from a generator."""

    def __init__(self, out_height: int = 36, out_width: int = 64, temporal_emb_dim: int = 1024,
                 latent_w_dim: int = 1024, temporal_ksize: int = 3, spatial_ksize: int = 3,
                 temporal_padding: int = 8, output_scale: float = 0.25, channel_max: int = 512,
                 num_fp16_layers: int = 0, embedding_kwargs: Optional[dict] = None,
                 device=None):
        super().__init__()
        assert num_fp16_layers == 0, "the reference runs in float32"
        self.latent_w_dim = latent_w_dim
        self.temporal_padding, self.output_scale = temporal_padding, output_scale
        long_edge = max(out_height, out_width)
        scales = [max(1, long_edge // 2 ** (2 + i)) for i in range(5)]
        hs = [math.ceil(out_height / s) for s in scales]
        ws = [math.ceil(out_width / s) for s in scales]
        ch = lambda c: min(c, channel_max)  # noqa: E731
        t = dict(spatial_ksize=spatial_ksize, temporal_ksize=temporal_ksize)
        s = dict(spatial_ksize=spatial_ksize)
        temporal = [
            dict(in_channels=ch(512), out_height=hs[0], out_width=ws[0], temporal_up=True, **t),
            dict(in_channels=ch(512), out_height=hs[1], out_width=ws[1], temporal_up=True,
                 spatial_up=True, **t),
            dict(in_channels=ch(512), temporal_up=True, **t),
            dict(in_channels=ch(512), out_channels=ch(512), out_height=hs[2], out_width=ws[2],
                 temporal_up=True, spatial_up=True, **t),
            dict(in_channels=ch(512), out_channels=ch(256), temporal_up=True, **t),
            dict(in_channels=ch(256), **t),
        ]
        spatial = [
            dict(in_channels=ch(256), out_channels=ch(128), out_height=hs[3], out_width=ws[3],
                 spatial_up=True, **s),
            dict(in_channels=ch(128), **s),
            dict(in_channels=ch(128), out_channels=ch(64), out_height=hs[4], out_width=ws[4],
                 spatial_up=hs[4] != hs[3], **s),
            dict(in_channels=ch(64), out_height=out_height, out_width=out_width, **s),
        ]
        self.temporal_layers = nn.ModuleList(
            [Synthesis3dResBlock(latent_w_dim, device=device, **c) for c in temporal])
        self.spatial_layers = nn.ModuleList(
            [Synthesis3dResBlock(latent_w_dim, device=device, **c) for c in spatial])
        self.to_rgb = ToRGB(latent_w_dim, ch(64), device=device)
        self.spatial_input = nn.Parameter(torch.zeros(1, ch(512), 1, hs[0], ws[0], device=device))
        self.temporal_emb = BlurredNoise(temporal_emb_dim, device=device,
                                         **(embedding_kwargs or {}))
        self.latent_mapping = LatentMappingNetwork(temporal_emb_dim, latent_w_dim, device=device)
        self.temporal_downsample_latent = temporal_kaiser_down(device)
        self.w_to_temp_input = FullyConnectedLayer(latent_w_dim, ch(512), device=device)
        self.temporal_ups = [c.get("temporal_up", False) for c in temporal]

    def init_stds(self) -> dict[str, float]:
        return {"spatial_input": 1.0}

    @property
    def total_temporal_scale(self) -> int:
        return 2 ** sum(self.temporal_ups)

    def seq_lengths(self, seq_length: int) -> tuple[int, list[int]]:
        """The first block's input length and each temporal block's output
        length, each with its 2 * temporal_padding frames of halo, the last
        without."""
        out = [seq_length]
        scale = 1
        for up in reversed(self.temporal_ups):
            scale *= 2 if up else 1
            out.append(math.ceil(seq_length / scale) + 2 * self.temporal_padding)
        first = out.pop()
        return first, out[::-1]

    def noise_shape(self, batch_size: int, seq_length: int) -> tuple[int, int, int]:
        emb_len = self.seq_lengths(seq_length)[0] * self.total_temporal_scale
        return (batch_size, self.temporal_emb.noise_channels,
                emb_len + self.temporal_emb.kernel_size - 1)

    def forward(self, noise: torch.Tensor, seq_length: int, beta: float = 1.0) -> torch.Tensor:
        first, lengths = self.seq_lengths(seq_length)
        latent = self.latent_mapping(self.temporal_emb(noise))
        # The spatial blocks and ToRGB read w at the full rate; each temporal
        # block one x2 Kaiser downsampling further back per upsampling after it.
        ws = [center_crop(latent, seq_length=seq_length)] * (len(self.spatial_layers) + 1)
        temporal_ws = []
        for up, length in zip(reversed(self.temporal_ups), [*lengths[:-1][::-1], first]):
            if up:
                latent = self.temporal_downsample_latent(latent)
            temporal_ws.insert(0, center_crop(latent, seq_length=length))
        w0 = temporal_ws[0]
        n = w0.shape[0]
        x = self.w_to_temp_input(w0.transpose(1, 2).reshape(n * first, self.latent_w_dim))
        x = x.reshape(n, first, -1).transpose(1, 2)
        x = (x[:, :, :, None, None] + self.spatial_input) * math.sqrt(0.5)
        for layer, w, length in zip(self.temporal_layers, temporal_ws, lengths):
            x = layer(x, w, beta, length)
        for layer, w in zip(self.spatial_layers, ws):
            x = layer(x, w, beta, None)
        return self.to_rgb(x, ws[-1], beta) * self.output_scale
