"""Stage-1 low-resolution video generator (36x64, long sequences).

Counterpart of `long_video_gan_tpu/models/generator_lres.py`: an
unconditional 3D-conv video GAN driven by a multi-timescale "blurred noise"
temporal latent. Modulation is applied to the activations and demodulation to
the conv output, so each modulated conv3d is one dense `conv3d`. Magnitude
EMAs are buffers; half-precision layers run in bfloat16.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import bias_act
from ..ops.filters import design_kaiser_lowpass
from ..utils.misc import assert_shape
from .common import (
    FullyConnectedLayer,
    MagnitudeEMA,
    SpatialBilinearUpsample,
    TemporalKaiserDownsample,
    TemporalLinearUpsample,
    center_crop,
    normalize_2nd_moment,
    randn_,
)


def temporal_modulated_conv3d(
    x: torch.Tensor,                   # [N, Ci, T, H, W]
    weight: torch.Tensor,              # [Co, Ci, kt, kh, kw]
    style: torch.Tensor,               # [N, Ci, T] per-timestep styles
    input_gain: Optional[torch.Tensor] = None,
    padding: tuple[int, int, int] = (0, 0, 0),
    demodulate: bool = True,
) -> torch.Tensor:
    """Modulated conv3d with per-timestep styles; weights, styles and the
    demodulation coefficients in f32, the conv in x's dtype."""
    assert x.ndim == 5
    batch, in_channels = x.shape[0], x.shape[1]
    assert_shape(weight, (None, in_channels, None, None, None))
    assert_shape(style, (batch, in_channels, None))

    weight = weight.float()
    style = style.float()

    if demodulate:
        weight = weight / weight.abs().amax(dim=(1, 2, 3, 4), keepdim=True)
        style = style / style.abs().amax(dim=(1, 2), keepdim=True)

    num_inputs = int(np.prod(weight.shape[1:]))
    weight = weight / math.sqrt(num_inputs)

    if demodulate:
        demod = torch.einsum("oizyx,nit->not", weight.square(), style.square())
        demod = (demod + 1e-8).rsqrt()                                   # [N, Co, T]

    if input_gain is not None:
        assert input_gain.ndim == 0
        x = x * input_gain.to(x.dtype)

    x = x * style[:, :, :, None, None].to(x.dtype)
    y = F.conv3d(x, weight.to(x.dtype), padding=padding)

    if demodulate:
        y = y * demod[:, :, :, None, None].to(y.dtype)
    return y


# ---------------------------------------------------------------------------


class BlurredNoise(nn.Module):
    """Multi-timescale temporal latent: white noise blurred by a bank of
    Kaiser low-pass filters at log-spaced sampling rates (one
    1 -> blur_widths channel conv1d)."""

    def __init__(self, channels: int = 1024, min_sampling_rate: float = 250.0,
                 max_sampling_rate: float = 10000.0, blur_widths: int = 128,
                 cutoff: float = 2.0, width: float = 12.0, sampling_rate_base: float = 2.0,
                 normalize_per_filter: float = 1.0, device=None):
        super().__init__()
        assert channels % blur_widths == 0
        self.blur_widths = blur_widths
        self.noise_channels = channels // blur_widths
        self.kernel_size = int(np.ceil(max_sampling_rate / 2))

        if sampling_rate_base > 1:
            lo = math.log(min_sampling_rate, sampling_rate_base)
            hi = math.log(max_sampling_rate, sampling_rate_base)
            rates = sampling_rate_base ** np.linspace(lo, hi, blur_widths)
            rates = np.clip(rates, min_sampling_rate, max_sampling_rate)
        else:
            rates = np.linspace(min_sampling_rate, max_sampling_rate, blur_widths)

        filters = np.zeros((blur_widths, self.kernel_size), dtype=np.float32)
        for i, rate in enumerate(rates):
            taps = int(np.ceil(rate / 2))
            filters[i, -taps:] = design_kaiser_lowpass(taps, cutoff, width, rate)

        # Per-filter output scale, folded as the JAX package applies it.
        scale = np.ones((blur_widths,), np.float32)
        if normalize_per_filter > 0:
            output_scale = 1.0 / np.sqrt((filters ** 2).sum(axis=1))
            scale = (1.0 + normalize_per_filter * (output_scale - 1.0)).astype(np.float32)
        self.register_buffer("blur_filters", torch.as_tensor(filters[:, None, :], device=device),
                             persistent=False)                            # [widths, 1, taps]
        self.register_buffer("output_scale", torch.as_tensor(scale[None, :, None], device=device),
                             persistent=False)

    def forward(self, batch_size: int, seq_length: int, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Blur injected `noise` [N, noise_channels, seq_length + kernel_size - 1],
        or noise drawn from `generator`."""
        input_len = seq_length + self.kernel_size - 1
        if noise is None:
            if generator is None:
                raise ValueError("need noise or a torch.Generator to draw it from")
            noise = torch.randn((batch_size, self.noise_channels, input_len),
                                generator=generator, device=generator.device)
        noise = noise.to(self.blur_filters.device)
        assert_shape(noise, (batch_size, self.noise_channels, input_len))
        return self.blur(noise)

    def blur(self, noise: torch.Tensor) -> torch.Tensor:
        n, c, t_in = noise.shape
        assert c == self.noise_channels
        # conv1d correlates, as the JAX package's conv does: no flip.
        feats = F.conv1d(noise.reshape(n * c, 1, t_in).float(), self.blur_filters)
        feats = feats * self.output_scale
        return feats.reshape(n, c * self.blur_widths, feats.shape[-1])


# ---------------------------------------------------------------------------


class LatentMappingNetwork(nn.Module):
    """Per-timestep MLP mapping temporal embedding -> w."""

    def __init__(self, temporal_emb_dim: int = 1024, latent_w_dim: int = 1024,
                 num_layers: int = 2, activation: str = "lrelu", lrate_mul: float = 0.01,
                 normalize_input: bool = True, device=None):
        super().__init__()
        self.temporal_emb_dim, self.latent_w_dim = temporal_emb_dim, latent_w_dim
        self.num_layers = num_layers
        self.normalize_input = normalize_input
        for index in range(num_layers):
            in_dim = temporal_emb_dim if index == 0 else latent_w_dim
            self.add_module(f"layer_{index}", FullyConnectedLayer(
                in_dim, latent_w_dim, activation=activation, lrate_mul=lrate_mul, device=device))

    def forward(self, temporal_emb: torch.Tensor) -> torch.Tensor:
        assert_shape(temporal_emb, (None, self.temporal_emb_dim, None))
        if self.normalize_input:
            temporal_emb = normalize_2nd_moment(temporal_emb)
        n, c, t = temporal_emb.shape
        x = temporal_emb.transpose(1, 2).reshape(n * t, c)
        for index in range(self.num_layers):
            x = getattr(self, f"layer_{index}")(x)
        return x.reshape(n, t, self.latent_w_dim).transpose(1, 2)


# ---------------------------------------------------------------------------


class Synthesis3dResBlock(nn.Module):
    """Residual modulated-conv3d block with optional temporal/spatial x2 up
    (two modulated convs, 1x1x1 skip, magnitude-EMA input gains, lrelu clamp
    256, upsample then center-crop bookkeeping)."""

    def __init__(self, latent_dim: int, in_channels: int, out_channels: Optional[int] = None,
                 out_width: Optional[int] = None, out_height: Optional[int] = None,
                 temporal_ksize: int = 1, spatial_ksize: int = 1, temporal_up: bool = False,
                 spatial_up: bool = False, activation: str = "lrelu",
                 activation_clamp: Optional[float] = 256.0, magnitude_ema: bool = True,
                 demodulate: bool = True, half_dtype: torch.dtype = torch.bfloat16,
                 use_half: bool = False, device=None):
        super().__init__()
        ic = in_channels
        oc = out_channels or in_channels
        self.latent_dim = latent_dim
        self.in_channels, self.out_ch = ic, oc
        self.out_width, self.out_height = out_width, out_height
        self.temporal_ksize, self.spatial_ksize = temporal_ksize, spatial_ksize
        self.temporal_up, self.spatial_up = temporal_up, spatial_up
        self.activation, self.activation_clamp = activation, activation_clamp
        self.magnitude_ema = magnitude_ema
        self.half_dtype, self.use_half = half_dtype, use_half
        kt, ks = temporal_ksize, spatial_ksize
        self.affine_0 = FullyConnectedLayer(latent_dim, ic, bias_init=1.0, device=device)
        self.affine_1 = FullyConnectedLayer(latent_dim, ic, bias_init=1.0, device=device)
        self.weight_0 = nn.Parameter(torch.zeros(ic, ic, kt, ks, ks, device=device))
        self.weight_1 = nn.Parameter(torch.zeros(oc, ic, kt, ks, ks, device=device))
        self.weight_skip = nn.Parameter(torch.zeros(oc, ic, 1, 1, 1, device=device))
        self.bias_0 = nn.Parameter(torch.zeros(ic, device=device))
        self.bias_1 = nn.Parameter(torch.zeros(oc, device=device))
        if magnitude_ema:
            self.input_magnitude_ema_0 = MagnitudeEMA(device=device)
            self.input_magnitude_ema_1 = MagnitudeEMA(device=device)
        if temporal_up:
            self.temporal_upsample = TemporalLinearUpsample(device=device)
        if spatial_up:
            self.spatial_upsample = SpatialBilinearUpsample(device=device)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        for p in (self.weight_0, self.weight_1, self.weight_skip):
            randn_(p, generator)

    def forward(self, x: torch.Tensor, latent: torch.Tensor, magnitude_ema_beta: float = 1.0,
                out_seq_length: Optional[int] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        assert_shape(x, (None, self.in_channels, None, None, None))
        batch, in_t = x.shape[0], x.shape[2]
        assert_shape(latent, (batch, self.latent_dim, in_t))

        latent_flat = latent.transpose(1, 2).reshape(batch * in_t, self.latent_dim)
        style_0 = self.affine_0(latent_flat).reshape(batch, in_t, -1).transpose(1, 2)

        dtype = dtype if dtype is not None else (self.half_dtype if self.use_half else torch.float32)
        x = x.to(dtype)

        if self.magnitude_ema:
            x = x * self.input_magnitude_ema_0(x, magnitude_ema_beta).to(dtype)

        padding = (self.temporal_ksize // 2, self.spatial_ksize // 2, self.spatial_ksize // 2)
        h = temporal_modulated_conv3d(x, self.weight_0, style_0, padding=padding, demodulate=True)
        h = bias_act(h, self.bias_0.to(h.dtype), act=self.activation, clamp=self.activation_clamp)

        style_1 = self.affine_1(latent_flat).reshape(batch, in_t, -1).transpose(1, 2)
        gain_1 = self.input_magnitude_ema_1(h, magnitude_ema_beta) if self.magnitude_ema else None
        h = temporal_modulated_conv3d(h, self.weight_1, style_1, gain_1, padding, demodulate=True)

        skip_gain = 1.0 / math.sqrt(self.in_channels)
        skip = F.conv3d(x, (self.weight_skip * skip_gain).to(x.dtype))
        h = (skip + h) * math.sqrt(0.5)

        if self.temporal_up:
            h = self.temporal_upsample(h)
        h = center_crop(h, seq_length=out_seq_length)
        if self.spatial_up:
            h = self.spatial_upsample(h)
        h = center_crop(h, width=self.out_width, height=self.out_height)

        out = bias_act(h, self.bias_1.to(h.dtype), act=self.activation, clamp=self.activation_clamp)
        assert_shape(out, (None, self.out_ch, None, self.out_height, self.out_width))
        return out


class ToRGB(nn.Module):
    """Non-demodulated 1x1x1 modulated conv to RGB."""

    def __init__(self, latent_dim: int, in_channels: int,
                 activation_clamp: Optional[float] = 256.0, magnitude_ema: bool = True,
                 half_dtype: torch.dtype = torch.bfloat16, use_half: bool = False, device=None):
        super().__init__()
        self.latent_dim, self.in_channels = latent_dim, in_channels
        self.activation_clamp = activation_clamp
        self.magnitude_ema = magnitude_ema
        self.half_dtype, self.use_half = half_dtype, use_half
        self.affine = FullyConnectedLayer(latent_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.zeros(3, in_channels, 1, 1, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(3, device=device))
        if magnitude_ema:
            self.input_magnitude_ema = MagnitudeEMA(device=device)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        randn_(self.weight, generator)

    def forward(self, x: torch.Tensor, latent: torch.Tensor, magnitude_ema_beta: float = 1.0,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        assert_shape(x, (None, self.in_channels, None, None, None))
        batch, in_t = x.shape[0], x.shape[2]
        assert_shape(latent, (batch, self.latent_dim, in_t))

        latent_flat = latent.transpose(1, 2).reshape(batch * in_t, self.latent_dim)
        style = self.affine(latent_flat).reshape(batch, in_t, -1).transpose(1, 2)

        dtype = dtype if dtype is not None else (self.half_dtype if self.use_half else torch.float32)
        x = x.to(dtype)
        gain = self.input_magnitude_ema(x, magnitude_ema_beta) if self.magnitude_ema else None
        y = temporal_modulated_conv3d(x, self.weight, style, gain, demodulate=False)
        return bias_act(y, self.bias.to(y.dtype), act="linear", clamp=self.activation_clamp)


# ---------------------------------------------------------------------------


class VideoGenerator(nn.Module):
    """Stage-1 generator: 6 temporal + 4 spatial residual blocks + ToRGB, with
    the JAX package's construction math (scales, per-layer sizes, temporal
    bookkeeping), so its checkpoints line up layer for layer.

    `block_remat` (a JAX training memory option stored in checkpoints'
    kwargs) is accepted and does nothing at inference.
    """

    def __init__(self, out_height: int = 36, out_width: int = 64, temporal_emb_dim: int = 1024,
                 latent_w_dim: int = 1024, temporal_ksize: int = 3, spatial_ksize: int = 3,
                 temporal_padding: int = 8, spatial_padding: int = 0, output_scale: float = 0.25,
                 num_fp16_layers: int = 0, channel_max: int = 512,
                 embedding_kwargs: Optional[dict] = None, mapping_kwargs: Optional[dict] = None,
                 block_remat: bool = False, device=None):
        super().__init__()
        del block_remat
        self.out_height, self.out_width = out_height, out_width
        self.temporal_emb_dim, self.latent_w_dim = temporal_emb_dim, latent_w_dim
        self.temporal_ksize, self.spatial_ksize = temporal_ksize, spatial_ksize
        self.temporal_padding, self.spatial_padding = temporal_padding, spatial_padding
        self.output_scale = output_scale
        self.channel_max = channel_max

        heights, widths, temporal_cfg, spatial_cfg = self._plan()
        num_layers = len(temporal_cfg) + len(spatial_cfg) + 1
        # bf16 opt-in for the last N layers, counted from ToRGB backwards.
        use_half = [False] * num_layers
        for i in range(min(num_fp16_layers, num_layers)):
            use_half[num_layers - 1 - i] = True

        self.temporal_layers = nn.ModuleList([
            Synthesis3dResBlock(latent_w_dim, use_half=use_half[i], device=device, **cfg)
            for i, cfg in enumerate(temporal_cfg)])
        self.spatial_layers = nn.ModuleList([
            Synthesis3dResBlock(latent_w_dim, use_half=use_half[len(temporal_cfg) + i],
                                device=device, **cfg)
            for i, cfg in enumerate(spatial_cfg)])
        last_out = spatial_cfg[-1].get("out_channels") or spatial_cfg[-1]["in_channels"]
        self.to_rgb = ToRGB(latent_w_dim, in_channels=last_out, use_half=use_half[-1],
                            device=device)

        self.spatial_input = nn.Parameter(torch.zeros(
            1, temporal_cfg[0]["in_channels"], 1, heights[0], widths[0], device=device))
        self.temporal_emb = BlurredNoise(temporal_emb_dim, device=device,
                                         **(embedding_kwargs or {}))
        self.latent_mapping = LatentMappingNetwork(temporal_emb_dim, latent_w_dim,
                                                   device=device, **(mapping_kwargs or {}))
        self.temporal_downsample_latent = TemporalKaiserDownsample(device=device)
        self.w_to_temp_input = FullyConnectedLayer(latent_w_dim, temporal_cfg[0]["in_channels"],
                                                   device=device)
        self._temporal_ups = [cfg.get("temporal_up", False) for cfg in temporal_cfg]

    def reset_parameters_(self, generator: torch.Generator) -> None:
        randn_(self.spatial_input, generator)

    # ---- static architecture derivation (config only) ----

    def _plan(self):
        long_edge = max(self.out_height, self.out_width)
        scales = tuple(max(1, long_edge // (2 ** (2 + i))) for i in range(5))
        heights = [math.ceil(self.out_height / s) + 2 * self.spatial_padding for s in scales]
        widths = [math.ceil(self.out_width / s) + 2 * self.spatial_padding for s in scales]
        t_cfg = dict(spatial_ksize=self.spatial_ksize, temporal_ksize=self.temporal_ksize)
        s_cfg = dict(spatial_ksize=self.spatial_ksize)
        ch = lambda c: min(c, self.channel_max)  # noqa: E731
        temporal = [
            dict(in_channels=ch(512), out_height=heights[0], out_width=widths[0], temporal_up=True, **t_cfg),
            dict(in_channels=ch(512), out_height=heights[1], out_width=widths[1], temporal_up=True, spatial_up=True, **t_cfg),
            dict(in_channels=ch(512), temporal_up=True, **t_cfg),
            dict(in_channels=ch(512), out_channels=ch(512), out_height=heights[2], out_width=widths[2], temporal_up=True, spatial_up=True, **t_cfg),
            dict(in_channels=ch(512), out_channels=ch(256), temporal_up=True, **t_cfg),
            dict(in_channels=ch(256), **t_cfg),
        ]
        spatial = [
            dict(in_channels=ch(256), out_channels=ch(128), out_height=heights[3], out_width=widths[3], spatial_up=True, **s_cfg),
            dict(in_channels=ch(128), **s_cfg),
            dict(in_channels=ch(128), out_channels=ch(64), out_height=heights[4], out_width=widths[4],
                 spatial_up=heights[4] != heights[3], **s_cfg),
            dict(in_channels=ch(64), out_height=self.out_height, out_width=self.out_width, **s_cfg),
        ]
        return heights, widths, temporal, spatial

    @property
    def noise_kernel_size(self) -> int:
        return self.temporal_emb.kernel_size

    @property
    def noise_channels(self) -> int:
        return self.temporal_emb.noise_channels

    @property
    def total_temporal_scale(self) -> int:
        return 2 ** sum(self._temporal_ups)

    def compute_seq_lengths(self, seq_length: int) -> tuple[int, list[int]]:
        """Per-temporal-layer output lengths incl. the 2*temporal_padding halo."""
        seq_lengths = [seq_length]
        scale = 1
        for temporal_up in reversed(self._temporal_ups):
            if temporal_up:
                scale *= 2
            seq_lengths.append(math.ceil(seq_length / scale) + 2 * self.temporal_padding)
        input_seq_length = seq_lengths.pop()
        seq_lengths.reverse()
        return input_seq_length, seq_lengths

    def noise_shape(self, batch_size: int, seq_length: int) -> tuple[int, int, int]:
        """Shape of the white noise `forward` blurs for a `seq_length` video."""
        emb_len = self.compute_seq_lengths(seq_length)[0] * self.total_temporal_scale
        return batch_size, self.noise_channels, emb_len + self.noise_kernel_size - 1

    # ---- forward paths ----

    def sample_temporal_emb(self, batch_size: int, seq_length: int,
                            noise: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        input_len = self.compute_seq_lengths(seq_length)[0]
        emb_len = input_len * self.total_temporal_scale
        return self.temporal_emb(batch_size, emb_len, noise=noise, generator=generator)

    def compute_latent_ws(self, temporal_emb: torch.Tensor, seq_length: int) -> list[torch.Tensor]:
        assert_shape(temporal_emb, (None, self.temporal_emb_dim, None))
        latent_w = self.latent_mapping(temporal_emb)
        input_seq_length, seq_lengths = self.compute_seq_lengths(seq_length)

        # ws for the spatial layers + ToRGB (full temporal rate, seq_length).
        num_spatial = len(self.spatial_layers) + 1
        w_layer = center_crop(latent_w, seq_length=seq_lengths.pop())
        latent_ws = [w_layer for _ in range(num_spatial)]

        # ws for the temporal layers, progressively Kaiser-downsampled.
        seq_lengths.reverse()
        seq_lengths.append(input_seq_length)
        for temporal_up, layer_len in zip(reversed(self._temporal_ups), seq_lengths):
            if temporal_up:
                latent_w = self.temporal_downsample_latent(latent_w)
            latent_ws.insert(0, center_crop(latent_w, seq_length=layer_len))
        latent_ws.insert(0, latent_ws[0])
        return latent_ws

    def synthesize_video(self, temporal_input: torch.Tensor, latent_ws: Sequence[torch.Tensor],
                         seq_length: int, magnitude_ema_beta: float = 1.0,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        in_len, seq_lengths = self.compute_seq_lengths(seq_length)
        assert_shape(temporal_input, (None, self.temporal_layers[0].in_channels, in_len))

        x = (temporal_input[:, :, :, None, None] + self.spatial_input) * math.sqrt(0.5)
        w_index = 0
        for layer, layer_len in zip(self.temporal_layers, seq_lengths):
            x = layer(x, latent_ws[w_index], magnitude_ema_beta, layer_len, dtype)
            w_index += 1
        for layer in self.spatial_layers:
            x = layer(x, latent_ws[w_index], magnitude_ema_beta, None, dtype)
            w_index += 1
        video = self.to_rgb(x, latent_ws[w_index], magnitude_ema_beta, dtype=dtype)
        return video.float() * self.output_scale

    def forward(self, batch_size: int, seq_length: int, magnitude_ema_beta: float = 1.0,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Generate [batch, 3, seq_length, out_height, out_width] videos from
        injected white `noise` (shape `noise_shape(...)`) or noise drawn from
        `generator`."""
        temporal_emb = self.sample_temporal_emb(batch_size, seq_length, noise=noise,
                                                generator=generator)
        latent_ws = self.compute_latent_ws(temporal_emb, seq_length)
        in_len = self.compute_seq_lengths(seq_length)[0]

        w0 = latent_ws.pop(0)                                            # [N, w, T_in]
        n = w0.shape[0]
        temporal_input = self.w_to_temp_input(
            w0.transpose(1, 2).reshape(n * in_len, self.latent_w_dim)
        ).reshape(n, in_len, -1).transpose(1, 2)

        return self.synthesize_video(temporal_input, latent_ws, seq_length,
                                     magnitude_ema_beta, dtype)


def sample_video_segments(G: VideoGenerator, batch_size: int, seq_length: int,
                          segment_length: int = 8, noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """Stream a long lres video in segments: the whole video is synthesized in
    one pass (cheap at 36x64); only the output splits into segments."""
    video = G(batch_size, seq_length, noise=noise, generator=generator)
    for start in range(0, video.shape[2], segment_length):
        yield video[:, :, start:start + segment_length]
