"""Stage-1 low-resolution video discriminator.

Benchmark reference: plain PyTorch in float32 on one process, importing only
`h100_bench.reference`; initializers declare `init_stds()` in place of
drawing. It follows the published model (NVlabs/long-video-gan,
`model/discriminator_lres.py`) with the JAX package's numerics
(`long_video_gan_tpu/models/discriminator_lres.py`), and names its
parameters as the program does.

36x64 videos are zero-padded to a square `max_edge` x `max_edge`; four
residual 3D-conv blocks walk down space and time with binomial [1, 3, 3, 1]
x2 downsampling; a temporal conv1d epilogue flattens space and scores one
logit per clip.

Departures from the program, none of which changes a first-order number:
  * float32 only (no bfloat16 blocks, `num_fp16_res`), and the epilogue
    without its optional temporal downsampling (`num_downsamples`, 0 in
    every preset);
  * the dense convolutions are `F.conv1d` and `F.conv3d`, so R1's second
    derivative runs PyTorch's own double backward (its whole-output-filter
    weight term among them) where the program runs its three cuDNN kernels
    (`ops/conv.py`): the same values, summed in another order.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .models_common import FullyConnectedLayer
from .ops import bias_act, downsample2d, filter_buffer

BINOMIAL = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32) / 8.0


class Conv1dLayer(nn.Module):
    """Equalized-lr conv1d over T of [N, C, T], then the bias and the
    activation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 activation: str = "linear", device=None):
        super().__init__()
        self.in_channels, self.kernel_size, self.activation = in_channels, kernel_size, activation
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size,
                                               device=device))
        self._bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def init_stds(self) -> dict[str, float]:
        return {"weight": 1.0}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * (1.0 / math.sqrt(self.in_channels * self.kernel_size))
        y = F.conv1d(x, w, padding=self.kernel_size // 2) + self._bias[None, :, None]
        return bias_act(y, act=self.activation)


class Downsample3d(nn.Module):
    """Binomial x2 downsampling of [N, C, T, H, W] in space (time folded into
    channels) and/or time (space folded into the last axis)."""

    def __init__(self, spatial: bool, temporal: bool, device=None):
        super().__init__()
        self.spatial, self.temporal = spatial, temporal
        self.register_buffer("filter", filter_buffer(BINOMIAL, device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial:
            n, c, t, h, w = x.shape
            y = downsample2d(x.reshape(n, c * t, h, w), self.filter, down=2)
            x = y.reshape(n, c, t, y.shape[2], y.shape[3])
        if self.temporal:
            n, c, t, h, w = x.shape
            y = downsample2d(x.reshape(n, c, t, h * w), self.filter.reshape(-1, 1), down=(1, 2))
            x = y.reshape(n, c, y.shape[2], h, w)
        return x


class Conv3dLayer(nn.Module):
    """Equalized-lr conv3d, optional binomial downsampling, bias, activation
    and clamp."""

    def __init__(self, in_channels: int, out_channels: int, spatial_ksize: int,
                 temporal_ksize: int, use_bias: bool = True, spatial_down: bool = False,
                 temporal_down: bool = False, activation: str = "linear",
                 conv_clamp: Optional[float] = None, device=None):
        super().__init__()
        self.fan_in = in_channels * temporal_ksize * spatial_ksize ** 2
        self.padding = (temporal_ksize // 2, spatial_ksize // 2, spatial_ksize // 2)
        self.activation, self.conv_clamp = activation, conv_clamp
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, temporal_ksize,
                                               spatial_ksize, spatial_ksize, device=device))
        self._bias = nn.Parameter(torch.zeros(out_channels, device=device)) if use_bias else None
        self.downsample = (Downsample3d(spatial_down, temporal_down, device)
                           if spatial_down or temporal_down else None)

    def init_stds(self) -> dict[str, float]:
        return {"weight": 1.0}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x, self.weight * (1.0 / math.sqrt(self.fan_in)), padding=self.padding)
        if self.downsample is not None:
            y = self.downsample(y)
        return bias_act(y, self._bias, act=self.activation, clamp=self.conv_clamp)


class DiscriminatorBlock(nn.Module):
    """(conv_vid), conv_0, conv_1 with downsampling, and a downsampling 1x1x1
    skip, summed at sqrt(1/2)."""

    def __init__(self, in_channels: int, out_channels: int, vid_channels: int = 0,
                 spatial_ksize: int = 3, temporal_ksize: int = 5, spatial_down: bool = True,
                 temporal_down: bool = True, conv_clamp: Optional[float] = 256.0, device=None):
        super().__init__()
        self.conv_vid = None
        if vid_channels > 0:
            self.conv_vid = Conv3dLayer(vid_channels, in_channels, 1, 1, activation="lrelu",
                                        conv_clamp=conv_clamp, device=device)
        self.conv_0 = Conv3dLayer(in_channels, in_channels, spatial_ksize, temporal_ksize,
                                  activation="lrelu", conv_clamp=conv_clamp, device=device)
        self.conv_1 = Conv3dLayer(in_channels, out_channels, spatial_ksize, temporal_ksize,
                                  spatial_down=spatial_down, temporal_down=temporal_down,
                                  activation="lrelu", conv_clamp=conv_clamp, device=device)
        self.conv_skip = Conv3dLayer(in_channels, out_channels, 1, 1, use_bias=False,
                                     spatial_down=spatial_down, temporal_down=temporal_down,
                                     conv_clamp=conv_clamp, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_vid is not None:
            x = self.conv_vid(x)
        return (self.conv_1(self.conv_0(x)) + self.conv_skip(x)) * math.sqrt(0.5)


class DiscriminatorEpilogue(nn.Module):
    """[N, C, T, H, W] -> [N, C*H*W, T]; conv1d layers over time (1x1 first,
    then `temporal_ksize`), then fully connected layers to one logit."""

    def __init__(self, in_res: int, in_seq_length: int, in_channels: int,
                 channels: int = 1024, temporal_ksize: int = 3, num_conv1d_layers: int = 4,
                 num_linear_layers: int = 2, device=None):
        super().__init__()
        self.conv1d = nn.ModuleList([
            Conv1dLayer(in_res ** 2 * in_channels if i == 0 else channels, channels,
                        kernel_size=1 if i == 0 else temporal_ksize, activation="lrelu",
                        device=device)
            for i in range(num_conv1d_layers)])
        self.linear = nn.ModuleList([
            FullyConnectedLayer(in_seq_length * channels if i == 0 else channels,
                                1 if i == num_linear_layers - 1 else channels,
                                activation="linear" if i == num_linear_layers - 1 else "lrelu",
                                device=device)
            for i in range(num_linear_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, t, h, w = x.shape
        feats = x.permute(0, 1, 3, 4, 2).reshape(n, c * h * w, t)
        for layer in self.conv1d:
            feats = layer(feats)
        feats = feats.reshape(n, -1)
        for layer in self.linear:
            feats = layer(feats)
        return feats


class VideoDiscriminator(nn.Module):
    """The stage-1 discriminator at `channels_max` (512 published)."""

    def __init__(self, seq_length: int, max_edge: int, channels_max: int = 512,
                 num_fp16_res: int = 0, epilogue_kwargs: Optional[dict] = None, device=None):
        super().__init__()
        assert num_fp16_res == 0, "the reference runs in float32"
        self.max_edge = max_edge
        ch = lambda c: min(c, channels_max)  # noqa: E731
        cfgs = [dict(in_channels=ch(32), out_channels=ch(64), vid_channels=3, temporal_ksize=1,
                     temporal_down=False, spatial_down=max_edge > 32),
                dict(in_channels=ch(64), out_channels=ch(128), temporal_down=seq_length >= 4),
                dict(in_channels=ch(128), out_channels=ch(256), temporal_down=seq_length >= 8),
                dict(in_channels=ch(256), out_channels=ch(512), temporal_down=seq_length >= 16)]
        self.blocks = nn.ModuleList([DiscriminatorBlock(**c, device=device) for c in cfgs])
        spatial = math.prod(2 if c.get("spatial_down", True) else 1 for c in cfgs)
        temporal = math.prod(2 if c["temporal_down"] else 1 for c in cfgs)
        self.epilogue = DiscriminatorEpilogue(max_edge // spatial, seq_length // temporal,
                                              ch(512), **(epilogue_kwargs or {}), device=device)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        px = (self.max_edge - videos.shape[4]) // 2
        py = (self.max_edge - videos.shape[3]) // 2
        feats = F.pad(videos, [px, px, py, py])
        for block in self.blocks:
            feats = block(feats)
        return self.epilogue(feats)
