"""Stage-1 low-resolution video discriminator.

Counterpart of `long_video_gan_tpu/models/discriminator_lres.py`: 36x64
videos are zero-padded to a square `max_edge` x `max_edge`, four residual
Conv3d blocks walk down space and time with binomial [1, 3, 3, 1] x2
downsampling, and a temporal Conv1d epilogue flattens space and scores one
logit per clip. Blocks below the `num_fp16_res` cut run in bfloat16 and the
epilogue in float32, as in the JAX package.

Every FIR (the blocks' spatial and temporal downsampling, the epilogue's
`TemporalLinearDownsample`) runs through `ops.upfirdn2d`, whose gradient is
its adjoint, and every dense conv through `ops.conv`, whose gradients of
every order are cuDNN's three convolution kernels, so R1's second
derivative runs the same kinds of convolution as the forward.
While a profiler records, each block opens `lvg.layer.D.block<i>` and the
epilogue `lvg.layer.D.epilogue`, each with its `.bwd` on autograd's thread
where its input requires a gradient (`utils/profiling.layer_span`).
Parameters are named as the JAX variables (`weight`, `_bias`; the lists
`blocks`, `epilogue.conv1d` and `epilogue.linear` are the flax `name_N`
submodules), so `io.convert_torch` maps a flax tree onto the state_dict.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv import conv
from ..ops.filters import binomial_filter
from ..ops.upfirdn2d import downsample2d
from ..utils.misc import assert_shape
from ..utils.profiling import annotate, layer_span
from .common import FullyConnectedLayer, TemporalLinearDownsample, filter_buffer, randn_

# ---------------------------------------------------------------------------


class Conv1dLayer(nn.Module):
    """Equalized-lr conv1d over the time axis of [N, C, T], with an optional
    x2 linear temporal downsampling between the bias and the activation."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 kernel_size: int = 1, use_bias: bool = True, activation: str = "linear",
                 lr_multiplier: float = 1.0, weight_std_init: float = 1.0,
                 bias_init: float = 0.0, downsample: bool = False, device=None):
        super().__init__()
        assert activation in activation_funcs
        out_channels = out_channels or in_channels
        self.in_channels, self.kernel_size = in_channels, kernel_size
        self.activation, self.lr_multiplier = activation, lr_multiplier
        self.weight_std_init = weight_std_init
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size,
                                               device=device))
        self._bias = None
        if use_bias:
            self._bias = nn.Parameter(torch.full((out_channels,), bias_init / lr_multiplier,
                                                 device=device))
        self._downsample = TemporalLinearDownsample(scale=2, device=device) if downsample else None

    def reset_parameters_(self, generator: torch.Generator) -> None:
        randn_(self.weight, generator, self.weight_std_init / self.lr_multiplier)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight_gain = self.lr_multiplier / math.sqrt(self.in_channels * self.kernel_size)
        w = (self.weight * weight_gain).to(x.dtype)
        y = conv(x, w, (self.kernel_size // 2,))
        if self._bias is not None:
            b = self._bias * self.lr_multiplier if self.lr_multiplier != 1 else self._bias
            y = y + b.to(y.dtype)[None, :, None]
        if self._downsample is not None:
            y = self._downsample(y)
        return bias_act(y, act=self.activation)


class Conv3dLayer(nn.Module):
    """Equalized-lr conv3d over [N, C, T, H, W], with optional binomial
    downsampling before the bias and activation."""

    def __init__(self, in_channels: int, out_channels: int, spatial_ksize: int,
                 temporal_ksize: int, use_bias: bool = True, spatial_down: bool = False,
                 temporal_down: bool = False, activation: str = "linear",
                 conv_clamp: Optional[float] = None, device=None):
        super().__init__()
        assert activation in activation_funcs
        self.in_channels = in_channels
        self.spatial_ksize, self.temporal_ksize = spatial_ksize, temporal_ksize
        self.activation, self.conv_clamp = activation, conv_clamp
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, temporal_ksize,
                                               spatial_ksize, spatial_ksize, device=device))
        self._bias = nn.Parameter(torch.zeros(out_channels, device=device)) if use_bias else None
        self.downsample = None
        if spatial_down or temporal_down:
            self.downsample = Downsample3d(spatial_down, temporal_down, device=device)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        randn_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fan_in = self.in_channels * self.temporal_ksize * self.spatial_ksize ** 2
        w = (self.weight * (1.0 / math.sqrt(fan_in))).to(x.dtype)
        pt, ps = self.temporal_ksize // 2, self.spatial_ksize // 2
        y = conv(x, w, (pt, ps, ps))
        if self.downsample is not None:
            y = self.downsample(y)
        b = self._bias.to(y.dtype) if self._bias is not None else None
        return bias_act(y, b, act=self.activation, clamp=self.conv_clamp)


class Downsample3d(nn.Module):
    """Binomial [1, 3, 3, 1] spatial and/or temporal x2 downsampling of
    [N, C, T, H, W]: time folds into channels for the spatial pass, space
    into the last axis for the temporal one."""

    def __init__(self, spatial_down: bool = True, temporal_down: bool = True, device=None):
        super().__init__()
        self.spatial_down, self.temporal_down = spatial_down, temporal_down
        self.register_buffer("filter", filter_buffer(binomial_filter(), device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 5
        if self.spatial_down:
            n, c, t, h, w = x.shape
            y = downsample2d(x.reshape(n, c * t, h, w), self.filter, down=2)
            x = y.reshape(n, c, t, y.shape[2], y.shape[3])
        if self.temporal_down:
            n, c, t, h, w = x.shape
            y = downsample2d(x.reshape(n, c, t, h * w), self.filter.reshape(-1, 1), down=(1, 2))
            x = y.reshape(n, c, y.shape[2], h, w)
        return x


# ---------------------------------------------------------------------------


class DiscriminatorBlock(nn.Module):
    """Residual 3D block: (conv_vid), conv_0, conv_1 with downsampling, and a
    downsampling 1x1x1 skip, summed at sqrt(1/2). With `use_fp16` the block
    runs in `half_dtype` (bfloat16)."""

    def __init__(self, in_channels: int, out_channels: int, vid_channels: int = 0,
                 spatial_ksize: int = 3, temporal_ksize: int = 5,
                 spatial_ksize_1: Optional[int] = None, temporal_ksize_1: Optional[int] = None,
                 spatial_down: bool = True, temporal_down: bool = True,
                 conv_clamp: Optional[float] = 256.0, use_fp16: bool = False,
                 half_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.use_fp16, self.half_dtype = use_fp16, half_dtype
        self.conv_vid = None
        if vid_channels > 0:
            self.conv_vid = Conv3dLayer(vid_channels, in_channels, 1, 1, activation="lrelu",
                                        conv_clamp=conv_clamp, device=device)
        self.conv_0 = Conv3dLayer(in_channels, in_channels, spatial_ksize, temporal_ksize,
                                  activation="lrelu", conv_clamp=conv_clamp, device=device)
        self.conv_1 = Conv3dLayer(in_channels, out_channels, spatial_ksize_1 or spatial_ksize,
                                  temporal_ksize_1 or temporal_ksize,
                                  spatial_down=spatial_down, temporal_down=temporal_down,
                                  activation="lrelu", conv_clamp=conv_clamp, device=device)
        self.conv_skip = Conv3dLayer(in_channels, out_channels, 1, 1, use_bias=False,
                                     spatial_down=spatial_down, temporal_down=temporal_down,
                                     conv_clamp=conv_clamp, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 5
        x = x.to(self.half_dtype if self.use_fp16 else torch.float32)
        if self.conv_vid is not None:
            x = self.conv_vid(x)
        hidden = self.conv_0(x)
        skip = self.conv_skip(x)
        hidden = self.conv_1(hidden)
        return (hidden + skip) * math.sqrt(0.5)


class DiscriminatorEpilogue(nn.Module):
    """Space-flattening temporal epilogue, in float32: [N, C, T, H, W] ->
    [N, C*H*W, T], `num_conv1d_layers` conv1d over time (the first
    `num_downsamples` halving it), then `num_linear_layers` FC layers to one
    logit."""

    def __init__(self, in_res: int = 4, in_seq_length: int = 16, in_channels: int = 512,
                 channels: int = 1024, temporal_ksize: int = 3, num_conv1d_layers: int = 4,
                 num_linear_layers: int = 2, conv_clamp: Optional[float] = 256.0,
                 num_downsamples: int = 0, device=None):
        super().__init__()
        del conv_clamp   # accepted as the JAX module does; its layers do not clamp
        assert num_downsamples <= num_conv1d_layers
        assert in_seq_length % (2 ** num_downsamples) == 0
        self.in_res, self.in_seq_length, self.in_channels = in_res, in_seq_length, in_channels
        self.conv1d = nn.ModuleList([
            Conv1dLayer((in_res ** 2) * in_channels if i == 0 else channels, channels,
                        kernel_size=1 if i == 0 else temporal_ksize, activation="lrelu",
                        downsample=i < num_downsamples, device=device)
            for i in range(num_conv1d_layers)])
        self.linear = nn.ModuleList([
            FullyConnectedLayer(
                in_seq_length * channels // (2 ** num_downsamples) if i == 0 else channels,
                1 if i == num_linear_layers - 1 else channels,
                activation="linear" if i == num_linear_layers - 1 else "lrelu", device=device)
            for i in range(num_linear_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert_shape(x, (None, self.in_channels, self.in_seq_length, self.in_res, self.in_res))
        n, c, t, h, w = x.shape
        feats = x.float().permute(0, 1, 3, 4, 2).reshape(n, c * h * w, t)
        for layer in self.conv1d:
            feats = layer(feats)
        feats = feats.reshape(n, -1)
        for layer in self.linear:
            feats = layer(feats)
        return feats


# ---------------------------------------------------------------------------


class VideoDiscriminator(nn.Module):
    """Stage-1 video discriminator. `channels_max=512` is the released
    configuration; lower values scale the 32 -> 512 channel ladder down for
    tests, as `epilogue_kwargs` does the epilogue."""

    def __init__(self, seq_length: int, max_edge: int, channels: int = 3,
                 channels_base: int = 2048, channels_max: int = 512, spatial_ksize: int = 3,
                 temporal_ksize: int = 5, spatial_ksize_1: Optional[int] = None,
                 temporal_ksize_1: Optional[int] = None, conv_clamp: Optional[float] = 256.0,
                 num_fp16_res: int = 0, epilogue_kwargs: Optional[dict] = None, device=None):
        super().__init__()
        del channels_base   # kept for config parity (unused upstream too)
        self.seq_length, self.max_edge, self.channels = seq_length, max_edge, channels
        ch = lambda c: min(c, channels_max)  # noqa: E731
        kwargs = dict(spatial_ksize=spatial_ksize, temporal_ksize=temporal_ksize,
                      spatial_ksize_1=spatial_ksize_1, temporal_ksize_1=temporal_ksize_1,
                      conv_clamp=conv_clamp)
        cfgs = [
            dict(in_channels=ch(32), out_channels=ch(64), vid_channels=channels,
                 spatial_ksize=spatial_ksize, temporal_ksize=1, temporal_down=False,
                 spatial_down=max_edge > 32, use_fp16=num_fp16_res > 0, conv_clamp=conv_clamp),
            dict(in_channels=ch(64), out_channels=ch(128), use_fp16=num_fp16_res > 1,
                 temporal_down=seq_length >= 4, **kwargs),
            dict(in_channels=ch(128), out_channels=ch(256), use_fp16=num_fp16_res > 2,
                 temporal_down=seq_length >= 8, **kwargs),
            dict(in_channels=ch(256), out_channels=ch(512), use_fp16=num_fp16_res > 3,
                 temporal_down=seq_length >= 16, **kwargs),
        ]
        self.blocks = nn.ModuleList([DiscriminatorBlock(**cfg, device=device) for cfg in cfgs])
        spatial_scale = math.prod(2 if cfg.get("spatial_down", True) else 1 for cfg in cfgs)
        temporal_scale = math.prod(2 if cfg.get("temporal_down", True) else 1 for cfg in cfgs)
        self.epilogue = DiscriminatorEpilogue(
            in_res=max_edge // spatial_scale, in_seq_length=seq_length // temporal_scale,
            in_channels=cfgs[-1]["out_channels"], **(epilogue_kwargs or {}), device=device)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        with annotate("lvg.D"):
            assert_shape(videos, (None, self.channels, self.seq_length, None, None))
            assert videos.shape[3] == self.max_edge or videos.shape[4] == self.max_edge
            px = (self.max_edge - videos.shape[4]) // 2
            py = (self.max_edge - videos.shape[3]) // 2
            feats = F.pad(videos, [px, px, py, py])
            for i, block in enumerate(self.blocks):
                feats = layer_span(f"lvg.layer.D.block{i}", block, feats)
            return layer_span("lvg.layer.D.epilogue", self.epilogue, feats)
