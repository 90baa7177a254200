"""Stage-2 super-resolution discriminator.

Counterpart of `long_video_gan_tpu/models/discriminator_sres.py`: the
bilinearly upsampled lr video and the hr video are concatenated, padded to a
square and time folds into channels (img_channels = 2 * 3 * seq_length);
resnet blocks walk resolutions 256 -> 8 and an epilogue scores one logit per
clip. Blocks at resolution >= the `num_fp16_res` cut run in bfloat16, as in
the JAX package. Attributes are named as the JAX submodules (`b256`, ...,
`b4`), so `flax_path_to_torch_key` maps a flax tree onto the state_dict.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.filters import setup_filter
from ..ops.upfirdn2d import downsample2d
from ..parallel.mesh import all_gather_batch, local_rows
from ..utils.profiling import annotate
from .common import FullyConnectedLayer, SpatialBilinearUpsample, filter_buffer, randn_

# ---------------------------------------------------------------------------


class Conv2dLayer(nn.Module):
    """Equalized-lr conv2d with fused FIR up/downsampling."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 use_bias: bool = True, activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter=(1, 3, 3, 1), conv_clamp: Optional[float] = None, device=None):
        super().__init__()
        assert activation in activation_funcs
        self.in_channels, self.kernel_size = in_channels, kernel_size
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.register_buffer("resample_filter", filter_buffer(setup_filter(list(resample_filter)),
                                                              device), persistent=False)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if use_bias else None

    def reset_parameters_(self, generator: torch.Generator) -> None:
        randn_(self.weight, generator)

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        weight_gain = 1.0 / math.sqrt(self.in_channels * self.kernel_size ** 2)
        w = (self.weight * weight_gain).to(x.dtype)
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up, down=self.down,
                            padding=self.kernel_size // 2, flip_weight=self.up == 1)
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return bias_act(x, b, act=self.activation, gain=act_gain, clamp=act_clamp)


# ---------------------------------------------------------------------------


class DiscriminatorBlock(nn.Module):
    """Block walking one resolution: 'orig', 'resnet' (the release config) or
    'resnet2' (filter-downsample skip with channel doubling)."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 resolution: int, img_channels: int, architecture: str = "resnet",
                 activation: str = "lrelu", resample_filter=(1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False,
                 half_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        assert architecture in ("orig", "skip", "resnet", "resnet2")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.resolution = resolution
        self.architecture = architecture
        self.use_fp16, self.half_dtype = use_fp16, half_dtype
        self.register_buffer("resample_filter", filter_buffer(setup_filter(list(resample_filter)),
                                                              device), persistent=False)
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, kernel_size=1,
                                       activation=activation, conv_clamp=conv_clamp,
                                       device=device)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, kernel_size=3,
                                 activation=activation, conv_clamp=conv_clamp, device=device)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, kernel_size=3,
                                 activation=activation, down=2, resample_filter=resample_filter,
                                 conv_clamp=conv_clamp, device=device)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, kernel_size=1, use_bias=False,
                                    down=2, resample_filter=resample_filter, device=device)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                force_fp32: bool = False):
        dtype = self.half_dtype if (self.use_fp16 and not force_fp32) else torch.float32
        if x is not None:
            x = x.to(dtype)

        if self.in_channels == 0 or self.architecture == "skip":
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter) if self.architecture == "skip"
                   else None)

        if self.architecture == "resnet":
            y = self.skip(x)
            x = self.conv0(x)
            x = self.conv1(x)
            x = (x + y) * float(np.sqrt(0.5))
        elif self.architecture == "resnet2":
            y = downsample2d(x, self.resample_filter)
            y = torch.cat([y, y], dim=1)[:, :self.out_channels]
            x = self.conv0(x)
            x = self.conv1(x)
            x = (x + y) * float(np.sqrt(0.5))
        else:
            x = self.conv0(x)
            x = self.conv1(x)
        assert x.dtype == dtype
        return x, img


class MinibatchStdLayer(nn.Module):
    """Append per-group feature-stddev channels.

    The groups are formed over the global batch, as the JAX layer's reshape
    strides across the devices of the mesh: with several processes, every
    process gathers the global batch, applies the layer to it and keeps its
    own rows."""

    def __init__(self, group_size: Optional[int], num_channels: int = 1):
        super().__init__()
        self.group_size, self.num_channels = group_size, num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return local_rows(self._global(all_gather_batch(x)))

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        g = min(self.group_size, n) if self.group_size is not None else n
        f = self.num_channels
        y = x.reshape(g, -1, f, c // f, h, w)
        y = y - y.mean(dim=0)
        y = y.square().mean(dim=0)
        y = (y + 1e-8).sqrt()
        y = y.mean(dim=(2, 3, 4))
        y = y.reshape(-1, f, 1, 1)
        y = y.repeat(g, 1, h, w)
        return torch.cat([x, y.to(x.dtype)], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """Final conv + FC head, in f32."""

    def __init__(self, in_channels: int, height: int, width: int, mbstd_group_size: int = 4,
                 mbstd_num_channels: int = 1, activation: str = "lrelu",
                 conv_clamp: Optional[float] = None, output_dim: int = 1,
                 pool_mode: str = "fully_connected", device=None):
        super().__init__()
        assert pool_mode in ("fully_connected", "average")
        self.mbstd_num_channels = mbstd_num_channels
        self.pool_mode = pool_mode
        if mbstd_num_channels > 0:
            self.mbstd = MinibatchStdLayer(mbstd_group_size, mbstd_num_channels)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, kernel_size=3,
                                activation=activation, conv_clamp=conv_clamp, device=device)
        self.fc = FullyConnectedLayer(in_channels * height * width, in_channels,
                                      activation=activation, device=device)
        self.out = FullyConnectedLayer(in_channels, output_dim, device=device)

    def forward(self, x: torch.Tensor,
                conditioning: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.float()
        if self.mbstd_num_channels > 0:
            x = self.mbstd(x)
        x = self.conv(x)
        if self.pool_mode == "fully_connected":
            x = self.fc(x.reshape(x.shape[0], -1))
        else:
            x = x.mean(dim=(2, 3))
        x = self.out(x)
        if conditioning is not None:
            x = (x * conditioning).sum(dim=1, keepdim=True) / float(np.sqrt(conditioning.shape[1]))
        return x


# ---------------------------------------------------------------------------


class VideoDiscriminator(nn.Module):
    """Stage-2 discriminator on (upsampled-lr, hr) video pairs."""

    def __init__(self, channels: int = 3, seq_length: int = 8, lr_height: int = 32,
                 lr_width: int = 32, hr_height: int = 256, hr_width: int = 256,
                 channels_base: int = 16384, channels_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, minibatch_std_group_size: int = 4,
                 minibatch_std_num_channels: int = 0, architecture: str = "resnet",
                 pool_mode: str = "fully_connected", device=None):
        super().__init__()
        self.channels, self.seq_length = channels, seq_length
        self.lr_height, self.lr_width = lr_height, lr_width
        self.hr_height, self.hr_width = hr_height, hr_width
        resolution = self.resolution
        res_log2 = int(np.log2(resolution))
        channels_dict = {res: min(channels_base // res, channels_max)
                         for res in self.block_resolutions + [4]}
        fp16_resolution = max(2 ** (res_log2 + 1 - num_fp16_res), 8)
        img_channels = 2 * channels * seq_length

        for res in self.block_resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(
                in_channels=channels_dict[res] if res < resolution else 0,
                tmp_channels=channels_dict[res], out_channels=channels_dict[res // 2],
                resolution=res, img_channels=img_channels, use_fp16=res >= fp16_resolution,
                conv_clamp=conv_clamp, architecture=architecture, device=device))
        self.b4 = DiscriminatorEpilogue(
            channels_dict[4], height=4, width=4, mbstd_group_size=minibatch_std_group_size,
            mbstd_num_channels=minibatch_std_num_channels, output_dim=1,
            conv_clamp=conv_clamp, pool_mode=pool_mode, device=device)
        self.upsample = SpatialBilinearUpsample(resolution // max(lr_height, lr_width),
                                                device=device)

    @property
    def resolution(self) -> int:
        return max(self.hr_height, self.hr_width)

    @property
    def block_resolutions(self) -> list[int]:
        res_log2 = int(np.log2(self.resolution))
        return [2 ** i for i in range(res_log2, 2, -1)]

    def upsample_lr(self, lr_video: torch.Tensor) -> torch.Tensor:
        """Bilinear-upsample the lr conditioning video to hr resolution (the
        trainer's run_D concatenates it with hr on time before ADA)."""
        return self.upsample(lr_video)

    def forward(self, lr_video: torch.Tensor, hr_video: torch.Tensor) -> torch.Tensor:
        with annotate("lvg.D"):
            if lr_video.shape[3] == self.lr_height and lr_video.shape[4] == self.lr_width:
                lr_video = self.upsample(lr_video)
            else:
                assert lr_video.shape[3] == self.hr_height and lr_video.shape[4] == self.hr_width

            videos = torch.cat([lr_video, hr_video], dim=1)
            p = (videos.shape[4] - videos.shape[3]) // 2
            videos = F.pad(videos, [0, 0, p, p])
            n, c, t, h, w = videos.shape
            videos = videos.reshape(n, c * t, h, w)

            feats = None
            for res in self.block_resolutions:
                feats, videos = getattr(self, f"b{res}")(feats, videos)
            return self.b4(feats)
