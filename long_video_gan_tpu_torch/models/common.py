"""Shared model building blocks (both generator stages).

Counterpart of `long_video_gan_tpu/models/common.py`. Conventions:
  * Tensors are NCTHW (videos) / NCHW (frames) / NCT (temporal streams).
  * Parameter names and layouts match the JAX package's variable trees, so
    `io.convert_torch.load_jax_variables` is a rename with shape checks.
  * Modules allocate parameters without drawing random numbers; `init_weights_`
    draws them from an explicit `torch.Generator` (checkpoints overwrite them).
  * FIR filters are non-persistent buffers: they follow the module's device
    and are not part of the state_dict (they are deterministic from config).
  * The JAX "ema" collection becomes persistent buffers.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.filters import kaiser_resample_filter, tent_filter
from ..ops.upfirdn2d import downsample2d, upsample2d


def normalize_2nd_moment(x: torch.Tensor, dim: Union[int, tuple] = 1,
                         eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2, dim) + eps)."""
    return x * (x.square().mean(dim=dim, keepdim=True) + eps).rsqrt()


def center_crop(x: torch.Tensor, width: Optional[int] = None, height: Optional[int] = None,
                seq_length: Optional[int] = None) -> torch.Tensor:
    """Center-crop NCT / NCTHW tensors."""
    assert x.ndim in (3, 5)
    if width is not None:
        assert x.ndim == 5
        x0 = (x.shape[4] - width) // 2
        x = x[:, :, :, :, x0:x0 + width]
    if height is not None:
        assert x.ndim == 5
        y0 = (x.shape[3] - height) // 2
        x = x[:, :, :, y0:y0 + height]
    if seq_length is not None:
        t0 = (x.shape[2] - seq_length) // 2
        x = x[:, :, t0:t0 + seq_length]
    return x


def filter_buffer(f: Optional[np.ndarray], device=None) -> Optional[torch.Tensor]:
    """FIR taps as a float32 tensor for a non-persistent buffer (None stays None)."""
    return None if f is None else torch.as_tensor(np.asarray(f, np.float32), device=device)


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every random parameter of `module` from `generator`, as the JAX
    package's initializers do (normal weights; constant biases, EMAs and
    filters stay). Returns the module."""
    with torch.no_grad():
        for sub in module.modules():
            if hasattr(sub, "reset_parameters_"):
                sub.reset_parameters_(generator)
    return module


def randn_(param: torch.Tensor, generator: torch.Generator, std: float = 1.0) -> None:
    """Fill `param` with N(0, std^2) drawn on the generator's device."""
    draw = torch.randn(param.shape, generator=generator, device=generator.device)
    param.copy_(draw * std)


# ---------------------------------------------------------------------------


class FullyConnectedLayer(nn.Module):
    """Equalized-lr fully connected layer.

    weight stored as randn * weight_std_init / lrate_mul, runtime-scaled by
    lrate_mul / sqrt(in_features); bias stored as bias_init / lrate_mul,
    runtime-scaled by lrate_mul.
    """

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 activation: str = "linear", lrate_mul: float = 1.0,
                 weight_std_init: float = 1.0, bias_init: float = 0.0, device=None):
        super().__init__()
        assert activation in activation_funcs
        self.in_features = in_features
        self.activation = activation
        self.lrate_mul = lrate_mul
        self.weight_std_init = weight_std_init
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, device=device))
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(
                torch.full((out_features,), bias_init / lrate_mul, device=device))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        randn_(self.weight, generator, self.weight_std_init / self.lrate_mul)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight_gain = self.lrate_mul / math.sqrt(self.in_features)
        w = (self.weight * weight_gain).to(x.dtype)
        y = x @ w.t()
        b = None
        if self.bias is not None:
            b = self.bias * self.lrate_mul if self.lrate_mul != 1 else self.bias
            b = b.to(x.dtype)
        return bias_act(y, b, dim=y.ndim - 1, act=self.activation)


# ---------------------------------------------------------------------------


class MagnitudeEMA(nn.Module):
    """Running mean of activation magnitude; returns its rsqrt gain.

    `beta == 1.0` reads the EMA without updating (generation); `beta < 1`
    updates it in place from the current batch mean.
    """

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("magnitude_ema", torch.ones((), device=device))

    def forward(self, x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
        if beta != 1.0:
            mag = x.detach().float().square().mean()
            self.magnitude_ema.add_((1.0 - beta) * (mag - self.magnitude_ema))
        return self.magnitude_ema.rsqrt()


# ---------------------------------------------------------------------------
# Static resamplers: FIR taps only, held as non-persistent buffers.


def _pad_edge(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Replicate-pad the last two axes of a 4-D tensor."""
    return F.pad(x, [pad_w, pad_w, pad_h, pad_h], mode="replicate")


class SpatialBilinearUpsample(nn.Module):
    """x2 (or xN) bilinear spatial upsampling of NCTHW videos (time folds into
    channels so the 2-D resampler sees [N, C*T, H, W])."""

    def __init__(self, scale: int = 2, padding: int = 0, impl: str = "conv", device=None):
        super().__init__()
        self.scale = scale
        self.padding = padding
        self.impl = impl
        self.register_buffer("filter", filter_buffer(tent_filter(scale), device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 5
        n, c, t, h, w = x.shape
        x = x.reshape(n, c * t, h, w)
        if self.padding > 0:
            x = _pad_edge(x, self.padding, self.padding)
        x = upsample2d(x, self.filter, up=self.scale, padding=-self.padding * self.scale,
                       impl=self.impl)
        return x.reshape(n, c, t, x.shape[2], x.shape[3])


class _TemporalResample(nn.Module):
    """Apply a 1-D filter along the T axis of NCT / NCTHW: space folds into the
    last axis so the 2-D resampler sees [N, C, T, H*W] and filters along its H
    dimension with a [taps, 1] filter."""

    def __init__(self, taps: np.ndarray, scale: int, padding: int, up: bool, device=None):
        super().__init__()
        self.scale, self.padding, self.up = scale, padding, up
        self.register_buffer("filter", filter_buffer(taps.reshape(-1, 1), device),
                             persistent=False)

    def forward(self, x: torch.Tensor, impl: str = "conv") -> torch.Tensor:
        ndim = x.ndim
        assert ndim in (3, 5)
        if ndim == 5:
            n, c, t, h, w = x.shape
            x = x.reshape(n, c, t, h * w)
        else:
            x = x[..., None]

        if self.up:
            if self.padding > 0:
                x = _pad_edge(x, self.padding, 0)
            x = upsample2d(x, self.filter, up=(1, self.scale),
                           padding=(0, -self.padding * self.scale), impl=impl)
        else:
            pad = self.padding * self.scale
            if self.padding > 0:
                x = _pad_edge(x, pad, 0)
            x = downsample2d(x, self.filter, down=(1, self.scale), padding=(0, -pad), impl=impl)

        if ndim == 5:
            return x.reshape(n, c, x.shape[2], h, w)
        return x[..., 0]


class TemporalLinearUpsample(_TemporalResample):
    def __init__(self, scale: int = 2, padding: int = 0, device=None):
        super().__init__(tent_filter(scale), scale, padding, up=True, device=device)


class TemporalLinearDownsample(_TemporalResample):
    def __init__(self, scale: int = 2, padding: int = 0, device=None):
        super().__init__(tent_filter(scale), scale, padding, up=False, device=device)


class TemporalKaiserDownsample(_TemporalResample):
    def __init__(self, scale: int = 2, padding: int = 0, filter_size: int = 6,
                 cutoff: float = 1.0, width: float = 6.0, sampling_rate: float = 4.0,
                 device=None):
        taps = kaiser_resample_filter(scale, filter_size, cutoff, width, sampling_rate)
        super().__init__(taps, scale, padding, up=False, device=device)
