"""Shared model building blocks (both generator stages).

Benchmark reference: a frozen copy of `long_video_gan_tpu_torch/models/common.py`, plain
PyTorch on one process (the collectives are identities), importing only
`h100_bench.reference`; initializers declare `init_stds()` in place of
drawing, since the benchmark draws the weights.

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
import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops import activation_funcs, bias_act, filter_buffer, q, tent_filter, upsample2d  # noqa: F401


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

    def init_stds(self) -> dict[str, float]:
        return {"weight": self.weight_std_init / self.lrate_mul}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight_gain = self.lrate_mul / math.sqrt(self.in_features)
        w = (self.weight * weight_gain).to(x.dtype)
        y = q(x) @ q(w).t()
        b = None
        if self.bias is not None:
            b = self.bias * self.lrate_mul if self.lrate_mul != 1 else self.bias
            b = b.to(x.dtype)
        return bias_act(y, b, dim=y.ndim - 1, act=self.activation)


# ---------------------------------------------------------------------------


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


