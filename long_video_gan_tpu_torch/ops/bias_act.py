"""Fused bias + activation (+ gain + clamp).

Counterpart of `long_video_gan_tpu/ops/bias_act.py`: a plain tensor
expression. Activation table: name -> (fn, default alpha, default gain).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    func: Callable
    def_alpha: float
    def_gain: float


_SQRT2 = math.sqrt(2.0)

activation_funcs: dict[str, ActivationSpec] = {
    "linear": ActivationSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, alpha: F.relu(x), 0.0, _SQRT2),
    "lrelu": ActivationSpec(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, _SQRT2),
    "tanh": ActivationSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActivationSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActivationSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": ActivationSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": ActivationSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": ActivationSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, _SQRT2),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = 1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Add per-channel bias `b` along axis `dim`, apply `act`, scale by `gain`,
    clamp to `[-clamp, clamp]`."""
    assert clamp is None or clamp >= 0
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)

    if b is not None:
        assert b.ndim == 1, "bias must be 1-D"
        assert 0 <= dim < x.ndim
        assert b.shape[0] == x.shape[dim]
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)

    x = spec.func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
