"""Fused bias + activation (+ gain + clamp).

Counterpart of `long_video_gan_tpu/ops/bias_act.py`: a plain tensor
expression. Activation table: name -> (fn, default alpha, default gain).

Where its input requires a gradient under grad mode, `lrelu` is a pair of
autograd Functions on PyTorch's own kernels (`F.leaky_relu` and
`aten.leaky_relu_backward`, so every value and first-order gradient has the
same bits), whose gradient's derivative has no term in the input: PyTorch's
is `zeros_like`, and a double backward (R1) would carry those zeros back
through every layer before the activation, convolutions included.
StyleGAN2-ADA's `bias_act` drops lrelu's second-order input term
(`has_2nd_grad=False`) alike. Elsewhere `lrelu` is `F.leaky_relu` itself.
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


class _LeakyReLU(torch.autograd.Function):
    """y = leaky_relu(x, alpha)."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return F.leaky_relu(x, alpha)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None
        (x,) = ctx.saved_tensors
        return _LeakyReLUGrad.apply(dy, x.detach(), ctx.alpha), None


class _LeakyReLUGrad(torch.autograd.Function):
    """dx = leaky_relu's gradient of dy at `x`, linear in dy; `x` enters as a
    constant (the derivative in it is zero almost everywhere), so no gradient
    goes back into the graph that made `x`."""

    @staticmethod
    def forward(ctx, dy, x, alpha):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return torch.ops.aten.leaky_relu_backward(dy, x, alpha, False)

    @staticmethod
    def backward(ctx, ddx):
        if ddx is None:
            return None, None, None
        (x,) = ctx.saved_tensors
        return _LeakyReLUGrad.apply(ddx, x, ctx.alpha), None, None


def _lrelu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _LeakyReLU.apply(x, alpha)
    return F.leaky_relu(x, alpha)


activation_funcs: dict[str, ActivationSpec] = {
    "linear": ActivationSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, alpha: F.relu(x), 0.0, _SQRT2),
    "lrelu": ActivationSpec(_lrelu, 0.2, _SQRT2),
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
