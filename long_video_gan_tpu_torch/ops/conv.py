"""Dense N-d convolution (stride 1, groups 1) whose gradients of every order
are convolutions of the same three kinds.

PyTorch's own double backward of a convolution computes the weight term of
the input gradient's derivative as a forward convolution of the transposed
input with the transposed output gradient as its filter, a filter as large
as the whole output. On the card cuDNN runs that through a slow generic
kernel: R1, which differentiates the lres discriminator's 3D convolutions
twice, spent 1.6 s of a 2.1 s micro-batch of 16 clips there (NVIDIA H100
80GB HBM3; a `torch.profiler` run of each lres phase). Here the convolution, its input
gradient and its weight gradient are three autograd Functions, each of whose
gradients is made of the three again (as StyleGAN's conv2d_gradfix does for 2D), so
every order runs cuDNN's forward, input-gradient and weight-gradient
kernels. The values are those of `F.conv{1,2,3}d`; XLA differentiates the
JAX package's convolutions the same way by construction.
"""

from __future__ import annotations

from typing import Sequence

import torch


def conv(x: torch.Tensor, w: torch.Tensor, padding: Sequence[int]) -> torch.Tensor:
    """Correlate [N, C, *spatial] `x` with [O, C, *kernel] `w`, zero-padding
    each spatial axis by `padding` on both sides."""
    padding = tuple(int(p) for p in padding)
    assert x.ndim == w.ndim == len(padding) + 2, (x.shape, w.shape, padding)
    return _Conv.apply(x, w, padding)


def _ones(padding):
    return [1] * len(padding)


def _zeros(padding):
    return [0] * len(padding)


def _input_grad(g, w, x_shape, padding):
    dummy = g.new_empty(1).expand(x_shape)
    return torch.ops.aten.convolution_backward(
        g, dummy, w, None, _ones(padding), list(padding), _ones(padding), False,
        _zeros(padding), 1, (True, False, False))[0]


def _weight_grad(x, g, w_shape, padding):
    dummy = g.new_empty(1).expand(w_shape)
    return torch.ops.aten.convolution_backward(
        g, x, dummy, None, _ones(padding), list(padding), _ones(padding), False,
        _zeros(padding), 1, (False, True, False))[1]


class _Conv(torch.autograd.Function):
    """y = conv(x, w)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return torch.ops.aten.convolution(x, w, None, _ones(padding), list(padding),
                                          _ones(padding), False, _zeros(padding), 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _ConvInputGrad.apply(g, w, tuple(x.shape), ctx.padding)
        if ctx.needs_input_grad[1]:
            gw = _ConvWeightGrad.apply(x, g, tuple(w.shape), ctx.padding)
        return gx, gw, None


class _ConvInputGrad(torch.autograd.Function):
    """gx = conv's input gradient of output gradient g, linear in g and w:
    <ggx, gx> = <conv(ggx, w), g>."""

    @staticmethod
    def forward(ctx, g, w, x_shape, padding):
        ctx.save_for_backward(g, w)
        ctx.padding = padding
        return _input_grad(g, w, x_shape, padding)

    @staticmethod
    def backward(ctx, ggx):
        g, w = ctx.saved_tensors
        dg = dw = None
        if ctx.needs_input_grad[0]:
            dg = _Conv.apply(ggx, w, ctx.padding)
        if ctx.needs_input_grad[1]:
            dw = _ConvWeightGrad.apply(ggx, g, tuple(w.shape), ctx.padding)
        return dg, dw, None, None


class _ConvWeightGrad(torch.autograd.Function):
    """gw = conv's weight gradient of input x and output gradient g:
    <ggw, gw> = <conv(x, ggw), g>."""

    @staticmethod
    def forward(ctx, x, g, w_shape, padding):
        ctx.save_for_backward(x, g)
        ctx.padding = padding
        return _weight_grad(x, g, w_shape, padding)

    @staticmethod
    def backward(ctx, ggw):
        x, g = ctx.saved_tensors
        dx = dg = None
        if ctx.needs_input_grad[0]:
            dx = _ConvInputGrad.apply(g, ggw, tuple(x.shape), ctx.padding)
        if ctx.needs_input_grad[1]:
            dg = _Conv.apply(x, ggw, ctx.padding)
        return dx, dg, None, None
