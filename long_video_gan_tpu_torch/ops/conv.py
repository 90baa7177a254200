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

No Function runs a gradient convolution whose result nothing reads. A
backward that receives no gradient (None: the Functions do not materialise
it as zeros) launches nothing and returns None. Inside `no_weight_gradients()`
the convolution's backward computes the input gradient alone: R1's
`autograd.grad(logits, video, create_graph=True)` asks for no weight's
gradient, but `ctx.needs_input_grad` is fixed at the forward (StyleGAN2-ADA's
`conv2d_gradfix.no_weight_gradients` does the same around its R1).

Routes, by kernel shape, chosen on the card's times of every lres
convolution (float32, TF32 off, micro-batch 16; NVIDIA H100 80GB HBM3,
torch 2.11 with cuDNN 92200): a kernel of size one on every axis, without
padding (the lres models' 1x1x1 skips, D's from-RGB, G's ToRGB, the conv1d
of kernel 1), takes its weight gradient as cuDNN's 2D 1x1 weight gradient
over the same memory viewed as [N, C, positions, 1], with no copy. cuDNN's N-d weight gradient
runs such a kernel on generic engines: D's from-RGB (3 -> 32 channels at
128 x 64 x 64) took 128.4 ms a call in `wgrad2d_grouped_direct_kernel`, the
2D view 1.0 ms. Every other call, the 1x1x1 forwards and input gradients
included, goes to cuDNN's N-d kernels as PyTorch calls them, on cuDNN's
heuristic choice: the channels_last_3d layout and folding T into the batch
of a 2D convolution (1xkxk kernels) were slower, and the fold costs GiBs of
copies; the input gradient as a forward convolution of the flipped filter
won on two shapes of many. cuBLAS ran the 1x1x1 forwards and input
gradients faster, but under the matmul precision flag rather than cuDNN's
TF32 flag, for about 0.5% of a training step.

Each Function counts its calls (`fwd_calls`, `input_grad_calls`,
`weight_grad_calls`, since the module was imported), `skipped_calls` the
gradient convolutions they declined to run, and, while a profiler records,
each runs inside the span `lvg.conv.fwd`, `lvg.conv.input_grad` or
`lvg.conv.weight_grad`, on the thread that calls it: autograd's for every
gradient.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from ..utils.profiling import annotate

# Calls of each Function: the convolution, its input gradient, its weight
# gradient, whatever order of derivative asked for them.
fwd_calls = 0
input_grad_calls = 0
weight_grad_calls = 0
# Gradient convolutions declined: weight gradients inside
# `no_weight_gradients()`, and those of backward calls that received None.
skipped_calls = 0

# Module state and not thread-local: the backward runs on autograd's device
# thread, not on the thread that entered the scope.
_weight_gradients_disabled = False


@contextlib.contextmanager
def no_weight_gradients():
    """Inside the block, the backward of `conv` computes no weight gradient
    (returns None for `w`); the gradients' own derivatives are unaffected."""
    global _weight_gradients_disabled
    old = _weight_gradients_disabled
    _weight_gradients_disabled = True
    try:
        yield
    finally:
        _weight_gradients_disabled = old


def _skip(n: int) -> None:
    global skipped_calls
    skipped_calls += n


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


def _pointwise(w_shape, padding) -> bool:
    """A kernel of size one on every axis, without padding: a product over
    the channels at each position, whatever the layout of the positions."""
    return all(k == 1 for k in w_shape[2:]) and not any(padding)


def _weight_grad(x, g, w_shape, padding):
    if _pointwise(w_shape, padding):
        # The 2D weight gradient over [N, C, positions, 1] views (module doc).
        x = x.reshape(x.shape[0], x.shape[1], -1, 1)
        g = g.reshape(g.shape[0], g.shape[1], -1, 1)
        return _cudnn_weight_grad(x, g, (*w_shape[:2], 1, 1), (0, 0)).view(w_shape)
    return _cudnn_weight_grad(x, g, w_shape, padding)


def _cudnn_weight_grad(x, g, w_shape, padding):
    dummy = g.new_empty(1).expand(w_shape)
    return torch.ops.aten.convolution_backward(
        g, x, dummy, None, _ones(padding), list(padding), _ones(padding), False,
        _zeros(padding), 1, (False, True, False))[1]


class _Conv(torch.autograd.Function):
    """y = conv(x, w)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        global fwd_calls
        fwd_calls += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        with annotate("lvg.conv.fwd"):
            return torch.ops.aten.convolution(x, w, None, _ones(padding), list(padding),
                                              _ones(padding), False, _zeros(padding), 1)

    @staticmethod
    def backward(ctx, g):
        want_gx, want_gw = ctx.needs_input_grad[:2]
        if g is None:
            _skip(want_gx + want_gw)
            return None, None, None
        if want_gw and _weight_gradients_disabled:
            _skip(1)
            want_gw = False
        x, w = ctx.saved_tensors
        gx = gw = None
        if want_gx:
            gx = _ConvInputGrad.apply(g, w, tuple(x.shape), ctx.padding)
        if want_gw:
            gw = _ConvWeightGrad.apply(x, g, tuple(w.shape), ctx.padding)
        return gx, gw, None


class _ConvInputGrad(torch.autograd.Function):
    """gx = conv's input gradient of output gradient g, linear in g and w:
    <ggx, gx> = <conv(ggx, w), g>."""

    @staticmethod
    def forward(ctx, g, w, x_shape, padding):
        global input_grad_calls
        input_grad_calls += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(g, w)
        ctx.padding = padding
        with annotate("lvg.conv.input_grad"):
            return _input_grad(g, w, x_shape, padding)

    @staticmethod
    def backward(ctx, ggx):
        if ggx is None:
            _skip(sum(ctx.needs_input_grad[:2]))
            return None, None, None, None
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
        global weight_grad_calls
        weight_grad_calls += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, g)
        ctx.padding = padding
        with annotate("lvg.conv.weight_grad"):
            return _weight_grad(x, g, w_shape, padding)

    @staticmethod
    def backward(ctx, ggw):
        if ggw is None:
            _skip(sum(ctx.needs_input_grad[:2]))
            return None, None, None, None
        x, g = ctx.saved_tensors
        dx = dg = None
        if ctx.needs_input_grad[0]:
            dx = _ConvInputGrad.apply(g, ggw, tuple(x.shape), ctx.padding)
        if ctx.needs_input_grad[1]:
            dg = _Conv.apply(x, ggw, ctx.padding)
        return dx, dg, None, None
