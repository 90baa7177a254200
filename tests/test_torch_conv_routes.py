"""`ops.conv`'s routes for every kind of convolution the lres models run,
against `F.conv1d` / `F.conv3d` under PyTorch's autograd, on the CPU at a
tiny size: the output, the first-order input and weight gradients, and R1's
second order (the weight and input gradients of ||dy/dx||^2, the input
gradient taken under `no_weight_gradients()`). Float64 within 1e-12 of the
largest magnitude compared; float32 within 1e-5 of it, room for two chained
sums of at most 135 products each rounded to float32 in another order.

A kernel of size one on every axis, without padding (the 1x1x1 skips,
from-RGB, ToRGB, the conv1d of kernel 1), takes its weight gradient as a 2D
convolution over [N, C, positions, 1] views; every other call keeps the
rank of its input."""

import contextlib

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from long_video_gan_tpu_torch.ops.conv import conv, no_weight_gradients

# (x shape, w shape, padding): each kind of the lres G and D at a tiny width.
KINDS = {
    "1x3x3": ((2, 3, 4, 5, 6), (4, 3, 1, 3, 3), (0, 1, 1)),
    "1x1x1": ((2, 3, 4, 5, 6), (4, 3, 1, 1, 1), (0, 0, 0)),
    "1x1x1_to_rgb": ((2, 5, 3, 4, 5), (3, 5, 1, 1, 1), (0, 0, 0)),
    "3x3x3": ((2, 3, 5, 4, 5), (4, 3, 3, 3, 3), (1, 1, 1)),
    "5x3x3": ((2, 3, 6, 4, 4), (4, 3, 5, 3, 3), (2, 1, 1)),
    "conv1d_k3": ((2, 6, 5), (4, 6, 3), (1,)),
    "conv1d_k1": ((2, 6, 5), (4, 6, 1), (0,)),
}
TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}


def _reference(x, w, padding):
    return (F.conv1d if x.ndim == 3 else F.conv3d)(x, w, padding=padding)


def _orders(fn, x0, w0, r, scope):
    """y, the first-order gradients of <y, r>, and R1's second order: the
    gradients of ||dL/dx||^2 for L = <y, r> + ||y||^2, which depends on x."""
    x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    y = fn(x, w)
    gx, gw = torch.autograd.grad((y * r).sum(), [x, w])
    x = x0.clone().requires_grad_(True)
    with scope():
        y = fn(x, w)
        (r1_gx,) = torch.autograd.grad((y * r + y.square()).sum(), x, create_graph=True)
    r1_gw, r1_gx2 = torch.autograd.grad(r1_gx.square().sum(), [w, x])
    return tuple(t.detach() for t in (y, gx, gw, r1_gx, r1_gw, r1_gx2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_route_matches_torch(kind, dtype):
    x_shape, w_shape, padding = KINDS[kind]
    g = torch.Generator().manual_seed(22)
    x0 = torch.randn(x_shape, generator=g, dtype=dtype)
    w0 = torch.randn(w_shape, generator=g, dtype=dtype)
    r = torch.randn(_reference(x0, w0, padding).shape, generator=g, dtype=dtype)
    ours = _orders(lambda x, w: conv(x, w, padding), x0, w0, r, no_weight_gradients)
    theirs = _orders(lambda x, w: _reference(x, w, padding), x0, w0, r,
                     contextlib.nullcontext)
    for name, got, want in zip(("y", "gx", "gw", "r1_gx", "r1_gw", "r1_gx2"), ours, theirs):
        assert got.shape == want.shape, name
        gap = float((got - want).abs().max() / want.abs().max())
        assert gap <= TOLERANCE[dtype], (name, gap)


class _Ranks(TorchDispatchMode):
    """The rank of the input of every weight gradient that aten runs."""

    def __init__(self):
        super().__init__()
        self.weight_grad_ranks = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default and args[10][1]:
            self.weight_grad_ranks.append(args[1].ndim)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_weight_gradient_of_a_size_one_kernel_runs_in_2d(kind):
    x_shape, w_shape, padding = KINDS[kind]
    x = torch.randn(x_shape, requires_grad=True)
    w = torch.randn(w_shape, requires_grad=True)
    y = conv(x, w, padding)
    with _Ranks() as ranks:
        y.sum().backward()
    pointwise = all(k == 1 for k in w_shape[2:])
    assert ranks.weight_grad_ranks == [4 if pointwise else len(x_shape)]
