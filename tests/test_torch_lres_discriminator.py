"""The port's lres discriminator against the JAX package's, on the CPU: the
forward and the input gradient in float32 (rtol 1e-4 of max |out|), the bf16
block ladder (0.05 of max |out|, 0.1 relative L2 of the input gradient),
R1's grad-of-grad through the bf16 casts (finite), and the variable tree
carried across both ways (`load_jax_variables` / `module_to_variables`).
Also `ops.conv`, its dense convolution, against PyTorch's own to the third
order and in R1's pattern under `no_weight_gradients()`."""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.models import discriminator_lres as jax_dlres
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables, module_to_variables
from long_video_gan_tpu_torch.models import discriminator_lres
from long_video_gan_tpu_torch.models.common import init_weights_
from long_video_gan_tpu_torch.ops import conv as conv_ops
from long_video_gan_tpu_torch.ops.conv import conv, no_weight_gradients
from test_torch_generators import random_variables
from test_torch_lres_train import one_torch_thread  # noqa: F401

# tests/test_discriminator_fp16.py's config, and variants that reach the
# epilogue's temporal downsampling, other kernel sizes and a square input.
D_CFGS = {
    "fp16_test": dict(seq_length=8, max_edge=32, channels_max=32,
                      epilogue_kwargs=dict(channels=64)),
    "downsampling_epilogue": dict(seq_length=32, max_edge=32, channels_max=16,
                                  temporal_ksize_1=3, spatial_ksize_1=1,
                                  epilogue_kwargs=dict(channels=32, num_downsamples=2,
                                                       num_conv1d_layers=3,
                                                       num_linear_layers=3)),
    "short_square": dict(seq_length=4, max_edge=16, channels_max=16, temporal_ksize=3,
                         epilogue_kwargs=dict(channels=16)),
}
SHAPES = {"fp16_test": (2, 3, 8, 18, 32), "downsampling_epilogue": (2, 3, 32, 18, 32),
          "short_square": (3, 3, 4, 16, 16)}


def _rel_err(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


def _pair(name, num_fp16_res=0, seed=20):
    cfg = D_CFGS[name]
    D_j = jax_dlres.VideoDiscriminator(**cfg, num_fp16_res=num_fp16_res)
    variables = random_variables(D_j, jnp.zeros(SHAPES[name]), seed=seed)
    D_t = discriminator_lres.VideoDiscriminator(**cfg, num_fp16_res=num_fp16_res)
    load_jax_variables(D_t, variables)
    return D_j, variables, D_t


@pytest.mark.parametrize("name", sorted(D_CFGS))
def test_lres_discriminator_matches_jax(name):
    D_j, variables, D_t = _pair(name)
    rng = np.random.default_rng(21)
    x = rng.standard_normal(SHAPES[name]).astype(np.float32)
    cot = rng.standard_normal((x.shape[0], 1)).astype(np.float32)
    want, pull = jax.vjp(lambda v: D_j.apply(variables, v), jnp.asarray(x))
    (want_dx,) = pull(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = D_t(xt)
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    assert got.shape == (x.shape[0], 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert _rel_err(got_dx.numpy(), want_dx) < 1e-4


def test_lres_discriminator_bf16_ladder_matches_jax():
    """num_fp16_res 2: blocks 0 and 1 run in bfloat16 in both, the epilogue
    in float32. With the JAX init's variables (biases 0) the outputs agree
    within 0.05 of max|out| and the input gradients within 0.1 relative L2:
    the frameworks round at other places."""
    cfg = D_CFGS["fp16_test"]
    x = np.random.default_rng(22).standard_normal(SHAPES["fp16_test"]).astype(np.float32)
    D_j = jax_dlres.VideoDiscriminator(**cfg, num_fp16_res=2)
    variables = D_j.init({"params": jax.random.key(3)}, jnp.asarray(x))
    D_t = discriminator_lres.VideoDiscriminator(**cfg, num_fp16_res=2)
    load_jax_variables(D_t, variables)
    assert [b.use_fp16 for b in D_t.blocks] == [True, True, False, False]
    want, pull = jax.vjp(lambda v: D_j.apply(variables, v), jnp.asarray(x))
    (want_dx,) = pull(jnp.ones((2, 1), jnp.float32))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = D_t(xt)
    (got_dx,) = torch.autograd.grad(got.sum(), xt)
    assert got.dtype == torch.float32 and got_dx.dtype == torch.float32
    assert _rel_err(got.detach().numpy(), want) < 0.05
    want_dx = np.asarray(want_dx)
    assert np.linalg.norm(got_dx.numpy() - want_dx) / np.linalg.norm(want_dx) < 0.1


@pytest.mark.parametrize("num_fp16_res", [2, 4])
def test_lres_r1_grad_of_grad_through_bf16_is_finite(num_fp16_res):
    """R1 = ||d D(x) / dx||^2 differentiated with respect to D's parameters,
    through the bf16 casts (tests/test_discriminator_fp16.py's JAX check)."""
    D_t = discriminator_lres.VideoDiscriminator(**D_CFGS["fp16_test"],
                                                num_fp16_res=num_fp16_res)
    init_weights_(D_t, torch.Generator().manual_seed(0))
    x = torch.randn((1, 3, 8, 18, 32), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    out = D_t(x)
    assert out.dtype == torch.float32
    (g,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    g.square().sum().backward()
    grads = [p.grad for p in D_t.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(t).all()) for t in grads)
    assert any(float(t.abs().max()) > 0 for t in grads)


@pytest.mark.parametrize("name", sorted(D_CFGS))
def test_lres_discriminator_variables_round_trip(name):
    """flax tree -> port (load_jax_variables) -> flax tree (module_to_variables):
    the same paths and arrays, every `blocks_N`, `conv1d_N` and `linear_N`
    in place."""
    _, variables, D_t = _pair(name, seed=23)
    tree = module_to_variables(D_t)
    assert set(tree) == set(variables) == {"params"}
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    keys = set(D_t.state_dict())
    assert {"blocks.0.conv_vid._bias", "epilogue.conv1d.0.weight",
            "epilogue.linear.1.bias"} <= keys
    D_back = discriminator_lres.VideoDiscriminator(**D_CFGS[name])
    load_jax_variables(D_back, tree)
    for key, value in D_t.state_dict().items():
        assert torch.equal(D_back.state_dict()[key], value), key


@pytest.mark.parametrize("x_shape,w_shape,padding", [
    ((2, 3, 5), (4, 3, 3), (1,)),
    ((2, 2, 3, 4, 3), (2, 2, 3, 3, 1), (1, 1, 0)),
    ((1, 2, 3, 4, 4), (3, 2, 1, 1, 1), (0, 0, 0)),
])
def test_conv_matches_torch_to_third_order(x_shape, w_shape, padding):
    """`ops.conv`, whose gradients are its own three Functions, against
    `F.conv1d` / `F.conv3d` under PyTorch's autograd, in float64: the output,
    R1's penalty-style second order (the weight gradient of ||dy/dx||^2) and
    a third order through it; R1's pattern, the input gradient taken under
    `no_weight_gradients()` (no weight gradient runs inside the scope) and
    then differentiated in the weights; then gradcheck and gradgradcheck
    against finite differences."""
    ref = torch.nn.functional.conv1d if len(padding) == 1 else torch.nn.functional.conv3d
    g = torch.Generator().manual_seed(24)
    x0 = torch.randn(x_shape, generator=g, dtype=torch.float64)
    w0 = torch.randn(w_shape, generator=g, dtype=torch.float64)

    def orders(fn):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        y = fn(x, w)
        (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        gw, gx2 = torch.autograd.grad(gx.square().sum(), [w, x], create_graph=True)
        (g3,) = torch.autograd.grad((gw * w).sum() + gx2.sum(), w)
        return y, gx, gw, gx2, g3

    for got, want in zip(orders(lambda x, w: conv(x, w, padding)),
                         orders(lambda x, w: ref(x, w, padding=padding))):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)

    def r1(fn, scope):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        y = fn(x, w)
        with scope():
            (gx,) = torch.autograd.grad(y.sum() + y.square().sum(), x, create_graph=True)
        (gw,) = torch.autograd.grad(gx.square().sum(), w)
        return gx, gw

    before = conv_ops.weight_grad_calls, conv_ops.skipped_calls
    ours = r1(lambda x, w: conv(x, w, padding), no_weight_gradients)
    # The scope's backward skips the forward's weight gradient; the loss's
    # backward runs two: the input gradient's, and the forward's (the output
    # gradient 1 + 2y depends on w through y).
    assert (conv_ops.weight_grad_calls - before[0], conv_ops.skipped_calls - before[1]) == (2, 1)
    theirs = r1(lambda x, w: ref(x, w, padding=padding), contextlib.nullcontext)
    for got, want in zip(ours, theirs):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: conv(a, b, padding), (x, w))
    assert torch.autograd.gradgradcheck(lambda a, b: conv(a, b, padding), (x, w))


def test_no_weight_gradients_restored_after_an_exception():
    """The scope's flag is restored on exit and after an exception, nested or
    not; outside it the convolution's backward computes the weight gradient."""
    assert not conv_ops._weight_gradients_disabled
    with pytest.raises(RuntimeError, match="inside"):
        with no_weight_gradients():
            with no_weight_gradients():
                assert conv_ops._weight_gradients_disabled
            assert conv_ops._weight_gradients_disabled
            raise RuntimeError("inside")
    assert not conv_ops._weight_gradients_disabled
    x = torch.randn(1, 2, 5, requires_grad=True)
    w = torch.randn(3, 2, 3, requires_grad=True)
    gx, gw = torch.autograd.grad(conv(x, w, (1,)).sum(), [x, w])
    assert gx is not None and gw is not None


class _DropGradient(torch.autograd.Function):
    """The identity, whose backward gives its input no gradient (None)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return None


def test_conv_backward_without_a_gradient_launches_nothing():
    """A backward that receives None (the Functions do not materialise it as
    zeros) runs no convolution, returns None and counts the gradients it
    declined in `skipped_calls`."""
    x = torch.randn(1, 2, 5, requires_grad=True)
    w = torch.randn(3, 2, 3, requires_grad=True)
    before = conv_ops.input_grad_calls, conv_ops.weight_grad_calls, conv_ops.skipped_calls
    y = _DropGradient.apply(conv(x, w, (1,)))
    gx, gw = torch.autograd.grad(y.sum(), [x, w], allow_unused=True)
    assert gx is None and gw is None
    after = conv_ops.input_grad_calls, conv_ops.weight_grad_calls, conv_ops.skipped_calls
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (0, 0, 2)
