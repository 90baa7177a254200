"""Gradients of the port's ops against the JAX package's, on the CPU.

  * K2's plain version (the stage-rounded banded products): the gradient of
    the port's filtered_lrelu Function on a CPU tensor against the VJP of the
    JAX package's `_packed_op`, its Pallas backward run in interpret mode as
    tests/test_pallas_packed.py runs it, at that file's geometries; double
    backward raises in both.
  * Forward and gradient of upfirdn2d, bias_act (all 9 activations) and the
    composed filtered_lrelu against `jax.vjp`; second order for upfirdn2d.
  * bias_act's lrelu Functions against `F.leaky_relu` (the same bits to first
    order), gradcheck and gradgradcheck, and no Function without a gradient.
"""

import importlib
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.ops import filters as jax_filters
from long_video_gan_tpu_torch.ops import filtered_lrelu_bands, filtered_lrelu_cuda
from long_video_gan_tpu_torch.ops.bias_act import activation_funcs, bias_act
from long_video_gan_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_composed
from long_video_gan_tpu_torch.ops.upfirdn2d import upfirdn2d

jax_bias_act = importlib.import_module("long_video_gan_tpu.ops.bias_act")
jax_upfirdn2d = importlib.import_module("long_video_gan_tpu.ops.upfirdn2d")
jax_flrelu = importlib.import_module("long_video_gan_tpu.ops.filtered_lrelu")


def _vjp(fn, args, cot):
    """(output, cotangent-weighted gradients) of a JAX function."""
    out, pull = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in pull(jnp.asarray(cot))]


def _torch_grads(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, rtol):
    """Max-abs error within rtol of max|want|."""
    scale = float(np.max(np.abs(want))) or 1.0
    assert got.shape == want.shape
    err = float(np.max(np.abs(got.astype(np.float32) - want.astype(np.float32))))
    assert err <= rtol * scale, (err, scale)


# ---------------------------------------------------------------------------
# K2's plain version against the JAX package's packed VJP.


@pytest.fixture
def jax_packed_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jax_flrelu, "FORCE_FUSED_ON_CPU", True)
    return jax_flrelu.filtered_lrelu


# tests/test_pallas_packed.py CASES: up, down, h, w, padding.
PACKED_CASES = [
    (2, 2, 21, 31, (9, 8, 9, 8)),
    (2, 1, 14, 22, 6),
    (1, 2, 24, 32, 8),
    (2, 2, 12, 16, 10),
    (4, 2, 10, 16, (7, 6, 7, 6)),
]


def _packed_inputs(up, h, w, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    fu = jax_filters.design_kaiser_lowpass(12 * up // 2 if up > 1 else 8, 1.0, 2.0 * up,
                                           8.0 * up)
    fd = jax_filters.design_kaiser_lowpass(12, 1.0, 2.0, 8.0)
    x = (rng.standard_normal((2, 3, h, w)) * 3).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    return fu, fd, x, b


@pytest.mark.parametrize("clamp", [4.0, None])
@pytest.mark.parametrize("up,down,h,w,pad", PACKED_CASES)
def test_k2_plain_matches_jax_packed_vjp_f32(up, down, h, w, pad, clamp, jax_packed_interpret):
    fu, fd, x, b = _packed_inputs(up, h, w, seed=up * 100 + h)
    kw = dict(up=up, down=down, padding=pad, gain=math.sqrt(2.0), slope=0.2, clamp=clamp)
    y_shape = jax.eval_shape(lambda xx: jax_packed_interpret(xx, fu, fd, None, **kw),
                             jnp.asarray(x)).shape
    cot = np.random.default_rng(1).standard_normal(y_shape).astype(np.float32)
    want_y, (want_dx, want_db) = _vjp(
        lambda xx, bb: jax_packed_interpret(xx, fu, fd, bb, impl="packed", **kw), (x, b), cot)
    filtered_lrelu_cuda.launches = filtered_lrelu_cuda.bwd_launches = 0
    got_y, (got_dx, got_db) = _torch_grads(
        lambda xx, bb: filtered_lrelu(xx, fu, fd, bb, impl="packed", **kw), (x, b), cot)
    assert filtered_lrelu_cuda.launches == filtered_lrelu_cuda.bwd_launches == 0
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5 * np.abs(want_y).max())
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=1e-5 * np.abs(want_dx).max())
    np.testing.assert_allclose(got_db, want_db, rtol=1e-5, atol=1e-5 * np.abs(want_db).max())


@pytest.mark.parametrize("up,down,h,w,pad", [PACKED_CASES[0], PACKED_CASES[4]])
def test_k2_plain_bf16_close_to_jax_packed_vjp(up, down, h, w, pad, jax_packed_interpret):
    """bf16: each gradient within 0.03 of max|f32 reference|, and of each other."""
    fu, fd, x, _ = _packed_inputs(up, h, w, seed=7)
    kw = dict(up=up, down=down, padding=pad, clamp=256.0)
    y_shape = jax.eval_shape(lambda xx: jax_packed_interpret(xx, fu, fd, None, **kw),
                             jnp.asarray(x)).shape
    cot = np.random.default_rng(2).standard_normal(y_shape).astype(np.float32)
    _, (want,) = _vjp(lambda xx: jax_packed_interpret(xx, fu, fd, None, **kw), (x,), cot)
    _, pull = jax.vjp(lambda xx: jax_packed_interpret(xx, fu, fd, None, impl="packed", **kw),
                      jnp.asarray(x, jnp.bfloat16))
    (jax_bf16,) = pull(jnp.asarray(cot, jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    yt = filtered_lrelu(xt, fu, fd, None, impl="packed", **kw)
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(cot).bfloat16())
    assert got.dtype == torch.bfloat16
    got, jax_bf16 = got.float().numpy(), np.asarray(jax_bf16, np.float32)
    _close(got, want, 0.03)
    _close(jax_bf16, want, 0.03)
    _close(got, jax_bf16, 0.03)


def test_k2_double_backward_raises_like_jax(jax_packed_interpret):
    fu, fd, x, _ = _packed_inputs(2, 12, 16, seed=3)
    kw = dict(up=2, down=2, padding=8, clamp=256.0)

    def outer_jax(xx):
        g = jax.grad(lambda v: jnp.sum(jnp.square(
            jax_packed_interpret(v, fu, fd, None, impl="packed", **kw))))(xx)
        return jnp.sum(jnp.square(g))

    with pytest.raises(NotImplementedError, match="first-order"):
        jax.grad(outer_jax)(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    y = filtered_lrelu(xt, fu, fd, None, impl="packed", **kw)
    (g,) = torch.autograd.grad(y.square().sum(), xt, create_graph=True)
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(g.square().sum(), xt)
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(g.square().sum(), xt, allow_unused=True)
    with pytest.raises(NotImplementedError, match="first-order"):
        g.square().sum().backward()
    # The composed path differentiates twice.
    y = filtered_lrelu(xt, fu, fd, None, impl="conv", **kw)
    (g,) = torch.autograd.grad(y.square().sum(), xt, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), xt)
    assert bool(torch.isfinite(gg).all())


def test_k2_plain_is_autograd_of_composed():
    """The plain backward on its own is what the Function's backward computes
    on a CPU tensor, and in f32 (no stage rounding) it is autograd through the
    composed op, up to f32 summation order (the bar of the f32 gradient
    comparisons above)."""
    fu, fd, x, _ = _packed_inputs(4, 10, 16, seed=4)
    kw = dict(up=4, down=2, padding=(7, 6, 7, 6), gain=math.sqrt(2.0), slope=0.2, clamp=3.0)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = filtered_lrelu_composed(xt, fu, fd, None, **kw)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    (want,) = torch.autograd.grad(y, xt, dy)
    got = filtered_lrelu_bands.banded_bwd_plain(xt.detach(), dy, fu, fd, **kw)
    (via_function,) = torch.autograd.grad(filtered_lrelu(xt, fu, fd, None, impl="packed", **kw),
                                          xt, dy)
    torch.testing.assert_close(got, via_function, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


# ---------------------------------------------------------------------------
# Gradients of the op layer: upfirdn2d, bias_act, the composed filtered_lrelu.


def _taps(n):
    return jax_filters.design_kaiser_lowpass(n, 1.0, 2.0, 8.0)


UPFIRDN_CASES = [
    (2, 1, (3, 4, 2, 5), _taps(8), False),
    (1, 2, 3, _taps(8), False),
    (4, 2, (-6, -9, -6, -9), _taps(24), False),
    (2, 2, (-3, -4, 1, -2), _taps(12), True),
    (2, 1, 2, np.outer(_taps(6), _taps(6)), False),
    ((1, 2), 1, (0, 0, 2, 1), _taps(4).reshape(-1, 1), False),
]


@pytest.mark.parametrize("up,down,padding,f,flip", UPFIRDN_CASES)
def test_upfirdn2d_grad_matches_jax(up, down, padding, f, flip):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 3, 11, 13)).astype(np.float32)
    kw = dict(up=up, down=down, padding=padding, flip_filter=flip, gain=1.7)
    y_shape = jax.eval_shape(lambda v: jax_upfirdn2d.upfirdn2d(v, f, impl="conv", **kw),
                             jnp.asarray(x)).shape
    cot = rng.standard_normal(y_shape).astype(np.float32)
    want_y, (want,) = _vjp(lambda v: jax_upfirdn2d.upfirdn2d(v, f, impl="conv", **kw), (x,), cot)
    got_y, (got,) = _torch_grads(lambda v: upfirdn2d(v, f, **kw), (x,), cot)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("up,down,padding,f,flip", [UPFIRDN_CASES[0], UPFIRDN_CASES[2],
                                                    UPFIRDN_CASES[4]])
def test_upfirdn2d_second_order_matches_jax(up, down, padding, f, flip):
    """d/dx |d/dx sum(w * sin(upfirdn2d(x)))|^2 in both frameworks."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 2, 11, 13)).astype(np.float32)
    kw = dict(up=up, down=down, padding=padding, flip_filter=flip)
    y_shape = jax.eval_shape(lambda v: jax_upfirdn2d.upfirdn2d(v, f, impl="conv", **kw),
                             jnp.asarray(x)).shape
    w = rng.standard_normal(y_shape).astype(np.float32)

    def outer_jax(v):
        g = jax.grad(lambda u: jnp.sum(jnp.asarray(w) * jnp.sin(
            jax_upfirdn2d.upfirdn2d(u, f, impl="conv", **kw))))(v)
        return jnp.sum(jnp.square(g))

    want = np.asarray(jax.grad(outer_jax)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad((torch.from_numpy(w) * torch.sin(upfirdn2d(xt, f, **kw))).sum(),
                               xt, create_graph=True)
    (got,) = torch.autograd.grad(g.square().sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("act", sorted(activation_funcs))
def test_bias_act_grad_matches_jax(act):
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((3, 5, 4, 6)) * 3).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    for kw in (dict(), dict(gain=0.7, clamp=1.5)):
        want_y, want = _vjp(lambda v, c: jax_bias_act.bias_act(v, c, act=act, **kw), (x, b), cot)
        got_y, got = _torch_grads(lambda v, c: bias_act(v, c, act=act, **kw), (x, b), cot)
        np.testing.assert_allclose(got_y, want_y, rtol=1e-6, atol=1e-6)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g, w_, rtol=1e-5, atol=1e-5)


LRELU_KWARGS = [dict(), dict(gain=1.0), dict(clamp=0.5), dict(gain=2.0, clamp=1.0)]


def _plain_lrelu(x, b, gain=math.sqrt(2.0), clamp=None):
    """bias_act's lrelu as PyTorch's autograd sees a plain expression."""
    y = torch.nn.functional.leaky_relu(x + b[None, :, None], 0.2)
    y = y * gain if gain != 1.0 else y
    return y.clamp(-clamp, clamp) if clamp is not None else y


@pytest.mark.parametrize("kw", LRELU_KWARGS, ids=["default", "gain1", "clamp", "gain_clamp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bias_act_lrelu_bit_equal_to_leaky_relu(dtype, kw):
    """lrelu's autograd Functions run PyTorch's own kernels: the output and the
    first-order input and bias gradients have `F.leaky_relu`'s bits, on
    inputs with zeros and negatives."""
    g = torch.Generator().manual_seed(14)
    x = torch.randn((3, 5, 7), generator=g).to(dtype)
    x[0, :, :3] = 0
    b = torch.randn(5, generator=g).to(dtype)
    b[1] = 0
    cot = torch.randn((3, 5, 7), generator=g).to(dtype)
    outs = []
    for fn in (lambda v, c: bias_act(v, c, act="lrelu", **kw),
               lambda v, c: _plain_lrelu(v, c, **kw)):
        xs, bs = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = fn(xs, bs)
        outs.append([y.detach(), *torch.autograd.grad(y, [xs, bs], cot)])
    itype = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for got, want in zip(*outs):
        assert torch.equal(got.view(itype), want.view(itype))


@pytest.mark.parametrize("kw", [dict(), dict(gain=0.7, clamp=1.5)], ids=["default", "gain_clamp"])
def test_bias_act_lrelu_gradcheck(kw):
    """The Functions' first and second derivatives against finite differences
    in float64 (the second has no term in the input: zero off the kinks)."""
    g = torch.Generator().manual_seed(15)
    x = torch.randn((2, 3, 4), generator=g, dtype=torch.float64).requires_grad_(True)
    b = torch.randn(3, generator=g, dtype=torch.float64).requires_grad_(True)
    fn = lambda v, c: bias_act(v, c, act="lrelu", **kw)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, b))
    assert torch.autograd.gradgradcheck(fn, (x, b))


def test_bias_act_lrelu_plain_without_grad():
    """Under `torch.no_grad()`, or where no input requires a gradient, lrelu is
    `F.leaky_relu` itself: no autograd Function runs; where the input requires
    one, the Function does."""
    x = torch.randn(2, 3, 4)
    assert bias_act(x, act="lrelu").grad_fn is None
    with torch.no_grad():
        assert bias_act(x.requires_grad_(True), act="lrelu").grad_fn is None
    assert type(bias_act(x, act="lrelu", gain=1.0).grad_fn).__name__ == "_LeakyReLUBackward"


# Small versions of the three filtered_lrelu geometries of the 144x256 plan.
FLRELU_CASES = [
    (2, 10, 16, (9, 8, 9, 8), 12),
    (4, 14, 18, (-6, -9, -6, -9), 24),
    (2, 30, 36, (-11, -12, -11, -12), 12),
]


@pytest.mark.parametrize("up,h,w,pad,fu_taps", FLRELU_CASES)
def test_filtered_lrelu_composed_grad_matches_jax(up, h, w, pad, fu_taps):
    rng = np.random.default_rng(13)
    fu = jax_filters.design_kaiser_lowpass(fu_taps, 1.0, 2.0 * up, 8.0 * up)
    fd = _taps(12)
    x = (rng.standard_normal((2, 3, h, w)) * 3).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    kw = dict(up=up, down=2, padding=pad, gain=math.sqrt(2.0), slope=0.2, clamp=4.0)
    y_shape = jax.eval_shape(lambda v: jax_flrelu.filtered_lrelu(v, fu, fd, None, impl="conv",
                                                                 **kw), jnp.asarray(x)).shape
    cot = rng.standard_normal(y_shape).astype(np.float32)
    want_y, want = _vjp(lambda v, c: jax_flrelu.filtered_lrelu(v, fu, fd, c, impl="conv", **kw),
                        (x, b), cot)
    got_y, got = _torch_grads(lambda v, c: filtered_lrelu_composed(v, fu, fd, c, **kw),
                              (x, b), cot)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-5, atol=1e-5 * np.abs(w_).max())
