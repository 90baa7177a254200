"""The `fused` slice of the port against the JAX package, on the CPU: the
`matrix` upfirdn2d backend, K3a's and K3b's plain versions (the operator
products with the TPU kernel's bf16 stage rounding) against the JAX fused
kernel run in Pallas interpret mode, the first-order limit, and the reduced
sres generator and its trainer with `resample_impl="fused"`.

Tolerances: f32 1e-5 (forward) and 1e-4 (gradient), summation order only; the
matrix backend 1e-5; bf16 one bf16 ulp of the output's scale (2**-8) relative
to the largest output, since both round the same stages in bf16 and differ
only in f32 summation order before a rounding; the generator rtol 1e-3 (the
bar of tests/test_parity_sres.py)."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.ops.filters import design_kaiser_lowpass
from long_video_gan_tpu.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
from long_video_gan_tpu_torch.ops import filtered_lrelu_fused as fused
from long_video_gan_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_composed
from long_video_gan_tpu_torch.ops.upfirdn2d import upfirdn2d

jax_flr = importlib.import_module("long_video_gan_tpu.ops.filtered_lrelu")

# tests/test_pallas_fused.py's CASES, and L3's geometry of the 144x256 plan:
# a 31x38 map, up 4 (24 taps), down 2 (12 taps), a crop of the padding.
CASES = [
    (2, 2, 21, 31, (9, 8, 9, 8), 12, 12),
    (2, 1, 14, 22, 6, 12, 12),
    (1, 2, 24, 32, 8, 12, 12),
    (2, 2, 12, 16, 10, 12, 12),
    (4, 2, 31, 38, (-6, -9, -6, -9), 24, 12),
]


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX fused kernel in interpret mode on the CPU, as
    tests/test_pallas_fused.py runs it."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jax_flr, "FORCE_FUSED_ON_CPU", True)


def _case(up, down, h, w, fu_taps, fd_taps, seed, scale=1.0, planes=(2, 3)):
    rng = np.random.default_rng(seed)
    fu = design_kaiser_lowpass(fu_taps, 1.0, 2.0, 8.0 * up / 2).astype(np.float32)
    fd = design_kaiser_lowpass(fd_taps, 1.0, 2.0, 8.0).astype(np.float32)
    x = (rng.standard_normal((*planes, h, w)) * scale).astype(np.float32)
    b = rng.standard_normal(planes[1]).astype(np.float32)
    return fu, fd, x, b


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


@pytest.mark.parametrize("up,down,pad", [(2, 2, (9, 8, 9, 8)), (1, 2, (-3, 4, 5, -2)),
                                         (4, 1, (3, 3, 3, 3)), (1, 1, (2, 1, 0, 3))])
@pytest.mark.parametrize("flip", [False, True])
def test_matrix_upfirdn2d_matches_jax(up, down, pad, flip):
    rng = np.random.default_rng(1)
    f = rng.standard_normal(6).astype(np.float32)
    x = rng.standard_normal((2, 3, 11, 13)).astype(np.float32)
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), f, up=up, down=down, padding=pad,
                                    flip_filter=flip, gain=3.0, impl="matrix"))
    for impl in ("matrix", "fused", "pallas"):
        got = upfirdn2d(torch.from_numpy(x), torch.from_numpy(f), up=up, down=down,
                        padding=pad, flip_filter=flip, gain=3.0, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_matrix_upfirdn2d_differentiates():
    """The matrix backend's gradient (autograd of its two contractions)
    equals the conv backend's adjoint."""
    f = torch.from_numpy(design_kaiser_lowpass(8, 1.0, 2.0, 8.0).astype(np.float32))
    x = torch.randn((2, 3, 9, 10), generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    grads = []
    for impl in ("conv", "matrix"):
        y = upfirdn2d(x, f, up=2, down=1, padding=(3, 2, 1, 4), impl=impl)
        grads.append(torch.autograd.grad(y.square().sum(), x)[0])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("up,down,h,w,pad,fu_taps,fd_taps", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_forward_matches_jax(up, down, h, w, pad, fu_taps, fd_taps, dtype,
                                   interpret_pallas):
    fu, fd, x, b = _case(up, down, h, w, fu_taps, fd_taps, seed=3)
    want = jax_flr.filtered_lrelu(_to_jax(x, dtype), fu, fd, _to_jax(b, dtype), up=up,
                                  down=down, padding=pad, clamp=256.0, impl="fused")
    fused.fwd_launches = 0
    got = filtered_lrelu(_to_torch(x, dtype), fu, fd, _to_torch(b, dtype), up=up, down=down,
                         padding=pad, clamp=256.0, impl="fused")
    assert fused.fwd_launches == 0 and got.dtype == dtype
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("up,down,h,w,pad,fu_taps,fd_taps", [CASES[0], CASES[1], CASES[4]])
@pytest.mark.parametrize("dtype,clamp", [(torch.float32, 4.0), (torch.float32, None),
                                         (torch.bfloat16, 4.0)])
def test_fused_gradient_matches_jax_vjp(up, down, h, w, pad, fu_taps, fd_taps, dtype, clamp,
                                        interpret_pallas):
    """K3b's plain version against `jax.vjp` of the JAX fused op, with a low
    clamp (a good share of elements saturate) and without one."""
    fu, fd, x, b = _case(up, down, h, w, fu_taps, fd_taps, seed=4, scale=3.0, planes=(1, 2))
    kw = dict(up=up, down=down, padding=pad, clamp=clamp)
    y, vjp = jax.vjp(lambda xx: jax_flr.filtered_lrelu(xx, fu, fd, _to_jax(b, dtype),
                                                      impl="fused", **kw), _to_jax(x, dtype))
    dy = np.random.default_rng(5).standard_normal(y.shape).astype(np.float32)
    (want,) = vjp(_to_jax(dy, dtype))
    want = np.asarray(jnp.asarray(want, jnp.float32))

    xt = _to_torch(x, dtype).requires_grad_(True)
    fused.bwd_launches = 0
    out = filtered_lrelu(xt, fu, fd, _to_torch(b, dtype), impl="fused", **kw)
    (got,) = torch.autograd.grad(out, xt, _to_torch(dy, dtype))
    assert fused.bwd_launches == 0 and got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4, atol=tol)


def test_fused_identity_and_flip_take_the_composed_path():
    """As in the JAX package: identity resamples (ToRGB) and flip_filter go
    to the composed path; every other call reaches the Function."""
    x = torch.randn((2, 3, 9, 11), generator=torch.Generator().manual_seed(6))
    b = torch.randn((3,), generator=torch.Generator().manual_seed(7))
    kw = dict(gain=1.0, slope=1.0, clamp=256.0)
    torch.testing.assert_close(filtered_lrelu(x, None, None, b, impl="fused", **kw),
                               filtered_lrelu_composed(x, None, None, b, **kw), rtol=0, atol=0)
    f = design_kaiser_lowpass(8, 1.0, 2.0, 8.0)
    kw = dict(up=2, down=2, padding=7, flip_filter=True)
    torch.testing.assert_close(filtered_lrelu(x, f, f, b, impl="fused", **kw),
                               filtered_lrelu_composed(x, f, f, b, **kw), rtol=0, atol=0)
    y = filtered_lrelu(x.requires_grad_(True), f, f, b, up=2, down=2, padding=7, impl="fused")
    assert y.grad_fn is not None and "Fused" in type(y.grad_fn).__name__


def test_fused_second_order_raises():
    f = design_kaiser_lowpass(8, 1.0, 2.0, 8.0)
    x = torch.randn((1, 2, 12, 16), generator=torch.Generator().manual_seed(8),
                    requires_grad=True)
    y = filtered_lrelu(x, f, f, None, up=2, down=2, padding=8, clamp=256.0, impl="fused")
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(g.square().sum(), x)
    with pytest.raises(NotImplementedError, match="first-order"):
        g.square().sum().backward()


def test_fused_kernel_entry_rejects_cpu_tensor():
    x = torch.zeros((1, 1, 12, 16))
    f = design_kaiser_lowpass(8, 1.0, 2.0, 8.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.fused_fwd_cuda(x, f, f, 2, 2, 8, 1.4, 0.2, None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.fused_bwd_cuda(x, torch.zeros((1, 1, 12, 16)), f, f, 2, 2, 8, 1.4, 0.2, None)
