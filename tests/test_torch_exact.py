"""K4 (`filtered_lrelu(impl="pallas")`) and K5 (`filtered_lrelu_pallas_v2`) of
the port against the JAX package's kernels in Pallas interpret mode, on the
CPU, at the cases of tests/test_pallas_kernel.py: the port's plain versions
compute what the JAX kernels compute (f32, 1e-5, summation order only; with
bf16 inputs both compute in f32 and round once, so they agree to one bf16
ulp), raise where they fail (a top crop of `up` rows or more; K5 outside up,
down in {1, 2}) and refuse a gradient."""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from long_video_gan_tpu.ops.filters import design_kaiser_lowpass
from long_video_gan_tpu.ops.pallas import filtered_lrelu_v2 as jax_v2
from long_video_gan_tpu_torch.ops import filtered_lrelu_exact as exact
from long_video_gan_tpu_torch.ops import filtered_lrelu_polyphase as polyphase
from long_video_gan_tpu_torch.ops.filtered_lrelu import filtered_lrelu

jax_flr = importlib.import_module("long_video_gan_tpu.ops.filtered_lrelu")
FU = design_kaiser_lowpass(12, 1.0, 2.0, 8.0)
# L3 of the 144x256 plan: 31x38, up 4 with 24 taps, a crop at the top.
L3 = dict(up=4, down=2, padding=(-6, -9, -6, -9))


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[1]).astype(np.float32))


def _compare(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=tol)


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("up,down,h,w,pad,taps", [
    (2, 2, 33, 47, (9, 8, 9, 8), FU),
    (2, 1, 20, 30, 6, FU),
    (1, 2, 40, 56, 8, FU),
    (2, 2, 16, 24, 10, FU),
    (2, 2, 16, 20, (-9, 8, -1, 8), FU),     # crops the JAX kernel takes
    (1, 1, 9, 11, 0, None),                 # L14, the ToRGB identity case
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_matches_jax(up, down, h, w, pad, taps, dtype):
    x, b = _inputs((2, 5, h, w), seed=10)
    kw = dict(up=up, down=down, padding=pad, clamp=256.0)
    if taps is None:
        kw.update(gain=1.0, slope=1.0)
    want = jax_flr.filtered_lrelu(_jax(x, dtype), taps, taps, _jax(b, dtype), impl="pallas",
                                  **kw)
    exact.launches = 0
    got = filtered_lrelu(torch.from_numpy(x).to(dtype), taps, taps,
                         torch.from_numpy(b).to(dtype), impl="pallas", **kw)
    assert exact.launches == 0
    _compare(got, want, dtype)


@pytest.mark.parametrize("up,down,h,w,pad", [
    (2, 2, 17, 23, (9, 8, 9, 8)),
    (2, 1, 12, 18, 6),
    (1, 2, 20, 28, 8),
    (1, 1, 9, 11, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_polyphase_matches_jax(up, down, h, w, pad, dtype):
    taps = None if (up == 1 and down == 1) else FU
    x, b = _inputs((2, 3, h, w), seed=11)
    want = jax_v2.filtered_lrelu_pallas_v2(_jax(x, dtype), taps, taps, _jax(b, dtype), up=up,
                                           down=down, padding=pad, clamp=256.0)
    polyphase.launches = 0
    got = polyphase.filtered_lrelu_pallas_v2(torch.from_numpy(x).to(dtype), taps, taps,
                                             torch.from_numpy(b).to(dtype), up=up, down=down,
                                             padding=pad, clamp=256.0)
    assert polyphase.launches == 0
    _compare(got, want, dtype)


@pytest.mark.parametrize("entry", ["K4", "K5"])
@pytest.mark.parametrize("kw", [L3, dict(up=2, down=2, padding=(9, 8, -2, 8)),
                                dict(up=1, down=2, padding=(8, 8, -1, 8))])
def test_top_crop_raises_where_jax_fails(entry, kw):
    """Where the JAX kernel fails on a top crop, the port raises ValueError
    naming the limit, on a CPU tensor too."""
    fu = design_kaiser_lowpass(24, 1.0, 2.0, 16.0) if kw["up"] == 4 else FU
    x, b = _inputs((1, 2, 31, 38), seed=12)
    jax_fn = (lambda: jax_flr.filtered_lrelu(jnp.asarray(x), fu, FU, jnp.asarray(b),
                                             impl="pallas", **kw)) if entry == "K4" else (
        lambda: jax_v2.filtered_lrelu_pallas_v2(jnp.asarray(x), fu, FU, jnp.asarray(b), **kw))
    with pytest.raises((ValueError, AssertionError)):
        jax_fn()
    port_fn = ((lambda *a, **k: filtered_lrelu(*a, impl="pallas", **k)) if entry == "K4"
               else polyphase.filtered_lrelu_pallas_v2)
    match = "up and down" if entry == "K5" and kw["up"] == 4 else "py0"
    with pytest.raises(ValueError, match=match):
        port_fn(torch.from_numpy(x), fu, FU, torch.from_numpy(b), **kw)


def test_polyphase_refuses_up_4():
    x, _ = _inputs((1, 1, 12, 16), seed=13)
    with pytest.raises(ValueError, match="up and down in"):
        polyphase.filtered_lrelu_pallas_v2(torch.from_numpy(x), FU, FU, up=4, down=2, padding=9)


@pytest.mark.parametrize("entry", ["K4", "K5"])
def test_gradient_raises(entry):
    x = torch.randn((1, 2, 12, 16), generator=torch.Generator().manual_seed(14),
                    requires_grad=True)
    kw = dict(up=2, down=2, padding=9)
    y = (filtered_lrelu(x, FU, FU, None, impl="pallas", **kw) if entry == "K4"
         else polyphase.filtered_lrelu_pallas_v2(x, FU, FU, None, **kw))
    with pytest.raises(NotImplementedError, match="forward-only"):
        torch.autograd.grad(y.sum(), x)
    with torch.no_grad():
        assert not filtered_lrelu(x, FU, FU, None, impl="pallas", **kw).requires_grad


def test_kernel_entries_reject_cpu_tensor():
    x = torch.zeros((1, 1, 12, 16))
    for fn in (exact.exact_fwd_cuda, polyphase.polyphase_fwd_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, FU, FU, 2, 2, 9, 1.4, 0.2, None)


def test_up_must_divide_16_down():
    """K4 raises ValueError where the JAX kernel's `_h_band_matrices`
    asserts that up divides 16 * down (here up 3, down 1), on a CPU tensor
    too."""
    x, b = _inputs((1, 2, 12, 16), seed=15)
    kw = dict(up=3, down=1, padding=9)
    with pytest.raises(AssertionError):
        jax_flr.filtered_lrelu(jnp.asarray(x), FU, FU, jnp.asarray(b), impl="pallas", **kw)
    with pytest.raises(ValueError, match="divide"):
        filtered_lrelu(torch.from_numpy(x), FU, FU, torch.from_numpy(b), impl="pallas", **kw)
